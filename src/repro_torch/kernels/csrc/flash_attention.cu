// Hand-written Hopper (sm_90a) kernel for blockwise online-softmax
// attention on the TF32 tensor cores: K5's route for f32, for head dims the
// wgmma kernel does not take, and for layouts TMA cannot read.
//
//   K5 flash_attention_tf32_kernel  <- repro/kernels/flash_attention.py
//                                      flash_attention_pallas, _flash_kernel
//
//   o[b, h, i, :] = softmax_j(mask(q[b,h,i,:] . k[b,h/G,j,:] * scale)) v[b,h/G,j,:]
//   q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] with any strides on the first
//   three axes (D contiguous), G = Hq / Hkv, scale = D^-0.5 applied after
//   the product; o [B, Hq, Sq, D] contiguous, in q's type (f32 or bf16).
//   mask = k_pos < Skv, & k_pos <= q_pos when causal, & k_pos > q_pos -
//   window when window > 0, with q_pos = i + q_offset and k_pos = j.  A
//   row whose keys are all masked gives 0, as in the reference.
//
// What bounds it on this card: at gemma-2b's prefill (Hq 8, D 256, causal
// S 1024) the function needs 4*Hq*D*S(S+1)/2 = 4.3 GFLOP against 18.9 MB
// moved in f32, so it is bound by operations: 0.0087 ms at the dense TF32
// rate (495 TFLOP/s), 0.064 ms at the f32 FMA rate of the CUDA cores.
//
// Numbers.  Both products run on mma.sync m16n8k8 with TF32 operands and f32
// accumulators.  One rounding of an f32 operand to TF32 (10 explicit
// mantissa bits, about 4.9e-4 relative) would break the reference's f32
// tolerance (2e-5), so every f32 operand x goes in as two TF32 terms,
// hi = x truncated to TF32 and lo = x - hi (which the mma truncates to
// TF32 in turn), and each product as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// (a_lo*b_lo, about 2^-20 relative, is dropped): three mmas where the
// function has one.  QK^T sums the small terms in an accumulator of their
// own and adds it once a tile; PV adds them to O before the large term.
// bf16 q, k
// and v are exact in TF32, so QK^T takes one mma and PV two (p is always
// split).  The softmax follows the Pallas kernel: s * scale, a running max
// and sum in f32 with expf (not __expf), p = 0 where masked, and o = acc /
// max(l, 1e-30) at the end.
//
// Design.  One CTA of 8 warps per (q tile of BQ = 32 rows, q head, batch
// row) walks the KV tiles in a loop inside the CTA, which takes the place
// of the TPU grid's sequential fourth axis.  Warps w, w + 2, w + 4 and
// w + 6 own q rows 16w..16w+15 and take keys 0-7, 8-15, 16-23 and 24-31 of
// every tile, each with its own running max, sum and accumulator; at the
// end three of them hand their state over through shared memory and the
// first merges the four parts (m = max_i m_i, the sums and accumulators
// rescaled by exp(m_i - m)).  Why this shape (benchmarks/
// torch_kernel_ablations.py): at D 256 in f32 the tiles fill one SM, so a
// CTA of 4 warps left each scheduler one warp, stalled on every dependent
// mma, load and split; and a causal prefill's last q tiles see every key,
// so with one 64-row tile an SM the slowest CTA did twice the average work.
// With 32-row tiles gemma-2b's prefill has 256 CTAs on 132 SMs, handed out
// heaviest first (the grid's q-tile axis runs backwards).  The q tile is
// copied into shared memory once; K and V tiles of BK = 32 keys come in by
// cp.async into a two-stage ring, so the next tile's copy runs under the
// current tile's products.  Tiles stay in the
// input's type in shared memory (bf16 is widened to TF32 bits by a shift
// when a fragment is read), with rows padded to D + 4 elements: then every
// fragment load -- Q and K along D, V along keys -- hits 32 distinct banks.
// The accumulator layout of S is not the A layout of PV; rather than move
// p between lanes, PV takes the keys of each 8-key chunk in the order
// (0, 2, 4, 6, 1, 3, 5, 7) -- the order in which a lane already holds them
// -- and reads V's rows in that order.  KV tiles that the causal or window
// mask empties for the whole q tile are never loaded, and a warp skips its
// half of a tile where that half is masked for all of its 16 rows; neither
// changes a number (p = 0, alpha = 1).  Ragged Sq and Skv come in as zero rows (cp.async with
// a source size of 0) and are masked here.  Row copies are 16, 8 or 4
// bytes wide as the operands' alignment allows (the wrapper picks the
// width), or plain element loads for layouts that allow none.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry point returns cudaGetLastError() so the
// Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QWARPS = 2;               // warps along q: 16 rows each
constexpr int KSPLIT = 4;               // warps along the keys of a tile
constexpr int NWARPS = QWARPS * KSPLIT;
constexpr int BQ = 16 * QWARPS;         // q rows per CTA
constexpr int BK = 32;                  // keys per KV tile
constexpr int BKW = BK / KSPLIT;        // keys of a tile one warp takes
constexpr int PAD = 4;                  // row pad of every tile, in elements
constexpr float NEG_INF = -1e30f;

__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// `bytes` (4, 8 or 16) from src into shared dst, zero-filled when !valid.
__device__ inline void cp_async(void* dst, const void* src, int bytes,
                                bool valid) {
  const int n = valid ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(n) : "memory");
}
__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ inline void cp_async_wait_one() {     // all but the newest group
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T> __device__ inline T zero();
template <> __device__ inline float zero<float>() { return 0.0f; }
template <> __device__ inline __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

// Rows [row0, row0 + NR) of one (b, h) slice into dst[r * ld + d]; rows at
// or past `nvalid` become zeros.  `vec` is the copy width in bytes (16, 8
// or 4), or 0 for plain element copies.
template <typename T, int NR>
__device__ inline void load_rows(T* dst, const T* src, long long rstride,
                                 int row0, int nvalid, int D, int ld,
                                 int vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (vec == 0) {
    for (int r = warp; r < NR; r += NWARPS)
      for (int d = lane; d < D; d += 32)
        dst[r * ld + d] = row0 + r < nvalid ? src[(row0 + r) * rstride + d]
                                            : zero<T>();
    return;
  }
  // a row of per_row copies takes `lanes` lanes (a power of two), so a
  // warp copies 32 / lanes rows at once
  const int per_row = D * static_cast<int>(sizeof(T)) / vec;
  int lanes = 1;
  while (lanes < per_row && lanes < 32) lanes <<= 1;
  const int rows = 32 / lanes;
  for (int r = warp * rows + lane / lanes; r < NR; r += NWARPS * rows) {
    const bool valid = row0 + r < nvalid;
    const char* s = reinterpret_cast<const char*>(
        valid ? src + (row0 + r) * rstride : src);
    char* d = reinterpret_cast<char*>(dst + r * ld);
    for (int c = lane % lanes; c < per_row; c += lanes)
      cp_async(d + c * vec, s + c * vec, vec, valid);
  }
}

// An element of a tile as f32, and its TF32 bits when the type is exact
// in TF32 (bf16: the 16 bits shifted up).
__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// x = hi + lo: hi is x with its low 13 mantissa bits cleared (a TF32
// value), lo = x - hi exactly (at most 13 significant bits).  The tensor
// cores read a .tf32 operand's top 19 bits, so lo enters the mma truncated
// to TF32: hi + lo keeps x to 2^-21 relative, against 2^-11 for hi alone,
// in two instructions (cvt.rna.tf32.f32 runs on a quarter-rate pipe and
// rounds one term only).  For bf16 input hi is x itself and lo is 0.
template <typename T>
__device__ inline void split(float x, uint32_t& hi, uint32_t& lo);
template <> __device__ inline void split<float>(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
template <> __device__ inline void split<__nv_bfloat16>(float x, uint32_t& hi,
                                                        uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = 0u;
}

// c += a b, m16n8k8, TF32 operands, f32 accumulators.
__device__ inline void mma(float (&c)[4], const uint32_t (&a)[4],
                           uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b with each operand in two TF32 terms: 3 mmas for f32 (lo*hi,
// hi*lo, hi*hi), fewer where a term is 0 for every element (bf16 operands).
// The small terms go to `small` where it is given (a second accumulator
// halves the chain of dependent mmas), else to c first.
template <bool kALo, bool kBLo>
__device__ inline void mma_split(float (&c)[4], float (&small)[4],
                                 const uint32_t (&ah)[4],
                                 const uint32_t (&al)[4], uint32_t bh0,
                                 uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  if (kALo) mma(small, al, bh0, bh1);
  if (kBLo) mma(small, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

__device__ inline float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ inline float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// the q tile and two K/V stages; after the loop the same bytes hold what
// the key-half warps hand over (QWARPS x 32 lanes x (4 + D / 2) floats)
size_t smem_bytes(int D, size_t esz) {
  const size_t tiles = esz * static_cast<size_t>(BQ + 4 * BK) * (D + PAD);
  const size_t xch =
      sizeof(float) * QWARPS * (KSPLIT - 1) * 32 * (4 + D / 2);
  return tiles > xch ? tiles : xch;
}

// NT = 8-column tiles of D that a lane's accumulator holds (D <= 8 * NT).
template <typename T, int NT>
__global__ void __launch_bounds__(NWARPS * 32, 1)
flash_attention_tf32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            int Hq, int Hkv, int Sq, int Skv, int D,
                            long long sqb, long long sqh, long long sqs,
                            long long skb, long long skh, long long sks,
                            long long svb, long long svh, long long svs,
                            int causal, int window, int q_offset, float scale,
                            int vec_q, int vec_kv) {
  constexpr bool kF32 = sizeof(T) == 4;   // f32 operands carry a lo term
  constexpr int NC = BKW / 8;             // 8-key chunks a warp takes a tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = D + PAD;
  T* qs = reinterpret_cast<T*>(smem);     // [BQ][ld]
  T* ks = qs + BQ * ld;                   // [2][BK][ld]
  T* vs = ks + 2 * BK * ld;               // [2][BK][ld]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wq = warp % QWARPS;           // this warp's 16 q rows
  const int wk = warp / QWARPS;           // this warp's keys of each tile
  const int g = lane >> 2;                // fragment row group
  const int t = lane & 3;                 // thread in the group
  // the grid runs over (q head, q tile, batch row) with the last q tiles,
  // the heaviest under a causal mask, handed out first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;
  const int nd = D / 8;

  // KV tiles this q tile can see (the rest are masked for every row)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + q_offset + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1) / BK * BK;

  // the keys this warp's rows can see, for skipping its part of a tile
  const int w0 = q0 + wq * 16;
  const bool w_rows = w0 < Sq;
  int w_hi = Skv;
  if (causal) w_hi = min(w_hi, min(w0 + 15, Sq - 1) + q_offset + 1);
  const int w_lo = window > 0 ? w0 + q_offset - window + 1 : 0;

  load_rows<T, BQ>(qs, qb, sqs, q0, Sq, D, ld, vec_q);
  if (kv_lo < kv_hi) {
    load_rows<T, BK>(ks, kb, sks, kv_lo, Skv, D, ld, vec_kv);
    load_rows<T, BK>(vs, vb, svs, kv_lo, Skv, D, ld, vec_kv);
  }
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};        // rows g and g + 8
  float l[2] = {0.0f, 0.0f};
  const T* qw = qs + wq * 16 * ld;

  int stage = 0;
  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK, stage ^= 1) {
    if (k0 + BK < kv_hi) {
      const int nxt = (stage ^ 1) * BK * ld;
      load_rows<T, BK>(ks + nxt, kb, sks, k0 + BK, Skv, D, ld, vec_kv);
      load_rows<T, BK>(vs + nxt, vb, svs, k0 + BK, Skv, D, ld, vec_kv);
      cp_async_commit();
      cp_async_wait_one();
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    const int kw = k0 + wk * BKW;         // this warp's first key
    if (w_rows && kw < w_hi && kw + BKW > w_lo) {
      const T* kt = ks + (stage * BK + wk * BKW) * ld;
      const T* vt = vs + (stage * BK + wk * BKW) * ld;

      // S = Q K^T over the warp's NC chunks of 8 keys: the hi*hi products
      // in s, the small terms in s2, added once at the end
      float s[NC][4], s2[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = s2[n][i] = 0.0f;
      for (int kk = 0; kk < nd; ++kk) {
        const int c = kk * 8 + t;
        uint32_t ah[4], al[4];
        split<T>(to_f32(qw[g * ld + c]), ah[0], al[0]);
        split<T>(to_f32(qw[(g + 8) * ld + c]), ah[1], al[1]);
        split<T>(to_f32(qw[g * ld + c + 4]), ah[2], al[2]);
        split<T>(to_f32(qw[(g + 8) * ld + c + 4]), ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          const T* kr = kt + (n * 8 + g) * ld + c;
          uint32_t bh0, bl0, bh1, bl1;
          split<T>(to_f32(kr[0]), bh0, bl0);
          split<T>(to_f32(kr[4]), bh1, bl1);
          mma_split<kF32, kF32>(s[n], s2[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      if (kF32) {
#pragma unroll
        for (int n = 0; n < NC; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[n][i] = s2[n][i] + s[n][i];
      }

      // mask, scale, online softmax (lane holds rows g, g + 8 and keys
      // n * 8 + 2t, n * 8 + 2t + 1 of each chunk n)
      uint32_t valid = 0;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int kp = kw + n * 8 + 2 * t + (i & 1);
          const int qp = w0 + g + 8 * r + q_offset;
          bool ok = kp < Skv;
          if (causal) ok = ok && kp <= qp;
          if (window > 0) ok = ok && kp > qp - window;
          s[n][i] = ok ? s[n][i] * scale : NEG_INF;
          valid |= static_cast<uint32_t>(ok) << (n * 4 + i);
          mx[r] = fmaxf(mx[r], s[n][i]);
        }
      float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = expf(m[r] - mx[r]);
        m[r] = mx[r];
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = (valid >> (n * 4 + i)) & 1u
                              ? expf(s[n][i] - m[i >> 1]) : 0.0f;
          s[n][i] = p;
          sum[i >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }

      // O += P V, chunk by chunk: A column j of chunk c is key c*8 + 2j
      // for j < 4 and key c*8 + 2(j-4) + 1 for j >= 4
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        uint32_t ph[4], pl[4];
        split<float>(s[c][0], ph[0], pl[0]);   // (g,     key 2t)
        split<float>(s[c][2], ph[1], pl[1]);   // (g + 8, key 2t)
        split<float>(s[c][1], ph[2], pl[2]);   // (g,     key 2t + 1)
        split<float>(s[c][3], ph[3], pl[3]);   // (g + 8, key 2t + 1)
        const T* v0 = vt + (c * 8 + 2 * t) * ld + g;
        const T* v1 = v0 + ld;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          if (n < nd) {
            uint32_t bh0, bl0, bh1, bl1;
            split<T>(to_f32(v0[n * 8]), bh0, bl0);
            split<T>(to_f32(v1[n * 8]), bh1, bl1);
            mma_split<true, kF32>(acc[n], acc[n], ph, pl, bh0, bh1, bl0,
                                  bl1);
          }
        }
      }
    }
    __syncthreads();                      // the stage is free to refill
  }
  cp_async_wait_all();

  // the KSPLIT key parts of each row: warps wk > 0 hand their running
  // max, sum and accumulator over through shared memory (the tiles are no
  // longer read) and warp wk = 0 merges them
  const int stride = 4 + 4 * nd;          // floats a lane hands over
  float* xch = reinterpret_cast<float*>(smem);
  if (wk > 0) {
    float* mine = xch + ((wq * (KSPLIT - 1) + wk - 1) * 32 + lane) * stride;
    mine[0] = m[0];
    mine[1] = m[1];
    mine[2] = l[0];
    mine[3] = l[1];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nd)
#pragma unroll
        for (int i = 0; i < 4; ++i) mine[4 + 4 * n + i] = acc[n][i];
  }
  __syncthreads();
  if (wk > 0 || !w_rows) return;
  float mn[2] = {m[0], m[1]};
  for (int j = 1; j < KSPLIT; ++j) {
    const float* part = xch + ((wq * (KSPLIT - 1) + j - 1) * 32 + lane) * stride;
    mn[0] = fmaxf(mn[0], part[0]);
    mn[1] = fmaxf(mn[1], part[1]);
  }
  float a[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    a[r] = expf(m[r] - mn[r]);
    l[r] *= a[r];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] *= a[i >> 1];
  for (int j = 1; j < KSPLIT; ++j) {
    const float* part = xch + ((wq * (KSPLIT - 1) + j - 1) * 32 + lane) * stride;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      a[r] = expf(part[r] - mn[r]);
      l[r] += part[2 + r] * a[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      if (n < nd)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[n][i] += part[4 + 4 * n + i] * a[i >> 1];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * Hq + h) * Sq + row) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (n < nd) {
        const float x0 = acc[n][2 * r] / den, x1 = acc[n][2 * r + 1] / den;
        if constexpr (kF32) {
          *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) = make_float2(x0, x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
  }
}

template <typename T, int NT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, const long long* st,
           int causal, int window, int q_offset, float scale, int vec_q,
           int vec_kv, cudaStream_t stream) {
  const size_t smem = smem_bytes(D, sizeof(T));
  // the attribute belongs to the current device, so it is set on every
  // launch (a cheap host call) rather than once per process
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tf32_kernel<T, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int q_tiles = (Sq + BQ - 1) / BQ;
  if (q_tiles > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(Hq, q_tiles, B);
  flash_attention_tf32_kernel<T, NT><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window, q_offset, scale, vec_q, vec_kv);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, const long long* st,
             int causal, int window, int q_offset, float scale, int vec_q,
             int vec_kv, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 4>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                        window, q_offset, scale, vec_q, vec_kv, stream);
  if (D <= 64)
    return launch<T, 8>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                        window, q_offset, scale, vec_q, vec_kv, stream);
  if (D <= 128)
    return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                         window, q_offset, scale, vec_q, vec_kv, stream);
  return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                       window, q_offset, scale, vec_q, vec_kv, stream);
}

bool vec_ok(int vec, size_t esz) {
  return vec == 0 || vec == 4 || vec == 8 || (vec == 16 && esz == 4);
}

}  // namespace

// strides: q (b, h, s), k (b, h, s), v (b, h, s), in elements; D is
// contiguous.  window <= 0 means no window.  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and o share it).  vec_q / vec_kv: the bytes of one
// row copy (16 for f32 only, 8, 4), or 0 for element copies; every row
// start of q (of k and v) must be aligned to it.  Returns a cudaError_t as
// int.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, int causal, int window,
    int q_offset, float scale, int dtype, int vec_q, int vec_kv,
    void* stream) {
  const size_t esz = dtype == 0 ? 4 : 2;
  if (D <= 0 || D > 256 || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      !vec_ok(vec_q, esz) || !vec_ok(vec_kv, esz))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                           window, q_offset, scale, vec_q, vec_kv, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st,
                                   causal, window, q_offset, scale, vec_q,
                                   vec_kv, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
