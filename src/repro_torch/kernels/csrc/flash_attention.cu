// Hand-written Hopper (sm_90a) kernel for blockwise online-softmax
// attention, the LM substrate's prefill attention.
//
//   K5 flash_attention_kernel  <- repro/kernels/flash_attention.py
//                                 flash_attention_pallas, _flash_kernel
//
//   o[b, h, i, :] = softmax_j(mask(q[b,h,i,:] . k[b,h/G,j,:] * scale)) v[b,h/G,j,:]
//   q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] with any strides on the first
//   three axes (D contiguous), G = Hq / Hkv, scale = D^-0.5 applied after
//   the product; o [B, Hq, Sq, D] contiguous, in q's type.
//   mask = k_pos < Skv, & k_pos <= q_pos when causal, & k_pos > q_pos -
//   window when window > 0, with q_pos = i + q_offset and k_pos = j.  A
//   row whose keys are all masked gives 0, as in the reference.
//
// What bounds it on this card: at gemma-2b's prefill (Hq 8, D 256, causal
// S 1024) the function needs 4*Hq*D*S(S+1)/2 = 4.3 GFLOP against 9.4 MB
// moved, so it is bound by operations.  This first port does them as f32
// FMAs on the CUDA cores (no TF32, no wgmma, expf rather than __expf), as
// the Pallas kernel computes in f32 inside; its floor is then 67 TFLOP/s,
// not the tensor cores' 989.  Making it fast (wgmma on bf16 tiles, TMA) is
// later work.
//
// Design.  One CTA of NWARPS warps per (q tile of BQ = 4*NWARPS rows, q
// head, batch row); the KV tiles are walked in a loop inside the CTA, which
// takes the place of the TPU grid's sequential fourth axis.  The CTA
// stages its q tile once and each K and V tile of BK = 32 keys in shared
// memory as f32 (K rows padded to D+1 floats so a warp reading 32 keys at
// one d hits 32 banks).  Warp w owns q rows 4w..4w+3: lane l computes the
// four scores of key l, the warp reduces max and sum with shuffles, and
// each lane then accumulates the four rows' outputs at d = l + 32*i in
// registers.  The KV head is h / G: KV is never repeated in memory.  KV
// tiles that the causal or window mask empties for the whole q tile are
// skipped: that changes no number, because a masked p is 0 and alpha is
// then exactly 1.  Ragged Sq and Skv are masked in the kernel, with no
// padded copies.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry point returns cudaGetLastError() so the
// Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int ROWS = 4;                 // q rows per warp
constexpr int BQ = NWARPS * ROWS;       // q rows per CTA
constexpr int BK = 32;                  // keys per KV tile (one per lane)
constexpr float NEG_INF = -1e30f;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Butterfly sum: lanes i and i^off add the same two values, so every lane
// ends with the same float.
__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(BQ) * D       // q tile
                          + static_cast<size_t>(BK) * (D + 1)  // K tile
                          + static_cast<size_t>(BK) * D     // V tile
                          + static_cast<size_t>(BQ) * BK);  // p per warp
}

// ND = number of 32-wide column chunks of D each lane accumulates.
template <typename T, int ND>
__global__ void __launch_bounds__(NWARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int Hq, int Hkv, int Sq, int Skv, int D,
                       long long sqb, long long sqh, long long sqs,
                       long long skb, long long skh, long long sks,
                       long long svb, long long svh, long long svs,
                       int causal, int window, int q_offset, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [BQ][D]
  float* ks = qs + BQ * D;                // [BK][D + 1]
  float* vs = ks + BK * (D + 1);          // [BK][D]
  float* ps = vs + BK * D;                // [NWARPS][ROWS][BK]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + hk * skh;
  const T* vb = v + b * svb + hk * svh;

  for (int idx = tid; idx < BQ * D; idx += NWARPS * 32) {
    const int r = idx / D, d = idx % D;
    qs[idx] = q0 + r < Sq ? to_f32(qb[(q0 + r) * sqs + d]) : 0.0f;
  }

  // KV tiles this q tile can see (the rest are masked for every row)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + q_offset + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1) / BK * BK;

  float m[ROWS], l[ROWS], acc[ROWS][ND];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    m[rr] = NEG_INF;
    l[rr] = 0.0f;
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[rr][i] = 0.0f;
  }
  float* pw = ps + warp * ROWS * BK;

  for (int k0 = kv_lo; k0 < kv_hi; k0 += BK) {
    __syncthreads();                      // previous tile fully consumed
    for (int idx = tid; idx < BK * D; idx += NWARPS * 32) {
      const int j = idx / D, d = idx % D;
      const bool in = k0 + j < Skv;
      ks[j * (D + 1) + d] = in ? to_f32(kb[(k0 + j) * sks + d]) : 0.0f;
      vs[j * D + d] = in ? to_f32(vb[(k0 + j) * svs + d]) : 0.0f;
    }
    __syncthreads();

    // scores of key k0 + lane against this warp's rows
    float s[ROWS];
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) s[rr] = 0.0f;
    const float* krow = ks + lane * (D + 1);
    const float* qrow = qs + warp * ROWS * D;
    for (int d = 0; d < D; ++d) {
      const float kv = krow[d];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr)
        s[rr] = fmaf(qrow[rr * D + d], kv, s[rr]);
    }

    const int kp = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const int qp = q0 + warp * ROWS + rr + q_offset;
      bool valid = kp < Skv;
      if (causal) valid = valid && kp <= qp;
      if (window > 0) valid = valid && kp > qp - window;
      const float sv = valid ? s[rr] * scale : NEG_INF;
      const float m_new = fmaxf(m[rr], warp_max(sv));
      const float p = valid ? expf(sv - m_new) : 0.0f;
      const float alpha = expf(m[rr] - m_new);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = m_new;
      pw[rr * BK + lane] = p;
#pragma unroll
      for (int i = 0; i < ND; ++i) acc[rr][i] *= alpha;
    }
    __syncwarp();

    for (int j = 0; j < BK; ++j) {
      float vv[ND];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        const int d = lane + 32 * i;
        vv[i] = d < D ? vs[j * D + d] : 0.0f;
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float p = pw[rr * BK + j];
#pragma unroll
        for (int i = 0; i < ND; ++i) acc[rr][i] = fmaf(p, vv[i], acc[rr][i]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = q0 + warp * ROWS + rr;
    if (r >= Sq) continue;
    const float den = fmaxf(l[rr], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * Hq + h) * Sq + r) * D;
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int d = lane + 32 * i;
      if (d < D) orow[d] = from_f32<T>(acc[rr][i] / den);
    }
  }
}

template <typename T, int ND>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, const long long* st,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  // the attribute belongs to the current device, so it is set on every
  // launch (a cheap host call) rather than once per process
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, ND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(32 * ND)));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<T, ND><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, D,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, const long long* st,
             int causal, int window, int q_offset, float scale,
             cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                        window, q_offset, scale, stream);
  if (D <= 64)
    return launch<T, 2>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                        window, q_offset, scale, stream);
  if (D <= 128)
    return launch<T, 4>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                        window, q_offset, scale, stream);
  return launch<T, 8>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                      window, q_offset, scale, stream);
}

}  // namespace

// strides: q (b, h, s), k (b, h, s), v (b, h, s), in elements; D is
// contiguous.  window <= 0 means no window.  dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and o share it).  Returns a cudaError_t as int.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, int causal, int window,
    int q_offset, float scale, int dtype, void* stream) {
  if (D <= 0 || D > 256 || D % 8 != 0 || Hkv <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st, causal,
                           window, q_offset, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, st,
                                   causal, window, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
