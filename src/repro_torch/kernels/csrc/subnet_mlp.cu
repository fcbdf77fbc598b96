// Hand-written Hopper (sm_90a) kernels for one affine stage of many tiny
// per-unit MLPs (the sub-networks hidden inside the L-LUTs).
//
//   K4 unit_affine_dense_kernel, unit_affine_units_kernel, and the dense
//      gradient unit_affine_dx_kernel + unit_affine_dx_sum_kernel
//                          <- repro/kernels/subnet_mlp.py
//                             unit_affine_pallas, _affine_kernel
//
//   y[b, u, :] = x[b, u, :] @ w[u] + bias[u]      (optional ReLU)
//   x [B, U, DIN] (any strides; a stride-0 unit axis is dense mode),
//   w [U, DIN, DOUT] (any strides: backward passes w^T as a view),
//   bias [U, DOUT] contiguous or absent, y [B, U, DOUT] contiguous.
//
// What bounds it on this card: at the paper's widths it is a GEMM with real
// depth (dense layer 0 of mnist: 2*256*2160*784*64 = 55.5 GFLOP against
// 0.58 GB moved), so the floor is f32 FMAs at 67 TFLOP/s outside the tensor
// cores; sparse stages (DIN 6) are bound by writing y.  The tensor cores are
// not used on purpose: the toolflow needs one (unit, row) to give the same
// float at every batch size and through every input layout, so that a
// folded table equals the quantized model bit for bit on the card.
//
// The numeric contract, shared by every kernel here and by the reference
// kernel below: every output element is summed by one thread, with fmaf
// over k = 0..DIN-1 in that order, starting from 0.0f; then the bias is
// added, then the ReLU applied.  k-slices only stage data; they never split
// the sum.  So tile shapes, batch size, grid and layout never change a bit.
//
// Design of the forward (unit_affine_dense_kernel / _units_kernel):
//  * A CTA computes a BM x BN output tile; each thread keeps a TM x TN
//    register tile.  Operands are staged k-major in shared memory
//    (xs[k][row], ws[k][col]) and read as float4 fragments; a warp's lanes
//    are laid out 4 x 8, so its fragment reads touch contiguous bytes.  The
//    loop is bound by those shared-memory reads more than by the FMAs, so
//    the big dense tile (128 x 128) gives each of 128 threads 16 x 8
//    outputs: 6 float4 reads per 128 FMAs, three CTAs an SM
//    (benchmarks/torch_k4_tiles.py compares the shapes).  Other routes use
//    256 threads with 8x8, 8x4, 4x4, 4x2 or 1x1.
//  * k-slices of 16 are double-buffered and copied by cp.async: 16 bytes at
//    a time where the tile's fast axis is contiguous and aligned (w's
//    columns; the dense route's x, which the wrapper hands over k-major), 4
//    bytes at a time, transposing, otherwise.  A slice lands while the
//    previous one is computed; one __syncthreads a slice.
//    bf16 operands are converted to f32 while staging.  A slice of DIN < KT
//    stages only DIN rows.
//  * Dense mode (x's unit axis has stride 0, or x is shared rows [B, DIN]):
//    the column axis is c = u*DOUT + n over all units, so one staged x tile
//    serves every column of the CTA (two units at DOUT 64, 128 at DOUT 1).
//  * Per-unit mode: x differs per unit, column tiles stay within a unit
//    (grid z = unit).
//
// The dense gradient (unit_affine_dx_kernel): dx[b, k] = sum over (u, n) of
// dy[b, u, n] * w[u, k, n], straight into [B, DIN] without the [B, U, DIN]
// tensor that the per-unit route would write.  The same tile machinery runs
// the reduction axis (u, n); it is split across CTAs in fixed chunks of
// CHUNK units into an f32 scratch [S, B, DIN], and unit_affine_dx_sum_kernel
// adds the S partials in index order.  Each partial is one thread's fmaf
// chain over (u ascending, n ascending); the partition depends on U only,
// so dx is the same bit for bit from run to run and for any batch size.
//
// unit_affine_reference_kernel is the first version of K4 (one CTA per
// unit, 4x4 register tiles, scalar staging), kept unchanged as the
// bit-exact oracle of the kernels above; no route of the main path
// launches it.
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise; every C entry point returns cudaGetLastError() so the Python
// wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---------------------------------------------------------------------------
// The reference kernel (the oracle; unchanged from K4's first version)
// ---------------------------------------------------------------------------

constexpr int REF_KT = 16;   // k-slice staged per iteration

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
unit_affine_reference_kernel(const T* __restrict__ x, const T* __restrict__ w,
                             const T* __restrict__ bias, T* __restrict__ y,
                             int B, int U, int DIN, int DOUT, int col_tiles,
                             long long sxb, long long sxu, long long sxk,
                             long long swu, long long swk, long long swn,
                             int activate) {
  constexpr int KT = REF_KT;
  constexpr int TX = BN / TN;            // threads along the columns
  constexpr int TY = BM / TM;            // threads along the rows
  constexpr int NT = TX * TY;
  // +1 column: the staging stores walk k across a warp without bank
  // conflicts; the compute reads walk rows/columns and stay conflict-free.
  __shared__ float xs[KT][BM + 1];
  __shared__ float ws[KT][BN + 1];

  const int u = blockIdx.y;
  const int col0 = (blockIdx.x % col_tiles) * BN;
  const int row0 = (blockIdx.x / col_tiles) * BM;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const T* xu = x + static_cast<long long>(u) * sxu;
  const T* wu = w + static_cast<long long>(u) * swu;
  const bool w_k_fast = swk == 1;        // w^T view: k is the contiguous axis

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < DIN; k0 += KT) {
    const int kn = min(KT, DIN - k0);
    for (int idx = tid; idx < BM * KT; idx += NT) {
      const int kk = idx % KT;
      const int r = idx / KT;
      const int gr = row0 + r;
      float v = 0.0f;
      if (gr < B && kk < kn)
        v = to_f32(xu[gr * sxb + static_cast<long long>(k0 + kk) * sxk]);
      xs[kk][r] = v;
    }
    for (int idx = tid; idx < KT * BN; idx += NT) {
      int kk, c;
      if (w_k_fast) { kk = idx % KT; c = idx / KT; }
      else          { c = idx % BN;  kk = idx / BN; }
      const int gc = col0 + c;
      float v = 0.0f;
      if (gc < DOUT && kk < kn)
        v = to_f32(wu[static_cast<long long>(k0 + kk) * swk + gc * swn]);
      ws[kk][c] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= B) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c >= DOUT) continue;
      float v = acc[i][j];
      if (bias != nullptr) v = v + to_f32(bias[static_cast<long long>(u) * DOUT + c]);
      if (activate) v = fmaxf(v, 0.0f);
      y[(static_cast<long long>(r) * U + u) * DOUT + c] = from_f32<T>(v);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN>
int launch_reference(const void* x, const void* w, const void* b, void* y,
                     int B, int U, int DIN, int DOUT, long long sxb,
                     long long sxu, long long sxk, long long swu,
                     long long swk, long long swn, int activate,
                     cudaStream_t stream) {
  const int col_tiles = (DOUT + BN - 1) / BN;
  const long long row_tiles = (B + BM - 1) / BM;
  dim3 grid(static_cast<unsigned>(row_tiles * col_tiles), static_cast<unsigned>(U));
  constexpr int threads = (BM / TM) * (BN / TN);
  unit_affine_reference_kernel<T, BM, BN, TM, TN><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), B, U, DIN, DOUT,
      col_tiles, sxb, sxu, sxk, swu, swk, swn, activate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_reference(const void* x, const void* w, const void* b, void* y,
                       int B, int U, int DIN, int DOUT, long long sxb,
                       long long sxu, long long sxk, long long swu,
                       long long swk, long long swn, int activate,
                       cudaStream_t stream) {
  // Tile shape by the output width only (never by the batch): 64x64 tiles
  // for the hidden widths and backward dx, 128x16 for narrow outputs, one
  // row per thread for the scalar last affine.
  if (DOUT >= 48)
    return launch_reference<T, 64, 64, 4, 4>(x, w, b, y, B, U, DIN, DOUT, sxb,
                                             sxu, sxk, swu, swk, swn, activate,
                                             stream);
  if (DOUT >= 2)
    return launch_reference<T, 128, 16, 4, 2>(x, w, b, y, B, U, DIN, DOUT,
                                              sxb, sxu, sxk, swu, swk, swn,
                                              activate, stream);
  return launch_reference<T, 256, 1, 1, 1>(x, w, b, y, B, U, DIN, DOUT, sxb,
                                           sxu, sxk, swu, swk, swn, activate,
                                           stream);
}

// ---------------------------------------------------------------------------
// Shared machinery of the tiled kernels (KT: the k-slice staged at once)
// ---------------------------------------------------------------------------

// The big tile of the dense forward (BM x BN outputs, TM x TN a thread,
// so (BM / TM) * (BN / TN) threads), its k-slice and the CTAs an SM its
// register budget is cut for, and the units a partial of the dense dx sums.
// 16 x 8 a thread reads 6 float4 fragments per 128 FMAs (8 x 8 at two CTAs
// an SM: 4 per 64, and slower; benchmarks/torch_k4_tiles.py compares
// shapes).
constexpr int DENSE_BM = 128;
constexpr int DENSE_BN = 128;
constexpr int DENSE_TM = 16;
constexpr int DENSE_TN = 8;
constexpr int DENSE_KT = 16;
constexpr int DENSE_MINB = 3;
constexpr int CHUNK = 16;       // units per partial of the dense dx

constexpr int NT = 256;         // threads per CTA of the dx sum

// How a [KT x cols] operand tile is copied (chosen on the host per call):
enum StageMode : int {
  STAGE_VEC = 0,    // 16-byte copies along contiguous, aligned columns (f32)
  STAGE_KFAST = 1,  // 4-byte copies, lanes along k (k contiguous in memory)
  STAGE_CFAST = 2,  // 4-byte copies, one column per thread, lanes along cols
};

__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One element into shared f32: an async 4-byte copy for f32, a load and a
// conversion for bf16 (cp.async moves at least 4 bytes).
__device__ inline void copy_elem(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ inline void copy_elem(float* dst, const __nv_bfloat16* src) {
  *dst = __bfloat162float(*src);
}

// Four consecutive f32 elements, of which the first n_valid are read (the
// rest of the 16 bytes are zero-filled).
__device__ inline void copy_vec4(float* dst, const float* src, int n_valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(n_valid * 4) : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ inline void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Tile [ROWS x kn] -> smem[kk * LD + r], element (r, kk) at
// base + r * rstride + kk * kstep; lanes run along kk (coalesced when
// kstep == 1).  Rows >= rows_valid are not copied (their outputs are never
// stored), nor are kk >= kn (never read).
template <int NTH, int KT, int ROWS, int LD, typename T>
__device__ inline void stage_kfast(float* smem, const T* base,
                                   long long rstride, long long kstep,
                                   int rows_valid, int kn, int tid) {
  constexpr int STEP = NTH / KT;             // rows per pass
  constexpr int PASSES = (ROWS + STEP - 1) / STEP;
  const int kk = tid % KT;
  if (kk >= kn) return;
  const int r0 = tid / KT;
  const T* src = base + kk * kstep + r0 * rstride;
  const long long pstride = STEP * rstride;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int r = r0 + p * STEP;
    if (r < rows_valid) copy_elem(&smem[kk * LD + r], src);
    src += pstride;
  }
}

// Tile [kn x COLS] -> smem[kk * LD + c], element (kk, c) at
// base + coff + kk * kstep with c = tid % COLS (coff is that column's
// offset, computed once per CTA); lanes run along the columns.
template <int NTH, int KT, int COLS, int LD, typename T>
__device__ inline void stage_cfast(float* smem, const T* base, long long coff,
                                   bool cvalid, long long kstep, int kn,
                                   int tid) {
  static_assert(NTH % COLS == 0, "one column per thread");
  constexpr int STEP = NTH / COLS;           // k rows per pass
  constexpr int PASSES = (KT + STEP - 1) / STEP;
  if (!cvalid) return;
  const int c = tid % COLS;
  const T* src = base + coff;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int kk = tid / COLS + p * STEP;
    if (kk < kn) copy_elem(&smem[kk * LD + c], src + kk * kstep);
  }
}

// Tile [kn x COLS] of f32 by 16-byte copies: chunk c4 = tid % (COLS / 4)
// covers columns 4*c4 .. 4*c4+3 at base + coff + kk * kstep, of which
// n_valid (0..4) exist.
template <int NTH, int KT, int COLS, int LD>
__device__ inline void stage_vec(float* smem, const float* base,
                                 long long coff, int n_valid, long long kstep,
                                 int kn, int tid) {
  constexpr int CH = COLS / 4;               // chunks per k row
  static_assert(NTH % CH == 0, "one chunk column per thread");
  constexpr int STEP = NTH / CH;
  constexpr int PASSES = (KT + STEP - 1) / STEP;
  if (n_valid <= 0) return;
  const int c4 = tid % CH;
  const float* src = base + coff;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int kk = tid / CH + p * STEP;
    if (kk < kn) copy_vec4(&smem[kk * LD + c4 * 4], src + kk * kstep, n_valid);
  }
}

// A thread's TM rows (or TN columns) of a BM-wide tile: TM/VEC groups of
// VEC consecutive indices, group g at g*STRIDE + t*VEC, so each group is
// one 16-byte (VEC 4) shared load.
template <int TM, int BM>
struct Frag {
  static constexpr int VEC = TM >= 4 ? 4 : TM;
  static constexpr int STRIDE = BM * VEC / TM;
  static_assert(TM % VEC == 0, "fragment of whole vectors");
  __device__ static inline int at(int t, int i) {
    return (i / VEC) * STRIDE + t * VEC + i % VEC;
  }
  __device__ static inline void load(const float* row, int t, float (&a)[TM]) {
#pragma unroll
    for (int g = 0; g < TM / VEC; ++g) {
      const float* p = row + g * STRIDE + t * VEC;
      if constexpr (VEC == 4) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        a[g * 4 + 0] = v.x; a[g * 4 + 1] = v.y;
        a[g * 4 + 2] = v.z; a[g * 4 + 3] = v.w;
      } else if constexpr (VEC == 2) {
        const float2 v = *reinterpret_cast<const float2*>(p);
        a[g * 2 + 0] = v.x; a[g * 2 + 1] = v.y;
      } else {
        a[g] = p[0];
      }
    }
  }
};

// Thread (ty, tx) of a TY x TX arrangement; a warp's lanes form LY x LX
// (4 x 8 where the tile is wide enough).
template <int TX, int TY>
struct Layout {
  static constexpr int LX = TX < 8 ? TX : 8;
  static constexpr int LY = 32 / LX;
  static constexpr int WX = TX / LX;
  static_assert(TX % LX == 0 && TY % LY == 0, "whole warps");
  __device__ static inline int tx(int tid) {
    return (tid / 32 % WX) * LX + tid % 32 % LX;
  }
  __device__ static inline int ty(int tid) {
    return (tid / 32 / WX) * LY + tid % 32 / LX;
  }
};

template <int BM, int BN, int TM, int TN, int LDX, int LDW>
__device__ __forceinline__ void fma_step(const float* xs, const float* ws,
                                         int kk, int ty, int tx,
                                         float (&acc)[TM][TN]) {
  float a[TM], b[TN];
  Frag<TM, BM>::load(xs + kk * LDX, ty, a);
  Frag<TN, BN>::load(ws + kk * LDW, tx, b);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

// acc += xs[0..kn) (x) ws[0..kn), k ascending.
template <int BM, int BN, int TM, int TN, int LDX, int LDW, int KT>
__device__ __forceinline__ void fma_slice(const float* xs, const float* ws,
                                          int kn, int ty, int tx,
                                          float (&acc)[TM][TN]) {
  if (kn == KT) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      fma_step<BM, BN, TM, TN, LDX, LDW>(xs, ws, kk, ty, tx, acc);
  } else {
#pragma unroll 1
    for (int kk = 0; kk < kn; ++kk)
      fma_step<BM, BN, TM, TN, LDX, LDW>(xs, ws, kk, ty, tx, acc);
  }
}

// ---------------------------------------------------------------------------
// The forward
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int TM, int TN, int KT, bool DENSE>
__device__ __forceinline__ void affine_tile(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, T* __restrict__ y, int B, int U, int DIN,
    int DOUT, long long sxb, long long sxu, long long sxk, long long swu,
    long long swk, long long swn, int xmode, int wmode, int activate) {
  using L = Layout<BN / TN, BM / TM>;
  using FM = Frag<TM, BM>;
  using FN = Frag<TN, BN>;
  constexpr int NTH = (BM / TM) * (BN / TN);
  constexpr int LDX = BM + 4;
  constexpr int LDW = BN % 4 == 0 ? BN + 4 : BN;
  __shared__ __align__(16) float xs[2][KT * LDX];
  __shared__ __align__(16) float ws[2][KT * LDW];

  const int tid = threadIdx.x;
  const int ty = L::ty(tid), tx = L::tx(tid);
  const int row0 = blockIdx.y * BM;
  const long long N = static_cast<long long>(U) * DOUT;
  long long col0, col_end;
  const T* xb = x + static_cast<long long>(row0) * sxb;
  if (DENSE) {
    col0 = static_cast<long long>(blockIdx.x) * BN;
    col_end = N;
  } else {
    const long long u = blockIdx.z;
    col0 = u * DOUT + static_cast<long long>(blockIdx.x) * BN;
    col_end = (u + 1) * DOUT;
    xb += u * sxu;
  }
  const int rows_valid = min(BM, B - row0);
  const int cols_valid = static_cast<int>(min(static_cast<long long>(BN),
                                              col_end - col0));

  // this thread's w column (VEC, CFAST) or the tile's first (KFAST)
  long long wcol, wcstride = 0;
  int wvalid;
  if (wmode == STAGE_KFAST) {
    wcol = (col0 / DOUT) * swu + (col0 % DOUT) * swn;
    wcstride = DOUT == 1 ? swu : swn;        // columns are affine here
    wvalid = cols_valid;
  } else {
    const int cl = wmode == STAGE_VEC ? tid % (BN / 4 > 0 ? BN / 4 : 1) * 4
                                      : tid % BN;
    const long long c = col0 + cl;
    wcol = (c / DOUT) * swu + (c % DOUT) * swn;
    wvalid = wmode == STAGE_VEC ? max(0, min(4, cols_valid - cl))
                                : (cl < cols_valid);
  }
  // this thread's four x rows where x comes with its rows contiguous (VEC)
  const int xr = xmode == STAGE_VEC ? tid % (BM / 4) * 4 : 0;
  const int xvalid = max(0, min(4, rows_valid - xr));

  auto stage = [&](int s, int buf) {
    const int k0 = s * KT;
    const int kn = min(KT, DIN - k0);
    if (xmode == STAGE_VEC) {
      if constexpr (sizeof(T) == 4)
        stage_vec<NTH, KT, BM, LDX>(xs[buf], xb + k0 * sxk, xr * sxb, xvalid,
                                    sxk, kn, tid);
    } else {
      stage_kfast<NTH, KT, BM, LDX>(xs[buf], xb + k0 * sxk, sxb, sxk,
                                    rows_valid, kn, tid);
    }
    const T* wk = w + k0 * swk;
    if (wmode == STAGE_KFAST) {
      stage_kfast<NTH, KT, BN, LDW>(ws[buf], wk + wcol, wcstride, swk,
                                    wvalid, kn, tid);
    } else if (wmode == STAGE_CFAST) {
      stage_cfast<NTH, KT, BN, LDW>(ws[buf], wk, wcol, wvalid != 0, swk, kn,
                                    tid);
    } else {
      if constexpr (sizeof(T) == 4 && BN % 4 == 0)
        stage_vec<NTH, KT, BN, LDW>(ws[buf],
                                    reinterpret_cast<const float*>(wk), wcol,
                                    wvalid, swk, kn, tid);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // double-buffered: slice s + 1 is copied while slice s is computed
  const int nslices = (DIN + KT - 1) / KT;
  if (nslices > 0) {
    stage(0, 0);
    cp_async_commit();
  }
  for (int s = 0; s < nslices; ++s) {
    cp_async_wait_all();
    __syncthreads();               // slice s landed; slice s-1 consumed
    if (s + 1 < nslices) {
      stage(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    fma_slice<BM, BN, TM, TN, LDX, LDW, KT>(
        xs[s & 1], ws[s & 1], min(KT, DIN - s * KT), ty, tx, acc);
  }

  // epilogue: bias, ReLU, store in T; y[r, c] at r * N + c
  float bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int cl = FN::at(tx, j);
    bv[j] = (bias != nullptr && cl < cols_valid)
                ? to_f32(bias[col0 + cl]) : 0.0f;
  }
  const bool vec_store = sizeof(T) == 4 && FN::VEC == 4 && N % 4 == 0 &&
                         col0 % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = FM::at(ty, i);
    if (rl >= rows_valid) continue;
    T* yr = y + static_cast<long long>(row0 + rl) * N + col0;
    float v[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      v[j] = acc[i][j];
      if (bias != nullptr) v[j] = v[j] + bv[j];
      if (activate) v[j] = fmaxf(v[j], 0.0f);
    }
#pragma unroll
    for (int g = 0; g < TN / FN::VEC; ++g) {
      const int cl = FN::at(tx, g * FN::VEC);
      if constexpr (FN::VEC == 4 && sizeof(T) == 4) {
        if (vec_store && cl + 3 < cols_valid) {
          *reinterpret_cast<float4*>(reinterpret_cast<float*>(yr) + cl) =
              make_float4(v[g * 4], v[g * 4 + 1], v[g * 4 + 2], v[g * 4 + 3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < FN::VEC; ++e)
        if (cl + e < cols_valid) yr[cl + e] = from_f32<T>(v[g * FN::VEC + e]);
    }
  }
}

template <typename T, int BM, int BN, int TM, int TN, int KT, int MINB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
unit_affine_dense_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ y, int B,
                         int U, int DIN, int DOUT, long long sxb,
                         long long sxk, long long swu, long long swk,
                         long long swn, int xmode, int wmode, int activate) {
  affine_tile<T, BM, BN, TM, TN, KT, true>(x, w, bias, y, B, U, DIN, DOUT,
                                           sxb, 0, sxk, swu, swk, swn, xmode,
                                           wmode, activate);
}

template <typename T, int BM, int BN, int TM, int TN, int KT, int MINB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
unit_affine_units_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const T* __restrict__ bias, T* __restrict__ y, int B,
                         int U, int DIN, int DOUT, long long sxb,
                         long long sxu, long long sxk, long long swu,
                         long long swk, long long swn, int xmode, int wmode,
                         int activate) {
  affine_tile<T, BM, BN, TM, TN, KT, false>(x, w, bias, y, B, U, DIN, DOUT,
                                            sxb, sxu, sxk, swu, swk, swn,
                                            xmode, wmode, activate);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int BM, int BN, int TM, int TN, bool DENSE,
          int KT = 16, int MINB = 2>
int launch_forward(const void* x, const void* w, const void* b, void* y,
                   int B, int U, int DIN, int DOUT, long long sxb,
                   long long sxu, long long sxk, long long swu, long long swk,
                   long long swn, int activate, cudaStream_t stream) {
  // how w's [KT x BN] tiles are copied: 16-byte copies along contiguous,
  // aligned columns (f32; in dense mode a chunk must not straddle units),
  // lanes along k where k is contiguous and the tile's columns are affine,
  // one column per thread otherwise
  constexpr int THREADS = (BM / TM) * (BN / TN);
  // x's [KT x BM] tiles: 16-byte copies where x comes with its rows
  // contiguous (the dense route's f32 x, transposed by the wrapper) and
  // every unit's rows start 16-byte aligned, lanes along k otherwise
  const int xmode = sizeof(T) == 4 && sxb == 1 && sxk % 4 == 0 &&
                    (DENSE || sxu % 4 == 0) && aligned16(x)
                        ? STAGE_VEC : STAGE_KFAST;
  int wmode = STAGE_CFAST;
  if (sizeof(T) == 4 && BN % 4 == 0 && swn == 1 && swk % 4 == 0 &&
      swu % 4 == 0 && aligned16(w) && (!DENSE || DOUT % 4 == 0))
    wmode = STAGE_VEC;
  else if (swk == 1 && (!DENSE || DOUT == 1))
    wmode = STAGE_KFAST;
  const long long rows = (B + BM - 1) / BM;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* yt = static_cast<T*>(y);
  if constexpr (DENSE) {
    const long long cols = (static_cast<long long>(U) * DOUT + BN - 1) / BN;
    dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(rows), 1);
    unit_affine_dense_kernel<T, BM, BN, TM, TN, KT, MINB>
        <<<grid, THREADS, 0, stream>>>(
        xt, wt, bt, yt, B, U, DIN, DOUT, sxb, sxk, swu, swk, swn, xmode,
        wmode, activate);
  } else {
    const int cols = (DOUT + BN - 1) / BN;
    dim3 grid(static_cast<unsigned>(cols), static_cast<unsigned>(rows),
              static_cast<unsigned>(U));
    unit_affine_units_kernel<T, BM, BN, TM, TN, KT, MINB>
        <<<grid, THREADS, 0, stream>>>(
        xt, wt, bt, yt, B, U, DIN, DOUT, sxb, sxu, sxk, swu, swk, swn,
        xmode, wmode, activate);
  }
  return static_cast<int>(cudaGetLastError());
}

// big tiles resident at once on 132 SMs
constexpr long long WAVE = DENSE_MINB * 132;

template <typename T>
int dispatch_forward(const void* x, const void* w, const void* b, void* y,
                     int B, int U, int DIN, int DOUT, long long sxb,
                     long long sxu, long long sxk, long long swu,
                     long long swk, long long swn, int activate,
                     cudaStream_t stream) {
  // Dense mode when every unit reads the same rows (sxu == 0); tile shapes
  // by problem size, none of which changes a bit of the output.
  if (sxu == 0) {
    const long long big =
        ((B + DENSE_BM - 1) / DENSE_BM) *
        ((static_cast<long long>(U) * DOUT + DENSE_BN - 1) / DENSE_BN);
    if (B > 64 && big >= WAVE)
      return launch_forward<T, DENSE_BM, DENSE_BN, DENSE_TM, DENSE_TN, true,
                            DENSE_KT, DENSE_MINB>(
          x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk, swu, swk, swn,
          activate, stream);
    return launch_forward<T, 64, 64, 4, 4, true>(
        x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk, swu, swk, swn, activate,
        stream);
  }
  if (DOUT >= 48) {
    if (B > 64)
      return launch_forward<T, 128, 64, 8, 4, false>(
          x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk, swu, swk, swn,
          activate, stream);
    return launch_forward<T, 64, 64, 4, 4, false>(
        x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk, swu, swk, swn, activate,
        stream);
  }
  if (DOUT >= 2)
    return launch_forward<T, 128, 16, 4, 2, false>(
        x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk, swu, swk, swn, activate,
        stream);
  return launch_forward<T, 256, 1, 1, 1, false>(
      x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk, swu, swk, swn, activate,
      stream);
}

// ---------------------------------------------------------------------------
// The dense gradient dx[b, k] = sum_{u, n} dy[b, u, n] * w[u, k, n]
// ---------------------------------------------------------------------------

template <typename T, int BM, int BN, int TM, int TN, int KT, int MINB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN), MINB)
unit_affine_dx_kernel(const T* __restrict__ dy, const T* __restrict__ w,
                      float* __restrict__ part, int B, int U, int DIN,
                      int DOUT, long long sdb, long long sdu, long long sdn,
                      long long swu, long long swk, long long swn,
                      int wmode) {
  using L = Layout<BN / TN, BM / TM>;
  using FM = Frag<TM, BM>;
  using FN = Frag<TN, BN>;
  constexpr int NTH = (BM / TM) * (BN / TN);
  constexpr int LDX = BM + 4;
  constexpr int LDW = BN % 4 == 0 ? BN + 4 : BN;
  __shared__ __align__(16) float as[2][KT * LDX];
  __shared__ __align__(16) float bs[2][KT * LDW];

  const int tid = threadIdx.x;
  const int ty = L::ty(tid), tx = L::tx(tid);
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int chunk = blockIdx.z;
  const int u0 = chunk * CHUNK;
  const int nu = min(CHUNK, U - u0);
  const int rows_valid = min(BM, B - row0);
  const int cols_valid = min(BN, DIN - col0);
  // the reduction axis (u, n), unit by unit in slices of up to KT n's; at
  // DOUT 1 it is the unit axis itself, in slices of KT units
  const int per_unit = (DOUT + KT - 1) / KT;
  const int nslices = DOUT == 1 ? (nu + KT - 1) / KT : nu * per_unit;
  const long long astep = DOUT == 1 ? sdu : sdn;
  const long long bstep = DOUT == 1 ? swu : swn;
  const T* ab = dy + static_cast<long long>(row0) * sdb;

  const int cl = wmode == STAGE_VEC ? tid % (BN / 4) * 4 : tid % BN;
  const long long wcol = static_cast<long long>(col0 + cl) * swk;
  const int wvalid = wmode == STAGE_VEC ? max(0, min(4, cols_valid - cl))
                                        : (cl < cols_valid);

  auto slice = [&](int s, long long& aoff, long long& boff) {
    if (DOUT == 1) {
      const long long u = u0 + s * KT;
      aoff = u * sdu;
      boff = u * swu;
      return min(KT, u0 + nu - static_cast<int>(u));
    }
    const long long u = u0 + s / per_unit;
    const int n0 = s % per_unit * KT;
    aoff = u * sdu + n0 * sdn;
    boff = u * swu + n0 * swn;
    return min(KT, DOUT - n0);
  };
  auto stage = [&](int s, int buf) {
    long long aoff, boff;
    const int kn = slice(s, aoff, boff);
    stage_kfast<NTH, KT, BM, LDX>(as[buf], ab + aoff, sdb, astep, rows_valid,
                                  kn, tid);
    const T* wb = w + boff;
    if (wmode == STAGE_KFAST) {
      stage_kfast<NTH, KT, BN, LDW>(bs[buf], wb + col0 * swk, swk, bstep,
                                    cols_valid, kn, tid);
    } else if (wmode == STAGE_CFAST) {
      stage_cfast<NTH, KT, BN, LDW>(bs[buf], wb, wcol, wvalid != 0, bstep,
                                    kn, tid);
    } else {
      if constexpr (sizeof(T) == 4)
        stage_vec<NTH, KT, BN, LDW>(bs[buf],
                                    reinterpret_cast<const float*>(wb), wcol,
                                    wvalid, bstep, kn, tid);
    }
    return kn;
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  int kn_next = 0;
  if (nslices > 0) {
    kn_next = stage(0, 0);
    cp_async_commit();
  }
  for (int s = 0; s < nslices; ++s) {
    const int kn = kn_next;
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < nslices) {
      kn_next = stage(s + 1, (s + 1) & 1);
      cp_async_commit();
    }
    fma_slice<BM, BN, TM, TN, LDX, LDW, KT>(as[s & 1], bs[s & 1], kn, ty, tx,
                                            acc);
  }

  float* pr = part + (static_cast<long long>(chunk) * B + row0) * DIN + col0;
  const bool vec_store = FN::VEC == 4 && DIN % 4 == 0;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int rl = FM::at(ty, i);
    if (rl >= rows_valid) continue;
    float* out = pr + static_cast<long long>(rl) * DIN;
#pragma unroll
    for (int g = 0; g < TN / FN::VEC; ++g) {
      const int c = FN::at(tx, g * FN::VEC);
      if constexpr (FN::VEC == 4) {
        if (vec_store && c + 3 < cols_valid) {
          *reinterpret_cast<float4*>(out + c) =
              make_float4(acc[i][g * 4], acc[i][g * 4 + 1], acc[i][g * 4 + 2],
                          acc[i][g * 4 + 3]);
          continue;
        }
      }
#pragma unroll
      for (int e = 0; e < FN::VEC; ++e)
        if (c + e < cols_valid) out[c + e] = acc[i][g * FN::VEC + e];
    }
  }
}

// dx[i] = ((0 + part[0][i]) + part[1][i]) + ... in index order.
template <typename T>
__global__ void __launch_bounds__(NT)
unit_affine_dx_sum_kernel(const float* __restrict__ part, T* __restrict__ dx,
                          int S, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * NT) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += part[s * n + i];
    dx[i] = from_f32<T>(acc);
  }
}

template <typename T, int BM, int BN, int TM, int TN, int KT = 16,
          int MINB = 2>
int launch_dx(const void* dy, const void* w, float* part, void* dx, int B,
              int U, int DIN, int DOUT, long long sdb, long long sdu,
              long long sdn, long long swu, long long swk, long long swn,
              cudaStream_t stream) {
  // w's tile [KT (u, n) x BN k]: lanes along the reduction axis where it is
  // contiguous (w [U, DIN, DOUT] contiguous, DOUT > 1), 16-byte copies along
  // k where k is contiguous and aligned (DOUT 1), one column per thread
  // otherwise
  const long long bstep = DOUT == 1 ? swu : swn;
  int wmode = STAGE_CFAST;
  if (bstep == 1)
    wmode = STAGE_KFAST;
  else if (sizeof(T) == 4 && swk == 1 && bstep % 4 == 0 && swu % 4 == 0 &&
           (DOUT == 1 || swn % 4 == 0) && aligned16(w))
    wmode = STAGE_VEC;
  const int S = (U + CHUNK - 1) / CHUNK;
  dim3 grid(static_cast<unsigned>((DIN + BN - 1) / BN),
            static_cast<unsigned>((B + BM - 1) / BM), static_cast<unsigned>(S));
  constexpr int THREADS = (BM / TM) * (BN / TN);
  unit_affine_dx_kernel<T, BM, BN, TM, TN, KT, MINB>
      <<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(w), part, B, U, DIN,
      DOUT, sdb, sdu, sdn, swu, swk, swn, wmode);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long n = static_cast<long long>(B) * DIN;
  const unsigned blocks =
      static_cast<unsigned>(min((n + NT - 1) / NT, 65535LL));
  unit_affine_dx_sum_kernel<T><<<blocks, NT, 0, stream>>>(
      part, static_cast<T*>(dx), S, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dx(const void* dy, const void* w, float* part, void* dx, int B,
                int U, int DIN, int DOUT, long long sdb, long long sdu,
                long long sdn, long long swu, long long swk, long long swn,
                cudaStream_t stream) {
  if (B > 64)
    return launch_dx<T, 128, 128, 8, 8>(
        dy, w, part, dx, B, U, DIN, DOUT, sdb, sdu, sdn, swu, swk, swn,
        stream);
  return launch_dx<T, 64, 64, 4, 4>(dy, w, part, dx, B, U, DIN, DOUT, sdb,
                                    sdu, sdn, swu, swk, swn, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and y share it).  bias may
// be null.  A unit stride sxu of 0 (every unit reads the same rows of x)
// takes the dense kernel, any other the per-unit kernel.  Returns a
// cudaError_t as int (0 on success).
extern "C" int unit_affine_launch(const void* x, const void* w, const void* b,
                                  void* y, int B, int U, int DIN, int DOUT,
                                  long long sxb, long long sxu, long long sxk,
                                  long long swu, long long swk, long long swn,
                                  int activate, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_forward<float>(x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk,
                                   swu, swk, swn, activate, s);
  if (dtype == 1)
    return dispatch_forward<__nv_bfloat16>(x, w, b, y, B, U, DIN, DOUT, sxb,
                                           sxu, sxk, swu, swk, swn, activate,
                                           s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx [B, DIN] (dy's dtype) from dy [B, U, DOUT] and w [U, DIN, DOUT] (any
// strides); part is f32 scratch of unit_affine_dx_chunks(U) * B * DIN.
extern "C" int unit_affine_dx_launch(const void* dy, const void* w,
                                     void* part, void* dx, int B, int U,
                                     int DIN, int DOUT, long long sdb,
                                     long long sdu, long long sdn,
                                     long long swu, long long swk,
                                     long long swn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_dx<float>(dy, w, p, dx, B, U, DIN, DOUT, sdb, sdu, sdn,
                              swu, swk, swn, s);
  if (dtype == 1)
    return dispatch_dx<__nv_bfloat16>(dy, w, p, dx, B, U, DIN, DOUT, sdb, sdu,
                                      sdn, swu, swk, swn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Number of partials S of the dense dx reduction for U units.
extern "C" int unit_affine_dx_chunks(int U) { return (U + CHUNK - 1) / CHUNK; }

// The reference kernel (the oracle of the kernels above); the arguments of
// unit_affine_launch.
extern "C" int unit_affine_reference_launch(
    const void* x, const void* w, const void* b, void* y, int B, int U,
    int DIN, int DOUT, long long sxb, long long sxu, long long sxk,
    long long swu, long long swk, long long swn, int activate, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_reference<float>(x, w, b, y, B, U, DIN, DOUT, sxb, sxu,
                                     sxk, swu, swk, swn, activate, s);
  if (dtype == 1)
    return dispatch_reference<__nv_bfloat16>(x, w, b, y, B, U, DIN, DOUT, sxb,
                                             sxu, sxk, swu, swk, swn, activate,
                                             s);
  return static_cast<int>(cudaErrorInvalidValue);
}
