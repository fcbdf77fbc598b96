// Hand-written Hopper (sm_90a) kernel for one affine stage of many tiny
// per-unit MLPs (the sub-networks hidden inside the L-LUTs).
//
//   K4 unit_affine_kernel  <- repro/kernels/subnet_mlp.py
//                             unit_affine_pallas, _affine_kernel
//
//   y[b, u, :] = x[b, u, :] @ w[u] + bias[u]      (optional ReLU)
//   x [B, U, DIN] (any strides, a stride-0 unit axis included),
//   w [U, DIN, DOUT] (any strides: backward dx passes w^T as a view),
//   bias [U, DOUT] contiguous or absent, y [B, U, DOUT] contiguous.
//
// What bounds it on this card: at the paper's widths it is a batched GEMM
// with real depth (dense layer 0 of mnist: 2*256*2160*784*64 = 55.5 GFLOP
// against 0.58 GB moved), so the floor is f32 FMAs at 67 TFLOP/s outside the
// tensor cores.  The tensor cores are not used on purpose: an f32 product
// in TF32 or through wgmma changes results, and the toolflow needs one
// (unit, row) to give the same float at every batch size, so that a folded
// table equals the quantized model bit for bit on the card.
//
// Design.  One CTA per (unit, batch tile, dout tile).  The CTA stages a
// [KT x BM] slice of x (transposed, so a warp reads consecutive rows) and a
// [KT x BN] slice of w[u] in shared memory and each thread accumulates a
// TM x TN register tile with fmaf.  Every output element is summed by one
// thread over k = 0..DIN-1 in that order, starting from 0, whatever the
// tile shape, batch size or grid: the k-tiles only stage data, they never
// split the sum.  Bias and ReLU are applied in the epilogue.  Inputs are
// f32 or bf16; accumulation is always f32 and the output takes x's type.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry point returns cudaGetLastError() so the
// Python wrapper can raise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 16;   // k-slice staged per iteration

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
unit_affine_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ y,
                   int B, int U, int DIN, int DOUT, int col_tiles,
                   long long sxb, long long sxu, long long sxk,
                   long long swu, long long swk, long long swn,
                   int activate) {
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
int launch(const void* x, const void* w, const void* b, void* y, int B, int U,
           int DIN, int DOUT, long long sxb, long long sxu, long long sxk,
           long long swu, long long swk, long long swn, int activate,
           cudaStream_t stream) {
  const int col_tiles = (DOUT + BN - 1) / BN;
  const long long row_tiles = (B + BM - 1) / BM;
  dim3 grid(static_cast<unsigned>(row_tiles * col_tiles), static_cast<unsigned>(U));
  constexpr int threads = (BM / TM) * (BN / TN);
  unit_affine_kernel<T, BM, BN, TM, TN><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y), B, U, DIN, DOUT,
      col_tiles, sxb, sxu, sxk, swu, swk, swn, activate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, const void* b, void* y, int B,
             int U, int DIN, int DOUT, long long sxb, long long sxu,
             long long sxk, long long swu, long long swk, long long swn,
             int activate, cudaStream_t stream) {
  // Tile shape by the output width only (never by the batch): 64x64 tiles
  // for the hidden widths and backward dx, 128x16 for narrow outputs, one
  // row per thread for the scalar last affine.
  if (DOUT >= 48)
    return launch<T, 64, 64, 4, 4>(x, w, b, y, B, U, DIN, DOUT, sxb, sxu,
                                   sxk, swu, swk, swn, activate, stream);
  if (DOUT >= 2)
    return launch<T, 128, 16, 4, 2>(x, w, b, y, B, U, DIN, DOUT, sxb, sxu,
                                     sxk, swu, swk, swn, activate, stream);
  return launch<T, 256, 1, 1, 1>(x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk,
                                 swu, swk, swn, activate, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w, bias and y share it).  bias may
// be null.  Returns a cudaError_t as int (0 on success).
extern "C" int unit_affine_launch(const void* x, const void* w, const void* b,
                                  void* y, int B, int U, int DIN, int DOUT,
                                  long long sxb, long long sxu, long long sxk,
                                  long long swu, long long swk, long long swn,
                                  int activate, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk, swu,
                           swk, swn, activate, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, b, y, B, U, DIN, DOUT, sxb, sxu, sxk,
                                   swu, swk, swn, activate, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
