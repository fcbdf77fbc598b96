// Hand-written Hopper (sm_90a) kernel for blockwise online-softmax
// attention on bf16 tiles: TMA loads, wgmma products, warp specialisation.
//
//   K5 flash_attention_wgmma_kernel  <- repro/kernels/flash_attention.py
//                                       flash_attention_pallas, _flash_kernel
//
// It computes what flash_attention_kernel (flash_attention.cu) computes,
// for bf16 q/k/v with D in {64, 128, 256} whose bases are 16 B aligned
// and whose strides on the first three axes are multiples of 16 B (the
// route in kernels/flash_attention.py sends everything else there):
//
//   o[b, h, i, :] = softmax_j(mask(q[b,h,i,:] . k[b,h/G,j,:] * scale)) v[b,h/G,j,:]
//   q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] (D contiguous), G = Hq / Hkv,
//   scale = D^-0.5 applied after the product; o [B, Hq, Sq, D] contiguous
//   bf16.  mask = k_pos < Skv, & k_pos <= q_pos when causal, & k_pos >
//   q_pos - window when window > 0, with q_pos = i + q_offset and k_pos = j.
//   A row whose keys are all masked gives 0.
//
// What bounds it on this card: gemma-2b's prefill (Hq 8, D 256, causal
// S 1024) needs 4*Hq*D*S(S+1)/2 = 4.3 GFLOP against 9.4 MB moved, so it is
// bound by operations, at the bf16 tensor cores' 989 TFLOP/s.
//
// Numbers.  The Pallas kernel upcasts to f32 and does both products in f32.
// Here QK^T runs on wgmma with bf16 operands and an f32 accumulator: a
// product of two bf16 values is exact in f32, so only the order of the f32
// sums differs.  PV needs p in bf16, and rounding p once would cost about
// 2^-9 * sum(p |v|) -- several bf16 ulps of an output near cancellation.
// So p goes in as two bf16 terms, p_hi = bf16(p) and p_lo = bf16(p - p_hi),
// through two wgmmas into one f32 accumulator: about 16 bits of p, while v
// is exact in bf16.  That is 1.5x the tensor-core work of the function.
// The softmax uses exp2f with log2(e) folded into the scale, and divides by
// max(l, 1e-30) once at the end; the output is rounded to bf16 once.
//
// Design.  One CTA per (q head, q tile of BQ = 64 rows, batch row), with
// the heavy causal tiles launched first: 128 CTAs for gemma-2b's 1024-token
// prefill on 132 SMs.  One consumer warpgroup owns the 64 q rows; one
// producer warp, of which one thread issues every TMA load: the Q tile
// once, then K and V tiles of BK = 64 keys into a ring of STAGES = 3
// stages, each guarded by a "full" mbarrier (transaction bytes) and an
// "empty" one (every consumer thread arrives when its wgmmas on the stage
// have retired).  A row of D bf16 is D * 2 bytes, so each tile is loaded as
// D / 64 column blocks of 64 elements (128 B) with the 128 B swizzle that
// the wgmma shared-memory descriptors read.  Per KV tile i the consumer
// issues S_i = Q K_i^T (D / 16 wgmma m64n64k16, Q and K K-major in shared
// memory) and, behind it on the tensor cores, the previous tile's
// O += p_{i-1} V_{i-1} (4 k-steps x {p_hi, p_lo} wgmma m64nDk16 with p from
// registers and V read MN-major from shared memory).  It waits for S_i
// only, and does tile i's softmax while that PV runs: masks only where the
// causal, window or Skv edge crosses the tile, takes the row max and sum
// over the four threads of a quad, and exponentiates.  Then it waits for
// the PV, releases that stage, rescales O by alpha (skipped where no row
// of a warp moved its max) and splits p_i into p_hi / p_lo A-fragments
// (the accumulator layout of S is the A-fragment layout of PV).  O sees the
// same sequence of rescales and sums as in a loop without the overlap, so
// the overlap changes no bit; without it QK^T, the softmax and PV would run
// one after another, with the tensor cores idle through the softmax
// (benchmarks/torch_k5_phases.py times the phases of one tile).
// KV tiles masked for the whole q tile are never loaded, as in the SIMT
// kernel; that changes no number (p = 0, alpha = 1).  Ragged Sq and Skv
// come in as zeros from TMA's out-of-bounds fill and are masked here.  The
// epilogue divides O by l in f32, rounds once to bf16 and stores two
// values a thread at a time to the contiguous output.
//
// ptxas -v (sm_90a, CUDA 12.8), p split: 218 registers at D 256, 154 at
// D 128, 122 at D 64; no spills, and no wgmma serialised (no C7515 /
// C7520 notes: the role branch and tile 0's peeling below are what keep
// them away).  Shared memory (dynamic) at D 256: 230,456 B of the 232,448
// a block may have.
//
// Tensor maps are encoded on the host per call, because the strides differ
// from call to call, and passed as __grid_constant__ parameters.
// cuTensorMapEncodeTiled is taken from the driver through the runtime's
// cudaGetDriverEntryPoint(ByVersion), so the source needs no -lcuda.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the C entry point returns cudaGetLastError(), or a
// negative code when the tensor maps cannot be made (-1: no driver entry
// point, -2 - CUresult: the encoding was refused).

#include <cuda.h>            // CUtensorMap and its enums (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                  // q rows per CTA: one warpgroup
constexpr int BK = 64;                  // keys per KV tile
constexpr int STAGES = 3;               // K/V ring depth
constexpr int THREADS = 128 + 32;       // consumer warpgroup + producer warp
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers and TMA -------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of parity `parity` has completed.  No wait of a
// working pipeline lasts a second, so one that lasts 4 s traps: the launch
// then fails with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 4000000000ull) __trap();
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing `bytes` on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptor, 128 B swizzle: start address, leading
// and stride byte offsets in 16 B units.  K-major tiles (Q, K): LBO unused,
// SBO = 1024 B between 8-row groups.  MN-major (V): LBO = the stride between
// 64-element column blocks, SBO = 1024 B between 8-key groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across this point.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D[64 x 64] = A[64 x 16] B[16 x 64] (+ D when scale_d); A and B K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers, B MN-major in
// shared memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]; A in registers, B MN-major in
// shared memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]; A in registers, B MN-major in
// shared memory (imm-trans-b = 1).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
struct Tiles {
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;            // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // 1024 B of slack to align the swizzled tiles, then Q, the ring and the
  // mbarriers (q, full[STAGES], empty[STAGES]): 230,456 B at D 256
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

// O += p V for one KV tile: 4 k-steps of 16 keys, each on p_hi and (with
// SPLIT) on p_lo; V is MN-major, so k-step kc starts 16 rows further on.
template <int D, bool SPLIT>
__device__ __forceinline__ void pv_wgmma(float (&acc)[D / 2],
                                         uint32_t (&ph)[4][4],
                                         uint32_t (&pl)[4][4], uint32_t v_s) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint64_t dv = sw128_desc(v_s + kc * 16 * 128, BK * 128, 1024);
    wgmma_rs(acc, ph[kc], dv);
    if constexpr (SPLIT) wgmma_rs(acc, pl[kc], dv);
  }
}

// S = Q K^T over D in steps of 16 (32 B inside a 128 B swizzle row); the
// first step overwrites S.  Issued, not waited for.
template <int D>
__device__ __forceinline__ void qk_wgmma(float (&sc)[32], uint32_t q_s,
                                         uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_m64n64k16(
        sc, sw128_desc(q_s + (kk / 4) * BQ * 128 + off, 16, 1024),
        sw128_desc(k_s + (kk / 4) * BK * 128 + off, 16, 1024), kk > 0);
  }
}

// The running state of this thread's two rows (row0 and row0 + 8).
struct Rows {
  float m0, m1;                         // row max, log2 domain
  float l0, l1;                         // this thread's part of the row sum
};

// One KV tile's online softmax on S in place: scale (log2 domain), mask
// where the causal, window or Skv edge crosses the tile, row max over the
// quad, p = exp2(s - max), row sums.  Returns the rescale factors of O.
__device__ __forceinline__ float2 softmax_tile(float (&sc)[32], Rows& st,
                                               int k0, int row0, int t,
                                               bool inside, int Skv,
                                               int causal, int window,
                                               int q_offset,
                                               float scale_log2) {
  float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    float x = sc[j] * scale_log2;
    if (!inside) {
      const int kp = k0 + 8 * (j / 4) + 2 * t + (j & 1);
      const int qp = row0 + ((j & 2) ? 8 : 0) + q_offset;
      bool ok = kp < Skv;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      x = ok ? x : NEG_INF;
    }
    sc[j] = x;
    if (j & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(st.m0, mx0), mn1 = fmaxf(st.m1, mx1);
  // a row with no key yet keeps p = 0 (exp2(-1e30 - 0) = 0)
  const float mu0 = mn0 == NEG_INF ? 0.0f : mn0;
  const float mu1 = mn1 == NEG_INF ? 0.0f : mn1;
  const float2 alpha = make_float2(exp2f(st.m0 - mu0), exp2f(st.m1 - mu1));
  st.m0 = mn0;
  st.m1 = mn1;
  float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float p = exp2f(sc[j] - ((j & 2) ? mu1 : mu0));
    sc[j] = p;
    if (j & 2) rs1 += p; else rs0 += p;
  }
  st.l0 = st.l0 * alpha.x + rs0;
  st.l1 = st.l1 * alpha.y + rs1;
  return alpha;
}

// O *= alpha, row by row.
template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2], float2 alpha) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= alpha.x;
    acc[4 * j + 1] *= alpha.x;
    acc[4 * j + 2] *= alpha.y;
    acc[4 * j + 3] *= alpha.y;
  }
}

// p = p_hi + p_lo as A-fragments: k-step kc (keys 16kc .. 16kc+15) takes
// S's n8 chunks 2kc and 2kc+1, register r = p[8kc + 2r, +1].
__device__ __forceinline__ void split_p(const float (&sc)[32],
                                        uint32_t (&ph)[4][4],
                                        uint32_t (&pl)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = sc[8 * kc + 2 * r], x1 = sc[8 * kc + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(hi);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      ph[kc][r] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[kc][r] = *reinterpret_cast<const uint32_t*>(&lo);
    }
  }
}

// SPLIT = false rounds p to bf16 once: a measurement of what the split
// buys, not a path of the model.
template <int D, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                             int Sq, int Skv, int causal, int window,
                             int q_offset, float scale_log2) {
  using T = Tiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                             // [D/64][BQ][64]
  const uint32_t ring = base + T::Q_BYTES;               // K, V per stage
  const uint32_t q_bar = base + T::BAR_OFF;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;             // heavy tiles first
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;

  // KV tiles this q tile can see (the rest are masked for every row)
  const int q_last = min(q0 + BQ, Sq) - 1;
  int kv_hi = Skv;
  if (causal) kv_hi = min(kv_hi, q_last + q_offset + 1);
  int kv_lo = 0;
  if (window > 0) kv_lo = max(0, q0 + q_offset - window + 1) / BK * BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role comes through a shuffle, so the compiler sees it uniform
  // across each warp: branching on threadIdx.x itself makes ptxas serialise
  // every wgmma of the consumer (C7520)
  if (__shfl_sync(0xffffffffu, threadIdx.x / 128, 0) == 1) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == 128) {
      mbar_expect_tx(q_bar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load(q_s + c * BQ * 128, &tq, q_bar, c * 64, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES)                 // wait for use i / STAGES - 1
          mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint32_t k_s = ring + s * 2 * T::KV_BYTES;
        const uint32_t v_s = k_s + T::KV_BYTES;
        const int k0 = kv_lo + i * BK;
        mbar_expect_tx(full_bar + 8 * s, 2 * T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          tma_load(k_s + c * BK * 128, &tk, full_bar + 8 * s, c * 64, k0, hk,
                   b);
          tma_load(v_s + c * BK * 128, &tv, full_bar + 8 * s, c * 64, k0, hk,
                   b);
        }
      }
    }
  } else {
    // ---- consumer warpgroup: q rows q0 .. q0 + 63 ----
    const int tid = threadIdx.x;
    const int g = (tid % 32) / 4;        // row within the warp's 8-row half
    const int t = tid % 4;               // column pair within an n8 chunk
    const int row0 = q0 + (tid / 32) * 16 + g;             // and row0 + 8
    const int q_first = q0 + q_offset;                     // q positions
    const int q_final = q_first + BQ - 1;

    float acc[D / 2];                    // O: n8 chunk j at acc[4j .. 4j+3]
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    Rows st = {NEG_INF, NEG_INF, 0.0f, 0.0f};
    float sc[32];                        // S, then p, of the current tile
    uint32_t ph[4][4], pl[4][4];         // p of the tile whose PV is next
    // a tile lies inside every mask when no edge crosses it
    auto inside = [&](int k0) {
      return k0 + BK <= Skv && (!causal || k0 + BK - 1 <= q_first)
             && (window <= 0 || k0 > q_final - window);
    };
    auto k_stage = [&](int i) { return ring + (i % STAGES) * 2 * T::KV_BYTES; };

    mbar_wait(q_bar, 0);
    // Tile 0 on its own, so that every path through the loop below that
    // issues a PV also waits for it (otherwise ptxas serialises the wgmmas).
    if (n_tiles > 0) {
      mbar_wait(full_bar, 0);
      wgmma_fence();
      qk_wgmma<D>(sc, q_s, k_stage(0));
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      softmax_tile(sc, st, kv_lo, row0, t, inside(kv_lo), Skv, causal,
                   window, q_offset, scale_log2);
      split_p(sc, ph, pl);               // O is 0: no rescale
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int k0 = kv_lo + i * BK;
      mbar_wait(full_bar + 8 * (i % STAGES), (i / STAGES) & 1);
      // S_i, and behind it on the tensor cores the previous tile's PV
      wgmma_fence();
      qk_wgmma<D>(sc, q_s, k_stage(i));
      wgmma_commit();
      pv_wgmma<D, SPLIT>(acc, ph, pl, k_stage(i - 1) + T::KV_BYTES);
      wgmma_commit();
      wgmma_wait<1>();                   // S_i is done, the PV may still run
      pin(sc);
      const float2 alpha = softmax_tile(sc, st, k0, row0, t, inside(k0), Skv,
                                        causal, window, q_offset,
                                        scale_log2);
      wgmma_wait<0>();                   // the previous tile's PV is done
      pin(acc);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        pin(ph[kc]);
        pin(pl[kc]);
      }
      mbar_arrive(empty_bar + 8 * ((i - 1) % STAGES));
      rescale<D>(acc, alpha);
      split_p(sc, ph, pl);
    }
    if (n_tiles > 0) {                   // the last tile's PV
      wgmma_fence();
      pv_wgmma<D, SPLIT>(acc, ph, pl, k_stage(n_tiles - 1) + T::KV_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
    }

    // epilogue: O / max(l, 1e-30) in f32, rounded once, rows < Sq
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, off);
      st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, off);
    }
    const float den0 = fmaxf(st.l0, 1e-30f), den1 = fmaxf(st.l1, 1e-30f);
    const long long head = (static_cast<long long>(b) * Hq + h) * Sq;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + 8 * half;
      if (r >= Sq) continue;
      const float den = half ? den1 : den0;
      __nv_bfloat16* orow = o + (head + r) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * half] / den,
                                  acc[4 * j + 2 * half + 1] / den);
      }
    }
  }
}

// cuTensorMapEncodeTiled, taken from the driver once per process.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, H, S, D] tensor with element strides (sb, sh, ss) on its
// first three axes, read in boxes of [rows, 64] with the 128 B swizzle.
// Rows past S come in as zeros.  Returns 0 or a negative code.
int tensor_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D,
               long long sb, long long sh, long long ss, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -2 - static_cast<int>(res);
}

template <int D, bool SPLIT>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, const long long* st, int causal,
           int window, int q_offset, float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap tq, tk, tv;
  int err = tensor_map(&tq, q, B, Hq, Sq, D, st[0], st[1], st[2], BQ);
  if (err == 0)
    err = tensor_map(&tk, k, B, Hkv, Skv, D, st[3], st[4], st[5], BK);
  if (err == 0)
    err = tensor_map(&tv, v, B, Hkv, Skv, D, st[6], st[7], st[8], BK);
  if (err != 0) return err;
  // the attribute belongs to the current device, so it is set on every
  // launch (a cheap host call) rather than once per process
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D, SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(Hq, (Sq + BQ - 1) / BQ, B);
  flash_attention_wgmma_kernel<D, SPLIT>
      <<<grid, THREADS, T::SMEM, stream>>>(
          tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv,
          causal, window, q_offset, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, const long long* st,
             int causal, int window, int q_offset, float scale, int split_p,
             cudaStream_t stream) {
  if (split_p)
    return launch<D, true>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, causal,
                           window, q_offset, scale, stream);
  return launch<D, false>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, causal,
                          window, q_offset, scale, stream);
}

}  // namespace

// q, k, v, o: bf16 device pointers, 16 B aligned.  strides: q (b, h, s),
// k (b, h, s), v (b, h, s) in elements, each a positive multiple of 8
// (16 B); D is contiguous and one of 64, 128, 256.  window <= 0 means no
// window.  split_p: 1 runs PV on p_hi and p_lo, 0 on bf16(p) alone (a
// measurement of what the split buys, not a path of the model).  Returns
// a cudaError_t as int, or a negative code when the tensor maps cannot be
// made.
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, int B, int Hq,
    int Hkv, int Sq, int Skv, int D, long long sqb, long long sqh,
    long long sqs, long long skb, long long skh, long long sks,
    long long svb, long long svh, long long svs, int causal, int window,
    int q_offset, float scale, int split_p, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B > 65535
      || (Sq + BQ - 1) / BQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[9] = {sqb, sqh, sqs, skb, skh, sks, svb, svh, svs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_d<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, causal, window,
                        q_offset, scale, split_p, s);
  if (D == 128)
    return launch_d<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, causal,
                         window, q_offset, scale, split_p, s);
  if (D == 256)
    return launch_d<256>(q, k, v, o, B, Hq, Hkv, Sq, Skv, st, causal,
                         window, q_offset, scale, split_p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
