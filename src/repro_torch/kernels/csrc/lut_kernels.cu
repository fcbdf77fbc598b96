// Hand-written Hopper (sm_90a) kernels for folded L-LUT inference.
//
// Three kernels, each the counterpart of one Pallas TPU kernel of the JAX
// package, computing the same function in integer arithmetic only:
//
//   K1 cascade_resident_kernel  <- repro/kernels/lut_cascade.py
//                                  lut_cascade_pallas(mode="resident"),
//                                  _resident_kernel
//   K2 cascade_streamed_kernel  <- repro/kernels/lut_cascade.py
//                                  lut_cascade_pallas(mode="streamed"),
//                                  _streamed_kernel / _phase_layout
//   K3 lut_lookup_kernel        <- repro/kernels/lut_gather.py
//                                  lut_lookup_pallas, _lut_kernel
//
// What bounds them on this card: a lookup does no arithmetic worth the
// name (an address is a few shifts and adds, the lookup one load), so the
// floor is the bytes moved: input codes read once, output codes written
// once, tables and maps read once (bytes / 3.35 TB/s).  What the TPU did
// with a one-hot matmul on the MXU is here an indexed load from shared
// memory, `tab[u][addr]`, which is exact by construction.  No float
// product appears anywhere: an f32 product may run in TF32 on Hopper,
// which would break the reference's 2^24 exactness argument.
//
// Address: addr = sum_f code[map[u,f]] << (bits*(F-1-f)), the first input
// in the most significant bits (quant.pack_address).  Duplicate fan-in
// indices are legal.  Tables are stored signed (int8/int16/int32) holding
// unsigned codes and are widened to int32 before use.
//
// Every kernel launches on the caller's stream, allocates nothing and does
// not synchronise; each C entry point returns cudaGetLastError() (or the
// error of cudaFuncSetAttribute) so the Python wrapper can raise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

// Per-layer descriptor, kDescInts int32 each (built by lut_cascade.py).
constexpr int kDescInts = 8;
constexpr int D_UNITS = 0;
constexpr int D_ENTRIES = 1;
constexpr int D_ROW_OFF = 2;
constexpr int D_FAN_IN = 3;
constexpr int D_BITS = 4;
constexpr int D_ASSEMBLE = 5;
constexpr int D_MAP_OFF = 6;

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// Block-wide copy of n bytes, 16 bytes a thread where possible.  Both
// pointers are 16-byte aligned (the wrapper checks the global one).
__device__ inline void copy_bytes(unsigned char* dst, const unsigned char* src,
                                  size_t n) {
  const size_t n16 = n / 16;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  for (size_t i = threadIdx.x; i < n16; i += blockDim.x) d4[i] = s4[i];
  for (size_t i = n16 * 16 + threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// Rows [b0, b0+rows) of the int32 input codes into the activation tile.
template <typename ActT>
__device__ inline void load_codes(ActT* h, const int32_t* __restrict__ codes,
                                  int b0, int rows, int w0, int a_dim) {
  const int n = rows * w0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / w0;
    const int c = i - r * w0;
    h[static_cast<size_t>(r) * a_dim + c] =
        static_cast<ActT>(codes[static_cast<size_t>(b0 + r) * w0 + c]);
  }
}

// Address of unit u of a layer from one activation row.  `src` is the
// layer's fan-in list for this unit (nullptr for assemble layers, whose
// unit u reads the contiguous slice [u*F, (u+1)*F)).
template <typename ActT>
__device__ inline int form_address(const ActT* hr, const int32_t* src, int u,
                                   int fan_in, int bits) {
  int a = 0;
  if (src == nullptr) {
    const ActT* p = hr + u * fan_in;
    for (int f = 0; f < fan_in; ++f) a = (a << bits) + static_cast<int>(p[f]);
  } else {
    for (int f = 0; f < fan_in; ++f) a = (a << bits) + static_cast<int>(hr[src[f]]);
  }
  return a;
}

// ---------------------------------------------------------------------------
// K3: one layer's lookup, out[b,u] = table[u, addr[b,u]].
// Grid (unit tiles, batch tiles).  The unit tile's table rows are staged in
// shared memory when they fit (`staged`), else read through the cache.
// Consecutive threads take consecutive units of one row, so the addr and
// out accesses coalesce.  An address outside [0, T) is clamped, as a JAX
// gather clamps.
// ---------------------------------------------------------------------------
__global__ void lut_lookup_kernel(const int32_t* __restrict__ table,
                                  const int32_t* __restrict__ addr,
                                  int32_t* __restrict__ out, int B, int U,
                                  int T, int unit_tile, int block_b,
                                  int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int u0 = blockIdx.x * unit_tile;
  const int b0 = blockIdx.y * block_b;
  const int ut = min(unit_tile, U - u0);
  const int rows = min(block_b, B - b0);
  const int32_t* rows_src = table + static_cast<size_t>(u0) * T;
  const int32_t* tab = rows_src;
  if (staged) {
    int32_t* s_tab = reinterpret_cast<int32_t*>(smem);
    const int n = ut * T;
    for (int i = threadIdx.x; i < n; i += blockDim.x) s_tab[i] = rows_src[i];
    __syncthreads();
    tab = s_tab;
  }
  const int items = rows * ut;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int r = i / ut;
    const int u = i - r * ut;
    const size_t g = static_cast<size_t>(b0 + r) * U + u0 + u;
    const int a = min(max(addr[g], 0), T - 1);
    out[g] = tab[static_cast<size_t>(u) * T + a];
  }
}

// ---------------------------------------------------------------------------
// K1: the whole cascade with every table resident in shared memory.
// One CTA per batch tile of block_b rows.  At entry the CTA copies the
// packed tables [sum U, max_entries] (narrow dtype) and all mapping-layer
// maps into shared memory, then walks the layers with two activation
// tiles h / h_next of block_b x a_dim codes (uint8 or uint16), one barrier
// per layer.  The final layer writes int32 codes straight to `out`.
// ---------------------------------------------------------------------------
template <typename TabT, typename ActT>
__global__ void cascade_resident_kernel(
    const int32_t* __restrict__ codes, const TabT* __restrict__ tables,
    const int32_t* __restrict__ maps, const int32_t* __restrict__ desc,
    int n_layers, int B, int w0, int max_entries, int a_dim,
    long long tables_elems, long long maps_words, int block_b,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tab_bytes = align16(static_cast<size_t>(tables_elems) * sizeof(TabT));
  const size_t map_bytes = align16(static_cast<size_t>(maps_words) * 4);
  const size_t act_bytes = align16(static_cast<size_t>(block_b) * a_dim * sizeof(ActT));
  TabT* s_tab = reinterpret_cast<TabT*>(smem);
  int32_t* s_map = reinterpret_cast<int32_t*>(smem + tab_bytes);
  ActT* h = reinterpret_cast<ActT*>(smem + tab_bytes + map_bytes);
  ActT* hn = reinterpret_cast<ActT*>(smem + tab_bytes + map_bytes + act_bytes);

  const int b0 = blockIdx.x * block_b;
  const int rows = min(block_b, B - b0);
  copy_bytes(smem, reinterpret_cast<const unsigned char*>(tables),
             static_cast<size_t>(tables_elems) * sizeof(TabT));
  copy_bytes(reinterpret_cast<unsigned char*>(s_map),
             reinterpret_cast<const unsigned char*>(maps),
             static_cast<size_t>(maps_words) * 4);
  load_codes(h, codes, b0, rows, w0, a_dim);
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    const int32_t* d = desc + l * kDescInts;
    const int units = d[D_UNITS];
    const int entries = d[D_ENTRIES];
    const int row_off = d[D_ROW_OFF];
    const int fan_in = d[D_FAN_IN];
    const int bits = d[D_BITS];
    const bool assemble = d[D_ASSEMBLE] != 0;
    const int map_off = d[D_MAP_OFF];
    const bool last = l == n_layers - 1;
    const int items = rows * units;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int r = i / units;
      const int u = i - r * units;
      const int32_t* src = assemble ? nullptr : s_map + map_off + u * fan_in;
      int a = form_address(h + static_cast<size_t>(r) * a_dim, src, u, fan_in, bits);
      a = min(a, entries - 1);
      const int v = static_cast<int>(
          s_tab[static_cast<size_t>(row_off + u) * max_entries + a]);
      if (last) {
        out[static_cast<size_t>(b0 + r) * units + u] = v;
      } else {
        hn[static_cast<size_t>(r) * a_dim + u] = static_cast<ActT>(v);
      }
    }
    __syncthreads();
    ActT* t = h;
    h = hn;
    hn = t;
  }
}

// ---------------------------------------------------------------------------
// K2: the whole cascade with tables streamed tile by tile.
// A GPU grid has no sequential axis, so one CTA per batch tile loops over
// the phases of _phase_layout itself: a phase is one (layer, unit tile of
// unit_tile units).  Each phase stages its table tile [ut, entries] and its
// map tile [ut, F] in shared memory; h / h_next stay in shared memory for
// the whole cascade.  Plain staged loads: no cp.async/TMA double buffering
// yet.
// ---------------------------------------------------------------------------
template <typename TabT, typename ActT>
__global__ void cascade_streamed_kernel(
    const int32_t* __restrict__ codes, const TabT* __restrict__ tables,
    const int32_t* __restrict__ maps, const int32_t* __restrict__ desc,
    int n_layers, int B, int w0, int max_entries, int a_dim, int unit_tile,
    int max_fan, int block_b, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tab_bytes = align16(static_cast<size_t>(unit_tile) * max_entries * sizeof(TabT));
  const size_t map_bytes = align16(static_cast<size_t>(unit_tile) * max_fan * 4);
  const size_t act_bytes = align16(static_cast<size_t>(block_b) * a_dim * sizeof(ActT));
  TabT* s_tab = reinterpret_cast<TabT*>(smem);
  int32_t* s_map = reinterpret_cast<int32_t*>(smem + tab_bytes);
  ActT* h = reinterpret_cast<ActT*>(smem + tab_bytes + map_bytes);
  ActT* hn = reinterpret_cast<ActT*>(smem + tab_bytes + map_bytes + act_bytes);

  const int b0 = blockIdx.x * block_b;
  const int rows = min(block_b, B - b0);
  load_codes(h, codes, b0, rows, w0, a_dim);

  for (int l = 0; l < n_layers; ++l) {
    const int32_t* d = desc + l * kDescInts;
    const int units = d[D_UNITS];
    const int entries = d[D_ENTRIES];
    const int row_off = d[D_ROW_OFF];
    const int fan_in = d[D_FAN_IN];
    const int bits = d[D_BITS];
    const bool assemble = d[D_ASSEMBLE] != 0;
    const int map_off = d[D_MAP_OFF];
    const bool last = l == n_layers - 1;
    for (int c0 = 0; c0 < units; c0 += unit_tile) {
      const int ut = min(unit_tile, units - c0);
      __syncthreads();  // previous phase done with the tiles (and h loaded)
      const int nt = ut * entries;
      for (int i = threadIdx.x; i < nt; i += blockDim.x) {
        const int u = i / entries;
        const int e = i - u * entries;
        s_tab[i] = tables[static_cast<size_t>(row_off + c0 + u) * max_entries + e];
      }
      if (!assemble) {
        const int nm = ut * fan_in;
        const int32_t* msrc = maps + map_off + c0 * fan_in;
        for (int i = threadIdx.x; i < nm; i += blockDim.x) s_map[i] = msrc[i];
      }
      __syncthreads();
      const int items = rows * ut;
      for (int i = threadIdx.x; i < items; i += blockDim.x) {
        const int r = i / ut;
        const int u = i - r * ut;
        const int32_t* src = assemble ? nullptr : s_map + u * fan_in;
        int a = form_address(h + static_cast<size_t>(r) * a_dim, src, c0 + u,
                             fan_in, bits);
        a = min(a, entries - 1);
        const int v = static_cast<int>(s_tab[static_cast<size_t>(u) * entries + a]);
        if (last) {
          out[static_cast<size_t>(b0 + r) * units + c0 + u] = v;
        } else {
          hn[static_cast<size_t>(r) * a_dim + c0 + u] = static_cast<ActT>(v);
        }
      }
    }
    __syncthreads();  // layer complete: its output becomes the next input
    ActT* t = h;
    h = hn;
    hn = t;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename TabT, typename ActT>
cudaError_t launch_resident(const void* codes, const void* tables,
                            const void* maps, const void* desc, int n_layers,
                            int B, int w0, int max_entries, int a_dim,
                            long long tables_elems, long long maps_words,
                            int block_b, void* out, cudaStream_t stream) {
  const size_t smem = align16(static_cast<size_t>(tables_elems) * sizeof(TabT)) +
                      align16(static_cast<size_t>(maps_words) * 4) +
                      2 * align16(static_cast<size_t>(block_b) * a_dim * sizeof(ActT));
  auto kernel = cascade_resident_kernel<TabT, ActT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + block_b - 1) / block_b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const TabT*>(tables),
      static_cast<const int32_t*>(maps), static_cast<const int32_t*>(desc),
      n_layers, B, w0, max_entries, a_dim, tables_elems, maps_words, block_b,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

template <typename TabT, typename ActT>
cudaError_t launch_streamed(const void* codes, const void* tables,
                            const void* maps, const void* desc, int n_layers,
                            int B, int w0, int max_entries, int a_dim,
                            int unit_tile, int max_fan, int block_b, void* out,
                            cudaStream_t stream) {
  const size_t smem = align16(static_cast<size_t>(unit_tile) * max_entries * sizeof(TabT)) +
                      align16(static_cast<size_t>(unit_tile) * max_fan * 4) +
                      2 * align16(static_cast<size_t>(block_b) * a_dim * sizeof(ActT));
  auto kernel = cascade_streamed_kernel<TabT, ActT>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((B + block_b - 1) / block_b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const TabT*>(tables),
      static_cast<const int32_t*>(maps), static_cast<const int32_t*>(desc),
      n_layers, B, w0, max_entries, a_dim, unit_tile, max_fan, block_b,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// Dispatch a templated launcher over (table itemsize, activation itemsize).
#define LUT_CALL(LAUNCH, T, A, ...) return static_cast<int>(LAUNCH<T, A>(__VA_ARGS__))
#define LUT_DISPATCH(LAUNCH, TSIZE, ASIZE, ...)                                   \
  do {                                                                            \
    if ((TSIZE) == 1 && (ASIZE) == 1) LUT_CALL(LAUNCH, int8_t, uint8_t, __VA_ARGS__);   \
    if ((TSIZE) == 1 && (ASIZE) == 2) LUT_CALL(LAUNCH, int8_t, uint16_t, __VA_ARGS__);  \
    if ((TSIZE) == 1 && (ASIZE) == 4) LUT_CALL(LAUNCH, int8_t, uint32_t, __VA_ARGS__);  \
    if ((TSIZE) == 2 && (ASIZE) == 1) LUT_CALL(LAUNCH, int16_t, uint8_t, __VA_ARGS__);  \
    if ((TSIZE) == 2 && (ASIZE) == 2) LUT_CALL(LAUNCH, int16_t, uint16_t, __VA_ARGS__); \
    if ((TSIZE) == 2 && (ASIZE) == 4) LUT_CALL(LAUNCH, int16_t, uint32_t, __VA_ARGS__); \
    if ((TSIZE) == 4 && (ASIZE) == 1) LUT_CALL(LAUNCH, int32_t, uint8_t, __VA_ARGS__);  \
    if ((TSIZE) == 4 && (ASIZE) == 2) LUT_CALL(LAUNCH, int32_t, uint16_t, __VA_ARGS__); \
    if ((TSIZE) == 4 && (ASIZE) == 4) LUT_CALL(LAUNCH, int32_t, uint32_t, __VA_ARGS__); \
    return static_cast<int>(cudaErrorInvalidValue);                               \
  } while (0)

extern "C" {

int lut_lookup_launch(const void* table, const void* addr, void* out, int B,
                      int U, int T, int unit_tile, int block_b, int staged,
                      void* stream) {
  const size_t smem = staged ? static_cast<size_t>(unit_tile) * T * 4 : 0;
  cudaError_t err = allow_smem(lut_lookup_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((U + unit_tile - 1) / unit_tile, (B + block_b - 1) / block_b);
  lut_lookup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(addr),
      static_cast<int32_t*>(out), B, U, T, unit_tile, block_b, staged);
  return static_cast<int>(cudaGetLastError());
}

int lut_cascade_resident_launch(const void* codes, const void* tables,
                                int table_itemsize, const void* maps,
                                const void* desc, int n_layers, int B, int w0,
                                int max_entries, int a_dim, int act_itemsize,
                                long long tables_elems, long long maps_words,
                                int block_b, void* out, void* stream) {
  LUT_DISPATCH(launch_resident, table_itemsize, act_itemsize,
               codes, tables, maps, desc, n_layers, B, w0, max_entries, a_dim,
               tables_elems, maps_words, block_b, out,
               static_cast<cudaStream_t>(stream));
}

int lut_cascade_streamed_launch(const void* codes, const void* tables,
                                int table_itemsize, const void* maps,
                                const void* desc, int n_layers, int B, int w0,
                                int max_entries, int a_dim, int act_itemsize,
                                int unit_tile, int max_fan, int block_b,
                                void* out, void* stream) {
  LUT_DISPATCH(launch_streamed, table_itemsize, act_itemsize,
               codes, tables, maps, desc, n_layers, B, w0, max_entries, a_dim,
               unit_tile, max_fan, block_b, out,
               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
