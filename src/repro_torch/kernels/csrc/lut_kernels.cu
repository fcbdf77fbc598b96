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
// once, tables and maps read once (bytes / 3.35 TB/s).  At the main path's
// shapes that floor is below a microsecond, so what they are held to in
// practice is latency: how many dependent global round trips a CTA waits
// for and how many CTAs share the card.  What the TPU did with a one-hot
// matmul on the MXU is here an indexed load, `tab[u][addr]`, which is
// exact by construction.  No float product appears anywhere: an f32
// product may run in TF32 on Hopper, which would break the reference's
// 2^24 exactness argument.
//
// Address: addr = sum_f code[map[u,f]] << (bits*(F-1-f)), the first input
// in the most significant bits (quant.pack_address).  Duplicate fan-in
// indices are legal.  Tables are stored signed (int8/int16/int32) holding
// unsigned codes and are widened to int32 before use.
//
// Every kernel launches on the caller's stream, allocates nothing and does
// not synchronise; each C entry point returns cudaGetLastError() (or the
// error of cudaFuncSetAttribute) so the Python wrapper can raise.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

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

constexpr int kGroup = 4;     // units per cascade work item (one pack store)

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// Block-wide asynchronous copy of n bytes into shared dst (16 B aligned):
// 16 bytes a thread over the body where src is 16-byte aligned, the rest
// 4 bytes a thread where src and n allow it, else plain byte copies (those
// are visible after the next __syncthreads like the others).
__device__ inline void async_copy(unsigned char* dst, const void* src,
                                  size_t n) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  size_t done = 0;
  if (a % 16 == 0) {
    done = n / 16 * 16;
    for (size_t i = threadIdx.x; i < n / 16; i += blockDim.x)
      cp_async16(dst + 16 * i, s + 16 * i);
  }
  if ((a + done) % 4 == 0 && (n - done) % 4 == 0) {
    for (size_t i = done / 4 + threadIdx.x; i < n / 4; i += blockDim.x)
      cp_async4(dst + 4 * i, s + 4 * i);
  } else {
    for (size_t i = done + threadIdx.x; i < n; i += blockDim.x) dst[i] = s[i];
  }
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

// kGroup codes as one store.
template <typename ActT> struct Pack;
template <> struct Pack<uint8_t> { using type = uint32_t; };
template <> struct Pack<uint16_t> { using type = uint2; };
template <> struct Pack<uint32_t> { using type = uint4; };

// The table values of the kGroup units k0 .. k0 + kGroup - 1 of a layer (of
// the n a CTA handles) for one activation row hr, side by side so that
// their loads are independent.  tab and map start at unit 0 of those n; an
// assemble layer's unit k reads the input columns [(col0 + k) * F, ...).  A
// unit past n repeats the last one (the caller does not store it).  An
// address past the layer's entries is clamped to the last entry.
template <typename TabT, typename InT>
__device__ inline void group_lookup(const InT* hr, const TabT* tab,
                                    const int32_t* map, int max_entries,
                                    int entries, int fan_in, int bits,
                                    bool assemble, int col0, int k0, int n,
                                    int (&val)[kGroup]) {
  int kk[kGroup], a[kGroup];
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    kk[j] = min(k0 + j, n - 1);
    a[j] = 0;
  }
  if (assemble) {
    for (int f = 0; f < fan_in; ++f) {
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        a[j] = (a[j] << bits) +
               static_cast<int>(hr[(col0 + kk[j]) * fan_in + f]);
    }
  } else {
    for (int f = 0; f < fan_in; ++f) {
      int src[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) src[j] = map[kk[j] * fan_in + f];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        a[j] = (a[j] << bits) + static_cast<int>(hr[src[j]]);
    }
  }
#pragma unroll
  for (int j = 0; j < kGroup; ++j)
    val[j] = static_cast<int>(
        tab[static_cast<size_t>(kk[j]) * max_entries + min(a[j], entries - 1)]);
}

// ---------------------------------------------------------------------------
// K3: one layer's lookup, out[b,u] = table[u, addr[b,u]], over the flat
// index i = b * U + u of the contiguous [B, U] arrays.
//
// The first kernel staged a 32-unit table tile in shared memory behind a
// __syncthreads and only then issued its addr -> table -> out chain; at
// nid's shapes it ran 16-32 CTAs, each three global round trips long.  Here
// there is no staging and no barrier: each thread owns kVec consecutive
// outputs (along U, wrapping to the next row), loads their addresses as one
// 16-byte vector, reads the kVec table entries through the read-only path
// (__ldg: a layer's table rows, 256 B a unit at 64 entries, stay in L1/L2)
// and stores the codes as one vector, so a launch is one addr load, one
// dependent table load and a store.  The wrapper sizes CTAs so that a
// layer's grid covers the SMs (lut_gather.tile_shape).  kVec is 1 where
// addr or out is not 16-byte aligned.  An address outside [0, T) is
// clamped, as a JAX gather clamps.
// ---------------------------------------------------------------------------
constexpr int kLookupMaxThreads = 256;

template <int kVec>
__global__ void __launch_bounds__(kLookupMaxThreads)
lut_lookup_kernel(const int32_t* __restrict__ table,
                  const int32_t* __restrict__ addr,
                  int32_t* __restrict__ out, long long n, int U, int T) {
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * kVec;
  if (i0 >= n) return;
  int u = i0 <= INT_MAX
              ? static_cast<int>(static_cast<unsigned>(i0) % static_cast<unsigned>(U))
              : static_cast<int>(i0 % U);
  if (kVec == 4 && i0 + 4 <= n) {
    const int4 a4 = __ldg(reinterpret_cast<const int4*>(addr + i0));
    const int a[4] = {a4.x, a4.y, a4.z, a4.w};
    int v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = __ldg(table + static_cast<size_t>(u) * T + min(max(a[j], 0), T - 1));
      u = u + 1 == U ? 0 : u + 1;
    }
    *reinterpret_cast<int4*>(out + i0) = make_int4(v[0], v[1], v[2], v[3]);
    return;
  }
  const long long end = i0 + kVec < n ? i0 + kVec : n;
  for (long long i = i0; i < end; ++i) {
    out[i] = __ldg(table + static_cast<size_t>(u) * T +
                   min(max(__ldg(addr + i), 0), T - 1));
    u = u + 1 == U ? 0 : u + 1;
  }
}

// ---------------------------------------------------------------------------
// K1: the whole cascade with every table resident in shared memory.
//
// The first kernel ran one CTA per 64-row tile (16 CTAs for a 1024-row
// block on 132 SMs) and loaded each tile's int32 codes 4 bytes a thread
// with an integer divide per element: the code load, a few KB in flight
// per SM, was most of its 0.039 ms.  Now:
//
//   * Persistent CTAs, as many as the plan fits on the card (CTAs an SM
//     from shared memory, threads and registers, at most one per tile),
//     walk tiles blockIdx.x, += gridDim.x of `tile_rows` rows, a multiple
//     of 4, so that a tile's codes -- one contiguous span of tile_rows * w0
//     int32 words -- start 16-byte aligned whatever w0.
//   * At entry a CTA copies the packed tables [rows, max_entries] (narrow
//     dtype), every mapping layer's map and the layer descriptors into
//     shared memory by cp.async, in one group with its first tile's codes,
//     and keeps them.
//   * Codes arrive by 16-byte cp.async into one of two int32 stages: tile
//     t+1's copy is in flight while tile t's layers run.  Layer 0 reads its
//     fan-in codes from the stage itself (rows w0 words apart); its codes
//     and every later layer's go into two activation tiles (uint8/16/32)
//     whose rows are a_pad codes apart (an odd number of words for uint8).
//     A pass narrowing the stage into such a tile first, and one barrier
//     more, took 0.4 of 6.9 us on an H100 at nid's 1024-row block.
//   * Layers as in K2: a work item is kGroup units of one row, loaded side
//     by side; consecutive threads take consecutive rows, so that a warp's
//     map and table reads are broadcasts and its activation reads fall in
//     distinct banks.  One __syncthreads per layer.  The last layer's
//     items run along units, so that its int32 codes store coalesced.
// ---------------------------------------------------------------------------
constexpr int kResidentThreads = 256;

// One layer of K1 for the `rows` rows of a tile: fan-in codes from h (rows
// `pitch` codes apart), codes into hn (rows a_pad apart) or, for the last
// layer, to out.
template <typename TabT, typename InT, typename ActT>
__device__ inline void resident_layer(const int32_t* d, bool last,
                                      const TabT* s_tab, const int32_t* s_map,
                                      int max_entries, const InT* h, int pitch,
                                      ActT* hn, int a_pad, int rows, int b0,
                                      int32_t* __restrict__ out) {
  const int units = d[D_UNITS];
  const int entries = d[D_ENTRIES];
  const int fan_in = d[D_FAN_IN];
  const int bits = d[D_BITS];
  const bool assemble = d[D_ASSEMBLE] != 0;
  const TabT* tab = s_tab + static_cast<size_t>(d[D_ROW_OFF]) * max_entries;
  const int32_t* map = assemble ? nullptr : s_map + d[D_MAP_OFF];
  const int groups = (units + kGroup - 1) / kGroup;
  const int items = rows * groups;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    int r, grp;
    if (last) {                      // along units: coalesced stores
      r = i / groups;
      grp = i - r * groups;
    } else {                         // along rows: broadcast map reads
      grp = i / rows;
      r = i - grp * rows;
    }
    const int k0 = grp * kGroup;
    int val[kGroup];
    group_lookup(h + static_cast<size_t>(r) * pitch, tab, map, max_entries,
                 entries, fan_in, bits, assemble, 0, k0, units, val);
    if (last) {
      int32_t* o = out + static_cast<size_t>(b0 + r) * units + k0;
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        if (k0 + j < units) o[j] = val[j];
    } else {
      ActT v[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
        v[j] = static_cast<ActT>(k0 + j < units ? val[j] : 0);
      using P = typename Pack<ActT>::type;
      memcpy(hn + static_cast<size_t>(r) * a_pad + k0, v, sizeof(P));
    }
  }
}

template <typename TabT, typename ActT>
__global__ void __launch_bounds__(kResidentThreads)
cascade_resident_kernel(const int32_t* __restrict__ codes,
                        const TabT* __restrict__ tables,
                        const int32_t* __restrict__ maps,
                        const int32_t* __restrict__ desc, int n_layers, int B,
                        int w0, int max_entries, int a_pad,
                        long long tables_elems, long long maps_words,
                        int tile_rows, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const size_t tab_bytes = align16(static_cast<size_t>(tables_elems) * sizeof(TabT));
  const size_t map_bytes = align16(static_cast<size_t>(maps_words) * 4);
  const size_t desc_bytes = align16(static_cast<size_t>(n_layers) * kDescInts * 4);
  const size_t stage_bytes = align16(static_cast<size_t>(tile_rows) * w0 * 4);
  const size_t act_bytes =
      align16(static_cast<size_t>(tile_rows) * a_pad * sizeof(ActT));
  const TabT* s_tab = reinterpret_cast<const TabT*>(smem);
  const int32_t* s_map = reinterpret_cast<const int32_t*>(smem + tab_bytes);
  unsigned char* s_desc = smem + tab_bytes + map_bytes;
  // two code stages, then two activation tiles; stage / tile i is picked
  // by a select, not an indexed array (which would live in local memory)
  unsigned char* s_stage = s_desc + desc_bytes;
  ActT* h0 = reinterpret_cast<ActT*>(s_stage + 2 * stage_bytes);
  ActT* h1 = reinterpret_cast<ActT*>(s_stage + 2 * stage_bytes + act_bytes);
  const int n_tiles = (B + tile_rows - 1) / tile_rows;
  auto fetch = [&](int tile, int st) {
    const int b0 = tile * tile_rows;
    const int rows = min(tile_rows, B - b0);
    async_copy(s_stage + (st ? stage_bytes : 0),
               codes + static_cast<size_t>(b0) * w0,
               static_cast<size_t>(rows) * w0 * 4);
  };

  int tile = blockIdx.x;
  if (tile >= n_tiles) return;
  async_copy(smem, tables, static_cast<size_t>(tables_elems) * sizeof(TabT));
  async_copy(smem + tab_bytes, maps, static_cast<size_t>(maps_words) * 4);
  async_copy(s_desc, desc, static_cast<size_t>(n_layers) * kDescInts * 4);
  fetch(tile, 0);
  cp_async_commit();
  for (int k = 0; tile < n_tiles; tile += gridDim.x, ++k) {
    cp_async_wait_all();
    // this tile's codes (and the tables) everywhere; every thread is past
    // the last tile's layers, so the other stage and h are free
    __syncthreads();
    if (tile + static_cast<int>(gridDim.x) < n_tiles) {
      fetch(tile + gridDim.x, (k + 1) & 1);
      cp_async_commit();
    }
    const int b0 = tile * tile_rows;
    const int rows = min(tile_rows, B - b0);
    for (int l = 0; l < n_layers; ++l) {
      const int32_t* d = reinterpret_cast<const int32_t*>(s_desc) + l * kDescInts;
      const bool last = l == n_layers - 1;
      if (l == 0)
        resident_layer<TabT, int32_t, ActT>(
            d, last, s_tab, s_map, max_entries,
            reinterpret_cast<const int32_t*>(s_stage +
                                             ((k & 1) ? stage_bytes : 0)),
            w0, h0, a_pad, rows, b0, out);
      else
        resident_layer<TabT, ActT, ActT>(d, last, s_tab, s_map, max_entries,
                                         (l & 1) ? h0 : h1, a_pad,
                                         (l & 1) ? h1 : h0, a_pad, rows, b0,
                                         out);
      if (!last) __syncthreads();    // the layer's codes, for the next
    }
  }
}

// ---------------------------------------------------------------------------
// K2: the whole cascade for table sets beyond one block's shared memory,
// split over a thread-block cluster of C CTAs (launched with a cluster
// dimension, C <= 8).
//
// The TPU kernel walked (layer, unit tile) phases on a sequential grid
// axis, streaming each phase's table tile.  Here the C CTAs of a cluster
// share one batch tile of `rows` rows, and CTA c owns the units
// [c * share, min((c + 1) * share, units)) of every layer, share =
// ceil(units / C) rounded up to kGroup (the same split of the input
// columns loads the codes).  Each CTA holds a full copy of the activation
// tile h (and h_next) in its shared memory: it forms its units' addresses
// from its own copy, writes its codes into its own h_next, and then copies
// its columns of h_next into every other CTA's through distributed shared
// memory, along the rows (kGroup codes a store, a warp's stores
// contiguous).  One cluster barrier per layer makes the layer's codes
// visible everywhere and frees the buffers; there is no block barrier per
// unit tile.  Clusters are persistent: each walks batch tiles cluster_id,
// cluster_id + n_clusters, ... so that its tables are copied once, not
// once per tile.  The wrapper's plan picks C (4 where a CTA then holds its
// share and 16 rows, else 8) and the rows a tile.
//
// Two routes, chosen by the wrapper from the shapes (not a fallback):
//   * resident (kRing false): the CTA's share of every layer's tables and
//     maps is copied into shared memory once, by cp.async, while the first
//     tile's codes are loaded, and stays for the whole kernel;
//   * ring (kRing true), where that share does not fit: the share streams
//     through two stages of `ring_units` units (the plan's unit_tile, as a
//     copy granule): the next granule's cp.async is in flight while the
//     current one's lookups run.
// ---------------------------------------------------------------------------
constexpr int kClusterThreads = 512;
// Units of a layer of n units that each CTA of a C-CTA cluster owns.
__host__ __device__ inline int cluster_share(int n, int cluster) {
  return ((n + cluster - 1) / cluster + kGroup - 1) / kGroup * kGroup;
}

// v into `local` (kGroup-aligned columns of an activation tile) of every
// CTA of the cluster (the input codes).
template <typename ActT>
__device__ inline void broadcast(cg::cluster_group& cluster, ActT* local,
                                 const ActT (&v)[kGroup], int C) {
  using P = typename Pack<ActT>::type;
  P w;
  memcpy(&w, v, sizeof(P));
  for (int r = 0; r < C; ++r)
    *cluster.map_shared_rank(reinterpret_cast<P*>(local), r) = w;
}

// The CTA's units lo + u0 .. lo + u0 + n - 1 of one layer for `rows` rows:
// tab and map start at unit lo + u0.  The last layer writes int32 codes to
// out; the others broadcast into h_next.
template <typename TabT, typename ActT>
__device__ inline void lookup_units(cg::cluster_group& cluster,
                                    const int32_t* d, bool last, int lo,
                                    int u0, int n, const TabT* tab,
                                    const int32_t* map, int max_entries,
                                    const ActT* h, ActT* hn, int a_pad,
                                    int rows, int b0, int C,
                                    int32_t* __restrict__ out) {
  const int units = d[D_UNITS];
  const int entries = d[D_ENTRIES];
  const int fan_in = d[D_FAN_IN];
  const int bits = d[D_BITS];
  const bool assemble = d[D_ASSEMBLE] != 0;
  // Lookups: consecutive threads take consecutive rows of one group of
  // units, so the map and table rows they read are the same (a broadcast)
  // and their activation rows are a_pad bytes apart, which the plan makes
  // an odd number of words for uint8 codes (no bank conflict).  Codes go
  // into this CTA's own h_next first; a second pass copies the CTA's
  // columns to its peers along the rows, so that a warp's remote stores
  // are contiguous (stores from a warp to 32 rows would each be a remote
  // transaction of their own).
  const int groups = (n + kGroup - 1) / kGroup;
  const int items = rows * groups;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int grp = i / rows;
    const int r = i - grp * rows;
    const int k0 = grp * kGroup;
    int val[kGroup];
    group_lookup(h + static_cast<size_t>(r) * a_pad, tab, map, max_entries,
                 entries, fan_in, bits, assemble, lo + u0, k0, n, val);
    ActT v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      v[j] = static_cast<ActT>(k0 + j < n ? val[j] : 0);
      if (last && k0 + j < n)
        out[static_cast<size_t>(b0 + r) * units + lo + u0 + k0 + j] = val[j];
    }
    if (!last) {
      using P = typename Pack<ActT>::type;
      memcpy(hn + static_cast<size_t>(r) * a_pad + lo + u0 + k0, v,
             sizeof(P));
    }
  }
  if (last || C == 1) return;
  __syncthreads();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int r = i / groups;
    using P = typename Pack<ActT>::type;
    P* src = reinterpret_cast<P*>(hn + static_cast<size_t>(r) * a_pad + lo +
                                  u0 + (i - r * groups) * kGroup);
    const P w = *src;
    for (int c = 1; c < C; ++c) {
      const int peer = rank + c < C ? rank + c : rank + c - C;
      *cluster.map_shared_rank(src, peer) = w;
    }
  }
}

template <typename TabT, typename ActT, bool kRing>
__global__ void __launch_bounds__(kClusterThreads)
cascade_streamed_kernel(const int32_t* __restrict__ codes,
                        const TabT* __restrict__ tables,
                        const int32_t* __restrict__ maps,
                        const int32_t* __restrict__ desc, int n_layers, int B,
                        int w0, int max_entries, int a_pad, int max_fan,
                        int tile_rows, int ring_units,
                        int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / C;
  const int n_tiles = (B + tile_rows - 1) / tile_rows;
  const size_t row_bytes = static_cast<size_t>(max_entries) * sizeof(TabT);

  // shared memory: [tables][maps] -- every layer's share (resident) or two
  // ring stages -- then the two activation tiles
  size_t tab_bytes = 0, map_bytes = 0;
  if (kRing) {
    tab_bytes = 2 * align16(static_cast<size_t>(ring_units) * row_bytes);
    map_bytes = 2 * align16(static_cast<size_t>(ring_units) * max_fan * 4);
  } else {
    for (int l = 0; l < n_layers; ++l) {
      const int32_t* d = desc + l * kDescInts;
      const int share = cluster_share(d[D_UNITS], C);
      tab_bytes += align16(static_cast<size_t>(share) * row_bytes);
      if (!d[D_ASSEMBLE])
        map_bytes += align16(static_cast<size_t>(share) * d[D_FAN_IN] * 4);
    }
  }
  unsigned char* s_tab = smem;
  unsigned char* s_map = smem + tab_bytes;
  const size_t act_bytes =
      align16(static_cast<size_t>(tile_rows) * a_pad * sizeof(ActT));
  ActT* hbuf[2] = {reinterpret_cast<ActT*>(s_map + map_bytes),
                   reinterpret_cast<ActT*>(s_map + map_bytes + act_bytes)};

  // the CTA's units of layer l: [lo, lo + n)
  auto owned = [&](int l, int& lo, int& n) {
    const int units = desc[l * kDescInts + D_UNITS];
    const int share = cluster_share(units, C);
    lo = rank * share;
    n = max(0, min(share, units - lo));
  };
  // ring granule g of layer l into stage st
  auto fetch = [&](int l, int g, int st) {
    const int32_t* d = desc + l * kDescInts;
    int lo, n;
    owned(l, lo, n);
    const int u = lo + g * ring_units;
    const int cnt = min(ring_units, n - g * ring_units);
    async_copy(s_tab + st * (tab_bytes / 2),
               tables + static_cast<size_t>(d[D_ROW_OFF] + u) * max_entries,
               static_cast<size_t>(cnt) * row_bytes);
    if (!d[D_ASSEMBLE])
      async_copy(s_map + st * (map_bytes / 2),
                 maps + d[D_MAP_OFF] + static_cast<size_t>(u) * d[D_FAN_IN],
                 static_cast<size_t>(cnt) * d[D_FAN_IN] * 4);
  };
  auto granules = [&](int l) {
    int lo, n;
    owned(l, lo, n);
    return (n + ring_units - 1) / ring_units;
  };

  if (!kRing) {                // the share of every layer, copied once
    size_t to = 0, mo = 0;
    for (int l = 0; l < n_layers; ++l) {
      const int32_t* d = desc + l * kDescInts;
      int lo, n;
      owned(l, lo, n);
      const int share = cluster_share(d[D_UNITS], C);
      async_copy(s_tab + to,
                 tables + static_cast<size_t>(d[D_ROW_OFF] + lo) * max_entries,
                 static_cast<size_t>(n) * row_bytes);
      to += align16(static_cast<size_t>(share) * row_bytes);
      if (!d[D_ASSEMBLE]) {
        async_copy(s_map + mo,
                   maps + d[D_MAP_OFF] + static_cast<size_t>(lo) * d[D_FAN_IN],
                   static_cast<size_t>(n) * d[D_FAN_IN] * 4);
        mo += align16(static_cast<size_t>(share) * d[D_FAN_IN] * 4);
      }
    }
    cp_async_commit();
  }
  cluster.sync();              // every CTA runs before the first remote store

  for (int tile = blockIdx.x / C; tile < n_tiles; tile += n_clusters) {
    const int b0 = tile * tile_rows;
    const int rows = min(tile_rows, B - b0);
    int first = 0;             // ring: the first layer with a granule here
    if (kRing) {
      while (first < n_layers && granules(first) == 0) ++first;
      if (first < n_layers) fetch(first, 0, 0);
      cp_async_commit();
    }
    {                          // this CTA's input columns, to every CTA
      const int share = cluster_share(w0, C);
      const int lo = rank * share;
      const int n = max(0, min(share, w0 - lo));
      const int groups = (n + kGroup - 1) / kGroup;
      for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
        const int r = i / groups;
        const int k0 = (i - r * groups) * kGroup;
        const int32_t* src = codes + static_cast<size_t>(b0 + r) * w0 + lo;
        ActT v[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          v[j] = static_cast<ActT>(k0 + j < n ? src[k0 + j] : 0);
        broadcast(cluster, hbuf[0] + static_cast<size_t>(r) * a_pad + lo + k0,
                  v, C);
      }
    }
    if (!kRing) cp_async_wait_all();
    cluster.sync();            // the input codes everywhere (and the tables)

    int cur = 0;
    size_t to = 0, mo = 0;
    int stage = 0;
    for (int l = 0; l < n_layers; ++l) {
      const int32_t* d = desc + l * kDescInts;
      const bool last = l == n_layers - 1;
      int lo, n;
      owned(l, lo, n);
      if (!kRing) {
        lookup_units<TabT, ActT>(
            cluster, d, last, lo, 0, n,
            reinterpret_cast<const TabT*>(s_tab + to),
            reinterpret_cast<const int32_t*>(s_map + mo), max_entries,
            hbuf[cur], hbuf[cur ^ 1], a_pad, rows, b0, C, out);
        const int share = cluster_share(d[D_UNITS], C);
        to += align16(static_cast<size_t>(share) * row_bytes);
        if (!d[D_ASSEMBLE])
          mo += align16(static_cast<size_t>(share) * d[D_FAN_IN] * 4);
      } else {
        const int ng = granules(l);
        for (int g = 0; g < ng; ++g) {
          int nl = l, nxt = g + 1;          // the granule after this one
          if (nxt == ng) {
            nxt = 0;
            for (++nl; nl < n_layers && granules(nl) == 0;) ++nl;
          }
          if (nl < n_layers) {
            fetch(nl, nxt, stage ^ 1);
            cp_async_commit();
            cp_async_wait_one();
          } else {
            cp_async_wait_all();
          }
          __syncthreads();
          lookup_units<TabT, ActT>(
              cluster, d, last, lo, g * ring_units,
              min(ring_units, n - g * ring_units),
              reinterpret_cast<const TabT*>(s_tab + stage * (tab_bytes / 2)),
              reinterpret_cast<const int32_t*>(s_map + stage * (map_bytes / 2)),
              max_entries, hbuf[cur], hbuf[cur ^ 1], a_pad, rows, b0, C, out);
          __syncthreads();                  // the stage is free to refill
          stage ^= 1;
        }
      }
      // the layer's codes everywhere; after the last layer, every CTA is
      // done reading h before the next tile's codes arrive
      cluster.sync();
      cur ^= 1;
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Shared memory K1's layout needs (lut_cascade.resident_smem_bytes).
template <typename TabT, typename ActT>
size_t resident_smem(int n_layers, int w0, int a_pad, long long tables_elems,
                     long long maps_words, int tile_rows) {
  return align16(static_cast<size_t>(tables_elems) * sizeof(TabT)) +
         align16(static_cast<size_t>(maps_words) * 4) +
         align16(static_cast<size_t>(n_layers) * kDescInts * 4) +
         2 * align16(static_cast<size_t>(tile_rows) * w0 * 4) +
         2 * align16(static_cast<size_t>(tile_rows) * a_pad * sizeof(ActT));
}

template <typename TabT, typename ActT>
cudaError_t launch_resident(const void* codes, const void* tables,
                            const void* maps, const void* desc, int n_layers,
                            int B, int w0, int max_entries, int a_pad,
                            long long tables_elems, long long maps_words,
                            int tile_rows, int grid, long long smem, void* out,
                            cudaStream_t stream) {
  if (static_cast<size_t>(smem) <
      resident_smem<TabT, ActT>(n_layers, w0, a_pad, tables_elems, maps_words,
                                tile_rows))
    return cudaErrorInvalidValue;
  auto kernel = cascade_resident_kernel<TabT, ActT>;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kResidentThreads, static_cast<size_t>(smem), stream>>>(
      static_cast<const int32_t*>(codes), static_cast<const TabT*>(tables),
      static_cast<const int32_t*>(maps), static_cast<const int32_t*>(desc),
      n_layers, B, w0, max_entries, a_pad, tables_elems, maps_words, tile_rows,
      static_cast<int32_t*>(out));
  return cudaGetLastError();
}

template <typename TabT, typename ActT>
cudaError_t resident_occupancy(long long smem, int* n) {
  auto kernel = cascade_resident_kernel<TabT, ActT>;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, kernel, kResidentThreads, static_cast<size_t>(smem));
}

template <typename TabT, typename ActT>
cudaLaunchConfig_t cluster_config(int cluster, int n_clusters, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * cluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename TabT, typename ActT>
cudaError_t launch_streamed(const void* codes, const void* tables,
                            const void* maps, const void* desc, int n_layers,
                            int B, int w0, int max_entries, int a_pad,
                            int max_fan, int cluster, int tile_rows,
                            int ring_units, int n_clusters, long long smem,
                            void* out, cudaStream_t stream) {
  auto kernel = ring_units > 0 ? cascade_streamed_kernel<TabT, ActT, true>
                               : cascade_streamed_kernel<TabT, ActT, false>;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<TabT, ActT>(
      cluster, n_clusters, static_cast<size_t>(smem), stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int32_t*>(codes),
      static_cast<const TabT*>(tables), static_cast<const int32_t*>(maps),
      static_cast<const int32_t*>(desc), n_layers, B, w0, max_entries, a_pad,
      max_fan, tile_rows, ring_units, static_cast<int32_t*>(out));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TabT, typename ActT>
cudaError_t streamed_max_clusters(int ring, int cluster, long long smem,
                                  int* n) {
  auto kernel = ring ? cascade_streamed_kernel<TabT, ActT, true>
                     : cascade_streamed_kernel<TabT, ActT, false>;
  cudaError_t err = allow_smem(kernel, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<TabT, ActT>(
      cluster, 1, static_cast<size_t>(smem), nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(n, kernel, &cfg);
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

// K3 over the n = B * U outputs: `grid` CTAs of `threads` threads, vec
// (1 or 4) outputs a thread; vec 4 needs addr and out 16-byte aligned.
int lut_lookup_launch(const void* table, const void* addr, void* out,
                      long long n, int U, int T, int threads, int vec,
                      int grid, void* stream) {
  if (threads < 1 || threads > kLookupMaxThreads || grid < 1 || U < 1 ||
      T < 1 || (vec != 1 && vec != 4) ||
      static_cast<long long>(grid) * threads * vec < n ||
      (vec == 4 && (reinterpret_cast<uintptr_t>(addr) % 16 != 0 ||
                    reinterpret_cast<uintptr_t>(out) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = vec == 4 ? lut_lookup_kernel<4> : lut_lookup_kernel<1>;
  kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), static_cast<const int32_t*>(addr),
      static_cast<int32_t*>(out), n, U, T);
  return static_cast<int>(cudaGetLastError());
}

// K1: `grid` persistent CTAs walking tiles of `tile_rows` rows (a multiple
// of 4); smem: the bytes of the wrapper's plan, at least what the layout
// needs.  a_pad: the activation tile's width, a multiple of 4.
int lut_cascade_resident_launch(const void* codes, const void* tables,
                                int table_itemsize, const void* maps,
                                const void* desc, int n_layers, int B, int w0,
                                int max_entries, int a_pad, int act_itemsize,
                                long long tables_elems, long long maps_words,
                                int tile_rows, int grid, long long smem,
                                void* out, void* stream) {
  if (tile_rows < 4 || tile_rows % 4 != 0 || grid < 1 || a_pad % kGroup != 0 ||
      a_pad < w0)
    return static_cast<int>(cudaErrorInvalidValue);
  LUT_DISPATCH(launch_resident, table_itemsize, act_itemsize,
               codes, tables, maps, desc, n_layers, B, w0, max_entries, a_pad,
               tables_elems, maps_words, tile_rows, grid, smem, out,
               static_cast<cudaStream_t>(stream));
}

// CTAs of K1 with `smem` bytes that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), written to *n.
int lut_cascade_resident_occupancy(int table_itemsize, int act_itemsize,
                                   long long smem, int* n) {
  LUT_DISPATCH(resident_occupancy, table_itemsize, act_itemsize, smem, n);
}

// K2 over clusters of `cluster` CTAs (<= 8), `n_clusters` of them walking
// batch tiles of `tile_rows` rows; ring_units > 0 takes the ring route with
// stages of that many units.  smem: the bytes one CTA needs (the wrapper's
// plan).  a_pad: the activation tile's width, a multiple of 4.
int lut_cascade_streamed_launch(const void* codes, const void* tables,
                                int table_itemsize, const void* maps,
                                const void* desc, int n_layers, int B, int w0,
                                int max_entries, int a_pad, int act_itemsize,
                                int max_fan, int cluster, int tile_rows,
                                int ring_units, int n_clusters,
                                long long smem, void* out, void* stream) {
  if (cluster < 1 || cluster > 8 || tile_rows < 1 || n_clusters < 1 ||
      a_pad % kGroup != 0 || (ring_units > 0 && ring_units % kGroup != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  LUT_DISPATCH(launch_streamed, table_itemsize, act_itemsize,
               codes, tables, maps, desc, n_layers, B, w0, max_entries, a_pad,
               max_fan, cluster, tile_rows, ring_units, n_clusters, smem, out,
               static_cast<cudaStream_t>(stream));
}

// How many clusters of K2 can be resident at once on the current device
// (cudaOccupancyMaxActiveClusters), written to *n.
int lut_cascade_streamed_max_clusters(int table_itemsize, int act_itemsize,
                                      int ring, int cluster, long long smem,
                                      int* n) {
  LUT_DISPATCH(streamed_max_clusters, table_itemsize, act_itemsize, ring,
               cluster, smem, n);
}

}  // extern "C"
