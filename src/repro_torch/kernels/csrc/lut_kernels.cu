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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

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
constexpr int kGroup = 4;     // units per work item: one vector store per peer

// Units of a layer of n units that each CTA of a C-CTA cluster owns.
__host__ __device__ inline int cluster_share(int n, int cluster) {
  return ((n + cluster - 1) / cluster + kGroup - 1) / kGroup * kGroup;
}

__device__ inline unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Block-wide asynchronous copy of n bytes into shared dst (16 B aligned):
// 16 bytes a thread where src allows it, else 4, else plain byte copies.
__device__ inline void async_copy(unsigned char* dst, const void* src,
                                  size_t n) {
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  if (a % 16 == 0 && n % 16 == 0) {
    for (size_t i = threadIdx.x; i < n / 16; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(smem_u32(dst + 16 * i)), "l"(s + 16 * i) : "memory");
  } else if (a % 4 == 0 && n % 4 == 0) {
    for (size_t i = threadIdx.x; i < n / 4; i += blockDim.x)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                   :: "r"(smem_u32(dst + 4 * i)), "l"(s + 4 * i) : "memory");
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = s[i];
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
    const ActT* hr = h + static_cast<size_t>(r) * a_pad;
    // the group's units side by side, so that their loads are independent
    // (a unit past n repeats the last one, and is not stored)
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
                 static_cast<int>(hr[(lo + u0 + kk[j]) * fan_in + f]);
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
    ActT v[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int val = static_cast<int>(
          tab[static_cast<size_t>(kk[j]) * max_entries +
              min(a[j], entries - 1)]);
      v[j] = static_cast<ActT>(k0 + j < n ? val : 0);
      if (last && k0 + j < n)
        out[static_cast<size_t>(b0 + r) * units + lo + u0 + k0 + j] = val;
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
