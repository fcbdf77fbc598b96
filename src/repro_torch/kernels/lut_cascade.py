"""K1/K2: the whole folded cascade in one launch.

Replaces ``repro/kernels/lut_cascade.py`` ``lut_cascade_pallas`` in its two
modes.  The TPU kernels formed addresses with an f32 matmul against the
plan's ``amat`` and looked up with a one-hot contraction; on Hopper both
become integer work on shared memory (``csrc/lut_kernels.cu``):

* **K1, resident** (``cascade_resident_kernel``): every table in one
  CTA's shared memory.  Persistent CTAs, as many as :func:`plan_resident`
  fits on the card, copy the packed tables (narrow dtype) and every
  ``map_<l>`` into shared memory once and walk batch tiles of a few rows;
  each tile's int32 codes arrive by 16-byte ``cp.async`` into one of two
  stages (the next tile's copy in flight while this one's layers run).
  Each layer gathers its fan-in codes -- layer 0 from the int32 stage,
  later layers from activation tiles (uint8 when every code fits, else
  uint16/uint32) -- forms the address with shifts and reads
  ``tab[off+u][addr]``.
* **K2, streamed** (``cascade_streamed_kernel``): for table sets beyond
  one block's shared memory, split over a thread-block cluster of up to 8
  CTAs (:func:`plan_cluster`).  The CTAs of a cluster share one batch
  tile; each owns a slice of every layer's units, keeps its slice of the
  tables and maps in shared memory (or streams it through a two-stage ring
  where it does not fit), and writes its output codes into every CTA's
  activation tile through distributed shared memory, one cluster barrier
  per layer.  Clusters are persistent: each walks several batch tiles with
  its tables in place.

Both read ``tables`` and the ``map_<l>`` buffers and ignore ``amat``, which
the plan keeps for format compatibility.  Both are bound by bytes: the
input codes, the output codes and the tables and maps, each moved once.

:func:`lut_cascade_plain` is the plain PyTorch version shared by K1 and
K2 (the torch twin of ``lut_cascade_xla``); the CPU path and the tests use
it.  The numpy helpers (``cascade_flops``, ``cascade_bytes``,
``_phase_layout``) are copies of the reference's cost model, which the
autotuner needs to reproduce the reference's plan metadata.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.kernels import build

LayerMeta = Tuple[int, int, int, int]

RESIDENT_LAUNCHES = build.counter("lut_cascade_resident")
STREAMED_LAUNCHES = build.counter("lut_cascade_streamed")

SMEM_PER_BLOCK = 232_448     # dynamic shared memory one Hopper block may use
SMEM_PER_SM = 233_472        # shared memory of one SM (228 KB)
SMEM_PER_CTA_RESERVED = 1024  # the runtime's own share of it, a resident CTA
THREADS_PER_SM = 2048
RESIDENT_THREADS = 256       # K1's CTA (kResidentThreads in the kernel)
RESIDENT_MIN_ROWS = 4        # K1's rows a tile: a multiple of 4, from here
RESIDENT_MAX_ROWS = 16       # ... to here (32 was slower in the plan sweep)
CLUSTER_MAX = 8              # K2's CTAs a cluster (the portable limit)
CLUSTER_SIZES = (4, 8)       # K2's cluster sizes, in the order plans try them
CLUSTER_ROWS = 32            # K2's rows a cluster tile, at most
CLUSTER_MIN_ROWS = 8         # fewer resident rows than this: take the ring
CLUSTER_FEW_ROWS = 16        # a smaller cluster is taken at this many rows
GROUP = 4                    # units a K1/K2 work item (kGroup in the kernel)
DESC_INTS = 8                # int32s a layer descriptor (kDescInts)


def layers_v1(layers: Sequence[Sequence[int]]) -> Tuple[LayerMeta, ...]:
    """Project layer metadata (v1 or v2 tuples) to ``(prev, units,
    entries, off)``."""
    return tuple((int(p), int(u), int(e), int(o))
                 for p, u, e, o, *_ in layers)


def is_v2_layers(layers: Sequence[Sequence[int]]) -> bool:
    """True when every entry carries the v2 ``(fan_in, in_bits,
    assemble)`` tail."""
    return all(len(l) >= 7 for l in layers)


def cascade_flops(layers: Sequence[Sequence[int]], batch: int) -> int:
    """The reference's MXU flop model of one cascade pass."""
    f = 0
    for prev, units, entries, _, *_ in layers:
        f += 2 * batch * prev * units + 2 * batch * units * entries
    return f


def cascade_bytes(layers: Sequence[Sequence[int]], batch: int,
                  table_itemsize: int, *, mode: str = "resident",
                  block_b: int = 256) -> int:
    """The reference's HBM byte model of one cascade pass (amat included)."""
    l4 = layers_v1(layers)
    total_units = sum(u for _, u, _, _ in l4)
    max_prev = max(p for p, _, _, _ in l4)
    max_entries = max(e for _, _, e, _ in l4)
    w0 = l4[0][0]
    n_out = l4[-1][1]
    const = max_prev * total_units * 4 + total_units * max_entries * table_itemsize
    io = batch * w0 * 4 + batch * n_out * 4
    if mode == "streamed":
        n_bt = max(1, math.ceil(batch / block_b))
        return io + n_bt * const
    return io + const


def _phase_layout(layers: Tuple[LayerMeta, ...], unit_tile: int):
    """Phase plan of the streamed cascade: a phase is one (layer, unit
    tile).  Returns the per-phase column offsets and start/end/emit flags,
    the per-phase row ranges, and the tile-rounded activation width."""
    cols, starts, ends, outs = [], [], [], []
    src = []
    last = len(layers) - 1
    for li, (_, units, _, off) in enumerate(layers):
        n_t = math.ceil(units / unit_tile)
        for c in range(n_t):
            cols.append(c * unit_tile)
            starts.append(1 if c == 0 else 0)
            ends.append(1 if c == n_t - 1 else 0)
            outs.append(1 if li == last else 0)
            lo = off + c * unit_tile
            src.append((lo, min(lo + unit_tile, off + units)))
    a_dim = max([layers[0][0]] +
                [math.ceil(u / unit_tile) * unit_tile
                 for _, u, _, _ in layers])
    return (np.asarray(cols, np.int32), np.asarray(starts, np.int32),
            np.asarray(ends, np.int32), np.asarray(outs, np.int32),
            src, a_dim)


# ---------------------------------------------------------------------------
# the plain version (K1 and K2 compute this function)
# ---------------------------------------------------------------------------

def lut_cascade_plain(codes: torch.Tensor, tables: torch.Tensor,
                      mappings: Sequence[Optional[torch.Tensor]],
                      layers: Sequence[Sequence[int]]) -> torch.Tensor:
    """Per layer: gather the fan-in codes, pack the address with an integer
    weight sum, gather ``tab[u, addr]`` from the layer's slice of the packed
    table buffer.  ``layers`` are v2 7-tuples ``(prev, units, entries, off,
    fan_in, in_bits, assemble)``; ``mappings[l]`` is ``None`` for assemble
    layers."""
    if not is_v2_layers(layers):
        raise ValueError("lut_cascade_plain needs v2 layer metadata "
                         "(prev, units, entries, off, fan_in, in_bits, "
                         "assemble); re-plan with the current backend")
    h = codes.to(torch.int32)
    for (prev, units, entries, off, fan_in, bits, asm), mp in zip(
            layers, mappings):
        if asm:
            ci = h.reshape(h.shape[0], units, fan_in)
        else:
            ci = h[:, mp.to(torch.int64)]
        w = (2 ** (bits * torch.arange(fan_in - 1, -1, -1,
                                       device=h.device))).to(torch.int32)
        addr = (ci * w).sum(dim=-1, dtype=torch.int32)
        tab = tables[off:off + units, :entries].to(torch.int32)
        h = torch.gather(tab, 1, addr.t().to(torch.int64)).t().contiguous()
    return h


# ---------------------------------------------------------------------------
# the kernels' operands and shared-memory layout
# ---------------------------------------------------------------------------

def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def act_itemsize(layers: Sequence[Sequence[int]]) -> int:
    """Bytes per activation code: every layer input (network input and
    inner-layer outputs) is ``in_bits`` wide."""
    bits = max(int(l[5]) for l in layers)
    return 1 if bits <= 8 else (2 if bits <= 16 else 4)


def act_width(layers: Sequence[Sequence[int]]) -> int:
    """Columns of an activation tile: the input width and every non-final
    layer's units (the final layer writes straight to the output)."""
    return max([int(layers[0][0])] + [int(l[1]) for l in layers[:-1]])


def resident_smem_bytes(layers: Sequence[Sequence[int]], table_itemsize: int,
                        rows: int, max_entries: Optional[int] = None) -> int:
    """Shared memory K1 needs, as the kernel lays it out: the packed tables
    (``max_entries`` columns, by default the widest layer's), the maps, the
    layer descriptors, two int32 code stages of ``rows`` input rows and two
    activation tiles of ``rows`` rows of :func:`_a_pad` codes."""
    max_entries = max_entries or max(int(l[2]) for l in layers)
    tab = max(int(l[3]) + int(l[1]) for l in layers) * max_entries
    maps = sum(int(l[1]) * int(l[4]) for l in layers if not int(l[6]))
    desc = len(layers) * DESC_INTS * 4
    stage = rows * int(layers[0][0]) * 4
    act = rows * _a_pad(layers) * act_itemsize(layers)
    return (_align16(tab * table_itemsize) + _align16(maps * 4)
            + _align16(desc) + 2 * _align16(stage) + 2 * _align16(act))


def cluster_share(n: int, cluster: int) -> int:
    """Units of a layer of ``n`` units that each CTA of a K2 cluster owns:
    ``ceil(n / cluster)`` rounded up to :data:`GROUP`."""
    per_cta = -(-n // cluster)
    return -(-per_cta // GROUP) * GROUP


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """How K2 splits a cascade over a cluster: ``cluster`` CTAs share a
    batch tile of ``rows`` rows; CTA ``c`` owns units ``ranges[c][l] =
    (lo, hi)`` of layer ``l`` (and ``input_ranges[c]`` of the input
    columns); its share of the tables stays resident (``ring_units`` 0) or
    streams through two stages of ``ring_units`` units; ``smem_bytes`` is
    what one CTA needs, ``a_pad`` the activation tile's width."""

    cluster: int
    rows: int
    ring_units: int
    a_pad: int
    smem_bytes: int
    ranges: Tuple[Tuple[Tuple[int, int], ...], ...]
    input_ranges: Tuple[Tuple[int, int], ...]

    @property
    def route(self) -> str:
        """``"ring"`` or ``"resident"``."""
        return "ring" if self.ring_units else "resident"


def _a_pad(layers: Sequence[Sequence[int]]) -> int:
    """Row width of K2's activation tiles: the widest layer input rounded
    up to :data:`GROUP`; for uint8 codes also an odd number of 4-byte
    words, so that the rows a warp reads at one column fall in distinct
    shared-memory banks."""
    a = -(-act_width(layers) // GROUP) * GROUP
    if act_itemsize(layers) == 1 and a // 4 % 2 == 0:
        a += 4
    return a


def _owned(n: int, cluster: int) -> Tuple[Tuple[int, int], ...]:
    share = cluster_share(n, cluster)
    return tuple((min(c * share, n), min((c + 1) * share, n))
                 for c in range(cluster))


def cluster_smem_bytes(layers: Sequence[Sequence[int]], table_itemsize: int,
                       cluster: int, rows: int, ring_units: int = 0,
                       max_entries: Optional[int] = None) -> int:
    """Shared memory one K2 CTA needs, as the kernel lays it out: its share
    of every layer's table rows and maps (or two ring stages of
    ``ring_units`` units), then two activation tiles of ``rows`` rows."""
    max_entries = max_entries or max(int(l[2]) for l in layers)
    row = max_entries * table_itemsize
    if ring_units:
        max_fan = max([int(l[4]) for l in layers if not int(l[6])] or [0])
        const = 2 * (_align16(ring_units * row)
                     + _align16(ring_units * max_fan * 4))
    else:
        const = 0
        for l in layers:
            share = cluster_share(int(l[1]), cluster)
            const += _align16(share * row)
            if not int(l[6]):
                const += _align16(share * int(l[4]) * 4)
    return const + 2 * _align16(rows * _a_pad(layers)
                                * act_itemsize(layers))


@functools.lru_cache(maxsize=256)
def plan_cluster(layers: Tuple[Tuple[int, ...], ...], table_itemsize: int, *,
                 unit_tile: int = 8, max_entries: Optional[int] = None,
                 cluster: Optional[int] = None,
                 rows: Optional[int] = None) -> ClusterPlan:
    """K2's plan for v2 ``layers`` (a tuple of tuples) and a table
    itemsize.  By default the resident route on the first of
    :data:`CLUSTER_SIZES` whose CTAs hold their share and at least
    :data:`CLUSTER_FEW_ROWS` rows in :data:`SMEM_PER_BLOCK` (the most rows,
    a power of two up to :data:`CLUSTER_ROWS`), else resident on
    :data:`CLUSTER_MAX` at down to :data:`CLUSTER_MIN_ROWS` rows, else the
    ring on :data:`CLUSTER_MAX` at the most rows that fit, with stages of
    ``unit_tile`` units rounded up to :data:`GROUP` (fewer, in steps of
    :data:`GROUP`, where two such stages do not fit).  ``cluster`` and
    ``rows`` pin either (the plan sweep): resident if that fits, else the
    ring.  Raises when nothing fits."""
    if not is_v2_layers(layers):
        raise ValueError("lut_cascade: K2 needs v2 layer metadata")
    if cluster is not None and not 1 <= int(cluster) <= CLUSTER_MAX:
        raise ValueError(f"lut_cascade: cluster {cluster} not in "
                         f"1..{CLUSTER_MAX}")
    ring = -(-max(int(unit_tile), 1) // GROUP) * GROUP
    granules = range(ring, 0, -GROUP)
    pw2 = [CLUSTER_ROWS >> i for i in range(CLUSTER_ROWS.bit_length())]
    if cluster is not None or rows is not None:
        c = CLUSTER_MAX if cluster is None else int(cluster)
        rs = pw2 if rows is None else [int(rows)]
        tries = [(c, r, 0) for r in rs] + [(c, r, g) for r in rs
                                           for g in granules]
    else:
        # resident on the smallest cluster that holds CLUSTER_FEW_ROWS rows
        # (fewer peers to write to), else on the largest, else the ring
        tries = [(c, r, 0) for c in CLUSTER_SIZES for r in pw2
                 if r >= CLUSTER_FEW_ROWS]
        tries += [(CLUSTER_MAX, r, 0) for r in pw2 if r >= CLUSTER_MIN_ROWS]
        tries += [(CLUSTER_MAX, r, g) for r in pw2 for g in granules]

    for c, r, g in tries:
        smem = cluster_smem_bytes(layers, table_itemsize, c, r, g,
                                  max_entries)
        if r >= 1 and smem <= SMEM_PER_BLOCK:
            return ClusterPlan(
                cluster=c, rows=r, ring_units=g, a_pad=_a_pad(layers),
                smem_bytes=smem,
                ranges=tuple(zip(*(_owned(int(l[1]), c) for l in layers))),
                input_ranges=_owned(int(layers[0][0]), c))
    raise ValueError(f"lut_cascade: no K2 plan fits {SMEM_PER_BLOCK} B of "
                     f"shared memory (cluster {cluster}, rows {rows})")


@dataclasses.dataclass(frozen=True)
class ResidentPlan:
    """How K1 runs a batch: ``grid`` persistent CTAs of
    :data:`RESIDENT_THREADS` threads walk ``tiles`` tiles of ``rows`` rows
    (a multiple of 4, so that every tile's int32 codes start 16-byte
    aligned); ``ctas_per_sm`` of them fit one SM; ``a_pad`` is the
    activation row pitch, ``smem_bytes`` what one CTA needs."""

    rows: int
    ctas_per_sm: int
    grid: int
    tiles: int
    a_pad: int
    smem_bytes: int


def resident_ctas_per_sm(smem_bytes: int) -> int:
    """K1's CTAs that one SM holds at once by shared memory and threads
    (the card's registers may hold fewer: :func:`resident_plan`)."""
    return min(THREADS_PER_SM // RESIDENT_THREADS,
               SMEM_PER_SM // (smem_bytes + SMEM_PER_CTA_RESERVED))


@functools.lru_cache(maxsize=256)
def plan_resident(layers: Tuple[Tuple[int, ...], ...], table_itemsize: int,
                  batch: int, sms: int, *, max_entries: Optional[int] = None,
                  rows: Optional[int] = None,
                  ctas_per_sm: Optional[int] = None) -> ResidentPlan:
    """K1's plan for v2 ``layers`` (a tuple of tuples), a table itemsize, a
    batch and the card's SM count.  By default the fewest rows a tile (a
    multiple of 4 from :data:`RESIDENT_MIN_ROWS` to
    :data:`RESIDENT_MAX_ROWS`) that leave at most one tile an SM, fewer
    where the shared memory does not hold them; then as many CTAs as fit
    the card (``sms`` x CTAs an SM), at most one a tile.  ``rows`` and
    ``ctas_per_sm`` pin either (the plan sweep; a pinned CTA count may not
    exceed what fits).  Raises when not even :data:`RESIDENT_MIN_ROWS` rows
    fit one block's shared memory."""
    if not is_v2_layers(layers):
        raise ValueError("lut_cascade: K1 needs v2 layer metadata")
    if batch < 1 or sms < 1:
        raise ValueError(f"lut_cascade: batch {batch}, sms {sms}")

    def smem(r):
        return resident_smem_bytes(layers, table_itemsize, r, max_entries)

    if rows is None:
        want = -(-batch // sms)
        r = min(RESIDENT_MAX_ROWS, max(RESIDENT_MIN_ROWS, -(-want // 4) * 4))
        while r > RESIDENT_MIN_ROWS and smem(r) > SMEM_PER_BLOCK:
            r -= 4
    else:
        r = int(rows)
        if r < 4 or r % 4:
            raise ValueError(f"lut_cascade: K1 rows {r} not a multiple of 4")
    need = smem(r)
    if need > SMEM_PER_BLOCK:
        raise ValueError(f"lut_cascade: K1 needs {need} B of shared memory at "
                         f"{r} rows, over {SMEM_PER_BLOCK} B")
    fit = resident_ctas_per_sm(need)
    if ctas_per_sm is not None:
        if not 1 <= int(ctas_per_sm) <= fit:
            raise ValueError(f"lut_cascade: {ctas_per_sm} K1 CTAs an SM, "
                             f"{fit} fit")
        fit = int(ctas_per_sm)
    tiles = -(-batch // r)
    return ResidentPlan(rows=r, ctas_per_sm=fit, grid=min(sms * fit, tiles),
                        tiles=tiles, a_pad=_a_pad(layers), smem_bytes=need)


@dataclasses.dataclass(frozen=True)
class CascadeOperands:
    """What K1/K2 read, on one device: the packed tables, every mapping
    layer's map concatenated (int32), and one descriptor row per layer
    ``(units, entries, row_off, fan_in, bits, assemble, map_off, 0)``."""

    layers: Tuple[Tuple[int, ...], ...]
    tables: torch.Tensor
    maps: torch.Tensor
    desc: torch.Tensor
    map_words: int
    max_fan: int


def prepare(tables: torch.Tensor, layers: Sequence[Sequence[int]],
            mappings: Sequence[Optional[torch.Tensor]]) -> CascadeOperands:
    """Pack the kernels' operands once per plan and device."""
    layers = tuple(tuple(int(v) for v in l) for l in layers)
    if not is_v2_layers(layers):
        raise ValueError("lut_cascade kernels need v2 layer metadata "
                         "(re-plan with the current backend)")
    desc, parts, moff, max_fan = [], [], 0, 0
    for (prev, units, entries, off, fan_in, bits, asm), mp in zip(
            layers, mappings):
        if entries > tables.shape[1] or off + units > tables.shape[0]:
            raise ValueError("lut_cascade: layer metadata exceeds tables")
        if asm:
            desc.append([units, entries, off, fan_in, bits, 1, -1, 0])
            continue
        if mp is None or tuple(mp.shape) != (units, fan_in):
            raise ValueError("lut_cascade: mapping layer without a "
                             f"[{units}, {fan_in}] map")
        desc.append([units, entries, off, fan_in, bits, 0, moff, 0])
        parts.append(mp.to(torch.int32).reshape(-1))
        moff += units * fan_in
        max_fan = max(max_fan, fan_in)
    dev = tables.device
    maps = (torch.cat(parts) if parts
            else torch.zeros(1, dtype=torch.int32, device=dev)).contiguous()
    if tables.data_ptr() % 16:
        tables = tables.clone()
    return CascadeOperands(
        layers=layers, tables=tables.contiguous(), maps=maps,
        desc=torch.tensor(desc, dtype=torch.int32, device=dev).contiguous(),
        map_words=moff, max_fan=max_fan)


def _check_codes(codes: torch.Tensor, ops: CascadeOperands) -> None:
    if not (codes.is_cuda and codes.device == ops.tables.device):
        raise ValueError("lut_cascade: codes and tables must be on one "
                         "CUDA device")
    if codes.dtype != torch.int32 or not codes.is_contiguous():
        raise TypeError("lut_cascade: codes must be contiguous int32")
    if codes.dim() != 2 or codes.shape[1] != ops.layers[0][0]:
        raise ValueError(f"lut_cascade: codes {tuple(codes.shape)} vs input "
                         f"width {ops.layers[0][0]}")
    if ops.tables.element_size() not in (1, 2, 4):
        raise TypeError("lut_cascade: tables must be int8/int16/int32")


def lut_cascade_resident(codes: torch.Tensor,
                         ops: CascadeOperands) -> torch.Tensor:
    """Launch K1 on the plan :func:`plan_resident` makes for this batch and
    card: ``[B, W0]`` int32 codes -> ``[B, n_out]`` int32."""
    _check_codes(codes, ops)
    b = codes.shape[0]
    if b == 0:
        return torch.empty((0, ops.layers[-1][1]), dtype=torch.int32,
                           device=codes.device)
    return launch_resident(codes, ops,
                           resident_plan(ops, b, codes.device.index or 0))


def resident_plan(ops: CascadeOperands, batch: int,
                  device_index: int) -> ResidentPlan:
    """K1's plan on a card: :func:`plan_resident` with the card's SM count,
    its CTAs an SM capped at what the runtime reports for the kernel
    (:func:`resident_occupancy`: registers may hold fewer CTAs than shared
    memory and threads)."""
    isz = ops.tables.element_size()
    plan = plan_resident(ops.layers, isz, batch,
                         _device.sm_count(device_index),
                         max_entries=ops.tables.shape[1])
    fit = resident_occupancy(device_index, isz, act_itemsize(ops.layers),
                             plan.smem_bytes)
    if fit < plan.ctas_per_sm:
        plan = plan_resident(ops.layers, isz, batch,
                             _device.sm_count(device_index),
                             max_entries=ops.tables.shape[1], rows=plan.rows,
                             ctas_per_sm=fit)
    return plan


@functools.lru_cache(maxsize=64)
def resident_occupancy(device_index: int, table_itemsize: int, act_size: int,
                       smem: int) -> int:
    """CTAs of K1 with ``smem`` bytes that one SM of the card holds at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    lib = build.library("lut_kernels")
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.lut_cascade_resident_occupancy(table_itemsize, act_size,
                                                 smem, ctypes.byref(n))
    build.check(err, "lut_cascade_resident (occupancy)")
    return n.value


def launch_resident(codes: torch.Tensor, ops: CascadeOperands,
                    plan: ResidentPlan) -> torch.Tensor:
    """Launch K1 on an explicit :class:`ResidentPlan` (the plan sweep's
    entry; :func:`lut_cascade_resident` is the path's)."""
    _check_codes(codes, ops)
    layers, isz = ops.layers, ops.tables.element_size()
    b = codes.shape[0]
    if plan.tiles != -(-b // plan.rows):
        raise ValueError(f"lut_cascade_resident: a plan for {plan.tiles} "
                         f"tiles of {plan.rows} rows, batch {b}")
    out = torch.empty((b, layers[-1][1]), dtype=torch.int32,
                      device=codes.device)
    tab_rows = max(l[3] + l[1] for l in layers)
    lib = build.library("lut_kernels")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.lut_cascade_resident_launch(
            codes.data_ptr(), ops.tables.data_ptr(), isz, ops.maps.data_ptr(),
            ops.desc.data_ptr(), len(layers), b, layers[0][0],
            ops.tables.shape[1], plan.a_pad, act_itemsize(layers),
            tab_rows * ops.tables.shape[1], ops.map_words, plan.rows,
            plan.grid, plan.smem_bytes, out.data_ptr(), stream)
    build.check(err, "lut_cascade_resident")
    RESIDENT_LAUNCHES.add()
    return out


def lut_cascade_streamed(codes: torch.Tensor, ops: CascadeOperands, *,
                         unit_tile: int = 8) -> torch.Tensor:
    """Launch K2 on the plan :func:`plan_cluster` makes: ``[B, W0]`` int32
    codes -> ``[B, n_out]`` int32.  ``unit_tile`` is the ring route's copy
    granule (the resident route does not read it)."""
    _check_codes(codes, ops)
    if unit_tile < 1:
        raise ValueError(f"lut_cascade: unit_tile {unit_tile} < 1")
    plan = plan_cluster(ops.layers, ops.tables.element_size(),
                        unit_tile=unit_tile, max_entries=ops.tables.shape[1])
    return launch_streamed(codes, ops, plan)


@functools.lru_cache(maxsize=64)
def max_active_clusters(device_index: int, table_itemsize: int,
                        act_size: int, ring: bool, cluster: int,
                        smem: int) -> int:
    """Clusters of K2 that fit the card at once
    (``cudaOccupancyMaxActiveClusters``)."""
    lib = build.library("lut_kernels")
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = lib.lut_cascade_streamed_max_clusters(
            table_itemsize, act_size, int(ring), cluster, smem,
            ctypes.byref(n))
    build.check(err, "lut_cascade_streamed (occupancy)")
    return n.value


def launch_streamed(codes: torch.Tensor, ops: CascadeOperands,
                    plan: ClusterPlan) -> torch.Tensor:
    """Launch K2 on an explicit :class:`ClusterPlan` (the plan sweep's
    entry; :func:`lut_cascade_streamed` is the path's): one persistent
    cluster per batch tile, at most as many as fit the card at once."""
    _check_codes(codes, ops)
    layers, isz = ops.layers, ops.tables.element_size()
    b = codes.shape[0]
    out = torch.empty((b, layers[-1][1]), dtype=torch.int32,
                      device=codes.device)
    if b == 0:
        return out
    lib = build.library("lut_kernels")
    asz = act_itemsize(layers)
    fit = max_active_clusters(codes.device.index or 0, isz, asz,
                              bool(plan.ring_units), plan.cluster,
                              plan.smem_bytes)
    if fit < 1:
        raise RuntimeError(f"lut_cascade_streamed: no cluster of "
                           f"{plan.cluster} CTAs of {plan.smem_bytes} B fits "
                           "the card")
    n_clusters = min(-(-b // plan.rows), fit)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.lut_cascade_streamed_launch(
            codes.data_ptr(), ops.tables.data_ptr(), isz, ops.maps.data_ptr(),
            ops.desc.data_ptr(), len(layers), b, layers[0][0],
            ops.tables.shape[1], plan.a_pad, asz, ops.max_fan, plan.cluster,
            plan.rows, plan.ring_units, n_clusters, plan.smem_bytes,
            out.data_ptr(), stream)
    build.check(err, "lut_cascade_streamed")
    STREAMED_LAUNCHES.add()
    return out
