"""K1/K2: the whole folded cascade in one launch.

Replaces ``repro/kernels/lut_cascade.py`` ``lut_cascade_pallas`` in its two
modes.  The TPU kernels formed addresses with an f32 matmul against the
plan's ``amat`` and looked up with a one-hot contraction; on Hopper both
become integer work on shared memory (``csrc/lut_kernels.cu``):

* **K1, resident** (``cascade_resident_kernel``): one CTA per batch tile;
  the packed tables (narrow dtype) and every ``map_<l>`` are copied into
  shared memory once, then each layer gathers its fan-in codes from the
  activation tile, forms the address with shifts and reads
  ``tab[off+u][addr]``.  Two activation tiles ``h``/``h_next`` (uint8 when
  every code fits, else uint16/uint32) alternate between layers.
* **K2, streamed** (``cascade_streamed_kernel``): for table sets beyond one
  block's shared memory.  The CTA walks the phases of
  :func:`_phase_layout` (layer, unit tile) itself, staging each phase's
  table and map tile; ``h``/``h_next`` stay in shared memory throughout.

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

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

LayerMeta = Tuple[int, int, int, int]

RESIDENT_LAUNCHES = build.counter("lut_cascade_resident")
STREAMED_LAUNCHES = build.counter("lut_cascade_streamed")

SMEM_PER_BLOCK = 232_448     # dynamic shared memory one Hopper block may use
MAX_BLOCK_B = 64             # rows per CTA: more CTAs in flight beats wider tiles


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
                        block_b: int) -> int:
    """Shared memory K1 needs: packed tables, maps, two activation tiles."""
    l4 = layers_v1(layers)
    tab = sum(u for _, u, _, _ in l4) * max(e for _, _, e, _ in l4)
    maps = sum(int(l[1]) * int(l[4]) for l in layers if not int(l[6]))
    act = block_b * act_width(layers) * act_itemsize(layers)
    return (_align16(tab * table_itemsize) + _align16(maps * 4)
            + 2 * _align16(act))


def streamed_smem_bytes(layers: Sequence[Sequence[int]], table_itemsize: int,
                        unit_tile: int, block_b: int) -> int:
    """Shared memory K2 needs: one table tile, one map tile, two
    activation tiles."""
    max_entries = max(int(l[2]) for l in layers)
    max_fan = max([int(l[4]) for l in layers if not int(l[6])] or [0])
    act = block_b * act_width(layers) * act_itemsize(layers)
    return (_align16(unit_tile * max_entries * table_itemsize)
            + _align16(unit_tile * max_fan * 4) + 2 * _align16(act))


def _fit_block_b(smem_of) -> int:
    """Largest power-of-two row count <= ``MAX_BLOCK_B`` whose tiles fit
    one block's shared memory."""
    bb = MAX_BLOCK_B
    while bb > 1 and smem_of(bb) > SMEM_PER_BLOCK:
        bb //= 2
    if smem_of(bb) > SMEM_PER_BLOCK:
        raise ValueError(f"lut_cascade: {smem_of(bb)} B of shared memory "
                         f"for one row exceeds {SMEM_PER_BLOCK} B")
    return bb


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
    """Launch K1: ``[B, W0]`` int32 codes -> ``[B, n_out]`` int32."""
    _check_codes(codes, ops)
    layers, isz = ops.layers, ops.tables.element_size()
    bb = _fit_block_b(lambda r: resident_smem_bytes(layers, isz, r))
    b = codes.shape[0]
    out = torch.empty((b, layers[-1][1]), dtype=torch.int32,
                      device=codes.device)
    if b == 0:
        return out
    lib = build.library("lut_kernels")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.lut_cascade_resident_launch(
            codes.data_ptr(), ops.tables.data_ptr(), isz, ops.maps.data_ptr(),
            ops.desc.data_ptr(), len(layers), b, layers[0][0],
            ops.tables.shape[1], act_width(layers), act_itemsize(layers),
            ops.tables.numel(), ops.map_words, bb, out.data_ptr(), stream)
    build.check(err, "lut_cascade_resident")
    RESIDENT_LAUNCHES.add()
    return out


def lut_cascade_streamed(codes: torch.Tensor, ops: CascadeOperands, *,
                         unit_tile: int = 8) -> torch.Tensor:
    """Launch K2: ``[B, W0]`` int32 codes -> ``[B, n_out]`` int32."""
    _check_codes(codes, ops)
    if unit_tile < 1:
        raise ValueError(f"lut_cascade: unit_tile {unit_tile} < 1")
    layers, isz = ops.layers, ops.tables.element_size()
    bb = _fit_block_b(
        lambda r: streamed_smem_bytes(layers, isz, unit_tile, r))
    b = codes.shape[0]
    out = torch.empty((b, layers[-1][1]), dtype=torch.int32,
                      device=codes.device)
    if b == 0:
        return out
    lib = build.library("lut_kernels")
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        err = lib.lut_cascade_streamed_launch(
            codes.data_ptr(), ops.tables.data_ptr(), isz, ops.maps.data_ptr(),
            ops.desc.data_ptr(), len(layers), b, layers[0][0],
            ops.tables.shape[1], act_width(layers), act_itemsize(layers),
            unit_tile, ops.max_fan, bb, out.data_ptr(), stream)
    build.check(err, "lut_cascade_streamed")
    STREAMED_LAUNCHES.add()
    return out
