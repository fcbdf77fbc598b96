"""K3: one layer's batched L-LUT lookup, ``out[b,u] = table[u, addr[b,u]]``.

Replaces ``repro/kernels/lut_gather.py`` ``lut_lookup_pallas`` /
``_lut_kernel``, which contracted a one-hot tile with the table on the MXU.
On Hopper the lookup is an indexed load: the CUDA kernel
(``csrc/lut_kernels.cu`` ``lut_lookup_kernel``) tiles (unit, batch), stages
the unit tile's table rows in shared memory and gathers from there.  It is
bound by bytes (addresses in, codes out, the table once), not operations.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel runs or
the wrapper raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import lut_lookup_ref

LAUNCHES = build.counter("lut_lookup")

SMEM_STAGE_BUDGET = 48 * 1024   # staged table rows per CTA
MAX_UNIT_TILE = 32
BLOCK_B = 64


def tile_shape(entries: int):
    """``(unit_tile, block_b, staged)`` for a table of ``entries`` columns:
    as many rows as fit the staging budget (at most 32); tables whose single
    row outgrows the budget are read through the cache unstaged."""
    row = entries * 4
    if row > SMEM_STAGE_BUDGET:
        return MAX_UNIT_TILE, BLOCK_B, False
    return max(1, min(MAX_UNIT_TILE, SMEM_STAGE_BUDGET // row)), BLOCK_B, True


def lut_lookup_plain(table: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3 (``ref.lut_lookup_ref``)."""
    return lut_lookup_ref(table, addr)


def lut_lookup_cuda(table: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """Launch K3.  table ``[U, T]`` int32 and addr ``[B, U]`` int32, both
    contiguous on one CUDA device -> ``[B, U]`` int32."""
    if not (table.is_cuda and addr.is_cuda and table.device == addr.device):
        raise ValueError("lut_lookup_cuda: table and addr must be on one "
                         "CUDA device")
    if table.dtype != torch.int32 or addr.dtype != torch.int32:
        raise TypeError("lut_lookup_cuda: table and addr must be int32")
    if table.dim() != 2 or addr.dim() != 2 or addr.shape[1] != table.shape[0]:
        raise ValueError(f"lut_lookup_cuda: shapes table {tuple(table.shape)}"
                         f", addr {tuple(addr.shape)}")
    if not (table.is_contiguous() and addr.is_contiguous()):
        raise ValueError("lut_lookup_cuda: inputs must be contiguous")
    b, u = addr.shape
    t = table.shape[1]
    out = torch.empty((b, u), dtype=torch.int32, device=addr.device)
    if b == 0 or u == 0:
        return out
    unit_tile, block_b, staged = tile_shape(t)
    lib = build.library("lut_kernels")
    with torch.cuda.device(addr.device):
        stream = torch.cuda.current_stream(addr.device).cuda_stream
        err = lib.lut_lookup_launch(table.data_ptr(), addr.data_ptr(),
                                    out.data_ptr(), b, u, t, unit_tile,
                                    block_b, int(staged), stream)
    build.check(err, "lut_lookup")
    LAUNCHES.add()
    return out


def lut_lookup(table: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if addr.device.type == "cpu":
        return lut_lookup_plain(table, addr)
    return lut_lookup_cuda(table, addr)
