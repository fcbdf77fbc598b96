"""K3: one layer's batched L-LUT lookup, ``out[b,u] = table[u, addr[b,u]]``.

Replaces ``repro/kernels/lut_gather.py`` ``lut_lookup_pallas`` /
``_lut_kernel``, which contracted a one-hot tile with the table on the MXU.
On Hopper the lookup is an indexed load: the CUDA kernel
(``csrc/lut_kernels.cu`` ``lut_lookup_kernel``) is a barrier-free gather
over the flat ``[B * U]`` index: each thread loads four addresses as one
16-byte vector, reads their table entries through the read-only cache and
stores four codes as one vector.  Nothing is staged in shared memory and
there is no barrier: a layer's table (256 B a unit at nid's 64 entries) is
read where it lies, through L1 and L2.  Its byte floor is a fraction of a
microsecond, below any launch, so its yardstick is an empty kernel's
device time on the same card.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel runs or
the wrapper raises.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch import device as _device
from repro_torch.kernels import build
from repro_torch.kernels.ref import lut_lookup_ref

LAUNCHES = build.counter("lut_lookup")

VEC = 4                      # outputs a thread (one 16-byte addr/out vector)
MIN_THREADS = 32             # CTA sizes the plan picks from: powers of two
MAX_THREADS = 256            # (kLookupMaxThreads in the kernel)
MAX_OUTPUTS = 2 ** 31 - 2 ** 16   # B * U the kernel's int arithmetic takes


@dataclasses.dataclass(frozen=True)
class LookupPlan:
    """K3's launch: ``grid`` CTAs of ``threads`` threads, ``vec`` outputs a
    thread."""

    threads: int
    vec: int
    grid: int


@functools.lru_cache(maxsize=256)
def tile_shape(entries: int, units: int, batch: int, sms: int,
               aligned: bool = True) -> LookupPlan:
    """K3's launch for a ``[units, entries]`` table and ``batch`` rows on a
    card of ``sms`` SMs: :data:`VEC` outputs a thread where addr and out
    are 16-byte ``aligned`` (else 1), and the largest power-of-two CTA
    (:data:`MIN_THREADS` to :data:`MAX_THREADS`) that still gives every SM a
    CTA.  The table's width does not enter: there is no staged route (its
    reads go through the cache at every width the tests take, up to 32768
    entries)."""
    if min(entries, units, batch, sms) < 1:
        raise ValueError(f"lut_lookup: table [{units}, {entries}], batch "
                         f"{batch}, sms {sms}")
    n = units * batch
    if n > MAX_OUTPUTS:
        raise ValueError(f"lut_lookup: {n} outputs exceed {MAX_OUTPUTS}")
    vec = VEC if aligned else 1
    per_sm = -(-n // (vec * sms))
    threads = MIN_THREADS
    while threads * 2 <= min(MAX_THREADS, per_sm):
        threads *= 2
    return LookupPlan(threads=threads, vec=vec,
                      grid=-(-n // (threads * vec)))


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
    plan = tile_shape(t, u, b, _device.sm_count(addr.device.index or 0),
                      addr.data_ptr() % 16 == 0)
    lib = build.library("lut_kernels")
    with torch.cuda.device(addr.device):
        stream = torch.cuda.current_stream(addr.device).cuda_stream
        err = lib.lut_lookup_launch(table.data_ptr(), addr.data_ptr(),
                                    out.data_ptr(), b * u, u, t,
                                    plan.threads, plan.vec, plan.grid, stream)
    build.check(err, "lut_lookup")
    LAUNCHES.add()
    return out


def lut_lookup(table: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if addr.device.type == "cpu":
        return lut_lookup_plain(table, addr)
    return lut_lookup_cuda(table, addr)
