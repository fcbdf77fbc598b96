"""Plain PyTorch oracles for the kernels (``repro.kernels.ref``)."""
from __future__ import annotations

from typing import Optional

import torch


def lut_lookup_ref(table: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """``out[b, u] = table[u, addr[b, u]]``; table ``[U, T]``, addr
    ``[B, U]`` -> ``[B, U]`` (a gather along the entries axis)."""
    return torch.gather(table, 1, addr.t().to(torch.int64)).t().contiguous()


def lut_lookup_onehot_ref(table: torch.Tensor,
                          addr: torch.Tensor) -> torch.Tensor:
    """The one-hot formulation: ``onehot(addr) . table`` in float32, then
    rounded back to the table's integer type."""
    entries = table.shape[-1]
    onehot = torch.nn.functional.one_hot(addr.to(torch.int64),
                                         entries).to(torch.float32)
    out = torch.einsum("but,ut->bu", onehot, table.to(torch.float32))
    return torch.round(out).to(table.dtype)


def unit_affine_ref(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                    *, activate: bool = False) -> torch.Tensor:
    """One affine stage of the per-unit MLPs: x ``[batch, units, din]``, w
    ``[units, din, dout]``, b ``[units, dout]`` (or None) -> ``[batch,
    units, dout]``, ReLU'd when ``activate``."""
    y = torch.einsum("bui,uio->buo", x, w)
    if b is not None:
        y = y + b
    return torch.relu(y) if activate else y
