"""Plain PyTorch oracles for the per-layer lookup (``repro.kernels.ref``)."""
from __future__ import annotations

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
