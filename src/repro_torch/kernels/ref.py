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
    """One affine stage of the per-unit MLPs: x ``[batch, units, din]`` or
    rows shared by every unit ``[batch, din]``, w ``[units, din, dout]``, b
    ``[units, dout]`` (or None) -> ``[batch, units, dout]``, ReLU'd when
    ``activate``.  Shared rows run as their stride-0 broadcast, so both
    forms give the same bits."""
    if x.dim() == 2:
        x = x[:, None, :].expand(x.shape[0], w.shape[0], x.shape[1])
    y = torch.einsum("bui,uio->buo", x, w)
    if b is not None:
        y = y + b
    return torch.relu(y) if activate else y


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: Optional[int] = None,
            q_offset: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Attention with a full softmax, in f32, KV repeated per group.

    q ``[B, Hq, Sq, D]``; k, v ``[B, Hkv, Skv, D]`` with ``Hq % Hkv == 0``.
    ``q_offset`` is the absolute position of ``q[:, :, 0]`` (``Skv - Sq``
    to decode); ``window`` the sliding-window size (None: full).  Returns
    ``[B, Hq, Sq, D]`` in q's type.
    """
    d = q.shape[-1]
    sq, skv = q.shape[2], k.shape[2]
    group = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
