"""Mixture-of-Experts FFN with static-shape capacity routing
(``repro.models.moe``).

Top-k token-choice routing, per group (one batch row is one group, the
GShard formulation the reference chose so that dispatch stays local to a
data-parallel shard):

  1. router logits -> the top-k experts of each token (f32 softmax over
     the k);
  2. the position of each (token, k) in its expert by a cumsum in flat
     ``(token, k)`` order; a token beyond ``capacity = group_tokens * top_k
     * capacity_factor / n_experts`` (rounded up to 8, at least 8) is
     dropped: neither dispatched nor combined;
  3. a dispatch table ``[E, C]`` of token indices gathers the token vectors,
     and the experts run as batched products over ``[B, E, C, D]``;
  4. the weighted expert outputs go back to their tokens.

Two choices make the card's answers repeat run to run: the top k come from
a stable descending sort, so tied logits pick the lower expert as
``jax.lax.top_k`` does (``torch.topk`` promises no order among ties); and
each token sums its (at most k) contributions in a fixed order, ascending
expert, where the reference scatter-adds (``index_add_`` on CUDA
accumulates with atomics in no fixed order).  The reference computes the
experts outside any Pallas kernel; so does the port.  The reference's
docstring figure of 281 s (a collective term of ``dbrx-132b`` on a
multi-pod TPU mesh) is the TPU's, not the port's.

The auxiliary load-balancing loss (Switch-style) is returned alongside.

On a tensor-parallel view (``lm.tp_view``) the weights keep the
reference's placements: the router is replicated and reads whole rows, so
every rank computes the same logits, dispatch and combine weights (and
the aux loss, whose gradient :func:`act_sharding.share_model` counts once);
``w_up``/``w_gate`` give this rank's hidden units of every expert, which
are gathered over ``model`` before ``w_down``, whose column shard gives
this rank's ``d`` columns of each expert's output, and the combine runs on
those columns, so the output lands on the residual's ``embed`` shard.  The
gathered hidden units are ``E * C`` rows a group, about
``top_k * capacity_factor`` times the group's tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from repro_torch.dist import act_sharding
from repro_torch.dist.act_sharding import constrain
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class MoESpec:
    """Widths, routing and capacity of one MoE layer."""

    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    act: str = "silu"
    gated: bool = True
    capacity_factor: float = 1.25


class MoE(nn.Module):
    """One layer's weights: ``router [d, E]``, ``w_up``/``w_gate [E, d,
    f]``, ``w_down [E, f, d]`` (uninitialised until filled)."""

    def __init__(self, spec: MoESpec, *, device=None, dtype=torch.float32):
        """Allocate the weights of ``spec`` on ``device`` in ``dtype``."""
        super().__init__()
        d, f, e = spec.d_model, spec.d_ff, spec.n_experts

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.router = param(d, e)
        self.w_up = param(e, d, f)
        self.w_down = param(e, f, d)
        self.w_gate = param(e, d, f) if spec.gated else None


def init_moe(generator: torch.Generator, spec: MoESpec, *,
             device=None) -> MoE:
    """One layer's weights, He-initialised from ``generator`` (fan-in on
    the axis before the last, as the reference's ``in_axis=-2``)."""
    p = MoE(spec, device=device)
    for name in ("router", "w_up", "w_down", "w_gate"):
        w = getattr(p, name)
        if w is not None:
            w.copy_(layers.he_init(generator, w.shape, device=device))
    return p


def capacity(spec: MoESpec, group_tokens: int) -> int:
    """Slots an expert holds for a group of ``group_tokens`` tokens: the
    even share times ``capacity_factor``, rounded up to 8, at least 8."""
    c = int(group_tokens * spec.top_k * spec.capacity_factor
            / spec.n_experts)
    return max(8, -(-c // 8) * 8)


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of the last axis and their indices, ties
    broken by the lower index (``jax.lax.top_k``'s rule), from a stable
    descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _group_dispatch(spec: MoESpec, cap: int, logits: torch.Tensor):
    """Routing of every group at once. logits ``[B, S, E]`` f32 ->
    (dispatch ``[B, E, C]`` token index, S where a slot is empty;
    combine_w ``[B, E, C]`` f32; slot ``[B, S, k]``, the flat index
    ``e * C + pos`` of each (token, k) in the expert outputs, ``E * C``
    where it was dropped, each token's k in ascending expert order; aux
    ``[B]``)."""
    b, s, e = logits.shape
    k = spec.top_k
    dev = logits.device
    logits = constrain(logits, "batch", None, None)
    gate_vals, gate_idx = top_k(logits, k)                        # [B, S, k]
    gate_w = torch.softmax(gate_vals, dim=-1)

    probs = torch.softmax(logits, dim=-1)
    top1 = nn.functional.one_hot(gate_idx[..., 0], e).float()
    aux = e * torch.sum(top1.mean(1) * probs.mean(1), dim=-1)     # [B]

    flat_expert = gate_idx.reshape(b, s * k)                      # [B, S*k]
    onehot = nn.functional.one_hot(flat_expert, e)                # int64
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)               # [B, S*k]
    keep = pos < cap
    flat_token = torch.arange(s, device=dev).repeat_interleave(k)
    slot = torch.where(keep, flat_expert * cap + pos,
                       torch.full_like(pos, e * cap))             # [B, S*k]
    dispatch = torch.full((b, e * cap + 1), s, dtype=torch.long, device=dev)
    dispatch.scatter_(1, slot, flat_token.expand(b, -1))
    combine_w = torch.zeros((b, e * cap + 1), device=dev)
    combine_w.scatter_(1, slot, gate_w.reshape(b, s * k))
    # each (expert, pos) is held by one (token, k) at most, so the scatters
    # write each kept slot once; column E * C collects the dropped ones
    order = gate_idx.argsort(dim=-1)
    slot = slot.reshape(b, s, k).gather(2, order)
    return (constrain(dispatch[:, :e * cap].reshape(b, e, cap),
                      "batch", None, None),
            constrain(combine_w[:, :e * cap].reshape(b, e, cap),
                      "batch", None, None), slot, aux)


def apply_moe(p: MoE, spec: MoESpec, x: torch.Tensor,
              router_fn: Optional[Callable[[torch.Tensor], torch.Tensor]]
              = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, S, D]`` -> (y ``[B, S, D]`` in x's type, aux loss f32).

    ``router_fn(x [B*S, D]) -> [B*S, E]`` replaces the dense router: the
    hook where a folded NeuraLUT-Assemble router plugs in, so that routing
    costs no matmul."""
    b, s, d = x.shape
    dt = x.dtype
    e = spec.n_experts
    cap = capacity(spec, s)
    if router_fn is not None:
        logits = router_fn(x.reshape(b * s, d)).float().reshape(b, s, e)
    else:
        logits = (x @ p.router.to(dt)).float()
    dispatch, combine_w, slot, aux = _group_dispatch(spec, cap, logits)

    rows = torch.arange(b, device=x.device)[:, None]
    # every per-token tensor stays on the batch's sharding, as the
    # reference pins it
    xpad = constrain(torch.cat([x, x.new_zeros((b, 1, d))], dim=1),
                     "batch", None, None)                         # [B, S+1, D]
    xe = constrain(xpad[rows, dispatch.reshape(b, e * cap)].reshape(
        b, e, cap, d), "batch", None, None, None)
    act = layers.activation(spec.act)
    up = torch.einsum("becd,edf->becf", xe, p.w_up.to(dt))
    if spec.gated:
        h = act(torch.einsum("becd,edf->becf", xe, p.w_gate.to(dt))) * up
    else:
        h = act(up)
    h = act_sharding.gather_model(h, spec.d_ff, "moe ffn")
    ye = constrain(torch.einsum("becf,efd->becd", h, p.w_down.to(dt)),
                   "batch", None, None, None)
    do = ye.shape[-1]               # d, or this rank's columns of it
    weighted = (ye * combine_w[..., None].to(dt)).reshape(b, e * cap, do)
    weighted = torch.cat([weighted, weighted.new_zeros((b, 1, do))], dim=1)
    # every token's k contributions, summed in f32 in a fixed order
    parts = weighted[rows, slot.reshape(b, s * spec.top_k)].float()
    parts = parts.reshape(b, s, spec.top_k, do)
    out = parts[:, :, 0]
    for j in range(1, spec.top_k):
        out = out + parts[:, :, j]
    return constrain(out.to(dt), "batch", None, None), \
        act_sharding.share_model(aux.mean())
