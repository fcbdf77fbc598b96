"""Selective SSM (Mamba-style), the second branch of hymba's hybrid blocks
(``repro.models.ssm``).

Diagonal state recurrence ``h_t = a_t * h_{t-1} + b_t`` with input-dependent
(a, b), the "selective scan", in the reference's chunked form: the state
``[B, di, n]`` is carried over chunks of C tokens one chunk at a time, and
inside a chunk a log-depth scan with the reference's ``combine`` does the
work.  The port runs the in-chunk scans of every chunk at once (log2(C)
Hillis-Steele steps over ``[B, nc, C, di, n]``) and then carries the state
across chunks, adding ``exp(a-prefix) * h`` to each chunk's local scan:
the same terms, one association apart, in f32.  Every exponent is a sum of
``dt * A <= 0`` over at most C tokens, so nothing overflows (a closed form
in ``exp(-cumsum)`` over the whole sequence would).  The reference's
docstring figure of 37.6 s (a memory roofline term of a hymba 32k prefill
on the TPU) is the TPU's, not the port's.  The depthwise causal conv
(kernel 4) is shifted adds with the last ``kernel - 1`` inputs carried.

    x_in  -> in_proj -> (x, z)
    x     -> causal depthwise conv -> silu
    dt    = softplus(x @ W_dt @ W_dt_out + bias);  B, C = x @ W_B, x @ W_C
    h_t   = exp(dt * A) h_{t-1} + dt * B * x_t      (A diagonal, negative)
    y     = C . h + D * x;   out = (y * silu(z)) @ out_proj

On a tensor-parallel view (``lm.tp_view``) the branch runs on this rank's
``d_inner`` channels (the scan is per channel), the weights under the
reference's placements: ``in_proj``'s column shard gives this rank's
columns of ``xs | z``, which one all-to-all re-pairs into its channels of
each (``act_sharding.pair_halves``); the conv, dt, scan and skip read
their rows or entries of each per-channel leaf (a sharded one as it is
placed, a replicated one sliced); the products with the replicated
``w_dt``, ``w_b`` and ``w_c`` are partial sums over channels, summed over
``model`` in f32 (``[B, S, 64]`` and ``[B, S, 16]``); ``y`` is gathered
over ``d_inner`` before ``out_proj``, whose column shard gives this rank's
``d`` columns.  The state it returns holds this rank's channels
(:func:`whole_state` gathers it for the cache).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.dist import act_sharding
from repro_torch.dist.act_sharding import constrain
from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    """Widths of one selective-SSM branch."""

    d_model: int
    d_inner: int
    d_state: int = 16
    conv_kernel: int = 4
    dt_rank: int = 64


class SSM(nn.Module):
    """One layer's weights under the reference's leaf names
    (uninitialised until filled)."""

    def __init__(self, spec: SSMSpec, *, device=None, dtype=torch.float32):
        """Allocate the weights of ``spec`` on ``device`` in ``dtype``."""
        super().__init__()
        d, di, n, r = spec.d_model, spec.d_inner, spec.d_state, spec.dt_rank
        shapes = {"in_proj": (d, 2 * di), "conv_w": (spec.conv_kernel, di),
                  "conv_b": (di,), "w_dt": (di, r), "w_dt_out": (r, di),
                  "dt_bias": (di,), "w_b": (di, n), "w_c": (di, n),
                  "log_a": (di, n), "d_skip": (di,), "out_proj": (di, d)}
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype),
                requires_grad=False))


@torch.no_grad()
def init_ssm(generator: torch.Generator, spec: SSMSpec, *,
             device=None) -> SSM:
    """One layer by the reference's rules: He projections (the conv's
    fan-in is its kernel), zero conv bias, ``dt_bias = -4`` (a slow
    start), ``log(-A) = log([1..n])`` per channel (S4D-real), unit skip."""
    p = SSM(spec, device=device)
    for name in ("in_proj", "conv_w", "w_dt", "w_dt_out", "w_b", "w_c",
                 "out_proj"):
        w = getattr(p, name)
        w.copy_(layers.he_init(generator, w.shape,
                               in_axis=0 if name == "conv_w" else -2,
                               device=device))
    p.conv_b.zero_()
    p.dt_bias.fill_(-4.0)
    p.log_a.copy_(torch.log(torch.arange(
        1, spec.d_state + 1, dtype=torch.float32, device=device)).expand(
            spec.d_inner, -1))
    p.d_skip.fill_(1.0)
    return p


class SSMState(NamedTuple):
    """One layer's recurrent state."""

    h: torch.Tensor        # [B, d_inner, d_state] f32
    conv: torch.Tensor     # [B, conv_kernel - 1, d_inner] trailing inputs


def init_state(spec: SSMSpec, batch: int, dtype=torch.bfloat16,
               device=None) -> SSMState:
    """A zero state: h in f32, the conv's trailing inputs in ``dtype``."""
    return SSMState(
        h=torch.zeros((batch, spec.d_inner, spec.d_state), device=device),
        conv=torch.zeros((batch, spec.conv_kernel - 1, spec.d_inner),
                         dtype=dtype, device=device))


def _causal_conv(p, spec: SSMSpec, x: torch.Tensor,
                 conv_state: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv by shifted adds. x ``[B, S, di]``; returns
    (y, the last ``kernel - 1`` inputs, the next call's state)."""
    kk = spec.conv_kernel
    hist = torch.cat([conv_state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(kk):          # small static kernel: unrolled shifts
        y = y + hist[:, i:i + s] * p.conv_w[i].to(x.dtype)
    y = y + p.conv_b.to(x.dtype)
    return y, hist[:, hist.shape[1] - (kk - 1):]


def _combine(a1: torch.Tensor, b1: torch.Tensor, a2: torch.Tensor,
             b2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan's operator: (a1, b1) then (a2, b2) is (a1 + a2,
    exp(a2) b1 + b2), in log space for a."""
    return a1 + a2, torch.exp(a2) * b1 + b2


def selective_scan(a_log: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor,
                   chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan of ``h_t = exp(a_log_t) * h_{t-1} + bx_t``.

    a_log, bx ``[B, S, di, n]`` f32; h0 ``[B, di, n]``.  Returns (h_all
    ``[B, S, di, n]``, h_final).  Chunks of ``min(chunk, S)``; a last
    partial chunk is zero-padded (``a = 0, b = 0`` carries h unchanged)."""
    b, s, di, n = a_log.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        a_log = F.pad(a_log, (0, 0, 0, 0, 0, pad))
        bx = F.pad(bx, (0, 0, 0, 0, 0, pad))
    nc = a_log.shape[1] // c
    a = constrain(a_log.reshape(b, nc, c, di, n),
                  "batch", None, None, "tp", None)
    h = constrain(bx.reshape(b, nc, c, di, n),
                  "batch", None, None, "tp", None)
    # in-chunk inclusive scan of every chunk at once, log2(C) steps
    off = 1
    while off < c:
        a_new, h_new = _combine(a[:, :, :-off], h[:, :, :-off],
                                a[:, :, off:], h[:, :, off:])
        a = torch.cat([a[:, :, :off], a_new], dim=2)
        h = torch.cat([h[:, :, :off], h_new], dim=2)
        off *= 2
    # carry across chunks: chunk i adds exp(a-prefix) * (its incoming h)
    carry, outs = h0, []
    for i in range(nc):
        hi = torch.exp(a[:, i]) * carry[:, None] + h[:, i]
        outs.append(hi)
        carry = hi[:, -1]
    h_all = constrain(torch.stack(outs, dim=1).reshape(b, nc * c, di, n),
                      "batch", None, "tp", None)
    return h_all[:, :s], carry


class _Channels(NamedTuple):
    """The per-channel leaves of one layer on the channels it runs."""

    conv_w: torch.Tensor     # [k, di']
    conv_b: torch.Tensor     # [di']
    w_dt: torch.Tensor       # [di', r]
    w_dt_out: torch.Tensor   # [r, di']
    dt_bias: torch.Tensor    # [di']
    w_b: torch.Tensor        # [di', n]
    w_c: torch.Tensor        # [di', n]
    log_a: torch.Tensor      # [di', n]
    d_skip: torch.Tensor     # [di']


def _channels(p: SSM, di: int, local: bool) -> _Channels:
    """``p``'s per-channel leaves: as they are, or (``local``) on this
    rank's channels of ``di``."""
    dims = dict(conv_w=1, conv_b=0, w_dt=0, w_dt_out=1, dt_bias=0, w_b=0,
                w_c=0, log_a=0, d_skip=0)
    return _Channels(**{
        k: act_sharding.own_piece(getattr(p, k), di, d) if local
        else getattr(p, k) for k, d in dims.items()})


def _times(xs: torch.Tensor, w: torch.Tensor, local: bool, what: str
           ) -> torch.Tensor:
    """``xs @ w`` in xs's type; with ``local`` channels, each rank's
    partial sum in f32, summed over ``model``, then rounded once."""
    if not local:
        return xs @ w.to(xs.dtype)
    part = xs.float() @ w.float()
    return act_sharding.sum_partials(part, what).to(xs.dtype)


def apply_ssm(p: SSM, spec: SSMSpec, x: torch.Tensor, state: SSMState
              ) -> Tuple[torch.Tensor, SSMState]:
    """x ``[B, S, D]`` -> (y ``[B, S, D]``, the new state).  ``state`` may
    be whole or hold this rank's channels; the new state holds the
    channels the branch ran."""
    dt_ = x.dtype
    di = spec.d_inner
    xs, z = act_sharding.pair_halves(x @ p.in_proj.to(dt_), di,
                                     "ssm in_proj")              # [B, S, di]
    local = xs.shape[-1] != di
    w = _channels(p, di, local)
    xs, conv_new = _causal_conv(w, spec, xs, act_sharding.own_piece(
        state.conv, di, 2) if local else state.conv)
    xs = F.silu(xs)
    dt = F.softplus(_times(xs, w.w_dt, local, "ssm dt") @ w.w_dt_out.to(dt_)
                    + w.dt_bias.to(dt_)).float()                 # [B, S, di]
    bmat = _times(xs, w.w_b, local, "ssm b").float()             # [B, S, n]
    cmat = _times(xs, w.w_c, local, "ssm c").float()
    a = -torch.exp(w.log_a.float())                              # [di, n]
    a_log = dt[..., None] * a
    bx = (dt * xs.float())[..., None] * bmat[:, :, None, :]
    h0 = act_sharding.own_piece(state.h, di, 1) if local else state.h
    h_all, h_fin = selective_scan(a_log, bx, h0)
    y = torch.einsum("bsdn,bsn->bsd", h_all, cmat)
    y = y + w.d_skip.float() * xs.float()
    y = y.to(dt_) * F.silu(z)
    y = act_sharding.gather_model(y, di, "ssm channels")
    return y @ p.out_proj.to(dt_), SSMState(h=h_fin, conv=conv_new)


def whole_state(spec: SSMSpec, state: SSMState) -> SSMState:
    """``state`` on every channel: gathered over ``model`` where it holds
    this rank's (a tensor-parallel step's), as the cache's spec places
    it."""
    di = spec.d_inner
    return SSMState(
        h=act_sharding.gather_model(state.h, di, "ssm state", dim=1),
        conv=act_sharding.gather_model(state.conv, di, "ssm state"))
