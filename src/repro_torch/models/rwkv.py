"""RWKV-6 "Finch": linear attention with a data-dependent decay, in the
chunked form (``repro.models.rwkv``).

Within a chunk of C tokens the WKV contribution is two matrix products (an
intra-chunk lower-triangular score and a read of the carried state), and
the recurrent state ``[dk, dv]`` is carried across chunks one chunk at a
time: S / C sequential steps of a few batched products each, not S steps.
Decay products stay in log space; within-chunk ratio factors are clamped
at exp(80) (f32 headroom; contributions that deep into the decay are below
e^-80 anyway).

Recurrence (per head; k-dim d, v-dim m):
    o_t = r_t . (S_{t-1} + (u * k_t)^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t ,   w_t = exp(-exp(z_t)) in (0,1)

Token-shift "ddlerp" mixing, the LoRA decay projection, the per-head group
norm and the squared-ReLU channel mix follow the RWKV-6 architecture.
:func:`rwkv_block_lut_tm` puts a folded NeuraLUT-Assemble recurrent cell in
the WKV slot, and :func:`feature_stream` is the fixed trunk that the
``rwkv_mix_reduced`` stream task reads, drawn as the reference draws it.

On a tensor-parallel view (``lm.tp_view``) the layer keeps the reference's
placements: the residual holds this rank's ``embed`` columns, and the
norms and the lerps read whole rows (their ``d``-entry weights gathered
with them).  ``wr``/``wk``/``wv``/``wg`` give this rank's heads, and the
WKV, its state, ``u`` and the per-head group norm run on them; ``w_b``'s
column shard gives the local channels' decay (``w0`` its own).  Where the
heads do not split evenly, r, k, v and the decay are gathered whole and
every rank runs every head.  ``wo`` and ``cm_wv`` take gathered inputs
(the heads' output, the channel mix's hidden units), ``cm_wr`` gives
local columns.  ``ddl_b [r, 5d]`` is the one weight gathered whole: its
column shard splits across the five lerp deltas, each needed whole, and
the low-rank factor is far smaller than its ``[B, S, 5d]`` output.  The
state the layer returns holds the heads it ran (:func:`whole_state`
gathers it for the cache).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.dist import act_sharding
from repro_torch.dist.act_sharding import constrain
from repro_torch.models import layers

_CLAMP = 80.0


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    """Widths of one RWKV-6 layer."""

    d_model: int
    n_heads: int          # head_dim = d_model // n_heads
    d_ff: int
    chunk: int = 64
    lora_rank: int = 64
    decay_lora: int = 64

    @property
    def head_dim(self) -> int:
        """Channels of one head."""
        return self.d_model // self.n_heads


def _shapes(spec: RWKVSpec) -> dict:
    d, h, hd, f = spec.d_model, spec.n_heads, spec.head_dim, spec.d_ff
    r, dr = spec.lora_rank, spec.decay_lora
    return {
        "mu_x": (d,), "mu_w": (d,), "mu_k": (d,), "mu_v": (d,),
        "mu_r": (d,), "mu_g": (d,),
        "ddl_a": (d, r), "ddl_b": (r, 5 * d), "w0": (d,),
        "w_a": (d, dr), "w_b": (dr, d), "u": (h, hd),
        "wr": (d, d), "wk": (d, d), "wv": (d, d), "wg": (d, d), "wo": (d, d),
        "gn_scale": (h, hd), "gn_bias": (h, hd),
        "cm_mu_k": (d,), "cm_mu_r": (d,),
        "cm_wk": (d, f), "cm_wv": (f, d), "cm_wr": (d, d),
        "ln1": (d,), "ln1_b": (d,), "ln2": (d,), "ln2_b": (d,),
    }


# the reference's init, leaf by leaf: the index of its He draw among
# split(key, 16), or a constant; ddl_b and w_b are He draws times 0
_HE = {"ddl_a": 0, "ddl_b": 1, "w_a": 2, "w_b": 3, "wr": 4, "wk": 5,
       "wv": 6, "wg": 7, "wo": 8, "cm_wk": 9, "cm_wv": 10, "cm_wr": 11}
_ZEROED = ("ddl_b", "w_b")
_CONST = {"w0": -6.0, "gn_scale": 1.0, "ln1": 1.0, "ln2": 1.0}


class RWKVLayer(nn.Module):
    """One RWKV-6 layer's weights under the reference's leaf names (time
    mix, channel mix, the two pre-norms), uninitialised until filled."""

    def __init__(self, spec: RWKVSpec, *, device=None, dtype=torch.float32):
        """Allocate the weights of ``spec`` on ``device`` in ``dtype``."""
        super().__init__()
        for name, shape in _shapes(spec).items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, device=device, dtype=dtype),
                requires_grad=False))


def _fill_constants(p: RWKVLayer) -> RWKVLayer:
    for name, t in p.named_parameters():
        if name not in _HE:
            t.fill_(_CONST.get(name, 0.0))
        elif name in _ZEROED:
            t.zero_()
    return p


@torch.no_grad()
def init_rwkv_layer(generator: torch.Generator, spec: RWKVSpec, *,
                    device=None) -> RWKVLayer:
    """One layer by the reference's rules (He projections, zeroed LoRA
    outputs, base decay -6, unit norms) from ``generator``."""
    p = _fill_constants(RWKVLayer(spec, device=device))
    for name in _HE:
        if name not in _ZEROED:
            w = getattr(p, name)
            w.copy_(layers.he_init(generator, w.shape, device=device))
    return p


class RWKVState(NamedTuple):
    """One layer's recurrent state."""

    wkv: torch.Tensor        # [B, H, dk, dv] f32
    shift_tm: torch.Tensor   # [B, D] last token input (time mix)
    shift_cm: torch.Tensor   # [B, D] last token input (channel mix)


def init_state(spec: RWKVSpec, batch: int, dtype=torch.bfloat16,
               device=None) -> RWKVState:
    """A zero state: the WKV state in f32, the token shifts in ``dtype``."""
    h, hd, d = spec.n_heads, spec.head_dim, spec.d_model
    return RWKVState(
        wkv=torch.zeros((batch, h, hd, hd), device=device),
        shift_tm=torch.zeros((batch, d), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, d), dtype=dtype, device=device))


def _ddlerp(p: RWKVLayer, x: torch.Tensor, xx: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
    """The data-dependent lerp: the five mixed streams (w, k, v, r, g)."""
    dt = x.dtype
    d = x.shape[-1]
    z = x + (xx - x) * _vec(p.mu_x, d).to(dt)
    ddl_b = act_sharding.gather_model(p.ddl_b, 5 * d, "ddl_b")
    delta = torch.tanh(z @ p.ddl_a.to(dt)) @ ddl_b.to(dt)
    deltas = torch.chunk(delta, 5, dim=-1)
    mus = (p.mu_w, p.mu_k, p.mu_v, p.mu_r, p.mu_g)
    return tuple(x + (xx - x) * (_vec(mu, d).to(dt) + dl)
                 for mu, dl in zip(mus, deltas))


def _vec(t: torch.Tensor, d: int) -> torch.Tensor:
    """A ``d``-entry weight whole (its shard gathered over ``model``)."""
    return act_sharding.gather_model(t, d, "norm")


def _decay(p: RWKVLayer, xw: torch.Tensor) -> torch.Tensor:
    """log(w) in (-inf, 0), f32: the data-dependent per-channel decay (on
    this rank's channels where ``w_b`` gives them)."""
    dt = xw.dtype
    d = xw.shape[-1]
    z = (torch.tanh(xw @ p.w_a.to(dt)) @ p.w_b.to(dt)).float()
    w0 = p.w0 if z.shape[-1] == d else act_sharding.own_piece(p.w0, d, 0)
    return -torch.exp(w0.float() + z)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV. r, k, v, logw ``[B, S, H, hd]`` f32; u ``[H, hd]``; s0
    ``[B, H, hd, hd]``.  Returns (o ``[B, S, H, hd]`` f32, final state).
    The chunk is ``min(chunk, S)`` (a decode step is one chunk of 1); a
    last partial chunk is zero-padded, which leaves the state unchanged."""
    b, s, h, hd = r.shape
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    nc = r.shape[1] // c

    def to_chunks(a):  # [B, S, H, hd] -> [nc, B, H, C, hd]
        return a.reshape(b, nc, c, h, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, logw))
    lw_cum = torch.cumsum(lwc, dim=3)                 # inclusive
    lw_excl = lw_cum - lwc                            # exclusive
    lw_tot = lw_cum[:, :, :, -1:, :]                  # [nc, B, H, 1, hd]
    # factored intra-chunk scores: a_i = r_i e^{lw_excl_i}, b_j = k_j e^{-lw_cum_j}
    a_fac = rc * torch.exp(lw_excl)
    b_fac = kc * torch.exp(torch.clamp(-lw_cum, max=_CLAMP))
    diag_c = torch.sum(rc * u[None, None, :, None, :] * kc, dim=-1)
    # state-update factors: kk_j = k_j e^{lw_tot - lw_cum_j}
    kk = kc * torch.exp(lw_tot - lw_cum)
    decay = torch.exp(lw_tot[:, :, :, 0, :, None])    # [nc, B, H, hd, 1]
    tri = torch.tril(torch.ones((c, c), device=r.device), -1)

    state, outs = s0, []
    for i in range(nc):
        ra, vv = a_fac[i], vc[i]
        att = (ra @ b_fac[i].transpose(-1, -2)) * tri
        outs.append(ra @ state + att @ vv + diag_c[i][..., None] * vv)
        state = decay[i] * state + kk[i].transpose(-1, -2) @ vv
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, nc * c, h, hd)
    return o[:, :s], state


def _shifted(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    return torch.cat([shift[:, None, :].to(x.dtype), x[:, :-1]], dim=1)


def _head_split(spec: RWKVSpec, r, k, v, logw):
    """(r, k, v, logw on the heads this rank runs, those heads): this
    rank's where the projections hold its columns and the heads split
    evenly over ``model``, else every head (pieces gathered whole)."""
    d, hd = spec.d_model, spec.head_dim
    if r.shape[-1] != d and spec.n_heads % act_sharding.model_group()[1]:
        r, k, v, logw = (act_sharding.gather_model(t, d, "rkv")
                         for t in (r, k, v, logw))
    first = 0 if r.shape[-1] == d else act_sharding.chunk(d)[0] // hd
    return r, k, v, logw, slice(first, first + r.shape[-1] // hd)


def time_mix(p: RWKVLayer, spec: RWKVSpec, x: torch.Tensor,
             shift: torch.Tensor, s0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x ``[B, S, D]``; ``shift [B, D]`` the last token of the previous
    segment; ``s0`` the WKV state of every head (or of the heads this rank
    runs).  Returns (out ``[B, S, D]``, or this rank's columns of it; new
    shift; final WKV state of the heads it ran)."""
    b, s, d = x.shape
    hd = spec.head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, _shifted(x, shift))
    dt = x.dtype
    r, k, v, logw, heads = _head_split(
        spec, xr @ p.wr.to(dt), xk @ p.wk.to(dt), xv @ p.wv.to(dt),
        _decay(p, xw))
    g = F.silu(xg @ p.wg.to(dt))
    h = heads.stop - heads.start
    r, k, v, logw = (constrain(t.reshape(b, s, h, hd),
                               "batch", None, "heads_tp", None)
                     for t in (r, k, v, logw))
    if s0.shape[1] != h:
        s0 = s0[:, heads]
    o, s_fin = wkv_chunked(r.float(), k.float(), v.float(), logw,
                           p.u[heads].float(), s0, spec.chunk)
    o = layers.layer_norm(o, p.gn_scale[heads], p.gn_bias[heads])
    o = o.reshape(b, s, h * hd).to(dt)
    if o.shape[-1] != g.shape[-1]:      # every head run, g this rank's
        o = act_sharding.model_slice(o, -1)
    o = act_sharding.gather_model(o * g, d, "rwkv heads")
    return o @ p.wo.to(dt), x[:, -1], s_fin


def channel_mix(p: RWKVLayer, spec: RWKVSpec, x: torch.Tensor,
                shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The squared-ReLU channel mix; returns (out, new shift)."""
    xx = _shifted(x, shift)
    dt = x.dtype
    d = x.shape[-1]
    xk = x + (xx - x) * _vec(p.cm_mu_k, d).to(dt)
    xr = x + (xx - x) * _vec(p.cm_mu_r, d).to(dt)
    hid = act_sharding.gather_model(torch.square(F.relu(xk @ p.cm_wk.to(dt))),
                                    spec.d_ff, "rwkv ffn")
    kv = hid @ p.cm_wv.to(dt)
    return torch.sigmoid(xr @ p.cm_wr.to(dt)) * kv, x[:, -1]


def rwkv_block(p: RWKVLayer, spec: RWKVSpec, x: torch.Tensor,
               state: RWKVState) -> Tuple[torch.Tensor, RWKVState]:
    """One RWKV layer (time mix + channel mix, each behind a LayerNorm).
    ``x`` is the residual, whole or (on a tensor-parallel view) this
    rank's columns, and so is the output; the token shifts come out
    whole, the WKV state on the heads this rank ran."""
    d = spec.d_model
    h1 = layers.row_layer_norm(x, p.ln1, p.ln1_b, d)
    att, new_tm, s_fin = time_mix(p, spec, h1, state.shift_tm, state.wkv)
    x = x + att
    h2 = layers.row_layer_norm(x, p.ln2, p.ln2_b, d)
    cm, new_cm = channel_mix(p, spec, h2, state.shift_cm)
    return constrain(x + cm, "batch", "act_seq", None), RWKVState(
        wkv=s_fin, shift_tm=new_tm, shift_cm=new_cm)


def whole_state(spec: RWKVSpec, state: RWKVState) -> RWKVState:
    """``state`` with the WKV state of every head: gathered over ``model``
    where it holds this rank's (a tensor-parallel step's), as the cache's
    spec places it."""
    return state._replace(wkv=act_sharding.gather_model(
        state.wkv, spec.n_heads, "rwkv state", dim=1))


# ---------------------------------------------------------------------------
# Assembled-LUT time mix: the WKV path replaced by a folded recurrent cell
# whose state lives in integer-code space
# ---------------------------------------------------------------------------

StepFn = Callable[[torch.Tensor, object], Tuple[torch.Tensor, object]]


def lut_time_mix(step_fn: StepFn, x: torch.Tensor, s0
                 ) -> Tuple[torch.Tensor, object]:
    """A per-step recurrent cell over ``x [B, S, n_in]``, in order.

    ``step_fn(x_t [B, n_in], s) -> (y_t [B, n_out], s_next)`` is the stream
    cell ABI: ``stream.cell.apply_step`` in training, or a wrapper over
    ``CompiledStreamCell.step`` (code-space state) in inference.  Returns
    ``(ys [B, S, n_out], s_final)``."""
    s, ys = s0, []
    for t in range(x.shape[1]):
        y, s = step_fn(x[:, t], s)
        ys.append(y)
    return torch.stack(ys, dim=1), s


def rwkv_block_lut_tm(p: RWKVLayer, spec: RWKVSpec, x: torch.Tensor,
                      shift_cm: torch.Tensor, step_fn: StepFn, s0
                      ) -> Tuple[torch.Tensor, object, torch.Tensor]:
    """The RWKV block with its time mix replaced by an assembled-LUT cell:
    the cell reads ``LN(x_t)`` and its own state, and its per-step output
    (``n_out == d_model``) takes the WKV output's residual slot; the
    channel mix is unchanged.  Returns ``(out [B, S, D], the cell's final
    state, the new channel-mix shift)``."""
    h1 = layers.layer_norm(x, p.ln1, p.ln1_b)
    att, s_fin = lut_time_mix(step_fn, h1, s0)
    if att.shape[-1] != x.shape[-1]:
        raise ValueError(
            f"cell n_out {att.shape[-1]} != d_model {x.shape[-1]}")
    x = x + att.to(x.dtype)
    h2 = layers.layer_norm(x, p.ln2, p.ln2_b)
    cm, new_cm = channel_mix(p, spec, h2, shift_cm)
    return x + cm, s_fin, new_cm


@torch.no_grad()
def reference_layer(spec: RWKVSpec, seed: int, device=None) -> RWKVLayer:
    """The layer ``repro.models.rwkv.init_rwkv_layer(PRNGKey(seed), spec,
    1)[0]`` draws, from the port's numpy Threefry (``data.jax_prng``): its
    He draws equal JAX's to within 3 f32 ulps (see that module)."""
    from repro_torch.data import jax_prng
    keys = jax_prng.split(jax_prng.prng_key(seed), 16)
    p = _fill_constants(RWKVLayer(spec, device=device))
    for name, i in _HE.items():
        if name not in _ZEROED:
            w = getattr(p, name)
            draw = jax_prng.normal(keys[i], (1,) + tuple(w.shape))[0]
            w.copy_(torch.from_numpy(draw * np.float32(w.shape[0] ** -0.5)))
    return p


@torch.no_grad()
def feature_stream(xs, *, n_heads: int = 2, seed: int = 0,
                   device="cpu") -> np.ndarray:
    """The fixed trunk features of the LUT time-mix task: ``xs [N, T, P]``
    through one RWKV block whose weights ``init_rwkv_layer`` draws from
    ``PRNGKey(seed)`` (``d_model = P``, chunk 16), in f32 on ``device``;
    returns the block outputs ``[N, T, P]`` as numpy f32."""
    xs = torch.as_tensor(np.asarray(xs, np.float32), device=device)
    n, _, d = xs.shape
    spec = RWKVSpec(d_model=d, n_heads=n_heads, d_ff=2 * d, chunk=16)
    p = reference_layer(spec, seed, device=xs.device)
    out, _ = rwkv_block(p, spec, xs,
                        init_state(spec, n, torch.float32, xs.device))
    return out.cpu().numpy()
