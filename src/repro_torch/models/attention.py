"""GQA attention (``repro.models.attention``): the prefill path through the
flash kernel K5, and the ring-buffer decode path.

GQA keeps the reference's grouped layout ``[B, Hkv, G, S, hd]``: KV is
never repeated.  Prefill attention goes through ``kernels.ops.
flash_attention`` (K5 on the card, its plain version on the CPU), which
computes in f32 inside as the reference's Pallas kernel does; the
reference's model path used a pure-JAX scan of the same online softmax
that rounds ``p`` to the working type before the PV product, so in bf16
the two differ by a few ulps (ROADMAP C.3).

KV caches are ring buffers of length ``window`` (SWA archs) or the
context: slot(p) = p % W, with stored absolute positions giving the
validity and causality mask.  Decode attention is a plain einsum and
softmax over the ring, as the reference left it to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import layers

Positions = Union[range, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    """Shape and options of one attention layer."""

    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True
    window: Optional[int] = None
    rope: bool = True
    rope_theta: float = 10_000.0


class Attention(nn.Module):
    """One layer's attention weights: ``wq [d, H*hd]``, ``wk``/``wv
    [d, Hkv*hd]``, ``wo [H*hd, d]``, with qkv biases and q/k norms where
    the spec asks (uninitialised until filled)."""

    def __init__(self, spec: AttnSpec, *, device=None, dtype=torch.float32):
        """Allocate the weights of ``spec`` on ``device`` in ``dtype``."""
        super().__init__()
        d, h, hk, hd = spec.d_model, spec.n_heads, spec.n_kv_heads, \
            spec.head_dim

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.wq, self.wk, self.wv = param(d, h * hd), param(d, hk * hd), \
            param(d, hk * hd)
        self.wo = param(h * hd, d)
        self.bq = self.bk = self.bv = self.q_norm = self.k_norm = None
        if spec.qkv_bias:
            self.bq, self.bk, self.bv = param(h * hd), param(hk * hd), \
                param(hk * hd)
        if spec.qk_norm:
            self.q_norm, self.k_norm = param(hd), param(hd)


def init_attention(generator: torch.Generator, spec: AttnSpec, *,
                   device=None) -> Attention:
    """One layer's weights: He-initialised projections from ``generator``,
    zero biases, unit q/k norms."""
    p = Attention(spec, device=device)
    for name in ("wq", "wk", "wv", "wo"):
        w = getattr(p, name)
        w.copy_(layers.he_init(generator, w.shape, device=device))
    for name in ("bq", "bk", "bv"):
        if getattr(p, name) is not None:
            getattr(p, name).zero_()
    for name in ("q_norm", "k_norm"):
        if getattr(p, name) is not None:
            getattr(p, name).fill_(1.0)
    return p


def _positions_tensor(positions: Positions, device) -> torch.Tensor:
    if isinstance(positions, range):
        return torch.arange(positions.start, positions.stop, positions.step,
                            dtype=torch.int32, device=device)
    return positions


def _project_qkv(p: Attention, spec: AttnSpec, x: torch.Tensor,
                 positions: Positions, freqs: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x ``[B, S, D]`` -> q ``[B, Hkv, G, S, hd]``, k/v ``[B, Hkv, S, hd]``.
    ``positions``: shared ``[S]`` (a range or a tensor) or per-row ``[B, S]``
    absolute positions for rope."""
    b, s, _ = x.shape
    h, hk, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    g = h // hk
    dt = x.dtype
    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if spec.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = q.reshape(b, s, hk, g, hd).permute(0, 2, 3, 1, 4)
    k = k.reshape(b, s, hk, hd).permute(0, 2, 1, 3)
    v = v.reshape(b, s, hk, hd).permute(0, 2, 1, 3)
    if spec.qk_norm:
        q = layers.rms_norm(q, p.q_norm.to(dt))
        k = layers.rms_norm(k, p.k_norm.to(dt))
    if spec.rope and freqs is not None:
        pos = _positions_tensor(positions, x.device)
        if pos.dim() == 2:          # per-row absolute positions [B, S]
            qpos, kpos = pos[:, None, None, :], pos[:, None, :]
        else:                       # shared positions [S]
            qpos, kpos = pos[None, None, None], pos[None, None]
        q = layers.apply_rope(q, qpos, freqs)
        k = layers.apply_rope(k, kpos, freqs)
    return q, k, v


def flash_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, window: Optional[int], q_positions: Positions,
               k_positions: Positions) -> torch.Tensor:
    """Online-softmax attention in the grouped layout, through K5.

    q ``[B, Hkv, G, Sq, hd]``; k/v ``[B, Hkv, Skv, hd]``; returns
    ``[B, Hkv, G, Sq, hd]`` in q's type.  A causal or windowed call takes
    host-side ranges, ``k_positions = range(Skv)`` and ``q_positions =
    range(off, off + Sq)`` (K5 masks by ``q_offset``, so no device sync is
    needed to check them).  A call that is neither causal nor windowed
    masks nothing by position, so its positions may be tensors (whisper's
    encoder passes ``arange(S)``, its cross-attention ``full(Sq, Skv)``);
    every key must then be valid (``k_positions >= 0``), as every caller
    has it.
    """
    b, hk, g, sq, hd = q.shape
    skv = k.shape[2]
    if causal or window is not None:
        if not (isinstance(q_positions, range)
                and isinstance(k_positions, range)
                and k_positions == range(skv) and q_positions.step == 1
                and len(q_positions) == sq):
            raise NotImplementedError(
                "a causal or windowed flash_scan takes k_positions = "
                "range(Skv) and q_positions = range(offset, offset + Sq); "
                f"got {q_positions!r}, {k_positions!r}")
        q_offset = q_positions.start
    else:
        if len(q_positions) != sq or len(k_positions) != skv:
            raise ValueError(f"{len(q_positions)} q and {len(k_positions)} "
                             f"k positions for Sq {sq}, Skv {skv}")
        q_offset = 0
    o = ops.flash_attention(q.reshape(b, hk * g, sq, hd), k, v,
                            causal=causal, window=window, q_offset=q_offset)
    return o.view(b, hk, g, sq, hd)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """``[B, Hkv, G, S, hd]`` -> ``[B, S, H*hd]``."""
    b, hk, g, s, hd = o.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hk * g * hd)


def attention_train(p: Attention, spec: AttnSpec, x: torch.Tensor,
                    positions: Positions, freqs: Optional[torch.Tensor]
                    ) -> torch.Tensor:
    """Full-sequence attention (forward only). x ``[B, S, D]``."""
    q, k, v = _project_qkv(p, spec, x, positions, freqs)
    o = flash_scan(q, k, v, causal=spec.causal, window=spec.window,
                   q_positions=positions, k_positions=positions)
    return _merge_heads(o) @ p.wo.to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache (ring buffer)
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """One layer's ring cache (stacked ``[L, ...]`` outside)."""

    k: torch.Tensor          # [B, Hkv, W, hd]
    v: torch.Tensor          # [B, Hkv, W, hd]


def cache_length(spec: AttnSpec, context: int) -> int:
    """Ring length: the window for SWA archs, else the context."""
    return min(context, spec.window) if spec.window else context


def init_cache(spec: AttnSpec, batch: int, context: int,
               dtype=torch.bfloat16, device=None) -> KVCache:
    """A zeroed ring cache."""
    w = cache_length(spec, context)
    shape = (batch, spec.n_kv_heads, w, spec.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def prefill_to_cache(spec: AttnSpec, k: torch.Tensor, v: torch.Tensor,
                     seq_len: int, context: int) -> KVCache:
    """Pack full-sequence K/V ``[B, Hkv, S, hd]`` into the ring cache: the
    last W positions rolled so position p sits in slot p % W when the
    prompt reaches the ring length, else zero-padded after the prompt."""
    w = cache_length(spec, context)
    if seq_len >= w:
        shift = (seq_len - w) % w
        k_r = torch.roll(k[:, :, seq_len - w:], shift, dims=2)
        v_r = torch.roll(v[:, :, seq_len - w:], shift, dims=2)
    else:
        pad = (0, 0, 0, w - seq_len)
        k_r = torch.nn.functional.pad(k, pad)
        v_r = torch.nn.functional.pad(v, pad)
    return KVCache(k=k_r, v=v_r)


def cache_positions(seq_len: int, w: int, device=None) -> torch.Tensor:
    """Absolute position stored in each ring slot after prefill (-1: empty),
    shared across layers and batch rows."""
    slots = torch.arange(w, device=device)
    if seq_len >= w:
        base = seq_len - w
        pos = base + ((slots - base % w) % w)
    else:
        pos = torch.where(slots < seq_len, slots, -1)
    return pos.to(torch.int32)


def attention_prefill(p: Attention, spec: AttnSpec, x: torch.Tensor,
                      positions: range, freqs: Optional[torch.Tensor],
                      context: int) -> Tuple[torch.Tensor, KVCache]:
    """Prefill attention of one layer: output ``[B, S, D]`` and the ring
    cache of its K/V."""
    q, k, v = _project_qkv(p, spec, x, positions, freqs)
    o = flash_scan(q, k, v, causal=spec.causal, window=spec.window,
                   q_positions=positions, k_positions=positions)
    cache = prefill_to_cache(spec, k, v, x.shape[1], context)
    return _merge_heads(o) @ p.wo.to(x.dtype), cache


def attention_decode(p: Attention, spec: AttnSpec, x: torch.Tensor,
                     pos: torch.Tensor, freqs: Optional[torch.Tensor],
                     cache: KVCache, slot_positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x ``[B, 1, D]``; ``pos`` ``[B]`` int32 absolute
    positions (each row at its own position) or a scalar for lock-step
    decoding; ``slot_positions`` ``[B, W]`` (``[W]`` when pos is scalar),
    the absolute position in each ring slot after this token's update.
    Returns the output and a new cache (the input cache is not written)."""
    w = cache.k.shape[2]
    if pos.dim():                   # per-row positions [B]
        q, k, v = _project_qkv(p, spec, x, pos[:, None], freqs)
        hit = (torch.arange(w, dtype=torch.int32, device=x.device)[None, :]
               == (pos % w)[:, None])                       # [B, W]
        k_new = torch.where(hit[:, None, :, None], k[:, :, :1], cache.k)
        v_new = torch.where(hit[:, None, :, None], v[:, :, :1], cache.v)
        pos_q = pos[:, None]                                # [B, 1]
    else:
        q, k, v = _project_qkv(p, spec, x, pos[None], freqs)
        slot = (pos % w).reshape(1).long()
        k_new = cache.k.index_copy(2, slot, k)
        v_new = cache.v.index_copy(2, slot, v)
        pos_q = pos
    scale = spec.head_dim ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", q.float() * scale, k_new.float())
    mask = (slot_positions >= 0) & (slot_positions <= pos_q)
    if spec.window is not None:
        mask = mask & (slot_positions > pos_q - spec.window)
    mask = mask[:, None, None, None, :] if mask.dim() == 2 else mask
    s = torch.where(mask, s, torch.full((), -1e30, device=x.device))
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", prob, v_new.float())
    o = _merge_heads(o.to(x.dtype))
    return o @ p.wo.to(x.dtype), KVCache(k=k_new, v=v_new)


def cross_attention(p: Attention, spec: AttnSpec, x: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Encoder-decoder cross attention (whisper): q from ``x [B, S, D]``,
    k/v precomputed ``[B, Hkv, S_enc, hd]``; no mask, no rope.  One
    non-causal K5 launch on the card, at Sq = S (Sq = 1 when decoding)."""
    b, s, _ = x.shape
    hk, hd = spec.n_kv_heads, spec.head_dim
    g = spec.n_heads // hk
    dt = x.dtype
    q = x @ p.wq.to(dt)
    if spec.qkv_bias:
        q = q + p.bq.to(dt)
    q = q.reshape(b, s, hk, g, hd).permute(0, 2, 3, 1, 4)
    skv = k.shape[2]
    o = flash_scan(q, k, v, causal=False, window=None,
                   q_positions=range(skv, skv + s), k_positions=range(skv))
    return _merge_heads(o) @ p.wo.to(dt)


def project_kv(p: Attention, spec: AttnSpec, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The K/V projection alone (the cross-attention source): x ``[B, S,
    D]`` -> k, v ``[B, Hkv, S, hd]``."""
    b, s, _ = x.shape
    hk, hd = spec.n_kv_heads, spec.head_dim
    dt = x.dtype
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if spec.qkv_bias:
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    return (k.reshape(b, s, hk, hd).permute(0, 2, 1, 3),
            v.reshape(b, s, hk, hd).permute(0, 2, 1, 3))
