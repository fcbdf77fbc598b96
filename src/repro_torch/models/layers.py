"""Shared primitives of the LM substrate (``repro.models.layers``).

Compute runs in the config's dtype (bf16 by default) with f32 master
weights and f32 norm statistics; every cast sits where the reference puts
it, because in bf16 the place of a rounding changes the numbers.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.dist import act_sharding


def he_init(generator: torch.Generator, shape: Sequence[int],
            in_axis: int = -2, device=None) -> torch.Tensor:
    """Normal f32 weights scaled by ``fan_in ** -0.5`` (fan-in on
    ``in_axis``), drawn from ``generator`` on ``device``."""
    fan_in = shape[in_axis]
    w = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    return w.normal_(generator=generator).mul_(fan_in ** -0.5)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, *, eps: float = 1e-6,
             plus_one: bool = False) -> torch.Tensor:
    """RMSNorm: statistics in f32, ``rsqrt`` and the weight cast to the
    working type, the products in the working type (the reference's order)."""
    dt = x.dtype
    ms = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(ms + eps).to(dt)
    w = scale.float()
    w = (1.0 + w if plus_one else w).to(dt)
    return x * inv * w


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm: mean and variance (``E[x^2] - mu^2``) in f32, the centring,
    scaling and shift in the working type (the reference's order)."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.square().mean(-1, keepdim=True) - mu.square()
    inv = torch.rsqrt(var + eps)
    y = (x - mu.to(dt)) * inv.to(dt)
    return y * scale.to(dt) + bias.to(dt)


def row_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   d: int) -> torch.Tensor:
    """:func:`layer_norm` of the residual ``x`` as whole ``d``-wide rows: on
    a tensor-parallel view ``x`` and the norm's ``d``-entry weights hold
    this rank's columns, and all three are gathered over ``model``."""
    gather = act_sharding.gather_model
    return layer_norm(gather(x, d, "rows"), gather(scale, d, "norm"),
                      gather(bias, d, "norm"))


def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    """Inverse rotary frequencies ``[head_dim // 2]``, f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """Rotate ``x [..., S, D]`` by absolute ``positions`` (broadcastable to
    ``[..., S]``), in f32, back to x's type."""
    dt = x.dtype
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


def sinusoidal_positions(length: int, dim: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal embeddings ``[length, dim]``, f32: sines
    then cosines of ``pos / 10000^(2i / dim)``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    idx = torch.arange(dim // 2, dtype=torch.float32, device=device)[None, :]
    angles = pos / (10_000.0 ** (2 * idx / dim))
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.square(F.relu(x))


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


_ACTIVATIONS = {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu,
                "relu2": _relu2}


def activation(name: str):
    """The activation ``name``: silu, gelu (tanh approximation), relu or
    relu2 (squared ReLU)."""
    if name not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {name!r}")
    return _ACTIVATIONS[name]


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, *,
                 dtype=torch.bfloat16,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` in ``dtype``, times ``scale`` rounded to
    ``dtype`` first (gemma's sqrt(2048) is 45.25 in bf16)."""
    y = table[ids].to(dtype)
    if scale is not None:
        y = y * torch.tensor(scale, dtype=dtype, device=y.device)
    return y


def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """``vocab`` rounded up to a multiple of ``multiple``."""
    return ((vocab + multiple - 1) // multiple) * multiple
