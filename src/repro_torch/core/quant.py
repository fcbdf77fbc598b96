"""Quantization boundaries and batch-norm (``repro.core.quant``).

Training: the learned-scale fake quantizer (:class:`Quantizer`,
:func:`fake_quant`, straight-through rounding) and batch-norm
(:class:`BatchNorm`, :func:`batchnorm_apply`).  Folded inference: the static
:class:`QuantSpec`, the hard quantizer to integer codes and its inverse, and
the address packing that turns ``F`` codes into one L-LUT address.

**Two forms of the quantizer, as in the reference.**  Training's
:func:`fake_quant` divides by ``s = exp(log_scale)`` with the log-scale a
traced parameter (``torch.exp`` and ``/``).  The hard quantizer below is the
deployed form, which both :func:`~repro_torch.core.assemble.apply_codes` and
folding use.

**The scale, to the last ulp.**  The reference serves through a jitted
executor that closes over the log-scale, so XLA constant-folds
``s = exp(log_scale)`` (correctly rounded to float32) and rewrites the
division by that constant into ``x * f32(1/s)``.  This module computes the
same two float32 numbers on the host (:func:`scale`) and applies them with
one float32 multiply per element, which rounds identically on the CPU and
on the card.  The reference's *eager* ``quantize_codes`` instead evaluates
XLA's polynomial ``exp`` and divides; the two reference paths disagree on
inputs within an ulp of a rounding midpoint (ROADMAP.md queue C).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of one quantization boundary."""

    bits: int
    signed: bool = True

    @property
    def levels(self) -> int:
        """Number of representable codes."""
        return 2 ** self.bits

    @property
    def qmin(self) -> int:
        """Smallest integer level."""
        return -(2 ** (self.bits - 1)) if self.signed else 0

    @property
    def qmax(self) -> int:
        """Largest integer level."""
        return 2 ** (self.bits - 1) - 1 if self.signed else 2 ** self.bits - 1


class Quantizer(nn.Module):
    """A learned-scale quantizer: one scalar ``log_scale`` parameter."""

    def __init__(self, log_scale: torch.Tensor):
        """Hold ``log_scale`` (a float32 scalar) as a parameter."""
        super().__init__()
        self.log_scale = nn.Parameter(log_scale)


def init_quant(spec: QuantSpec, init_scale: float = 1.0,
               device=None) -> Quantizer:
    """Parameters of a learned-scale quantizer (``log_scale = log(s0)``)."""
    del spec
    return Quantizer(torch.tensor(math.log(init_scale), dtype=torch.float32,
                                  device=device))


def _round_ste(x: torch.Tensor) -> torch.Tensor:
    """Round half to even with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def fake_quant(params: Quantizer, spec: QuantSpec,
               x: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s), qmin, qmax) * s`` with ``s = exp(log_scale)``
    and straight-through rounding.

    The clip is ``minimum(maximum(q, qmin), qmax)`` with tensor bounds: like
    ``jnp.clip`` it passes half the gradient where ``q`` equals a bound
    (``torch.clamp`` would pass all of it), which happens at every ReLU zero
    of an unsigned boundary.
    """
    s = torch.exp(params.log_scale)
    q = _round_ste(x / s)
    lo = torch.tensor(float(spec.qmin), dtype=q.dtype, device=q.device)
    hi = torch.tensor(float(spec.qmax), dtype=q.dtype, device=q.device)
    return torch.minimum(torch.maximum(q, lo), hi) * s


def fake_quant_dynamic(params, qmin, qmax, x: torch.Tensor) -> torch.Tensor:
    """:func:`fake_quant` with tensor clip bounds.

    ``params`` is a :class:`Quantizer` or a log-scale tensor; the log-scale,
    ``qmin`` and ``qmax`` broadcast against ``x``, so a candidate axis of a
    search population can carry its own scale and bit-width
    (``lut_trainer.population_forward``).  The clip passes half the
    gradient at a tie, to ``q`` and to the bound, as ``jnp.clip`` does, so
    a bound built from a trainable bit-width (:func:`beta_bounds`) gets its
    gradient through the saturation.  Equal to :func:`fake_quant` when the
    bounds are the spec's.
    """
    ls = params.log_scale if isinstance(params, Quantizer) else params
    s = torch.exp(ls)
    q = _round_ste(x / s)
    lo = torch.as_tensor(qmin, dtype=q.dtype, device=q.device)
    hi = torch.as_tensor(qmax, dtype=q.dtype, device=q.device)
    return torch.minimum(torch.maximum(q, lo), hi) * s


def beta_bounds(beta: torch.Tensor,
                signed: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable clip bounds ``2^beta`` levels wide for a trainable
    bit-width ``beta`` (the HGQ-LUT relaxation): ``[-2^(b-1), 2^(b-1)-1]``
    signed, ``[0, 2^b - 1]`` unsigned.  Fed to :func:`fake_quant_dynamic`
    the clip range, and so the loss, depends on ``beta``; promotion snaps it
    back to integers (:func:`round_beta`)."""
    levels = 2.0 ** beta
    if signed:
        return -levels / 2.0, levels / 2.0 - 1.0
    return torch.zeros_like(levels), levels - 1.0


def round_beta(beta, lo: int = 1, hi: int = 8) -> np.ndarray:
    """Learned bit-widths rounded (half to even) onto the integer grid
    ``[lo, hi]``, as an int64 numpy array."""
    if isinstance(beta, torch.Tensor):
        beta = beta.detach().cpu().numpy()
    return np.clip(np.rint(np.asarray(beta)), lo, hi).astype(np.int64)


class BatchNorm(nn.Module):
    """Batch-norm over all leading axes: ``gamma``/``beta`` parameters and
    the running ``mean``/``var`` as buffers."""

    def __init__(self, width: int, device=None):
        """Identity statistics and affine of ``width`` channels."""
        super().__init__()
        kw = dict(dtype=torch.float32, device=device)
        self.gamma = nn.Parameter(torch.ones(width, **kw))
        self.beta = nn.Parameter(torch.zeros(width, **kw))
        self.register_buffer("mean", torch.zeros(width, **kw))
        self.register_buffer("var", torch.ones(width, **kw))


def init_batchnorm(width: int, device=None) -> BatchNorm:
    """A fresh :class:`BatchNorm` (gamma 1, beta 0, mean 0, var 1)."""
    return BatchNorm(width, device=device)


def batchnorm_apply(bn: BatchNorm, x: torch.Tensor, *, training: bool,
                    momentum: float = 0.9, eps: float = 1e-5,
                    use_batch_stats: bool = True) -> torch.Tensor:
    """Batch-norm of ``x`` over all leading axes.

    When ``training`` the running statistics are refreshed in ``bn`` (an
    EMA of the detached batch mean and population variance), and the batch
    statistics normalize unless ``use_batch_stats=False`` (frozen-stats BN,
    which normalizes with the running statistics from before the refresh).
    Outside training the running statistics normalize and ``bn`` is left
    as it is.
    """
    mean, var = bn.mean, bn.var
    if training:
        axes = tuple(range(x.dim() - 1))
        bmean = x.mean(dim=axes)
        bvar = x.var(dim=axes, unbiased=False)
        bn.mean = momentum * mean + (1 - momentum) * bmean.detach()
        bn.var = momentum * var + (1 - momentum) * bvar.detach()
        if use_batch_stats:
            mean, var = bmean, bvar
    return (x - mean) * torch.rsqrt(var + eps) * bn.gamma + bn.beta


def _log_scale(params) -> np.float32:
    ls = (params.log_scale if isinstance(params, Quantizer)
          else params["log_scale"])
    if isinstance(ls, torch.Tensor):
        ls = ls.item()
    return np.float32(np.asarray(ls, np.float64))


def scale(params) -> Tuple[float, float]:
    """``(s, 1/s)`` as float32 values (returned as Python floats).

    ``params`` is a :class:`Quantizer` or ``{"log_scale": ...}``.
    ``s`` is ``exp(log_scale)`` correctly rounded to float32 and ``1/s`` the
    float32 quotient, exactly the constants the reference's jitted executor
    folds; both are exact in a Python float, so passing them as scalars to
    a float32 tensor op loses nothing.
    """
    s = np.float32(math.exp(float(_log_scale(params))))
    return float(s), float(np.float32(1.0) / s)


def quantize_codes(params, spec: QuantSpec,
                   x: torch.Tensor) -> torch.Tensor:
    """Hard-quantize to integer codes in ``[0, 2^bits)`` (int32).

    ``q = clip(round(x * (1/s)), qmin, qmax) - qmin``, rounding half to
    even like ``jnp.round``.
    """
    _, inv = scale(params)
    x = x.to(torch.float32)
    q = torch.clamp(torch.round(x * inv), spec.qmin, spec.qmax)
    return q.to(torch.int32) - spec.qmin


def dequantize_codes(params, spec: QuantSpec,
                     codes: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_codes` back to float32 values."""
    s, _ = scale(params)
    return (codes.to(torch.float32) + spec.qmin) * s


def recode(params_from: dict, spec_from: QuantSpec,
           params_to: dict, spec_to: QuantSpec,
           codes: torch.Tensor) -> torch.Tensor:
    """Re-quantize codes from one boundary to another (dequantize through
    the source scale, hard-quantize through the target scale)."""
    return quantize_codes(params_to, spec_to,
                          dequantize_codes(params_from, spec_from, codes))


def _place_weights(bits: int, fan_in: int,
                   device: torch.device) -> torch.Tensor:
    return (2 ** (bits * torch.arange(fan_in - 1, -1, -1, device=device))
            ).to(torch.int32)


def pack_address(codes: torch.Tensor, bits: int, fan_in: int) -> torch.Tensor:
    """Pack ``fan_in`` codes (last axis) of ``bits`` bits into one int32
    address; the first input occupies the most-significant bits."""
    if codes.shape[-1] != fan_in:
        raise ValueError(f"pack_address: last axis {codes.shape[-1]} != "
                         f"fan_in {fan_in}")
    w = _place_weights(bits, fan_in, codes.device)
    return (codes.to(torch.int32) * w).sum(dim=-1, dtype=torch.int32)


def unpack_address(addr: torch.Tensor, bits: int,
                   fan_in: int) -> torch.Tensor:
    """Inverse of :func:`pack_address`: ``[...] -> [..., fan_in]``."""
    shifts = bits * torch.arange(fan_in - 1, -1, -1, device=addr.device)
    mask = (1 << bits) - 1
    return (addr.to(torch.int64)[..., None] >> shifts).to(torch.int32) & mask


def all_codes(bits: int, fan_in: int,
              device: torch.device = torch.device("cpu")) -> torch.Tensor:
    """Every input-code combination, ``[2^(bits*fan_in), fan_in]`` int32."""
    n = 2 ** (bits * fan_in)
    return unpack_address(torch.arange(n, dtype=torch.int32, device=device),
                          bits, fan_in)
