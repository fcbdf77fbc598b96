"""Integer-code half of the quantization boundary (``repro.core.quant``).

Only what folded inference needs: the static :class:`QuantSpec`, the hard
quantizer to integer codes and its inverse, and the address packing that
turns ``F`` codes into one L-LUT address.

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


def _log_scale(params: dict) -> np.float32:
    ls = params["log_scale"]
    if isinstance(ls, torch.Tensor):
        ls = ls.item()
    return np.float32(np.asarray(ls, np.float64))


def scale(params: dict) -> Tuple[float, float]:
    """``(s, 1/s)`` as float32 values (returned as Python floats).

    ``s`` is ``exp(log_scale)`` correctly rounded to float32 and ``1/s`` the
    float32 quotient, exactly the constants the reference's jitted executor
    folds; both are exact in a Python float, so passing them as scalars to
    a float32 tensor op loses nothing.
    """
    s = np.float32(math.exp(float(_log_scale(params))))
    return float(s), float(np.float32(1.0) / s)


def quantize_codes(params: dict, spec: QuantSpec,
                   x: torch.Tensor) -> torch.Tensor:
    """Hard-quantize to integer codes in ``[0, 2^bits)`` (int32).

    ``q = clip(round(x * (1/s)), qmin, qmax) - qmin``, rounding half to
    even like ``jnp.round``.
    """
    _, inv = scale(params)
    x = x.to(torch.float32)
    q = torch.clamp(torch.round(x * inv), spec.qmin, spec.qmax)
    return q.to(torch.int32) - spec.qmin


def dequantize_codes(params: dict, spec: QuantSpec,
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
