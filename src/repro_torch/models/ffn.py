"""Feed-forward blocks (``repro.models.ffn``): gated (SwiGLU / GeGLU) and
plain (squared-ReLU)."""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.models import layers


@dataclasses.dataclass(frozen=True)
class FFNSpec:
    """Widths and activation of one feed-forward block."""

    d_model: int
    d_ff: int
    act: str = "silu"     # silu -> SwiGLU, gelu -> GeGLU, relu2 -> plain
    gated: bool = True


class FFN(nn.Module):
    """One layer's feed-forward weights: ``w_up [d, f]``, ``w_down [f, d]``
    and, when gated, ``w_gate [d, f]`` (uninitialised until filled)."""

    def __init__(self, spec: FFNSpec, *, device=None,
                 dtype=torch.float32):
        """Allocate the weights of ``spec`` on ``device`` in ``dtype``."""
        super().__init__()
        d, f = spec.d_model, spec.d_ff

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                                requires_grad=False)

        self.w_up = param(d, f)
        self.w_down = param(f, d)
        self.w_gate = param(d, f) if spec.gated else None


def init_ffn(generator: torch.Generator, spec: FFNSpec, *,
             device=None) -> FFN:
    """One layer's weights, He-initialised from ``generator``."""
    p = FFN(spec, device=device)
    for name in ("w_up", "w_down", "w_gate"):
        w = getattr(p, name)
        if w is not None:
            w.copy_(layers.he_init(generator, w.shape, device=device))
    return p


def apply_ffn(p: FFN, spec: FFNSpec, x: torch.Tensor) -> torch.Tensor:
    """``x [..., d]`` through the block, in x's type."""
    dt = x.dtype
    act = layers.activation(spec.act)
    up = x @ p.w_up.to(dt)
    if spec.gated:
        h = act(x @ p.w_gate.to(dt)) * up
    else:
        h = act(up)
    return h @ p.w_down.to(dt)
