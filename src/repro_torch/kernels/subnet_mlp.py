"""K4: one affine stage of many tiny per-unit MLPs,
``y[b,u,:] = x[b,u,:] @ w[u] + bias[u]`` with an optional ReLU.

Replaces ``repro/kernels/subnet_mlp.py`` ``unit_affine_pallas`` /
``_affine_kernel``, which packed a block of units into one grid step so the
MXU saw a batched contraction.  On Hopper the CUDA kernel
(``csrc/subnet_mlp.cu`` ``unit_affine_kernel``) runs one CTA per (unit,
batch tile, dout tile) with f32 FMAs outside the tensor cores, and sums
every output over ``k = 0..din-1`` in one fixed order, so one (unit, row)
gives the same float at any batch size.  At the paper's widths it is bound
by operations (dense layer 0 of ``mnist`` is 55.5 GFLOP per call).

Every subnet affine and skip edge of the training forward, the backward
``dx`` and the fold's enumeration run here.  :class:`UnitAffine` is the
gradient: ``dx`` reuses the kernel on ``w^T`` (after masking ``dy`` by
``y > 0`` when ``activate``); ``dw`` and ``db`` are plain PyTorch, as the
reference left its gradient to XLA outside Pallas.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel runs or
the wrapper raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import unit_affine_ref

LAUNCHES = build.counter("unit_affine")

MAX_UNITS = 65535            # the unit axis is the grid's y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def unit_affine_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, *,
                      activate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4 (``ref.unit_affine_ref``)."""
    return unit_affine_ref(x, w, b, activate=activate)


def unit_affine_cuda(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     activate: bool = False) -> torch.Tensor:
    """Launch K4.  x ``[B, U, din]`` with any strides (a stride-0 unit axis
    included), w ``[U, din, dout]`` with any strides, b ``[U, dout]`` or
    None, all f32 or all bf16 on one CUDA device -> ``[B, U, dout]``
    contiguous, in x's dtype."""
    tensors = [x, w] + ([] if b is None else [b])
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("unit_affine_cuda: x, w and b must be on one CUDA "
                         "device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError("unit_affine_cuda: x, w and b must all be float32 "
                        f"or all bfloat16 (got {[t.dtype for t in tensors]})")
    if x.dim() != 3 or w.dim() != 3 or w.shape[:2] != (x.shape[1],
                                                       x.shape[2]):
        raise ValueError(f"unit_affine_cuda: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    bsz, units, din = x.shape
    dout = w.shape[2]
    if b is not None:
        if b.shape != (units, dout):
            raise ValueError(f"unit_affine_cuda: bias {tuple(b.shape)} != "
                             f"{(units, dout)}")
        b = b.contiguous()
    if units > MAX_UNITS:
        raise ValueError(f"unit_affine_cuda: {units} units > {MAX_UNITS}")
    y = torch.empty((bsz, units, dout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = build.library("subnet_mlp")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.unit_affine_launch(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), bsz, units, din, dout, *x.stride(), *w.stride(),
            int(activate), _DTYPES[x.dtype], stream)
    build.check(err, "unit_affine")
    LAUNCHES.add()
    return y


def _affine(x, w, b, activate):
    if x.device.type == "cpu":
        return unit_affine_plain(x, w, b, activate=activate)
    return unit_affine_cuda(x, w, b, activate=activate)


class UnitAffine(torch.autograd.Function):
    """K4 (or its plain version on the CPU) with its gradient."""

    @staticmethod
    def forward(ctx, x, w, b, activate):
        """``y = relu?(x @ w + b)`` per unit."""
        y = _affine(x, w, b, activate)
        ctx.activate = activate
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w, y if activate else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        """dx through the kernel on ``w^T``; dw and db in plain PyTorch."""
        x, w, y = ctx.saved_tensors
        if ctx.activate:
            dy = torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype,
                                                    device=dy.device))
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _affine(dy, w.transpose(1, 2), None, False)
        if ctx.needs_input_grad[1]:
            if x.stride(1) == 0:       # dense mode: every unit reads one row
                dw = torch.einsum("bi,buo->uio", x[:, 0, :], dy)
            else:
                dw = torch.einsum("bui,buo->uio", x, dy)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(0)
        return dx, dw, db, None


def unit_affine(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *,
                activate: bool = False) -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors, with gradient."""
    return UnitAffine.apply(x, w, b, activate)
