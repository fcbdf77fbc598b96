"""K4: one affine stage of many tiny per-unit MLPs,
``y[b,u,:] = x[b,u,:] @ w[u] + bias[u]`` with an optional ReLU.

Replaces ``repro/kernels/subnet_mlp.py`` ``unit_affine_pallas`` /
``_affine_kernel``, which packed a block of units into one grid step so the
MXU saw a batched contraction.  On Hopper the CUDA kernels
(``csrc/subnet_mlp.cu``) run register-tiled f32 FMAs outside the tensor
cores, with operands staged by ``cp.async``, and sum every output over
``k = 0..din-1`` in one fixed order, so one (unit, row) gives the same float
at any batch size and through any input layout.  At the paper's widths the
dense stages are bound by operations (dense layer 0 of ``mnist`` is 55.5
GFLOP per call), the sparse ones by writing ``y``.

:func:`unit_affine_cuda` routes by x's layout, with no fallback:

* ``"dense"`` (:func:`route`): x is shared rows ``[B, din]`` or a
  ``[B, U, din]`` view whose unit axis has stride 0.  The kernel's column
  axis runs over ``(unit, dout)``, so one staged x tile serves many units.
* ``"units"``: every unit reads its own rows.

:class:`UnitAffine` is the gradient.  For shared rows ``dx`` is ``[B, din]``
straight from a reduction over units (:func:`unit_affine_dx_cuda`), which
never builds the ``[B, U, din]`` tensor; otherwise ``dx`` is the forward on
``w^T``.  ``dw`` and ``db`` are plain PyTorch, as the reference left its
gradient to XLA outside Pallas.  Every route counts its launches, and
``LAUNCHES`` counts them all.

:func:`unit_affine_reference_cuda` launches K4's first kernel, kept as the
bit-exact oracle of the others; no route reaches it.

On a CPU tensor the plain version runs; on a CUDA tensor a kernel runs or
the wrapper raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import unit_affine_ref

LAUNCHES = build.counter("unit_affine")              # every route below
DENSE_LAUNCHES = build.counter("unit_affine_dense")
UNITS_LAUNCHES = build.counter("unit_affine_units")
DX_LAUNCHES = build.counter("unit_affine_dx")
REFERENCE_LAUNCHES = build.counter("unit_affine_reference")

MAX_UNITS = 65535            # per-unit mode: the unit axis is the grid's z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def route(x: torch.Tensor) -> str:
    """``"dense"`` when every unit reads the same rows of x (shared rows
    ``[B, din]``, or a stride-0 unit axis), else ``"units"``."""
    return "dense" if x.dim() == 2 or x.stride(1) == 0 else "units"


def unit_affine_plain(x: torch.Tensor, w: torch.Tensor,
                      b: Optional[torch.Tensor] = None, *,
                      activate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4 (``ref.unit_affine_ref``)."""
    return unit_affine_ref(x, w, b, activate=activate)


def unit_affine_dx_plain(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of the dense gradient: ``dx[b, k] = sum_{u, n}
    dy[b, u, n] * w[u, k, n]``, ``[B, din]``."""
    return torch.einsum("buo,uio->bi", dy, w)


def _check(name: str, x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> Tuple[int, int, int, int,
                                               Tuple[int, int, int]]:
    """Validate K4's operands; returns ``(B, U, din, dout, x strides as
    (batch, unit, k))`` with a unit stride of 0 for shared rows."""
    tensors = [x, w] + ([] if b is None else [b])
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError(f"{name}: x, w and b must be on one CUDA device")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"{name}: x, w and b must all be float32 or all "
                        f"bfloat16 (got {[t.dtype for t in tensors]})")
    if w.dim() != 3 or x.dim() not in (2, 3) or \
            x.shape[-1] != w.shape[1] or \
            (x.dim() == 3 and x.shape[1] != w.shape[0]):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}")
    units, din, dout = w.shape
    if b is not None and b.shape != (units, dout):
        raise ValueError(f"{name}: bias {tuple(b.shape)} != {(units, dout)}")
    if x.dim() == 2:
        strides = (x.stride(0), 0, x.stride(1))
    else:
        strides = tuple(x.stride())
    return x.shape[0], units, din, dout, strides


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def unit_affine_cuda(x: torch.Tensor, w: torch.Tensor,
                     b: Optional[torch.Tensor] = None, *,
                     activate: bool = False) -> torch.Tensor:
    """Launch K4.  x shared rows ``[B, din]`` or ``[B, U, din]`` with any
    strides, w ``[U, din, dout]`` with any strides, b ``[U, dout]`` or None,
    all f32 or all bf16 on one CUDA device -> ``[B, U, dout]`` contiguous,
    in x's dtype.  The dense or per-unit kernel by :func:`route`."""
    bsz, units, din, dout, xs = _check("unit_affine_cuda", x, w, b)
    dense = route(x) == "dense"
    if not dense and units > MAX_UNITS:
        raise ValueError(f"unit_affine_cuda: {units} units > {MAX_UNITS}")
    b = None if b is None else b.contiguous()
    y = torch.empty((bsz, units, dout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    if dense and x.dtype == torch.float32 and bsz % 4 == 0:
        # the shared rows k-major ([din, B], 4 B * B * din): the kernel then
        # stages x by 16-byte copies
        x = (x if x.dim() == 2 else x[:, 0, :]).t().contiguous().t()
        xs = (1, 0, bsz)
    lib = build.library("subnet_mlp")
    with torch.cuda.device(x.device):
        err = lib.unit_affine_launch(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), bsz, units, din, dout, *xs, *w.stride(),
            int(activate), _DTYPES[x.dtype], _stream(x))
    build.check(err, "unit_affine")
    (DENSE_LAUNCHES if dense else UNITS_LAUNCHES).add()
    LAUNCHES.add()
    return y


def unit_affine_dx_cuda(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch K4's dense gradient: dy ``[B, U, dout]``, w ``[U, din, dout]``
    (any strides, both f32 or both bf16) -> dx ``[B, din]`` in dy's dtype.
    Partials over fixed chunks of units go to an f32 scratch and are added
    in index order, so dx has the same bits at any batch size."""
    if dy.dim() != 3:
        raise ValueError(f"unit_affine_dx_cuda: dy {tuple(dy.shape)} is not "
                         "[B, U, dout]")
    bsz, units, dout, din, ds = _check("unit_affine_dx_cuda", dy,
                                       w.transpose(1, 2), None)
    dx = torch.empty((bsz, din), dtype=dy.dtype, device=dy.device)
    if dx.numel() == 0:
        return dx
    lib = build.library("subnet_mlp")
    part = torch.empty((lib.unit_affine_dx_chunks(units), bsz, din),
                       dtype=torch.float32, device=dy.device)
    with torch.cuda.device(dy.device):
        err = lib.unit_affine_dx_launch(
            dy.data_ptr(), w.data_ptr(), part.data_ptr(), dx.data_ptr(), bsz,
            units, din, dout, *ds, *w.stride(), _DTYPES[dy.dtype],
            _stream(dy))
    build.check(err, "unit_affine_dx")
    DX_LAUNCHES.add()
    LAUNCHES.add()
    return dx


def unit_affine_reference_cuda(x: torch.Tensor, w: torch.Tensor,
                               b: Optional[torch.Tensor] = None, *,
                               activate: bool = False) -> torch.Tensor:
    """K4's first kernel, the bit-exact oracle of :func:`unit_affine_cuda`
    (same operands and result)."""
    bsz, units, din, dout, xs = _check("unit_affine_reference_cuda", x, w, b)
    if units > MAX_UNITS:
        raise ValueError(f"unit_affine_reference_cuda: {units} units > "
                         f"{MAX_UNITS}")
    b = None if b is None else b.contiguous()
    y = torch.empty((bsz, units, dout), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    lib = build.library("subnet_mlp")
    with torch.cuda.device(x.device):
        err = lib.unit_affine_reference_launch(
            x.data_ptr(), w.data_ptr(), None if b is None else b.data_ptr(),
            y.data_ptr(), bsz, units, din, dout, *xs, *w.stride(),
            int(activate), _DTYPES[x.dtype], _stream(x))
    build.check(err, "unit_affine_reference")
    REFERENCE_LAUNCHES.add()
    return y


def _affine(x, w, b, activate):
    if x.device.type == "cpu":
        return unit_affine_plain(x, w, b, activate=activate)
    return unit_affine_cuda(x, w, b, activate=activate)


def _dx_rows(dy, w):
    if dy.device.type == "cpu":
        return unit_affine_dx_plain(dy, w)
    return unit_affine_dx_cuda(dy, w)


class UnitAffine(torch.autograd.Function):
    """K4 (or its plain version on the CPU) with its gradient."""

    @staticmethod
    def forward(ctx, x, w, b, activate):
        """``y = relu?(x @ w + b)`` per unit; x ``[B, U, din]`` or shared
        rows ``[B, din]``."""
        y = _affine(x, w, b, activate)
        ctx.activate = activate
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w, y if activate else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        """dx ``[B, din]`` by the reduction over units for shared rows, else
        the forward on ``w^T``; dw and db in plain PyTorch."""
        x, w, y = ctx.saved_tensors
        if ctx.activate:
            dy = torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype,
                                                    device=dy.device))
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            if x.dim() == 2:
                dx = _dx_rows(dy, w)
            else:
                dx = _affine(dy, w.transpose(1, 2), None, False)
        if ctx.needs_input_grad[1]:
            if x.dim() == 2:             # shared rows
                dw = torch.einsum("bi,buo->uio", x, dy)
            elif x.stride(1) == 0:       # dense mode: every unit reads one row
                dw = torch.einsum("bi,buo->uio", x[:, 0, :], dy)
            else:
                dw = torch.einsum("bui,buo->uio", x, dy)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy.sum(0)
        return dx, dw, db, None


def unit_affine(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *,
                activate: bool = False) -> torch.Tensor:
    """K4 on CUDA tensors, its plain version on CPU tensors, with gradient.
    x is ``[B, U, din]`` or shared rows ``[B, din]``."""
    return UnitAffine.apply(x, w, b, activate)
