"""Dispatch over the kernels (the port of ``repro.kernels.ops``).

Dispatch is by the tensors' device, in place of the reference's
``on_tpu``/``pallas_interpret``: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the kernel's plain PyTorch version.  There is no
path that swaps a kernel for its plain version on a CUDA tensor: a kernel
that fails to build or launch raises.

* :func:`lut_lookup` -- ``take`` (gather oracle), ``onehot`` (one-hot
  formulation) or ``pallas`` (K3).
* :func:`lut_cascade` -- the fused cascade behind the ``fused`` backend:
  K1 or K2 by the plan's tuning and the shared-memory fit, or the plain
  cascade where the plan pins ``impl="xla"`` (as in the reference, where
  ``"xla"`` is not a kernel).
* :func:`unit_affine` -- one affine stage of the per-unit MLPs: K4 on CUDA
  tensors, the plain einsum on CPU tensors (``impl=None``); ``"einsum"``
  pins the plain version, ``"pallas"`` pins K4.
* :func:`flash_attention` -- blockwise attention: K5 on CUDA tensors, the
  plain ``mha_ref`` on CPU tensors (``impl=None``); ``"ref"`` pins the
  plain version, ``"pallas"`` pins K5.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import autotune, lut_cascade as _lc, lut_gather, ref
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import subnet_mlp


def lut_lookup(table: torch.Tensor, addr: torch.Tensor, *,
               impl: str = "take") -> torch.Tensor:
    """Batched L-LUT lookup. table ``[U, T]``, addr ``[B, U]`` -> ``[B, U]``."""
    if impl == "take":
        return ref.lut_lookup_ref(table, addr)
    if impl == "onehot":
        return ref.lut_lookup_onehot_ref(table, addr)
    if impl == "pallas":
        return lut_gather.lut_lookup(table, addr)
    raise ValueError(f"unknown lut_lookup impl {impl!r}")


def lut_cascade(codes: torch.Tensor, amat, tables: torch.Tensor, *,
                layers, mappings=None, tuning=None,
                operands: Optional[_lc.CascadeOperands] = None
                ) -> torch.Tensor:
    """Whole-network fused cascade.

    ``amat`` is accepted for the reference's signature and ignored: the
    kernels form addresses from ``mappings``.  ``tuning`` is a
    :class:`~repro_torch.kernels.autotune.KernelTuning` or its meta dict.
    ``operands`` are the kernels' packed inputs (:func:`lut_cascade.prepare`)
    when the caller caches them.
    """
    del amat
    t = tuning if isinstance(tuning, autotune.KernelTuning) \
        else autotune.KernelTuning.from_meta(tuning)
    if t.impl not in (None, "xla", "pallas"):
        raise ValueError(f"unknown lut_cascade impl {t.impl!r}")
    if t.mode not in ("resident", "streamed"):
        raise ValueError(f"unknown lut_cascade mode {t.mode!r}")
    layers = tuple(tuple(int(v) for v in l) for l in layers)
    if not _lc.is_v2_layers(layers) or mappings is None:
        raise ValueError("lut_cascade needs v2 layer metadata and mappings "
                         "(re-plan the backend)")
    if codes.device.type == "cpu" or t.impl == "xla":
        return _lc.lut_cascade_plain(codes, tables, mappings, layers)
    if operands is None:
        operands = _lc.prepare(tables, layers, mappings)
    codes = codes.to(torch.int32).contiguous()
    mode = t.mode
    if mode == "resident" and autotune.hopper_mode(
            layers, tables.element_size()) != "resident":
        mode = "streamed"
    if mode == "resident":
        return _lc.lut_cascade_resident(codes, operands)
    return _lc.lut_cascade_streamed(codes, operands, unit_tile=t.unit_tile)


def unit_affine(x: torch.Tensor, w: torch.Tensor,
                b: Optional[torch.Tensor] = None, *, activate: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
    """x ``[B, U, din]``, w ``[U, din, dout]``, b ``[U, dout]`` ->
    ``[B, U, dout]``.  ``impl=None`` dispatches by device (K4 on CUDA, plain
    on the CPU); ``"einsum"`` always runs the plain version; ``"pallas"``
    is K4 and raises on the CPU."""
    if impl is None:
        return subnet_mlp.unit_affine(x, w, b, activate=activate)
    if impl == "einsum":
        return ref.unit_affine_ref(x, w, b, activate=activate)
    if impl == "pallas":
        if x.device.type != "cuda":
            raise ValueError("unit_affine impl='pallas' is the CUDA kernel "
                             "and needs CUDA tensors")
        return subnet_mlp.UnitAffine.apply(x, w, b, activate)
    raise ValueError(f"unknown unit_affine impl {impl!r}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0,
                    impl: Optional[str] = None) -> torch.Tensor:
    """q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]`` -> ``[B, Hq, Sq, D]``.
    ``impl=None`` dispatches by device (K5 on CUDA, plain on the CPU);
    ``"ref"`` always runs the plain version; ``"pallas"`` is K5 and raises
    on the CPU."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if impl is None:
        return _fa.flash_attention(q, k, v, **kw)
    if impl == "ref":
        return ref.mha_ref(q, k, v, **kw)
    if impl == "pallas":
        if q.device.type != "cuda":
            raise ValueError("flash_attention impl='pallas' is the CUDA "
                             "kernel and needs CUDA tensors")
        return _fa.flash_attention_cuda(q, k, v, **kw)
    raise ValueError(f"unknown flash_attention impl {impl!r}")
