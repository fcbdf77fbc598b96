"""Gradient compression with error feedback (``repro.dist.compress``):
int8 with a per-tensor scale.

:func:`compress` quantizes ``g + err`` to int8 with a per-tensor scale and
carries the rounding residual forward, the error-feedback scheme that
keeps compressed SGD on the exact trajectory to first order.  Its
arithmetic is the reference's, in the reference's order (the max over
127, the 1e-12 floor, round half to even, the clip to +-127, the residual
``v - q * scale``), so ``q``, ``scale`` and the new error equal the
reference's bit for bit.  The residual is at most half a step,
``scale / 2``, up to the rounding of ``v - q * scale`` itself (a few f32
ulps of ``max|v|``).

:func:`compressed_psum` is the collective form: compress locally,
all-reduce the dequantized values over a process group, divide by its
size (the wire format is modelled; the sum runs on dequantized values).
Trees are nested dicts, lists and tuples of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch


@dataclasses.dataclass
class Compressed:
    """int8 payload and per-tensor f32 scale (a leaf, not a tree)."""

    q: torch.Tensor       # int8, the source tensor's shape
    scale: torch.Tensor   # f32 scalar


def compress(g: torch.Tensor, err: torch.Tensor
             ) -> Tuple[Compressed, torch.Tensor]:
    """Quantize ``g + err`` to int8; returns (compressed, new error)."""
    v = g + err
    # divide by a tensor on v's device: CUDA takes a Python divisor as a
    # multiplication by its reciprocal, which is not always the quotient
    scale = torch.clamp(torch.max(torch.abs(v)) / v.new_tensor(127.0),
                        min=1e-12)
    q = torch.clamp(torch.round(v / scale), -127, 127).to(torch.int8)
    new_err = v - q.to(torch.float32) * scale
    return Compressed(q=q, scale=scale), new_err


def decompress(c: Compressed) -> torch.Tensor:
    """The f32 values ``q * scale``."""
    return c.q.to(torch.float32) * c.scale


def _map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves (tensors or :class:`Compressed`) of ``tree``
    and the trees of the same structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def init_error(grads: Any) -> Any:
    """Zero error-feedback state shaped like ``grads``."""
    return _map(torch.zeros_like, grads)


def compress_tree(grads: Any, errs: Any) -> Tuple[Any, Any]:
    """:func:`compress` on every leaf: (tree of :class:`Compressed`, tree
    of new errors)."""
    pairs = _map(lambda g, e: _Pair(*compress(g, e)), grads, errs)
    return _map(lambda p: p.comp, pairs), _map(lambda p: p.err, pairs)


@dataclasses.dataclass
class _Pair:
    """One leaf's (compressed, new error), a leaf of :func:`_map`."""

    comp: Compressed
    err: torch.Tensor


def decompress_tree(comp: Any, like: Any = None) -> Any:
    """:func:`decompress` on every leaf (``like`` is accepted for the
    reference's signature; the structure is ``comp``'s)."""
    del like
    return _map(decompress, comp)


def compressed_psum(grads: Any, errs: Any, group: Optional[Any] = None
                    ) -> Tuple[Any, Any]:
    """Mean-reduce compressed gradients over ``group`` (the default group
    when None): (the mean tree, the same on every rank; this rank's new
    error-feedback tree)."""
    import torch.distributed as dist
    comp, new_errs = compress_tree(grads, errs)
    n = dist.get_world_size(group)

    def reduce_leaf(c: Compressed) -> torch.Tensor:
        x = decompress(c)
        dist.all_reduce(x, group=group)
        return x / n
    return _map(reduce_leaf, comp), new_errs
