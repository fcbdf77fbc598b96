"""Activation-sharding constraints over logical axis names
(``repro.dist.act_sharding``).

Model code names the axes of an activation ("batch", "heads", "embed",
"act_seq") instead of mesh dims; the mapping to the dims of a
``torch.distributed.device_mesh.DeviceMesh`` is resolved here, against the
mesh of the active :func:`activation_rules` context.  Outside a context
every :func:`constrain` call returns its tensor itself, so the same model
code runs unsharded on one device and under a mesh without change.

Inside a context a ``DTensor`` is redistributed to the resolved
placements.  The port's meshed steps (``launch.steps``) run the model on
each rank's local tensors (its slice of the batch, every weight gathered
at its use by :func:`gathered`), so their activations are plain tensors
and pass through: every rank of ``model`` computes the same layer whole.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

# The active mesh for constraint resolution (None: constraints are no-ops).
_ACTIVE_MESH = None

# Data-parallel axes in priority order; "model" is the tensor axis.
_DP_AXES = ("pod", "data")


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a torch ``DeviceMesh`` (``mesh_dim_names``) or of
    any mesh-like object with ``axis_names`` (a stand-in with a shape)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size for a torch ``DeviceMesh`` or a stand-in whose
    ``shape`` maps names to sizes."""
    names = axis_names(mesh)
    shape = mesh.shape
    if isinstance(shape, dict) or hasattr(shape, "items"):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(n) for n in shape)))


@contextlib.contextmanager
def activation_rules(mesh):
    """Enable activation constraints for ``mesh`` inside the context."""
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present in ``mesh``, in order."""
    names = axis_names(mesh)
    return tuple(a for a in _DP_AXES if a in names)


def _resolve(name, mesh):
    """Logical axis name -> mesh axis, a tuple of axes, or None (the
    reference's table)."""
    if name is None:
        return None
    names = axis_names(mesh)
    if name in ("batch", "act_batch"):
        axes = dp_axes(mesh)
        return axes if axes else None
    if name in ("heads", "embed", "model"):
        return "model" if "model" in names else None
    if name == "act_seq":
        return None  # sequence stays unsharded (no sequence parallelism yet)
    return name if name in names else None


def placements(mesh, spec) -> List:
    """``Shard``/``Replicate`` placements, one a mesh dim, for a tensor
    whose dims carry the mesh-axis entries of ``spec`` (each ``None``, an
    axis name or a tuple of them; the first dim naming an axis claims
    it)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None and isinstance(out[names.index(a)], Replicate):
                out[names.index(a)] = Shard(dim)
    return out


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """``x`` itself outside a context or when it is not a ``DTensor``;
    else ``x`` redistributed to the placements of the logical ``axes``."""
    from torch.distributed.tensor import DTensor
    if _ACTIVE_MESH is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(
        mesh, [_resolve(a, mesh) for a in axes]))


def gathered(t: torch.Tensor) -> torch.Tensor:
    """A weight as the meshed steps compute with it: a ``DTensor`` is
    all-gathered into a whole local tensor whose gradient is partial over
    the data-parallel axes (each rank's batch slice gives its part) and
    the same on every rank of ``model``; any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    dp = dp_axes(mesh)
    whole = t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return whole.to_local(grad_placements=[
        Partial() if a in dp else Replicate() for a in axis_names(mesh)])


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a ``DTensor`` (a collective: every rank of its
    mesh calls it); any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def local(t):
    """This rank's shard of a ``DTensor``; any other value as it is."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t
