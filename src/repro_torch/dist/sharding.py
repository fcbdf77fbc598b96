"""Sharding rules (``repro.dist.sharding``): spec trees for parameters,
optimizer state and caches, and their placements on a torch
``DeviceMesh``.

Axis convention (DESIGN.md §7): ``pod``/``data`` are data-parallel axes,
``model`` is the tensor axis.  The rules are structural, derived on the
meta device from the port's own models, so every architecture gets a spec
tree in the reference's layout (nested dicts, per-layer leaves stacked
``[L, ...]``, keys sorted as ``lm.leaves`` walks them):

* a leaf of 2 or more dims (stacked) whose trailing dim is at least 512
  shards that dim over ``model``;
* smaller leaves (biases, norms, scalar state) are replicated;
* a floating cache leaf ``[L, B, ...]`` shards its batch axis over the
  data-parallel axes when the batch divides evenly, else it is replicated.

A spec is a :class:`Spec`: a tuple with one entry a dim, each ``None``, an
axis name or a tuple of axis names (the reference's ``PartitionSpec``);
``Spec()`` is replicated.  :func:`to_shardings` turns specs into
``Shard``/``Replicate`` placements; a trailing dim that does not divide
the ``model`` axis is an uneven ``Shard`` (``torch.chunk``'s split).
"""
from __future__ import annotations

import types
from typing import Any, Dict, List, Tuple

import torch
from torch import nn

from repro_torch.dist import act_sharding
from repro_torch.models import lm, whisper
from repro_torch.models.config import ArchConfig

# Trailing dims at least this wide are worth tensor-sharding; smaller ones
# (head_dim tables, gate vectors) stay replicated.
_MIN_MODEL_DIM = 512


class Spec(tuple):
    """One leaf's partitioning: an entry a dim (None, an axis name or a
    tuple of axis names); empty when replicated."""

    def __new__(cls, *entries):
        """``Spec(None, "model")``, ``Spec(None, ("pod", "data"))``; a
        tuple of one axis is that axis and an empty one None, as the
        reference's ``PartitionSpec`` normalises them."""
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        """``Spec(None, 'model')``."""
        return f"Spec{tuple.__repr__(self)}"


# the mesh helpers both modules share
dp_axes = act_sharding.dp_axes
placements = act_sharding.placements
full = act_sharding.full
local = act_sharding.local


def is_sharded(shape: Tuple[int, ...]) -> bool:
    """Whether the rules split a (stacked) leaf of ``shape`` over
    ``model``: 2 or more dims, the trailing one at least 512 wide."""
    return len(shape) >= 2 and shape[-1] >= _MIN_MODEL_DIM


def _leaf_spec(shape: Tuple[int, ...]) -> Spec:
    if is_sharded(shape):
        return Spec(*([None] * (len(shape) - 1) + ["model"]))
    return Spec()


def _stacked_shape(layer, p: torch.Tensor) -> Tuple[int, ...]:
    """The reference's shape of a leaf: per-layer tensors stacked on a
    leading ``[L]`` (its size does not enter the rules)."""
    return tuple(p.shape) if layer is None else (1,) + tuple(p.shape)


def _leaf_specs(model: nn.Module) -> List[Tuple[Tuple[str, ...], Any, Spec]]:
    """``(path, layer, spec)`` a leaf of ``model`` in ``lm.leaves`` order,
    each spec that of the reference's stacked leaf."""
    return [(path, layer, _leaf_spec(_stacked_shape(layer, p)))
            for path, layer, p in lm.leaves(model)]


def _spec_tree(model: nn.Module) -> Dict:
    entries = _leaf_specs(model)
    return lm.nest([(path, layer) for path, layer, _ in entries],
                   [s for _, _, s in entries], lambda specs: specs[0])


def abstract_model(cfg: ArchConfig, dtype=torch.float32) -> nn.Module:
    """``cfg``'s model (an ``lm.LM`` or a ``whisper.Whisper``) on the meta
    device: shapes and types, no storage."""
    if cfg.is_enc_dec:
        return whisper.Whisper(cfg, torch.device("meta"), dtype)
    return lm.empty_params(cfg, torch.device("meta"), dtype)


def param_specs(cfg: ArchConfig) -> Dict:
    """Spec tree matching the reference's ``lm.init_params(cfg)`` (or
    ``whisper.init_params(cfg)``: the models are told apart by ``cfg``)."""
    return _spec_tree(abstract_model(cfg))


whisper_param_specs = param_specs


def param_placement_specs(model: nn.Module) -> Dict[str, Spec]:
    """Parameter name -> the spec of the port's own tensor: a per-layer
    tensor drops the stacked leaf's leading ``[L]`` entry."""
    out = {}
    names = {id(p): n for n, p in model.named_parameters()}
    for path, layer, p in lm.leaves(model):
        spec = _leaf_spec(_stacked_shape(layer, p))
        out[names[id(p)]] = Spec(*spec[1:]) if layer is not None and spec \
            else spec
    return out


def _dp_count(mesh) -> int:
    sizes = act_sharding.axis_sizes(mesh)
    n = 1
    for a in dp_axes(mesh):
        n *= sizes[a]
    return n


def batch_divides(mesh, batch: int) -> bool:
    """Whether ``batch`` rows split evenly over the data-parallel axes."""
    n = _dp_count(mesh)
    return bool(dp_axes(mesh)) and batch % n == 0 and batch >= n


def abstract_cache(cfg: ArchConfig, batch: int, context: int
                   ) -> Dict[str, torch.Tensor]:
    """The decode cache of ``cfg`` on the meta device."""
    owner = types.SimpleNamespace(embed=torch.empty(0, device="meta"))
    mod = whisper if cfg.is_enc_dec else lm
    return mod.init_decode_cache(owner, cfg, batch, context)


def cache_specs(cfg: ArchConfig, mesh, batch: int) -> Dict[str, Spec]:
    """Spec tree matching ``lm.init_decode_cache`` (or
    ``whisper.init_decode_cache``)."""
    dp = dp_axes(mesh)
    shard = batch_divides(mesh, batch)

    def leaf_spec(t: torch.Tensor) -> Spec:
        # layout [L, B, ...]; int bookkeeping (pos, slot_pos) stays
        # replicated, as in the reference
        if shard and t.dim() >= 2 and t.shape[1] == batch \
                and t.is_floating_point():
            return Spec(None, dp)
        return Spec()
    return {k: leaf_spec(t) for k, t in abstract_cache(cfg, batch, 8).items()}


whisper_cache_specs = cache_specs


def to_shardings(mesh, specs: Any) -> Any:
    """Spec tree -> placements tree on ``mesh`` (dicts, lists and tuples
    are walked; a :class:`Spec` is a leaf)."""
    if isinstance(specs, Spec):
        return placements(mesh, specs)
    if isinstance(specs, dict):
        return {k: to_shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        vals = [to_shardings(mesh, v) for v in specs]
        return type(specs)(*vals) if hasattr(specs, "_fields") \
            else type(specs)(vals)
    return specs


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t`` (the same full tensor on every rank) as a ``DTensor`` on
    ``mesh`` partitioned by ``spec``: each rank keeps its own chunk, with
    no communication."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements(mesh, spec),
                             src_data_rank=None)


@torch.no_grad()
def distribute_params(model: nn.Module, mesh) -> nn.Module:
    """Replace every parameter of ``model`` (the same full values on every
    rank) by a ``DTensor`` parameter placed by the sharding rules; in
    place, returns the model."""
    specs = param_placement_specs(model)
    for name, spec in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        p = mod._parameters[leaf]
        mod._parameters[leaf] = nn.Parameter(distribute(p.data, mesh, spec),
                                             requires_grad=p.requires_grad)
    return model


def local_like(full_t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of ``full_t`` as ``like`` (a ``DTensor``) holds
    its own; ``full_t`` itself when ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if not isinstance(like, DTensor):
        return full_t
    return distribute_tensor(full_t.to(like.device), like.device_mesh,
                             like.placements, src_data_rank=None).to_local()
