"""Device placement for lookup backends (the port of
``repro.backends.placement``).

Planning (``backend.plan``) decides buffer layout; *placement* decides
where the planned cascade runs.  A :class:`Placement` names a
:class:`~repro_torch.launch.mesh.DeviceMesh` of slots and a strategy, and
:func:`place` wraps any backend's ``run`` so that the same
:class:`~repro_torch.backends.ExecutionPlan` executes split over the slots:

  * ``batch``: the rows are zero-padded to the shard count (zero rows are
    valid addresses), split into one contiguous slice per shard, and each
    slice runs the whole cascade through ``backend.run`` on its slot's
    device; the results are concatenated on the caller's device and the
    padding is sliced off.  Rows are independent, so the codes equal the
    unplaced run's on every backend, K1 and K2 included.
  * ``units``: each slot holds its row slice of every layer's table and
    mapping (:func:`unit_shard_buffers`) and computes its slice of the
    layer's codes; at every layer boundary the slices are concatenated on
    the caller's device, the padded units sliced off, and the full codes
    moved to each slot's device, where the next layer's mapping may read
    any unit.  Only layer-by-layer backends support it
    (``supports_unit_sharding``); the fused cascade has no layer boundary
    to gather at.

This is one process driving its devices with explicit copies: the
in-process counterpart of the reference's ``shard_map``, with no
``torch.distributed``, because the fleet is one process.  The plan's
buffers are copied once to each physical device and cached
(``ExecutionPlan.derived``); a call copies only codes.  ``auto`` resolves
to ``batch``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from repro_torch.launch.mesh import DeviceMesh

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.backends.base import ExecutionPlan, LookupBackend

STRATEGIES = ("auto", "batch", "units")


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a planned cascade executes: a mesh of slots and a strategy.

    The serving mesh has one axis, so the sharded dimension (batch rows or
    layer units) is split over every slot and shard ``i`` runs on slot
    ``i``.  The reference's ``axes`` field and its ``dp_axes`` default
    choose among the axes of a mesh with several; they come with the
    multi-axis meshes of ``dist.sharding``.

    The reference's ``input_sharding`` (a ``NamedSharding`` that inputs
    carry into the jitted cascade) has no counterpart: the engine's pinned
    host block is copied to the net's device and each shard's rows from
    there to its slot's device, with no resharding step to avoid.
    """

    mesh: DeviceMesh
    strategy: str = "auto"

    def __post_init__(self):
        """Validate the strategy name."""
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"unknown placement strategy {self.strategy!r}; "
                f"one of {STRATEGIES}")

    def resolved_strategy(self) -> str:
        """The concrete strategy (``auto`` resolves to ``batch``)."""
        return "batch" if self.strategy == "auto" else self.strategy

    def cache_key(self) -> tuple:
        """Hashable identity for executor caching: the strategy and every
        slot's id and device."""
        return (self.resolved_strategy(),
                tuple((s.id, str(s.device)) for s in self.mesh.slots))


def place(backend: "LookupBackend", plan: "ExecutionPlan",
          placement: Placement) -> Callable:
    """Wrap ``backend.run(plan, ·)`` for execution under ``placement``.

    Returns ``run(codes) -> codes`` over whole tensors on the caller's
    device: callers never see the slots."""
    strategy = placement.resolved_strategy()
    if strategy == "batch":
        return _batch_sharded(backend, plan, placement)
    if not getattr(backend, "supports_unit_sharding", False):
        raise ValueError(
            f"backend {backend.name!r} does not support unit sharding "
            "(it has no per-layer boundaries to all-gather at); use "
            "strategy='batch'")
    return backend.unit_sharded_runner(plan, placement.mesh)


def _batch_sharded(backend: "LookupBackend", plan: "ExecutionPlan",
                   placement: Placement) -> Callable:
    slots = placement.mesh.slots
    n = len(slots)

    def run(codes: torch.Tensor) -> torch.Tensor:
        b = codes.shape[0]
        pad = (-b) % n
        if pad:  # zero rows are valid addresses; sliced off below
            codes = torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))])
        per = codes.shape[0] // n
        outs = [backend.run(plan, codes[i * per:(i + 1) * per].to(
                    s.device, non_blocking=True))
                for i, s in enumerate(slots)]
        out = torch.cat([o.to(codes.device, non_blocking=True)
                         for o in outs])
        return out[:b] if pad else out

    return run


def unit_shard_buffers(layers, get_table, get_mapping, n: int):
    """Pad every layer's unit axis to a multiple of ``n`` shards.

    Returns the interleaved ``[table_0, mapping_0, table_1, ...]`` numpy
    buffers whose unit axes all divide ``n`` (assemble layers get their
    contiguous mapping materialized so every layer is uniform).  Padded
    table rows are zeros and padded mapping rows point at input 0; their
    outputs are sliced off after every gather.  Shard ``i`` owns rows
    ``[i * r, (i + 1) * r)`` of each, ``r = ceil(units / n)``.
    """
    bufs = []
    for l, lm in enumerate(layers):
        units, fan_in = lm["units"], lm["fan_in"]
        table = np.asarray(get_table(l))
        if lm["assemble"]:
            mapping = np.arange(units * fan_in,
                                dtype=np.int32).reshape(units, fan_in)
        else:
            mapping = np.asarray(get_mapping(l), np.int32)
        pu = (-units) % n
        bufs.append(np.pad(table, ((0, pu), (0, 0))))
        bufs.append(np.pad(mapping, ((0, pu), (0, 0))))
    return bufs
