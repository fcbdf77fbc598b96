"""The fused cascade backend: the whole network in one kernel launch.

Planning is numpy, copied from the reference so that the plan buffers are
byte-identical and ``meta`` equal (on the CPU) to ``repro.backends.fused``
(schema v2, ``plan_format="fused-packed-v2"``):

* ``amat [max_prev, total_units] f32`` -- the reference's address-formation
  matrices, kept only so both packages read each other's artifacts; the
  port's kernels never read it.
* ``tables [total_units, max_entries]`` -- every layer's table packed
  row-wise, narrowed to int8/int16 when the largest bit-width allows.
* ``map_<l> [units, fan_in] int32`` -- the mappings of non-assemble layers.

``run`` goes through ``kernels.ops.lut_cascade``: K1 or K2 on the card, the
plain cascade on the CPU.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.backends.base import (BackendCapabilities, ExecutionPlan,
                                       LookupBackend, require_mappings)
from repro_torch.backends.registry import register
from repro_torch.kernels import autotune

MAX_ADDR_BITS = 24
PLAN_SCHEMA = 2


def _table_dtype(max_bits: int) -> np.dtype:
    """Narrowest signed dtype that holds codes of ``max_bits`` bits."""
    if max_bits <= 7:
        return np.dtype(np.int8)
    if max_bits <= 15:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def _layer_meta_v2(cfg, tables) -> List[List[int]]:
    """The v2 7-wide layer tuples from a config + concrete tables."""
    layers, off = [], 0
    for l, spec in enumerate(cfg.layers):
        layers.append([cfg.prev_width(l), spec.units, int(tables[l].shape[1]),
                       off, spec.fan_in, cfg.in_bits(l), int(spec.assemble)])
        off += spec.units
    return layers


def _numpy(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@register("fused")
class FusedCascadeBackend(LookupBackend):
    """Single-launch whole-cascade execution with a persisted tuning."""

    name = "fused"
    plan_format = "fused-packed-v2"

    def capabilities(self) -> BackendCapabilities:
        """Describe the fused backend (not unit-shardable: the cascade has
        no layer boundary to gather at; placements split it by rows)."""
        return BackendCapabilities(
            name=self.name, fused=True, needs_pallas=True,
            description="whole-network cascade in one launch; bit-packed "
                        "tables in shared memory, resident (K1) or streamed "
                        "(K2) hand-written CUDA kernel on the card, a plain "
                        "gather cascade on the CPU")

    def plan(self, net) -> ExecutionPlan:
        """Pack the folded ``net`` into the v2 fused plan and stamp the
        default tuning for the planning device."""
        require_mappings(net, "fused.plan")
        cfg = net.cfg
        for l, spec in enumerate(cfg.layers):
            if cfg.in_bits(l) * spec.fan_in > MAX_ADDR_BITS:
                raise ValueError(
                    f"fused.plan: layer {l} address width "
                    f"{cfg.in_bits(l) * spec.fan_in}b exceeds the f32-exact "
                    f"limit ({MAX_ADDR_BITS}b); use a per-layer backend")
        layers = _layer_meta_v2(cfg, net.tables)
        total_units = sum(lm[1] for lm in layers)
        max_prev = max(lm[0] for lm in layers)
        max_entries = max(lm[2] for lm in layers)
        max_bits = max(spec.bits for spec in cfg.layers)

        amat = np.zeros((max_prev, total_units), np.float32)
        tables = np.zeros((total_units, max_entries), _table_dtype(max_bits))
        buffers: Dict[str, np.ndarray] = {"amat": amat, "tables": tables}
        for l, spec in enumerate(cfg.layers):
            prev, units, _, off, fan_in, bits, _ = layers[l]
            if spec.assemble:
                mapping = np.arange(prev, dtype=np.int64).reshape(
                    units, fan_in)
            else:
                mapping = _numpy(net.mappings[l]).astype(np.int64)
                buffers[f"map_{l}"] = mapping.astype(np.int32)
            weights = 2.0 ** (bits * np.arange(fan_in - 1, -1, -1))
            for f in range(fan_in):
                np.add.at(amat, (mapping[:, f], off + np.arange(units)),
                          weights[f])
            table = _numpy(net.tables[l])
            tables[off:off + units, :table.shape[1]] = table

        tuning = autotune.default_tuning(
            layers, table_itemsize=tables.dtype.itemsize,
            table_dtype=tables.dtype.name, device=net.device)
        meta: Dict[str, Any] = {
            "schema": PLAN_SCHEMA,
            "layers": layers,
            "table_dtype": tables.dtype.name,
            "vmem_bytes": int(amat.nbytes + tables.nbytes),
            "input_span": 2 ** cfg.in_bits(0),
            "tuning": tuning.to_meta(),
        }
        return ExecutionPlan(backend=self.name, meta=meta, buffers=buffers)

    def migrate_plan(self, plan: ExecutionPlan,
                     net) -> Optional[ExecutionPlan]:
        """Upgrade a v1 ``fused-packed`` plan to schema v2: buffers kept
        verbatim, layer tuples extended from the config, ``map_<l>`` added,
        tuning defaulted.  ``None`` when the plan is not a matching v1 plan.
        """
        if plan.meta.get("plan_format") != "fused-packed-v1":
            return None
        if not {"amat", "tables"} <= set(plan.buffers):
            return None
        cfg = net.cfg
        layers = _layer_meta_v2(cfg, net.tables)
        old = [list(map(int, lm)) for lm in plan.meta.get("layers", [])]
        if old != [lm[:4] for lm in layers]:
            return None
        total_units = sum(lm[1] for lm in layers)
        max_prev = max(lm[0] for lm in layers)
        max_entries = max(lm[2] for lm in layers)
        amat, tables = plan.buffers["amat"], plan.buffers["tables"]
        if (amat.shape != (max_prev, total_units)
                or tables.shape != (total_units, max_entries)):
            return None
        buffers = dict(plan.buffers)
        for l, spec in enumerate(cfg.layers):
            if not spec.assemble:
                buffers[f"map_{l}"] = _numpy(net.mappings[l]).astype(np.int32)
        tuning = autotune.default_tuning(
            layers, table_itemsize=tables.dtype.itemsize,
            table_dtype=tables.dtype.name, device=net.device)
        meta = dict(plan.meta)
        meta.update(schema=PLAN_SCHEMA, layers=layers,
                    input_span=2 ** cfg.in_bits(0),
                    tuning=tuning.to_meta(),
                    plan_format=self.plan_format)
        return ExecutionPlan(backend=self.name, meta=meta, buffers=buffers)

    def run(self, plan: ExecutionPlan, codes: torch.Tensor) -> torch.Tensor:
        """Execute the cascade with the plan's persisted tuning."""
        from repro_torch.kernels import lut_cascade, ops
        dev = codes.device
        layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
        mappings = None
        if (all(len(l) >= 7 for l in layers)
                and all(l[6] or f"map_{i}" in plan.buffers
                        for i, l in enumerate(layers))):
            mappings = tuple(
                plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
                else None for l in range(len(layers)))
        tables = plan.tensor("tables", dev)
        operands = None
        if dev.type == "cuda" and mappings is not None:
            operands = plan.derived(dev, "cascade", lambda: lut_cascade.prepare(
                tables, layers, mappings))
        return ops.lut_cascade(codes.to(torch.int32), None, tables,
                               layers=layers, mappings=mappings,
                               tuning=plan.meta.get("tuning"),
                               operands=operands)
