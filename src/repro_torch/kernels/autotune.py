"""Tuning of the fused cascade (the port of ``repro.kernels.autotune``).

:class:`KernelTuning` is persisted in ``ExecutionPlan.meta["tuning"]`` by
the fused backend; both packages read it, so ``impl`` stays one of
``{None, "xla", "pallas"}`` (here ``"pallas"`` means the hand-written
kernel).  :func:`pick_tuning` is the reference's roofline model, copied so
that a plan made on the CPU carries exactly the reference's tuning.

On Hopper the one decision that matters is whether the packed tables fit
one block's shared memory: :func:`hopper_mode`.  A plan tuned elsewhere
that says ``resident`` but does not fit runs the streamed kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch import device as _device

DEVICE_MODELS: Dict[str, Dict[str, float]] = {
    "tpu": {"peak_flops": 197e12, "hbm_bw": 819e9, "vmem_bytes": 64 * 2**20},
    "gpu": {"peak_flops": 60e12, "hbm_bw": 1.5e12, "vmem_bytes": 48 * 2**20},
    "cpu": {"peak_flops": 2e11, "hbm_bw": 4e10, "vmem_bytes": 8 * 2**20},
}

BLOCK_B_CANDIDATES = (64, 128, 256, 512, 1024)
UNIT_TILE_CANDIDATES = (8, 16, 32)


@dataclasses.dataclass(frozen=True)
class KernelTuning:
    """One fused-cascade tuning choice, persisted in the ExecutionPlan."""

    impl: Optional[str] = None          # None=auto | "xla" | "pallas"
    mode: str = "resident"              # "resident" | "streamed"
    block_b: int = 256
    unit_tile: int = 8
    table_dtype: Optional[str] = None
    source: str = "default"

    def to_meta(self) -> Dict[str, Any]:
        """JSON-serializable form for ``ExecutionPlan.meta['tuning']``."""
        return dataclasses.asdict(self)

    @classmethod
    def from_meta(cls, meta: Optional[Dict[str, Any]]) -> "KernelTuning":
        """Rebuild from plan meta, dropping keys of a newer schema."""
        if not meta:
            return cls()
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in meta.items() if k in fields})


def device_kind(device=None) -> str:
    """A ``DEVICE_MODELS`` key: ``"gpu"`` for a CUDA device (the default
    when one is available), ``"cpu"`` otherwise; names already in the
    table pass through."""
    if isinstance(device, str) and device in DEVICE_MODELS:
        return device
    kind = _device.kind(None if device is None else torch.device(device))
    return kind if kind in DEVICE_MODELS else "cpu"


def _layer_dims(layers: Sequence[Sequence[int]]):
    l4 = [(int(p), int(u), int(e), int(o)) for p, u, e, o, *_ in layers]
    total_units = sum(u for _, u, _, _ in l4)
    max_prev = max(p for p, _, _, _ in l4)
    max_entries = max(e for _, _, e, _ in l4)
    return l4, total_units, max_prev, max_entries


def resident_bytes(layers: Sequence[Sequence[int]],
                   table_itemsize: int) -> int:
    """The reference's VMEM bytes for the resident kernel (packed tables +
    address matrices)."""
    _, total_units, max_prev, max_entries = _layer_dims(layers)
    return (total_units * max_entries * table_itemsize
            + max_prev * total_units * 4)


def roofline_candidates(layers: Sequence[Sequence[int]], *,
                        table_itemsize: int = 4, batch: int = 4096,
                        device=None) -> List[Dict[str, Any]]:
    """The reference's modeled candidate grid, one row per (mode, block_b
    [, unit_tile])."""
    from repro_torch.kernels.lut_cascade import (_phase_layout, cascade_bytes,
                                                 cascade_flops, layers_v1)
    dev = device_kind(device)
    m = DEVICE_MODELS[dev]
    l4 = layers_v1(layers)
    flops = cascade_flops(l4, batch)
    rows: List[Dict[str, Any]] = []
    for mode in ("resident", "streamed"):
        for block_b in BLOCK_B_CANDIDATES:
            for unit_tile in (UNIT_TILE_CANDIDATES if mode == "streamed"
                              else (0,)):
                if mode == "resident":
                    worst = max(u * e for _, u, e, _ in l4)
                    vmem = (resident_bytes(l4, table_itemsize)
                            + block_b * worst * 4)
                else:
                    _, _, _, _, _, a_dim = _phase_layout(l4, unit_tile)
                    max_e = max(e for _, _, e, _ in l4)
                    vmem = (block_b * (unit_tile * max_e + 2 * a_dim) * 4
                            + 2 * unit_tile * (max_e * table_itemsize
                                               + a_dim * 4))
                byts = cascade_bytes(l4, batch, table_itemsize, mode=mode,
                                     block_b=block_b)
                t_comp = flops / m["peak_flops"]
                t_mem = byts / m["hbm_bw"]
                rows.append({
                    "device": dev, "mode": mode, "block_b": block_b,
                    "unit_tile": unit_tile or None,
                    "flops": flops, "bytes": byts,
                    "t_compute_us": round(t_comp * 1e6, 3),
                    "t_memory_us": round(t_mem * 1e6, 3),
                    "bound": "compute" if t_comp >= t_mem else "memory",
                    "t_us": round(max(t_comp, t_mem) * 1e6, 3),
                    "rows_per_s": round(batch / max(t_comp, t_mem), 1),
                    "vmem_bytes": vmem,
                    "fits_vmem": vmem <= m["vmem_bytes"],
                })
    return rows


def pick_tuning(layers: Sequence[Sequence[int]], *,
                table_itemsize: int = 4, batch: int = 4096,
                device=None,
                table_dtype: Optional[str] = None) -> KernelTuning:
    """The reference's model-driven choice: the fastest feasible roofline
    candidate, ties toward resident mode and larger batch tiles."""
    rows = [r for r in roofline_candidates(
        layers, table_itemsize=table_itemsize, batch=batch, device=device)
        if r["fits_vmem"]]
    if not rows:
        return KernelTuning(mode="streamed", block_b=BLOCK_B_CANDIDATES[0],
                            unit_tile=UNIT_TILE_CANDIDATES[0],
                            table_dtype=table_dtype, source="roofline")
    rows.sort(key=lambda r: (r["t_us"],
                             0 if r["mode"] == "resident" else 1,
                             -r["block_b"]))
    best = rows[0]
    return KernelTuning(mode=best["mode"], block_b=best["block_b"],
                        unit_tile=best["unit_tile"] or 8,
                        table_dtype=table_dtype, source="roofline")


def hopper_mode(layers: Sequence[Sequence[int]], table_itemsize: int) -> str:
    """``"resident"`` when K1 has a plan (:func:`lut_cascade.plan_resident`):
    the packed tables, all maps, two code stages and two activation tiles
    of ``RESIDENT_MIN_ROWS`` rows fit one block's 232,448 bytes of dynamic
    shared memory; else ``"streamed"``.  Needs v2 layer tuples."""
    from repro_torch.kernels.lut_cascade import (RESIDENT_MIN_ROWS,
                                                 SMEM_PER_BLOCK,
                                                 resident_smem_bytes)
    need = resident_smem_bytes(layers, table_itemsize, RESIDENT_MIN_ROWS)
    return "resident" if need <= SMEM_PER_BLOCK else "streamed"


def default_tuning(layers: Sequence[Sequence[int]], *,
                   table_itemsize: int = 4,
                   table_dtype: Optional[str] = None,
                   device=None) -> KernelTuning:
    """The tuning stamped on fresh plans: the roofline pick for the
    planning device (``source="default"``).  On a GPU the mode is then the
    shared-memory fit of :func:`hopper_mode`; the measurement path and an
    H100 row of ``DEVICE_MODELS`` are not ported yet."""
    dev = device_kind(device)
    t = pick_tuning(layers, table_itemsize=table_itemsize, device=dev,
                    table_dtype=table_dtype)
    t = dataclasses.replace(t, source="default")
    if dev == "gpu":
        t = dataclasses.replace(t, mode=hopper_mode(layers, table_itemsize))
    return t
