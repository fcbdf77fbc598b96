"""Tuning of the fused cascade (the port of ``repro.kernels.autotune``).

:class:`KernelTuning` is persisted in ``ExecutionPlan.meta["tuning"]`` by
the fused backend; both packages read it, so ``impl`` stays one of
``{None, "xla", "pallas"}`` (here ``"pallas"`` means the hand-written
kernel).  :func:`pick_tuning` is the reference's roofline model, copied so
that a plan made on the CPU carries exactly the reference's tuning.

On Hopper the one decision that matters is whether the packed tables fit
one block's shared memory: :func:`hopper_mode`.  A plan tuned elsewhere
that says ``resident`` but does not fit runs the streamed kernel;
:func:`hopper_launch` names the launch a tuning makes on the card.

The measurement path is the reference's: :func:`measurement_grid` ranks
the roofline candidates, :func:`measure_tuning` times a runner per
candidate (``FusedCascadeBackend.autotune_plan`` wires it to a plan), and
:func:`choice_table` is the per-(task, device) audit of the model's picks.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import device as _device
from repro_torch.kernels.lut_cascade import (RESIDENT_MIN_ROWS,
                                             SMEM_PER_BLOCK, plan_cluster,
                                             resident_smem_bytes)

# The "gpu" row is one NVIDIA H100 SXM: peak_flops is its 67 TFLOP/s of
# f32 outside the tensor cores (the data sheet; K1 and K2 do integer work
# on those cores, not the 989 TFLOP/s bf16 tensor-core rate), hbm_bw the
# data sheet's 3.35 TB/s of HBM3, and the "vmem" budget one block's
# 232,448 bytes of dynamic shared memory (``SMEM_PER_BLOCK``).
# The "tpu" and "cpu" rows are the reference's.
DEVICE_MODELS: Dict[str, Dict[str, float]] = {
    "tpu": {"peak_flops": 197e12, "hbm_bw": 819e9, "vmem_bytes": 64 * 2**20},
    "gpu": {"peak_flops": 67e12, "hbm_bw": 3.35e12,
            "vmem_bytes": SMEM_PER_BLOCK},
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
    [, unit_tile]).  On ``"gpu"`` a row's ``vmem_bytes`` is the shared
    memory one block of the kernel needs (:func:`hopper_smem_bytes`, None
    where K2 has no plan), held against the H100 row's 232,448 bytes in
    place of the TPU kernels' VMEM working set; times are the reference's
    model at the H100 row's rates."""
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
                if dev == "gpu":
                    vmem = hopper_smem_bytes(layers, table_itemsize, mode,
                                             unit_tile)
                elif mode == "resident":
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
                    "fits_vmem": vmem is not None and vmem <= m["vmem_bytes"],
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
    need = resident_smem_bytes(layers, table_itemsize, RESIDENT_MIN_ROWS)
    return "resident" if need <= SMEM_PER_BLOCK else "streamed"


def hopper_smem_bytes(layers: Sequence[Sequence[int]], table_itemsize: int,
                      mode: str, unit_tile: int) -> Optional[int]:
    """Shared memory one block needs on the card: K1's at
    ``RESIDENT_MIN_ROWS`` rows (``"resident"``), or that of the plan
    :func:`lut_cascade.plan_cluster` makes for K2 at ``unit_tile``
    (``"streamed"``; None when no plan fits).  Neither reads ``block_b``.
    Needs v2 layer tuples."""
    if mode == "resident":
        return resident_smem_bytes(layers, table_itemsize, RESIDENT_MIN_ROWS)
    try:
        return plan_cluster(tuple(tuple(int(v) for v in l) for l in layers),
                            table_itemsize, unit_tile=unit_tile).smem_bytes
    except ValueError:
        return None


def hopper_launch(tuning: KernelTuning, layers: Sequence[Sequence[int]],
                  table_itemsize: int) -> Tuple:
    """The launch ``tuning`` makes on the card: ``("resident",)`` (K1) when
    it asks for resident and :func:`hopper_mode` agrees, else
    ``("streamed", cluster, rows, ring_units)`` (K2 on the plan
    :func:`lut_cascade.plan_cluster` makes at the tuning's ``unit_tile``).
    ``block_b`` is not read, and ``unit_tile`` only where it changes K2's
    plan (the ring route): two tunings with one key are one launch."""
    if (tuning.mode == "resident"
            and hopper_mode(layers, table_itemsize) == "resident"):
        return ("resident",)
    plan = plan_cluster(tuple(tuple(int(v) for v in l) for l in layers),
                        table_itemsize, unit_tile=int(tuning.unit_tile))
    return ("streamed", plan.cluster, plan.rows, plan.ring_units)


def _model_pick(layers: Sequence[Sequence[int]], *, table_itemsize: int,
                batch: int, device: str,
                table_dtype: Optional[str]) -> KernelTuning:
    """:func:`pick_tuning` for ``device``; on a GPU its mode is then the
    shared-memory fit of :func:`hopper_mode`."""
    device = device_kind(device)
    t = pick_tuning(layers, table_itemsize=table_itemsize, batch=batch,
                    device=device, table_dtype=table_dtype)
    if device == "gpu":
        t = dataclasses.replace(t, mode=hopper_mode(layers, table_itemsize))
    return t


def default_tuning(layers: Sequence[Sequence[int]], *,
                   table_itemsize: int = 4,
                   table_dtype: Optional[str] = None,
                   device=None) -> KernelTuning:
    """The tuning stamped on fresh plans: the roofline pick for the
    planning device (``source="default"``), on a GPU with the mode of
    :func:`hopper_mode`."""
    t = _model_pick(layers, table_itemsize=table_itemsize, batch=4096,
                    device=device, table_dtype=table_dtype)
    return dataclasses.replace(t, source="default")


def measure_tuning(run_factory: Callable[[KernelTuning], Callable[[], Any]],
                   candidates: Sequence[KernelTuning], *, reps: int = 3,
                   clock: Callable[[], float] = time.perf_counter
                   ) -> Tuple[KernelTuning, List[Dict[str, Any]]]:
    """Time each candidate and return (fastest, per-candidate report).

    ``run_factory(tuning)`` returns a nullary callable that runs one full
    cascade pass with that tuning and returns when it is done (on the card
    it synchronises).  The first call of each runner is a warm-up and is
    not timed.  Reps are interleaved across candidates so that a slow
    phase of the host hits all of them alike, and the best of each is
    kept.  ``clock`` is the timer (seconds); ties go to the earlier
    candidate.
    """
    if not candidates:
        raise ValueError("measure_tuning: empty candidate list")
    runners = [run_factory(t) for t in candidates]
    for r in runners:
        r()
    best = [math.inf] * len(candidates)
    for _ in range(max(1, reps)):
        for i, r in enumerate(runners):
            t0 = clock()
            r()
            best[i] = min(best[i], clock() - t0)
    report = [{"tuning": t.to_meta(), "best_s": round(b, 6)}
              for t, b in zip(candidates, best)]
    winner = dataclasses.replace(
        candidates[min(range(len(best)), key=best.__getitem__)],
        source="measured")
    return winner, report


def measurement_grid(layers: Sequence[Sequence[int]], *,
                     table_itemsize: int = 4,
                     table_dtype: Optional[str] = None,
                     max_candidates: int = 6,
                     device=None) -> List[KernelTuning]:
    """The top ``max_candidates`` feasible roofline candidates of
    ``device`` (default: the card when there is one), fastest first, as
    tunings with ``source="roofline"``; the default tuning when none is
    feasible.  On a GPU only the first-ranked candidate of each launch
    (:func:`hopper_launch`) is kept."""
    rows = [r for r in roofline_candidates(layers,
                                           table_itemsize=table_itemsize,
                                           device=device)
            if r["fits_vmem"]]
    rows.sort(key=lambda r: r["t_us"])
    grid = [KernelTuning(mode=r["mode"], block_b=r["block_b"],
                         unit_tile=r["unit_tile"] or 8,
                         table_dtype=table_dtype, source="roofline")
            for r in rows]
    if device_kind(device) == "gpu":
        # many tunings make one card launch: keep each launch's first
        first = {}
        for t in grid:
            first.setdefault(hopper_launch(t, layers, table_itemsize), t)
        grid = list(first.values())
    return grid[:max_candidates] or [KernelTuning(table_dtype=table_dtype)]


def choice_table(tasks: Optional[Sequence[str]] = None,
                 devices: Sequence[str] = ("cpu", "tpu"),
                 batch: int = 4096) -> Dict[str, Any]:
    """The model's tuning per (paper task, device), from the task configs
    alone (no training, no timing).  ``"gpu"`` is the H100 row, its mode
    the shared-memory fit of :func:`hopper_mode`, as planning on the card
    stamps it."""
    from repro_torch.configs import paper_tasks
    tasks = list(tasks or sorted(paper_tasks.TASKS))
    out: Dict[str, Any] = {"batch": batch, "choices": []}
    for task in tasks:
        cfg = paper_tasks.task_config(task)
        layers, off = [], 0
        for l, spec in enumerate(cfg.layers):
            entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
            layers.append((cfg.prev_width(l), spec.units, entries, off,
                           spec.fan_in, cfg.in_bits(l),
                           int(spec.assemble)))
            off += spec.units
        max_bits = max(spec.bits for spec in cfg.layers)
        itemsize = 1 if max_bits <= 7 else (2 if max_bits <= 15 else 4)
        for dev in devices:
            t = _model_pick(layers, table_itemsize=itemsize, batch=batch,
                            device=dev, table_dtype=None)
            out["choices"].append({
                "task": task, "device": dev,
                "table_itemsize": itemsize,
                "resident_bytes": resident_bytes(layers, itemsize),
                "tuning": t.to_meta(),
            })
    return out
