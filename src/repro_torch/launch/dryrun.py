"""The dry run (``repro.launch.dryrun``): every (arch x shape x mesh) cell
run once at production size without a device.

The reference lowers and compiles each cell against 512 placeholder XLA
devices.  The port runs the cell's step (``launch.steps.build_cell``)
once, in one process, as rank 0 of torch's fake process group
(``FakeStore``, backend ``"fake"``) of the mesh's size, on meta
``DTensor``s: every shape, placement and collective is real, nothing is
allocated and no collective moves data.  Sharding mismatches and
unsupported operations fail here, which is the point.  Each record holds:

* ``status``: ``ok``, ``skipped`` (with ``reason``, from
  ``steps.cell_runnable``) or ``error`` (with ``error`` and ``traceback``);
* ``design``: how the step computes over ``model`` (``steps.design``:
  ``tp`` or ``tp (q whole)``);
* ``collectives``: count and output bytes by kind (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) and ``total_bytes``, counted by
  ``torch.distributed.tensor.debug.CommDebugMode`` (the counterpart of
  the reference's HLO parse);
* ``tp_collectives``: the tensor-parallel design's share of those bytes
  by purpose and kind (``act_sharding.traffic``: ``ffn all-gather``, the
  FFN's hidden units gathered before ``w_down``, and its backward's
  ``ffn reduce-scatter``; ``moe ffn``, the experts' hidden units (``E C``
  slots a group, about ``top_k * capacity_factor`` times its tokens);
  ``head all-to-all``, the tied table's vocabulary rows; ``ssm in_proj
  all-to-all``, the hybrid's ``xs | z`` columns re-paired onto its
  channels, ``ssm dt`` / ``b`` / ``c all-reduce``, its partial sums over
  channels, and ``ssm channels``; ``rkv`` and ``rwkv heads``, RWKV's heads,
  ``rwkv ffn``, its channel mix, and ``ddl_b``, its one gathered weight;
  ``cross kv``, whisper's cross k and v; ``rows``, ``kv``, ``q``,
  ``heads``, ``norm`` and ``vocab``), empty when ``model`` is 1;
* ``cost_analysis.flops``: rank 0's flops, from
  ``torch.utils.flop_counter.FlopCounterMode`` (the meta forward of K5
  is its plain version a block of q rows at a time, the same products);
* ``memory_analysis``: ``argument_size_in_bytes`` (rank 0's shards of the
  step's arguments), ``param_bytes_per_rank`` and
  ``peak_bytes_per_rank`` (the peak while the step runs, arguments
  included, from ``torch.distributed._tools.mem_tracker.MemTracker``);
* ``devices``, ``mesh_shape``, ``run_s``.

The numbers are those of the port's meshed step as it stands: every
family computes each block on its weight shards (``tp``; the q heads
whole where they do not split evenly, ``tp (q whole)``).

The reference's ``hlo_bytes``, ``lower_s``, ``compile_s``, its HLO dump
and its loop-corrected ``analysis`` have no counterpart: nothing is
lowered or compiled.

``REPRO_DRYRUN_DEVICES`` sets the fake group's size (512 by default; a
mesh larger than it is an error); ``REPRO_MESH_SHAPE`` /
``REPRO_MESH_SHAPE_MULTI`` shrink the meshes (``launch.mesh``).  The
module sets no environment variable and starts no process group when it
is imported; :func:`run_cell` starts the fake group when it needs one.

Usage::

  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all     # every cell, cached
  python -m repro_torch.launch.dryrun --all --summary experiments/TORCH_dryrun_tp_families.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from collections import defaultdict
from typing import Dict, List, Optional

import torch

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "torch_dryrun")

# the card's memory: 80 GiB (H100 SXM)
DEVICE_BYTES = 80 * 2 ** 30
# a smoke cell's largest sequence and batch
SMOKE_SEQ, SMOKE_BATCH = 64, 8

_KINDS = {
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_gather": "all-gather", "allgather": "all-gather",
    "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
    "alltoall": "all-to-all",
}
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")


def _kind(name: str) -> str:
    """The reference's kind of a collective op (its own name for a kind
    the reference does not count, such as a broadcast)."""
    for key, kind in _KINDS.items():
        if key in name:
            return kind
    return name.rsplit(".", 1)[-1]


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


def _comm_mode():
    """A ``CommDebugMode`` that also sums each collective's output bytes
    by kind."""
    from torch.distributed.tensor.debug import CommDebugMode

    class _Counting(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes = defaultdict(int)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and not isinstance(
                    func, torch._ops.HigherOrderOperator):
                packet = func._overloadpacket
                if packet in self.comm_registry:
                    self.bytes[_kind(str(packet))] += _nbytes(out)
            return out

        def summary(self) -> Dict:
            stats = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
            for packet, n in self.get_comm_counts().items():
                stats.setdefault(_kind(str(packet)), {"count": 0,
                                                      "bytes": 0})
                stats[_kind(str(packet))]["count"] += int(n)
            for kind, b in self.bytes.items():
                stats.setdefault(kind, {"count": 0, "bytes": 0})
                stats[kind]["bytes"] += int(b)
            stats["total_bytes"] = sum(v["bytes"] for v in stats.values()
                                       if isinstance(v, dict))
            return stats
    return _Counting()


def _local_bytes(tree) -> int:
    """Bytes of rank 0's shards of every tensor in ``tree``."""
    from torch import nn
    from torch.distributed.tensor import DTensor
    if isinstance(tree, nn.Module):
        return sum(_local_bytes(p) for p in tree.parameters())
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    if isinstance(tree, torch.Tensor):
        return _nbytes(tree)
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    return 0


def fake_world() -> int:
    """The fake group's size: ``REPRO_DRYRUN_DEVICES``, else 512."""
    return int(os.environ.get("REPRO_DRYRUN_DEVICES") or 512)


def ensure_fake_group(world: int) -> None:
    """Make the default process group torch's fake group of ``world``
    ranks, this process rank 0 (replacing a fake group of another size;
    refusing to replace a real one)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the fake process group; "
                               "a real one is initialised")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             verbose: bool = True, smoke: bool = False) -> Dict:
    """One cell's record (see the module docstring); ``smoke`` takes the
    family's reduced config and cuts the shape to at most
    :data:`SMOKE_SEQ` positions and :data:`SMOKE_BATCH` rows (a batch of 1
    stays 1, so the replicated fallback still runs): a test's size."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import lm_archs
    from repro_torch.dist import act_sharding
    from repro_torch.launch import mesh as mesh_mod, steps

    cfg = lm_archs.smoke(arch) if smoke else lm_archs.get(arch)
    shape = steps.SHAPES[shape_name]
    if smoke:
        shape = dataclasses.replace(
            shape, seq_len=min(shape.seq_len, SMOKE_SEQ),
            global_batch=min(shape.global_batch, SMOKE_BATCH))
    ok, reason = steps.cell_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    mshape, axes = mesh_mod.production_shape(multi_pod=mesh_kind == "multi")
    n_dev = 1
    for n in mshape:
        n_dev *= n
    world = fake_world()
    if n_dev > world:
        raise RuntimeError(f"mesh {mshape} needs {n_dev} ranks; the fake "
                           f"group has {world} (REPRO_DRYRUN_DEVICES)")
    ensure_fake_group(world)
    t0 = time.time()
    mesh = mesh_mod.make_mesh(mshape, axes, device="meta")
    fn, args = steps.build_cell(cfg, shape, mesh)
    comm = _comm_mode()
    flops = FlopCounterMode(display=False)
    mem = MemTracker()
    mem.track_external(*[a for a in args if isinstance(a, torch.nn.Module)])
    with mem, comm, flops, act_sharding.traffic() as tp_bytes:
        fn(*args)
    peak = mem.get_tracker_snapshot("peak")
    peak_bytes = max((int(v.get("Total", 0)) for v in peak.values()),
                     default=0)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "mesh_shape": list(mshape), "devices": n_dev, "status": "ok",
        "design": steps.design(cfg, mesh),
        "run_s": round(time.time() - t0, 2),
        "memory_analysis": {
            "argument_size_in_bytes": _local_bytes(args),
            "param_bytes_per_rank": _local_bytes(args[0]),
            "peak_bytes_per_rank": peak_bytes,
            "fits_device": peak_bytes <= DEVICE_BYTES,
        },
        "cost_analysis": {"flops": float(flops.get_total_flops())},
        "collectives": comm.summary(),
        "tp_collectives": dict(sorted(tp_bytes.items())),
    }
    if verbose:
        print(json.dumps(record, indent=2))
    return record


def cell_path(arch: str, shape: str, mesh_kind: str,
              results_dir: str = RESULTS_DIR) -> str:
    """Where a cell's record is kept."""
    os.makedirs(results_dir, exist_ok=True)
    return os.path.join(results_dir, f"{arch}__{shape}__{mesh_kind}.json")


def run_and_save(arch: str, shape: str, mesh_kind: str, force: bool = False,
                 results_dir: str = RESULTS_DIR) -> Dict:
    """A cell's record, from its file when a finished one is kept."""
    path = cell_path(arch, shape, mesh_kind, results_dir)
    if os.path.exists(path) and not force:
        with open(path) as f:
            rec = json.load(f)
        if rec.get("status") in ("ok", "skipped"):
            print(f"[cached] {arch} {shape} {mesh_kind}: {rec['status']}")
            return rec
    try:
        rec = run_cell(arch, shape, mesh_kind, verbose=False)
    except Exception as e:  # noqa: BLE001 -- an error is a result here
        rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
               "status": "error", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
        print(rec["traceback"], file=sys.stderr)
    print(f"{arch} {shape} {mesh_kind}: {rec['status']}"
          + (f" ({rec.get('run_s')} s)" if rec["status"] == "ok" else ""))
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def summary(records: List[Dict]) -> Dict:
    """The grid in one table: each cell's status, per-rank bytes against
    the card's memory, collectives by kind and flops; errors listed."""
    cells = []
    for r in records:
        row = {k: r[k] for k in ("arch", "shape", "mesh", "status")}
        if r["status"] == "skipped":
            row["reason"] = r["reason"]
        elif r["status"] == "error":
            row["error"] = r["error"]
        else:
            ma = r["memory_analysis"]
            row.update(
                design=r["design"], mesh_shape=r["mesh_shape"],
                param_bytes_per_rank=ma["param_bytes_per_rank"],
                argument_bytes_per_rank=ma["argument_size_in_bytes"],
                peak_bytes_per_rank=ma["peak_bytes_per_rank"],
                peak_over_device=round(ma["peak_bytes_per_rank"]
                                       / DEVICE_BYTES, 4),
                flops_per_rank=r["cost_analysis"]["flops"],
                collectives={k: v for k, v in r["collectives"].items()
                             if k == "total_bytes" or v["count"]},
                tp_collectives=r["tp_collectives"])
        cells.append(row)
    count = defaultdict(int)
    for c in cells:
        count[c["status"]] += 1
    return {"device_bytes": DEVICE_BYTES,
            "counts": dict(count),
            "errors": [c for c in cells if c["status"] == "error"],
            "cells": cells}


def main(argv: Optional[List[str]] = None) -> None:
    """Run one cell, or ``--all`` of them; exits non-zero on an error."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results-dir", default=RESULTS_DIR)
    ap.add_argument("--summary", default=None,
                    help="write the grid's summary JSON here (--all)")
    args = ap.parse_args(argv)

    from repro_torch.configs import lm_archs
    from repro_torch.launch import steps

    if args.all:
        recs = [run_and_save(arch, shape, mesh_kind, force=args.force,
                             results_dir=args.results_dir)
                for arch in lm_archs.ARCHS for shape in steps.SHAPES
                for mesh_kind in ("single", "multi")]
        if args.summary:
            with open(args.summary, "w") as f:
                json.dump(summary(recs), f, indent=1)
        sys.exit(1 if any(r["status"] == "error" for r in recs) else 0)
    rec = run_and_save(args.arch, args.shape, args.mesh, force=args.force,
                       results_dir=args.results_dir)
    print(json.dumps({k: v for k, v in rec.items() if k != "traceback"},
                     indent=2))
    sys.exit(0 if rec["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
