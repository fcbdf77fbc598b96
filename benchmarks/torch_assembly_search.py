"""Assembly-search benchmark of the PyTorch/CUDA port: the Pareto frontier
per task as JSON (the counterpart of ``benchmarks/assembly_search.py``).

Runs ``repro_torch.search`` (``Toolflow.search``) over registered tasks on
the card and writes ``experiments/TORCH_assembly_search.json`` in the
reference benchmark's schema: per task the ranked frontier (accuracy,
calibrated LUT count, calibrated area-delay product), the best accuracy
and the search's bookkeeping (candidates, rejections, rung trajectories,
wall time by stage), plus the card's name and power limit and the K4
launches of the run.  Every frontier artifact is saved, loaded and
checked bit-identical on every registered backend against ``take``; a
mismatch is recorded and fails the CLI.

``--fast``: ``nid_reduced`` and ``jsc_reduced`` on the smoke budget.
``--task NAME``: one task on the full default budget.  ``--dist-compare``
adds, per task, the slot mesh (``launch.mesh.make_serving_mesh``,
``--slots`` slots over the visible cards; several share a card when there
are fewer) against the unsliced single-device run, and
``survivors_match``: whether the mesh run and a sequential run of the
same slice programs picked identical rung survivors.

    python3 benchmarks/torch_assembly_search.py [--fast] [--task NAME]
        [--tasks A,B,...] [--dist-compare] [--slots N] [--device cpu]
        [--out PATH]

The card is the default; ``--device cpu`` rehearses on the plain path
(write it elsewhere than the default ``--out``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

DEFAULT_OUT = ROOT / "experiments" / "TORCH_assembly_search.json"
SCHEMA_VERSION = 1
FAST_TASKS = ("nid_reduced", "jsc_reduced")


def _device_info(dev) -> dict:
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": smi}


def _artifact_contract(point, dev, batch: int = 64, seed: int = 0) -> dict:
    """Save/load round-trip and bit-identity of one frontier artifact on
    every registered backend against ``take``: {backend: bool}."""
    from repro_torch import backends
    from repro_torch.pipeline import CompiledLUTNetwork

    x = np.random.RandomState(seed).uniform(
        -1.0, 1.0, (batch, point.cfg.in_features)).astype(np.float32)
    ref = point.compiled.predict_codes(x, backend="take").cpu().numpy()
    with tempfile.TemporaryDirectory() as td:
        path = point.compiled.save(os.path.join(td, "artifact.npz"))
        loaded = CompiledLUTNetwork.load(path, device=dev)
        return {name: bool(np.array_equal(
            loaded.predict_codes(x, backend=name).cpu().numpy(), ref))
            for name in backends.available()}


def _task_entry(res, dev) -> dict:
    frontier = res.summary()
    return {
        "frontier": frontier,
        "best_accuracy": max((p["accuracy"] for p in frontier),
                             default=0.0),
        "frontier_points": len(frontier),
        "bit_identical": {p["name"]: _artifact_contract(pt, dev)
                          for p, pt in zip(frontier, res.frontier)},
        "n_candidates": len(res.evaluated),
        "n_rejected": len(res.rejected),
        "evaluated": res.evaluated,
        "rungs": res.rungs,
        "stage_seconds": {k: sum(v) for k, v in res.stage_seconds.items()},
        "seconds": round(res.seconds, 1),
    }


def _budget_summary(budget) -> dict:
    return {"rungs": list(budget.rungs), "n_candidates": budget.n_candidates,
            "promote": budget.promote, "min_frontier": budget.min_frontier,
            "retrain_steps": budget.retrain_steps, "seed": budget.seed}


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def sweep(tasks, budget, dev) -> dict:
    from repro_torch.kernels import build
    from repro_torch.pipeline import Toolflow

    results = {"schema_version": SCHEMA_VERSION,
               "budget": _budget_summary(budget),
               "device": _device_info(dev), "tasks": {}}
    for task in tasks:
        _sync(dev)
        build.reset_counters()
        res = Toolflow.search(task, budget, device=dev)
        _sync(dev)
        entry = _task_entry(res, dev)
        entry["k4_launches"] = {k: v for k, v in build.launch_counts().items()
                                if k.startswith("unit_affine")}
        results["tasks"][task] = entry
    return results


def dist_compare(tasks, budget, dev, slots: int) -> dict:
    """Per task: the slot mesh against the unsliced single-device run, and
    the mesh's rung survivors against a sequential run of its slice
    programs (promotion-free: survivors are fixed before promotion)."""
    from repro_torch.configs import paper_tasks
    from repro_torch.data import synthetic
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.search import DistributedSearchBudget, run_search

    mesh = (make_serving_mesh(slots=slots, device="cpu") if dev.type == "cpu"
            else make_serving_mesh(slots=slots))
    dist_budget = DistributedSearchBudget.from_budget(
        budget, population_slices=slots)
    results = {"schema_version": SCHEMA_VERSION,
               "budget": _budget_summary(budget),
               "device": _device_info(dev),
               "slots": slots,
               "physical_devices": len({s.device for s in mesh.slots}),
               "tasks": {}, "dist_compare": {"tasks": {}}}
    for task in tasks:
        data = synthetic.load(paper_tasks.task_dataset(task),
                              n_train=max(budget.train_rows, 2048),
                              n_test=max(budget.eval_rows * 2, 2048))
        single = run_search(task, budget, data=data, device=dev)
        dist = run_search(task, dist_budget, data=data, mesh=mesh)
        ref = run_search(task, dataclasses.replace(
            dist_budget, promote=0, max_promote_extra=0, min_frontier=0),
            data=data, device=dev)
        survivors_match = ([r["survivors"] for r in ref.rungs]
                           == [r["survivors"] for r in dist.rungs])
        entry = _task_entry(dist, dev)
        results["tasks"][task] = entry
        results["dist_compare"]["tasks"][task] = {
            "single_seconds": round(single.seconds, 1),
            "dist_seconds": round(dist.seconds, 1),
            "speedup": round(single.seconds / max(dist.seconds, 1e-9), 3),
            "single_stage_seconds": {k: sum(v) for k, v in
                                     single.stage_seconds.items()},
            "survivors_match": survivors_match,
            "mode": dist.dist["mode"],
            "slices": dist.dist["slices"],
            "partial": dist.dist["partial"],
            "n_straggler_events": len(dist.dist["straggler_events"]),
            "n_remesh_events": len(dist.dist["remesh_events"]),
            "wider_on_frontier": any(p["additive"] or p["learned_beta"]
                                     for p in entry["frontier"]),
        }
    dc = results["dist_compare"]
    total_single = sum(t["single_seconds"] for t in dc["tasks"].values())
    total_dist = sum(t["dist_seconds"] for t in dc["tasks"].values())
    dc["total_single_seconds"] = round(total_single, 1)
    dc["total_dist_seconds"] = round(total_dist, 1)
    dc["speedup"] = round(total_single / max(total_dist, 1e-9), 3)
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="smoke budget on nid_reduced and jsc_reduced")
    ap.add_argument("--task", default=None,
                    help="one task on the full default budget")
    ap.add_argument("--tasks", default=None,
                    help="comma list of tasks (or 'all' / 'reduced'); "
                         "full budget unless --fast")
    ap.add_argument("--dist-compare", action="store_true",
                    help="the slot mesh against the single-device run")
    ap.add_argument("--slots", type=int, default=2,
                    help="mesh slots for --dist-compare (dealt over the "
                         "visible cards)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to rehearse; the card by default")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args()

    import torch
    from repro_torch import device as _device
    from repro_torch.configs import paper_tasks
    from repro_torch.search import SearchBudget

    dev = _device.resolve(args.device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if args.tasks:
        tasks = {"all": paper_tasks.task_names(),
                 "reduced": paper_tasks.reduced_task_names()}.get(
            args.tasks, tuple(args.tasks.split(",")))
    elif args.task:
        tasks = (args.task,)
    else:
        tasks = FAST_TASKS
    budget = (SearchBudget.smoke() if args.fast and not args.task
              else SearchBudget())
    t0 = time.time()
    if args.dist_compare:
        results = dist_compare(tasks, budget, dev, args.slots)
    else:
        results = sweep(tasks, budget, dev)
    results["wall_seconds"] = round(time.time() - t0, 1)
    out = Path(args.out).resolve()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=2) + "\n")

    print("task,point,accuracy,luts,adp,bit_identical")
    bad = []
    for task, t in results["tasks"].items():
        for p in t["frontier"]:
            ok = all(t["bit_identical"][p["name"]].values())
            print(f"{task},{p['name']},{p['accuracy']},{p['luts']},"
                  f"{p['adp']},{ok}")
            if not ok:
                bad.append((task, p["name"]))
        if not t["frontier"]:
            bad.append((task, "empty frontier"))
    for task, t in results.get("dist_compare", {}).get("tasks", {}).items():
        print(f"dist,{task},single={t['single_seconds']}s,"
              f"dist={t['dist_seconds']}s,speedup={t['speedup']},"
              f"survivors_match={t['survivors_match']}")
        if not t["survivors_match"]:
            bad.append((task, "mesh rung survivors differ from the "
                              "sequential slice run"))
    print(json.dumps(results["device"]))
    if bad:
        raise SystemExit(f"assembly-search contract violations: {bad}")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
