"""Backend sweep of the port: every registered lookup backend x the reduced
paper tasks -> ``experiments/TORCH_lut_backends.json``.

The port's counterpart of ``benchmarks/lut_backends.py``.  For each (task,
batch) cell the sweep plans each backend once through
``CompiledLUTNetwork.compile_backend``, checks that its ``predict_codes``
equals the ``take`` oracle's bit for bit, times the planned executor (µs a
call: ``reps`` calls between two ``torch.cuda.synchronize``, after two
warm-up calls) and reports the speedup against ``take``.  Each cell also
records the kernel launches a call made (``fused``: one K1 launch on a
reduced task, whose tables are resident; ``pallas``: one K3 launch a
layer).  The networks are ``reduced(task)`` folded from a seeded init on
the device; the rows are uniform in [-1, 1) from ``numpy``, placed on the
device before timing.

    python3 benchmarks/torch_lut_backends.py [--fast] [--device cuda]
        [--out PATH]

Runs on the card by default and fails without one; ``--device cpu`` runs
the plain path (its times are the CPU's, not the card's).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

DEFAULT_OUT = os.path.join(ROOT, "experiments", "TORCH_lut_backends.json")
# every record the gate reads carries a schema_version
SCHEMA_VERSION = 1
# the one definition of "smoke-sized" (chip_smoke.py and torch_run.py --fast)
FAST_KW = dict(batches=(64,), reps=3)
TASKS = ("mnist", "jsc", "nid")
LUT_KERNELS = ("lut_cascade_resident", "lut_cascade_streamed", "lut_lookup")


def smi() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def device_record(dev) -> dict:
    """The device a record was measured on, with the card's power limit."""
    import torch
    if dev.type != "cuda":
        return {"type": dev.type, "name": "cpu", "count": 0,
                "nvidia_smi": None}
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count(), "nvidia_smi": smi()}


def sync(dev) -> None:
    """Wait for the device (a no-op on the CPU)."""
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def write_results(results: dict, out: str = DEFAULT_OUT) -> str:
    out = os.path.abspath(out)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
        f.write("\n")
    return out


def make_network(task: str, seed: int, dev):
    """``reduced(task)`` folded from the port's seeded init on ``dev``."""
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble
    cfg = paper_tasks.reduced(task)
    return pipeline.compile_network(assemble.init(seed, cfg, device=dev),
                                    cfg)


def random_rows(in_features: int, n: int, seed: int):
    """``[n, in_features]`` f32 rows uniform in [-1, 1) from ``seed``."""
    import numpy as np
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, in_features)).astype(np.float32)


def time_call(fn, x, reps: int, dev, warmup: int = 2) -> float:
    """µs a call of ``fn(x)``: ``reps`` calls between two synchronizes."""
    for _ in range(warmup):
        fn(x)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    sync(dev)
    return (time.perf_counter() - t0) / reps * 1e6


def launch_delta(fn, dev):
    """(``fn()``, the LUT kernel launches it made, by kernel).  Counted by
    difference, so a caller's count over a longer run stays whole; empty
    on the CPU, where no kernel launches."""
    from repro_torch.kernels import build
    sync(dev)
    before = build.launch_counts()
    out = fn()
    sync(dev)
    after = build.launch_counts()
    return out, {k: after[k] - before.get(k, 0) for k in LUT_KERNELS
                 if after.get(k, 0) - before.get(k, 0)}


def launches_per_call(fn, x, dev, calls: int = 2) -> dict:
    """Kernel launches one call of ``fn(x)`` makes (counted over
    ``calls``), by kernel; empty on the CPU."""
    _, counts = launch_delta(lambda: [fn(x) for _ in range(calls)], dev)
    return {k: v / calls for k, v in counts.items()}


def sweep(tasks=TASKS, batches=(256, 1024), reps: int = 10, seed: int = 0,
          device=None) -> dict:
    """The record: a cell a task and batch."""
    import numpy as np
    import torch
    from repro_torch import backends
    from repro_torch import device as _device

    dev = _device.resolve(device)
    names = backends.available()
    results = {"schema_version": SCHEMA_VERSION,
               "device": device_record(dev), "tasks": {},
               "backends": {name: vars(backends.get(name).capabilities())
                            for name in names}}
    for task in tasks:
        compiled = make_network(task, seed, dev)
        cfg = compiled.cfg
        cells = []
        for batch in batches:
            # on the device already, as the reference's rows are: a call
            # times the executor, not a host-to-device copy
            x = torch.from_numpy(random_rows(cfg.in_features, batch, seed + 1)
                                 ).to(dev)
            ref = compiled.predict_codes(x, backend="take").cpu().numpy()
            row = {"batch": batch, "us": {}, "speedup_vs_take": {},
                   "bit_identical": {}, "launches_per_call": {}}
            for name in names:
                ex = compiled.compile_backend(name)
                row["bit_identical"][name] = bool(np.array_equal(
                    ex.predict_codes(x).cpu().numpy(), ref))
                row["launches_per_call"][name] = launches_per_call(
                    ex.predict_codes, x, dev)
                row["us"][name] = round(
                    time_call(ex.predict_codes, x, reps, dev), 1)
            for name, us in row["us"].items():
                row["speedup_vs_take"][name] = round(
                    row["us"]["take"] / us, 3) if us else None
            cells.append(row)
        results["tasks"][task] = {
            "config": {"in_features": cfg.in_features,
                       "layers": [vars(l) for l in cfg.layers]},
            "cells": cells,
        }
    return results


def violations(results: dict) -> list:
    """Cells whose backend codes differ from ``take``'s."""
    return [(task, c["batch"], n)
            for task, t in results["tasks"].items() for c in t["cells"]
            for n, ok in c["bit_identical"].items() if not ok]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true",
                    help="tiny batches and reps (FAST_KW)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    results = sweep(**(FAST_KW if args.fast else {}), device=args.device)
    out = write_results(results, args.out)

    print("task,batch,backend,us_per_call,speedup_vs_take,bit_identical,"
          "launches_per_call")
    for task, t in results["tasks"].items():
        for cell in t["cells"]:
            for name, us in cell["us"].items():
                print(f"{task},{cell['batch']},{name},{us},"
                      f"{cell['speedup_vs_take'][name]},"
                      f"{cell['bit_identical'][name]},"
                      f"\"{cell['launches_per_call'][name]}\"")
    print(results["device"])
    bad = violations(results)
    if bad:
        raise SystemExit(f"backends NOT bit-identical: {bad}")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
