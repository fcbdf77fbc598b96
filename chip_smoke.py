#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/repro_torch``, holds
each against its plain PyTorch version on the card at the main path's
shapes, serves full-width ``mnist`` (fused backend, streamed kernel K2) and
full ``nid`` (fused backend, resident kernel K1; per-layer ``pallas``
backend, lookup kernel K3) from a saved and reloaded artifact through
``LUTEngine``, checks the served codes against the ``take`` backend on the
card and the plain CPU path, and times every kernel.  Weights are random,
drawn with ``numpy.random.RandomState(seed)``.

Any failed phase exits nonzero.  The last two lines of standard output are
a JSON object with every kernel's launches, error and times, then
``{"ok": true, "device": {...}}``.  A full report goes to
``build/chip_smoke/report.json``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor f32 rate, used for int32
SOURCE = "src/repro_torch/kernels/csrc/lut_kernels.cu"
REPLACES = {
    "lut_cascade_resident": "src/repro/kernels/lut_cascade.py:136",
    "lut_cascade_streamed": "src/repro/kernels/lut_cascade.py:193",
    "lut_lookup": "src/repro/kernels/lut_gather.py:40",
}


def fail(msg: str) -> None:
    """Report a failed phase and exit nonzero before any result line."""
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def random_network(cfg, seed: int):
    """Tables (codes below 2^bits), random mappings and log-scales."""
    import numpy as np
    rs = np.random.RandomState(seed)
    tables, maps = [], []
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        tables.append(rs.randint(0, 2 ** spec.bits,
                                 size=(spec.units, entries)).astype(np.int32))
        maps.append(None if spec.assemble else rs.randint(
            0, cfg.prev_width(l), size=(spec.units, spec.fan_in)
        ).astype(np.int32))
    return tables, maps, float(rs.uniform(-2.0, 0.0)), float(rs.uniform(-3.0, 0.0))


def per_call_ms(fn, calls: int = 40, reps: int = 5) -> float:
    """Device time per call: CUDA events around ``calls`` back-to-back
    calls, median over ``reps`` runs (after a warm-up)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def profile(fn, calls: int = 10):
    """(wall s, {kernel name: (launches, device s)}) of ``calls`` calls
    under torch.profiler; device times come from the CUDA trace."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us and getattr(ev, "device_type", None) is not None and \
                "CUDA" in str(ev.device_type):
            kernels[ev.key] = (ev.count, dev_us * 1e-6)
    return wall, kernels


def cascade_work(layers, batch: int, table_bytes: int, map_bytes: int):
    """(bytes, int ops) one cascade pass must at least move and do."""
    w0, n_out = layers[0][0], layers[-1][1]
    byts = batch * (w0 + n_out) * 4 + table_bytes + map_bytes
    ops = sum(batch * l[1] * 2 * l[4] for l in layers)
    return byts, ops


def bound(byts: int, ops: int):
    """(bound_ms, bound_by) from bytes and operations."""
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def main(seed: int) -> dict:
    """Run every phase; return the report (exits on the first failure)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from repro_torch import pipeline
        from repro_torch.configs import paper_tasks
        from repro_torch.kernels import build, lut_cascade, lut_gather
        from repro_torch.serve.lut_engine import LUTEngine
    except ImportError as e:
        fail(f"the port's package is not importable next to this script: {e}")

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {name}", flush=True)
    print(smi, flush=True)
    report = {"device": name, "nvidia_smi": smi, "seed": seed}

    # -- phase 2: build ------------------------------------------------------
    try:
        lib_path, build_s, ptxas = build.build()
        build.library()
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    print(f"build: {build_s:.1f} s -> {lib_path.name}", flush=True)
    for line in ptxas.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas " + line.split("ptxas info    :")[-1].strip())
    report["build_s"] = build_s

    # networks from the paper's Table II, random weights
    nets = {}
    for task in ("mnist", "jsc_cernbox", "jsc_openml", "nid"):
        cfg = paper_tasks.task_config(task)
        tables, maps, ils, ols = random_network(cfg, seed)
        net = pipeline.CompiledLUTNetwork(cfg, tables, maps, ils, ols,
                                          device=dev)
        nets[task] = net
    rs = np.random.RandomState(seed + 1)

    # -- phase 3: each kernel against its plain version ----------------------
    errs = {k: 0 for k in REPLACES}
    t3 = time.perf_counter()
    mnist_plan = nets["mnist"].compile_backend("pallas").plan
    for l, lm in enumerate(mnist_plan.meta["layers"]):
        table = mnist_plan.tensor(f"table_{l}", dev)
        for b in (1, 257, 4096):
            addr = torch.from_numpy(rs.randint(
                0, table.shape[1], size=(b, table.shape[0])).astype(np.int32)
            ).to(dev)
            got = lut_gather.lut_lookup_cuda(table, addr)
            torch.cuda.synchronize()
            want = lut_gather.lut_lookup_plain(table, addr)
            errs["lut_lookup"] = max(errs["lut_lookup"], int(
                (got - want).abs().max()))
    checks = [("lut_cascade_resident", t, None) for t in ("nid", "jsc_openml")]
    checks += [("lut_cascade_streamed", t, ut)
               for t in ("mnist", "jsc_cernbox") for ut in (8, 16, 32)]
    for kname, task, ut in checks:
        plan = nets[task].compile_backend("fused").plan
        layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
        tables = plan.tensor("tables", dev)
        maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
                else None for l in range(len(layers))]
        ops = lut_cascade.prepare(tables, layers, maps)
        span = 2 ** layers[0][5]
        for b in (1, 33, 257, 4096):
            codes = torch.from_numpy(rs.randint(
                0, span, size=(b, layers[0][0])).astype(np.int32)).to(dev)
            if ut is None:
                got = lut_cascade.lut_cascade_resident(codes, ops)
            else:
                got = lut_cascade.lut_cascade_streamed(codes, ops,
                                                       unit_tile=ut)
            torch.cuda.synchronize()
            want = lut_cascade.lut_cascade_plain(codes, tables, maps, layers)
            errs[kname] = max(errs[kname], int((got - want).abs().max()))
    print(f"kernels vs plain versions: max |diff| {errs} "
          f"({time.perf_counter() - t3:.1f} s)", flush=True)
    if any(errs.values()):
        fail(f"a kernel disagrees with its plain version: {errs}")

    # -- phase 4: serve from a reloaded artifact through LUTEngine ----------
    art_dir = ROOT / "build" / "chip_smoke"
    art_dir.mkdir(parents=True, exist_ok=True)
    serving = {}
    runs = (("mnist", "fused", "lut_cascade_streamed"),
            ("nid", "fused", "lut_cascade_resident"),
            ("nid", "pallas", "lut_lookup"))
    for task, backend, kname in runs:
        src = nets[task]
        src.compile_backend(backend)
        path = src.save(str(art_dir / f"{task}_{backend}.npz"))
        net = pipeline.CompiledLUTNetwork.load(path, device=dev)
        xs = rs.uniform(-1.0, 1.0, (8192, net.cfg.in_features)
                        ).astype(np.float32)
        eng = LUTEngine(net, block=1024, depth=2, backend=backend)
        eng.run(xs[:1024])                       # warm-up, not counted
        eng = LUTEngine(net, block=1024, depth=2, backend=backend)
        torch.cuda.synchronize()
        build.reset_counters()
        t0 = time.perf_counter()
        reqs = eng.submit_many(xs)
        while eng.queue:
            eng.tick()
        eng.drain()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        if counts.get(kname, 0) < 1:
            fail(f"{task}/{backend}: kernel {kname} was not launched "
                 f"(counts {counts})")
        got = np.stack([r.codes for r in reqs])
        take = net.predict_codes(xs, backend="take").cpu().numpy()
        cpu = pipeline.CompiledLUTNetwork.load(path, device="cpu")
        plain = cpu.predict_codes(xs, backend=backend).numpy()
        if not (np.array_equal(got, take) and np.array_equal(got, plain)):
            fail(f"{task}/{backend}: served codes differ from take on the "
                 "card or from the plain CPU path")
        logits = np.stack([r.logits for r in reqs])
        if logits.shape != (8192, net.cfg.layers[-1].units) or \
                not np.isfinite(logits).all():
            fail(f"{task}/{backend}: bad logits {logits.shape}")
        serving[f"{task}/{backend}"] = {
            "rows": 8192, "block": 1024, "depth": 2, "launches": counts,
            "rows_per_s": 8192 / wall,
            "p50_tick_us": eng.stats.latency_us(50),
            "p99_tick_us": eng.stats.latency_us(99),
        }
        print(f"serve {task}/{backend}: 8192 rows, codes == take == CPU, "
              f"{8192 / wall:,.0f} rows/s, p50 {eng.stats.latency_us(50):.0f}"
              f" us, p99 {eng.stats.latency_us(99):.0f} us, launches "
              f"{counts} [{smi}]", flush=True)
    report["serving"] = serving

    # -- phase 5: kernel times at the main path's shapes (block 1024) -------
    # Each kernel's "ms" is one main-path block of 1024 rows: one launch of
    # K1/K2, one launch per layer of K3 (nid has 5 layers).  Times are CUDA
    # events around 40 back-to-back blocks; device_ms is the kernels' own
    # time in the profiler's CUDA trace.
    kernels = []
    b = 1024
    substr = {"lut_cascade_streamed": "cascade_streamed_kernel",
              "lut_cascade_resident": "cascade_resident_kernel",
              "lut_lookup": "lut_lookup_kernel"}
    for kname, task in (("lut_cascade_streamed", "mnist"),
                        ("lut_cascade_resident", "nid")):
        plan = nets[task].compile_backend("fused").plan
        layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
        tables = plan.tensor("tables", dev)
        maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
                else None for l in range(len(layers))]
        ops = lut_cascade.prepare(tables, layers, maps)
        codes = torch.from_numpy(rs.randint(
            0, 2 ** layers[0][5], size=(b, layers[0][0])).astype(np.int32)
        ).to(dev)
        if kname == "lut_cascade_streamed":
            ut = plan.meta["tuning"]["unit_tile"]
            kern = lambda: lut_cascade.lut_cascade_streamed(  # noqa: E731
                codes, ops, unit_tile=ut)
        else:
            kern = lambda: lut_cascade.lut_cascade_resident(  # noqa: E731
                codes, ops)
        plain = lambda: lut_cascade.lut_cascade_plain(  # noqa: E731
            codes, tables, maps, layers)
        byts, n_ops = cascade_work(layers, b, tables.numel()
                                   * tables.element_size(),
                                   ops.map_words * 4)
        kernels.append({"name": kname, "task": task, "batch": b,
                        "kernel": kern, "plain": plain, "library": None,
                        "bytes": byts, "ops": n_ops})
    plan = nets["nid"].compile_backend("pallas").plan
    shapes = []
    for l in range(len(plan.meta["layers"])):
        table = plan.tensor(f"table_{l}", dev)
        addr = torch.from_numpy(rs.randint(
            0, table.shape[1], size=(b, table.shape[0])).astype(np.int32)
        ).to(dev)
        shapes.append((table, addr))
    kernels.append({
        "name": "lut_lookup", "task": "nid", "batch": b,
        "kernel": lambda: [lut_gather.lut_lookup_cuda(t, a)
                           for t, a in shapes],
        "plain": lambda: [lut_gather.lut_lookup_plain(t, a)
                          for t, a in shapes],
        "library": lambda: [torch.gather(t, 1, a.t().long()).t()
                            for t, a in shapes],
        "bytes": sum(a.numel() * 8 + t.numel() * 4 for t, a in shapes),
        "ops": 0})
    for k in kernels:
        k["ms"] = per_call_ms(k["kernel"])
        k["plain_ms"] = per_call_ms(k["plain"])
        k["library_ms"] = (None if k["library"] is None
                           else per_call_ms(k["library"]))
        _, prof = profile(k["kernel"])
        hits = [v for key, v in prof.items() if substr[k["name"]] in key]
        k["device_ms"] = (sum(s for _, s in hits) * 1e3 / 10 if hits
                          else None)
        k["bound_ms"], k["bound_by"] = bound(k["bytes"], k["ops"])
        for fn in ("kernel", "plain", "library"):
            del k[fn]

    # the engine under the profiler: device busy share of a serving pass
    for key, (task, backend) in (("mnist/fused", ("mnist", "fused")),
                                 ("nid/fused", ("nid", "fused")),
                                 ("nid/pallas", ("nid", "pallas"))):
        net = nets[task]
        xs = rs.uniform(-1.0, 1.0, (8192, net.cfg.in_features)
                        ).astype(np.float32)
        eng = LUTEngine(net, block=1024, depth=2, backend=backend)
        wall, prof = profile(lambda: eng.run(xs), calls=1)
        busy = sum(s for _, s in prof.values())
        serving[key]["profiled_wall_s"] = wall
        serving[key]["device_busy_s"] = busy
        serving[key]["device_idle_share"] = 1.0 - busy / wall
        print(f"profile {key}: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy * 1e3:.3f} ms, idle share {1.0 - busy / wall:.3f} "
              f"[{smi}]", flush=True)
    for k in kernels:
        k["launches"] = serving[{"lut_cascade_streamed": "mnist/fused",
                                 "lut_cascade_resident": "nid/fused",
                                 "lut_lookup": "nid/pallas"}[k["name"]]
                                ]["launches"][k["name"]]
        k["max_abs_err"] = errs[k["name"]]
        k["route"] = "cuda"
        k["source"] = SOURCE
        k["replaces"] = REPLACES[k["name"]]
        print(f"time {k['name']} ({k['task']}, block of {b} rows): kernel "
              f"{k['ms']:.4f} ms (device {k['device_ms']} ms), plain "
              f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms, bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']}) [{smi}]", flush=True)
    report["kernels"] = kernels
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rep = main(args.seed)
    import torch
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "report.json").write_text(json.dumps(rep, indent=1))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in rep["kernels"]]}))
    print(rep["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
