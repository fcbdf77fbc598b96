"""Benchmark harness of the port: the counterpart of ``benchmarks/run.py``.

One function a bench: the kernel micro-benchmarks, the port's benches
(``torch_lut_backends``, ``torch_lut_throughput``,
``torch_assembly_search``, ``torch_fleet_serving``,
``torch_stream_serving``, ``torch_chaos_soak``, ``torch_paper_tables``),
and the roofline report (``torch_roofline``).  Prints
``name,us_per_call,derived`` CSV rows, then the roofline tables.

``kernels`` times, on the device and synchronised after every call:
``ops.lut_lookup`` on ``take``, ``onehot`` and ``pallas`` (K3 on the card)
at batch 4,096, 256 units and 64 entries; the ``nid_reduced`` quantized
forward at batch 1,024; the folded forward on every registered backend;
the 256-row ``LUTEngine``.  The other choices run the benches (those with
a CLI of their own in a subprocess, which fails this harness when the
bench's contract fails) and write their records into ``--out-dir``
(``experiments/`` by default, where the gate reads them: write a scratch
run elsewhere).  The search runs ``--dist-compare`` on the reduced tasks
into ``TORCH_assembly_search_reduced.json``.

    python3 benchmarks/torch_run.py [--fast] [--only NAME] [--device cuda]
        [--out-dir DIR]

Runs on the card by default and fails without one (``--only roofline``
touches no device); ``--device cpu`` runs the plain path.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
from torch_lut_backends import ROOT, sync  # noqa: E402

EXPERIMENTS = os.path.join(ROOT, "experiments")
CHOICES = ("kernels", "backends", "throughput", "tables", "roofline",
           "search", "fleet", "stream", "chaos")


def _time_call(fn, *args, dev, reps: int = 5, warmup: int = 2) -> float:
    """µs a call, each call synchronised on the device."""
    for _ in range(warmup):
        fn(*args)
        sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
        sync(dev)
    return (time.perf_counter() - t0) / reps * 1e6


def bench_kernels(rows: list, dev) -> None:
    """LUT lookup implementations, and quantized against folded inference
    on ``nid_reduced``."""
    import numpy as np
    import torch
    from repro_torch import backends, pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble
    from repro_torch.data import synthetic
    from repro_torch.kernels import ops
    from repro_torch.serve.lut_engine import LUTEngine

    gen = torch.Generator().manual_seed(0)
    table = torch.randint(0, 255, (256, 64), generator=gen,
                          dtype=torch.int32).to(dev)
    addr = torch.randint(0, 64, (4096, 256), generator=gen,
                         dtype=torch.int32).to(dev)
    for impl in ("take", "onehot", "pallas"):
        us = _time_call(lambda t, a, i=impl: ops.lut_lookup(t, a, impl=i),
                        table, addr, dev=dev)
        rows.append((f"lut_lookup_{impl}", us,
                     "batch=4096 units=256 entries=64"))

    cfg = paper_tasks.reduced("nid")
    data = synthetic.load("nid", n_train=64, n_test=2048)
    params = assemble.init(0, cfg, device=dev)
    x = torch.as_tensor(data.x_test[:1024], dtype=torch.float32).to(dev)
    compiled = pipeline.compile_network(params, cfg)

    def q_fwd(xx):
        with torch.no_grad():
            return assemble.apply_codes(params, cfg, xx)

    rows.append(("nid_quantized_forward", _time_call(q_fwd, x, dev=dev),
                 "batch=1024"))
    for impl in backends.available():
        us = _time_call(lambda xx, i=impl: compiled.predict_codes(
            xx, backend=i), x, dev=dev)
        rows.append((f"nid_folded_forward_{impl}", us,
                     "batch=1024 (pure table lookups)"))
    eng = LUTEngine(compiled, block=256)
    xs = np.asarray(x.cpu())
    rows.append(("nid_lut_engine", _time_call(eng.run, xs, dev=dev),
                 "batch=1024 via 256-row micro-batching engine"))


def bench_backends(rows: list, fast: bool, dev, out_dir: str) -> None:
    """Registered-backend sweep (writes TORCH_lut_backends.json)."""
    import torch_lut_backends as bk
    t0 = time.time()
    res = bk.sweep(**(bk.FAST_KW if fast else {}), device=dev)
    bk.write_results(res, os.path.join(out_dir, "TORCH_lut_backends.json"))
    cell = res["tasks"]["nid"]["cells"][-1]
    rows.append(("lut_backend_sweep", (time.time() - t0) * 1e6,
                 "fused speedup vs take (nid) "
                 f"{cell['speedup_vs_take'].get('fused')}x"))


def bench_throughput(rows: list, fast: bool, dev, out_dir: str) -> None:
    """Serving-throughput sweep (writes TORCH_lut_throughput.json)."""
    import torch_lut_throughput as tp
    t0 = time.time()
    res = tp.sweep(**(tp.FAST_KW if fast else {}), device=dev)
    tp.write_results(res, os.path.join(out_dir,
                                       "TORCH_lut_throughput.json"))
    big = [c for c in res["engine"] if c["block"] >= 256]
    best = max(big, key=lambda c: c["async_speedup"]) if big else None
    derived = (f"async speedup {best['async_speedup']}x "
               f"({best['backend']}@{best['block']})" if best else "")
    rows.append(("lut_throughput_sweep", (time.time() - t0) * 1e6, derived))


def _script(rows: list, name: str, script: str, args: list, out: str,
            derive) -> dict:
    """Run ``benchmarks/<script>`` writing ``out``; fails on its exit."""
    t0 = time.time()
    subprocess.run([sys.executable, os.path.join(HERE, script), *args,
                    "--out", out], check=True)
    with open(out) as f:
        rec = json.load(f)
    rows.append((name, (time.time() - t0) * 1e6, derive(rec)))
    return rec


def bench_search(rows: list, fast: bool, dev, out_dir: str) -> None:
    """Assembly search, sliced against unsliced, on the reduced tasks."""
    args = ["--device", str(dev), "--dist-compare"]
    args += (["--fast"] if fast else
             ["--tasks", "nid_reduced,jsc_reduced,mnist_reduced"])
    _script(rows, "assembly_search_sweep", "torch_assembly_search.py", args,
            os.path.join(out_dir, "TORCH_assembly_search_reduced.json"),
            lambda res: "; ".join(
                f"{task}: {t['frontier_points']}pt best_acc="
                f"{t['best_accuracy']}" for task, t in res["tasks"].items()))


def bench_fleet(rows: list, fast: bool, dev, out_dir: str) -> None:
    """Multi-tenant fleet serving (writes TORCH_fleet.json)."""
    args = ["--device", str(dev)]
    if fast:
        args += ["--reduced", "--events", "24", "--reps", "2",
                 "--block", "128"]
    _script(rows, "fleet_serving_sweep", "torch_fleet_serving.py", args,
            os.path.join(out_dir, "TORCH_fleet.json"),
            lambda res: (f"online speedup "
                         f"{res['online']['speedup_vs_isolated_sync']}x "
                         f"({res['online']['fleet_blocks']} vs "
                         f"{res['online']['isolated_blocks']} blocks)"))


def bench_stream(rows: list, fast: bool, dev, out_dir: str) -> None:
    """Stateful stream serving (writes TORCH_stream.json)."""
    args = ["--device", str(dev)] + (["--fast"] if fast else [])

    def derive(res):
        peak = max(res["scaling"], key=lambda p: p["streams"])
        return (f"{peak['streams']} streams {peak['steps_per_s']:.1f} "
                f"steps/s p99 {peak['p99_step_us']:.1f}us")

    _script(rows, "stream_serving_sweep", "torch_stream_serving.py", args,
            os.path.join(out_dir, "TORCH_stream.json"), derive)


def bench_chaos(rows: list, fast: bool, dev, out_dir: str) -> None:
    """Fault-injected chaos soak (writes TORCH_chaos.json)."""
    args = ["--device", str(dev)]
    if fast:
        args += ["--events", "12", "--soak-events", "30",
                 "--stream-events", "18", "--block", "16",
                 "--stream-backends", "take"]

    def derive(res):
        worst = max(res["scenarios"].values(),
                    key=lambda sc: sc["recovery_p99_ms"])
        return (f"{len(res['scenarios'])} fault classes, worst recovery "
                f"p99 {worst['recovery_p99_ms']}ms ({worst['name']})")

    _script(rows, "chaos_soak", "torch_chaos_soak.py", args,
            os.path.join(out_dir, "TORCH_chaos.json"), derive)


def bench_tables(rows: list, fast: bool, dev, out_dir: str) -> dict:
    """The paper's tables (writes TORCH_paper_tables.json)."""
    args = ["--device", str(dev), "--seeds", "0" if fast else "0,1,2"]
    rec = _script(rows, "paper_tables", "torch_paper_tables.py", args,
                  os.path.join(out_dir, "TORCH_paper_tables.json"),
                  lambda res: "table2 table3 table4 fig2 fig5")
    for name, label in (("table2", "table2_accuracy"),
                        ("table3", "table3_pipelining"),
                        ("table4", "table4_area_delay"),
                        ("fig2", "fig2_assembly_scaling"),
                        ("fig5", "fig5_ablation")):
        rows.append((label, rec[name]["seconds"] * 1e6,
                     f"{len(rec[name]['rows'])} rows"))
    return {name: rec[name]["rows"] for name in
            ("table2", "table3", "table4", "fig2", "fig5")}


def bench_roofline(rows: list) -> None:
    import torch_roofline
    table = torch_roofline.build_table()
    ok = [r for r in table if r.get("status") == "ok"]
    rows.append(("roofline_cells", 0.0,
                 f"{len(ok)} analyzed / {len(table)} records"))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--only", default=None, choices=list(CHOICES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-dir", default=EXPERIMENTS)
    args = ap.parse_args()

    dev = None
    if args.only != "roofline":
        import torch
        from repro_torch import device as _device
        dev = _device.resolve(args.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    os.makedirs(args.out_dir, exist_ok=True)

    def want(name):
        return args.only in (None, name)

    rows: list = []
    outputs = {}
    if want("kernels"):
        bench_kernels(rows, dev)
    for name, fn in (("backends", bench_backends),
                     ("throughput", bench_throughput),
                     ("search", bench_search), ("fleet", bench_fleet),
                     ("stream", bench_stream), ("chaos", bench_chaos)):
        if want(name):
            fn(rows, args.fast, dev, args.out_dir)
    if want("tables"):
        outputs.update(bench_tables(rows, args.fast, dev, args.out_dir))
    if want("roofline"):
        bench_roofline(rows)

    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    for name, table in outputs.items():
        print(f"\n=== {name} ===")
        for row in table:
            print(json.dumps(row))
    if want("roofline"):
        import torch_roofline
        for mesh in ("single", "multi"):
            print(f"\n=== mesh: {mesh} ===")
            torch_roofline.print_table(mesh)


if __name__ == "__main__":
    main()
