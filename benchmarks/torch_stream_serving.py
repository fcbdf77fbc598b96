"""Stateful stream serving on the port -> ``experiments/TORCH_stream.json``.

The port's counterpart of ``benchmarks/stream_serving.py``: streams of the
``seqmnist_reduced`` recurrent cell (its own widths, parameters from a
seeded init, folded on the device) served by one cell-mode ``LUTEngine``
behind a ``StreamRouter``.

  * **Concurrent-stream scaling**: N streams open at once (64, 256, 1,024
    and 4,096), each fed 49 steps; the router packs steps of different
    streams into blocks of 256.  Per scale and backend: steps/s (the
    median of ``--reps`` runs), per-step latency p50/p99 (admission to
    retirement, over the last 10,000 steps of the run), blocks, padded
    rows, bytes of live state, bit-identity of every stream against the
    offline ``take`` scan, and the kernel's launches and device ms per
    block (one profiled run; K1 on ``fused``, K3 on ``pallas``).
  * **Churn bit-identity per backend** (``take``, ``onehot``, ``pallas``,
    ``fused``): a churned trace (streams open, burst-feed and close
    mid-trace, ``tests/traffic.py``'s ``stream_churn_trace``) replayed per
    backend; every stream's full sequence must equal ``predict_sequence``
    on that backend.

The reference benchmark's hot-swap part serves through the multi-tenant
fleet, which the port does not have yet (ROADMAP A.11); it is left out.

    python3 benchmarks/torch_stream_serving.py [--device cuda] [--out PATH]

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
sys.path.insert(0, os.path.join(ROOT, "tests"))   # traffic.py (numpy only)

DEFAULT_OUT = os.path.join(ROOT, "experiments", "TORCH_stream.json")
SCALES = (64, 256, 1024, 4096)
CHURN_BLOCK = 8      # small blocks, so that the churned streams share them
TRACE_LEADS = (8, 64, 512)   # spin launches opening each profiled replay
KERNEL = {"fused": ("lut_cascade_resident", "cascade_resident_kernel"),
          "pallas": ("lut_lookup", "lut_lookup_kernel")}


def _smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"
    return out.stdout.strip().splitlines()[0]


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _replay(cell, xs, backend: str, block: int, depth: int):
    """Open one stream per row of ``xs [N, T, n_in]``, feed its sequence,
    pump to idle.  Returns (seconds, router)."""
    from repro_torch.stream.session import StreamRouter
    router = StreamRouter(cell, block=block, backend=backend, depth=depth)
    _sync(cell.net.device)
    t0 = time.perf_counter()
    for sid in range(len(xs)):
        router.open(sid)
        router.feed(sid, xs[sid])
    router.pump()
    _sync(cell.net.device)
    return time.perf_counter() - t0, router


def _kernel_device_ms(cell, xs, backend: str, block: int, depth: int):
    """Device ms of the backend's kernel per block over one profiled
    replay: its traced time over the launches the trace recorded, times
    the launches a block.  The trace can lose device work of a session
    (see chip_smoke.py's ``profile``): spin-kernel launches open and close
    it, and a replay whose trace holds another number of launches than the
    kernel's counter is profiled again with a longer lead.  None on the
    CPU, or when no try held every launch."""
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.kernels import build
    if cell.net.device.type != "cuda":
        return None
    kname, sub = KERNEL[backend]
    for lead in TRACE_LEADS:
        build.reset_counters()
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            _, router = _replay(cell, xs, backend, block, depth)
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
        launched = build.launch_counts().get(kname, 0)
        total, traced = 0.0, 0
        for ev in prof.key_averages():
            if sub in ev.key:
                total += getattr(ev, "self_device_time_total", 0) or \
                    getattr(ev, "self_cuda_time_total", 0)
                traced += ev.count
        if traced == launched and traced:
            return total * 1e-3 / traced * launched / router.engine.stats.ticks
    print(f"device time of {sub} not measured: the trace held {traced} of "
          f"{launched} launches in {len(TRACE_LEADS)} tries", flush=True)
    return None


def scaling(cell, scales, t_steps: int, block: int, depth: int, reps: int,
            seed: int, backends) -> list:
    import numpy as np
    from repro_torch.kernels import build
    points = []
    for n in scales:
        xs = np.random.default_rng(seed + n).uniform(
            0.0, 1.0, (n, t_steps, cell.cell.n_in)).astype(np.float32)
        ref, _, ref_s = cell.predict_sequence(xs, backend="take")
        ref, ref_s = ref.cpu().numpy(), ref_s.cpu().numpy()
        for be in backends:
            _replay(cell, xs[:, :2], be, block, depth)     # warm-up
            runs = []
            for _ in range(max(reps, 1)):
                build.reset_counters()
                dt, router = _replay(cell, xs, be, block, depth)
                runs.append((dt, router, build.launch_counts()))
            identical = all(
                np.array_equal(router.sessions[sid].codes(), ref[sid])
                and np.array_equal(router.store.get(sid), ref_s[sid])
                for dt, router, _ in runs for sid in range(n))
            dt, router, counts = sorted(runs, key=lambda r: r[0])[
                len(runs) // 2]
            blocks = router.engine.stats.ticks
            kname = KERNEL.get(be, (None,))[0]
            points.append({
                "streams": n, "backend": be, "steps": n * t_steps,
                "steps_per_s": n * t_steps / dt,
                "steps_per_s_runs": [n * t_steps / r[0] for r in runs],
                "p50_step_us": router.latency_us(50),
                "p99_step_us": router.latency_us(99),
                "blocks": blocks,
                "rows_padded": router.engine.stats.rows_padded,
                "state_bytes": router.store.nbytes,
                "bit_identical": identical,
                "kernel": kname,
                "kernel_launches_per_block": (
                    None if kname is None else counts.get(kname, 0) / blocks),
                "kernel_device_ms_per_block": (
                    None if kname is None else _kernel_device_ms(
                        cell, xs, be, block, depth)),
            })
            p = points[-1]
            print(f"scale {n} {be}: {p['steps_per_s']:,.0f} steps/s, p50 "
                  f"{p['p50_step_us']:.0f} us, p99 {p['p99_step_us']:.0f} us,"
                  f" {blocks} blocks, identical {identical}, {kname} "
                  f"{p['kernel_launches_per_block']} launches and "
                  f"{p['kernel_device_ms_per_block']} device ms a block",
                  flush=True)
    return points


def churn(cell, n_events: int, block: int, depth: int, seed: int) -> dict:
    import numpy as np
    import traffic
    from repro_torch import backends
    from repro_torch.stream.session import StreamRouter
    trace = traffic.stream_churn_trace(["cell"], n_events=n_events,
                                       seed=seed)
    inputs = traffic.make_stream_inputs(trace, {"cell": cell.cell.n_in},
                                        seed=seed + 1)
    seqs = traffic.stream_sequences(trace, inputs)
    per_backend = {}
    for be in backends.available():
        router = StreamRouter(cell, block=block, backend=be, depth=depth)
        for ev, x in zip(trace, inputs):
            if ev.action == "open":
                router.open(ev.stream_id)
            elif ev.action == "feed":
                router.feed(ev.stream_id, x)
            else:
                router.close(ev.stream_id)
            for _ in range(ev.gap_ticks):
                router.tick()
        router.pump()
        identical = all(
            np.array_equal(router.sessions[sid].codes(),
                           cell.predict_sequence(xs[None], backend=be)[0]
                           .cpu().numpy()[0])
            for (_, sid), xs in seqs.items())
        done = sum(len(s.steps) for s in router.sessions.values())
        per_backend[be] = {"bit_identical": identical, "completed": done,
                           "dropped": sum(len(x) for x in seqs.values())
                           - done,
                           "closed": all(router.sessions[sid].closed
                                         for _, sid in seqs)}
        print(f"churn {be}: {per_backend[be]}", flush=True)
    return {"events": len(trace), "streams": len(seqs),
            "steps": int(sum(len(x) for x in seqs.values())),
            "per_backend": per_backend}


def violations(results: dict) -> list:
    bad = []
    for p in results["scaling"]:
        if not p["bit_identical"]:
            bad.append(f"scale {p['streams']} {p['backend']}: not "
                       "bit-identical to the offline scan")
    for be, r in results["churn"]["per_backend"].items():
        if not r["bit_identical"] or r["dropped"] or not r["closed"]:
            bad.append(f"churn {be}: {r}")
    return bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scales", default=",".join(map(str, SCALES)))
    ap.add_argument("--steps", type=int, default=49)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--churn-events", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    import torch
    from repro_torch import device as _device
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble
    from repro_torch.stream import cell as cell_mod

    dev = _device.resolve(args.device)
    cc = paper_tasks.stream_task_config("seqmnist_reduced")
    cell = cell_mod.compile_cell(
        assemble.init(args.seed, cc.net, device=dev), cc)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    results = {
        "device": {"type": dev.type, "name": name,
                   "nvidia_smi": _smi() if dev.type == "cuda" else None},
        "cell": {"task": "seqmnist_reduced", "n_in": cc.n_in,
                 "n_state": cc.n_state, "n_out": cc.n_out,
                 "layers": len(cc.net.layers)},
        "block": args.block, "depth": args.depth, "t_steps": args.steps,
        "reps": args.reps,
        "scaling": scaling(cell, [int(s) for s in args.scales.split(",")],
                           args.steps, args.block, args.depth, args.reps,
                           args.seed + 1, ("fused", "pallas")),
        "churn": churn(cell, args.churn_events, CHURN_BLOCK,
                       args.depth, args.seed + 2),
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"{results['device']} -> {args.out}")
    bad = violations(results)
    if bad:
        raise SystemExit("stream serving contract violated:\n  "
                         + "\n  ".join(bad))


if __name__ == "__main__":
    main()
