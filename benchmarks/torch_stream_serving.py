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

  * **Stateful hot swaps** through the multi-tenant fleet's stream lane
    (``LUTFleet.open_stream`` / ``submit_stream`` / ``deploy``, lanes on
    ``fused``): a deploy with an identical in-boundary while steps are in
    flight carries every live state verbatim (``carried``); a deploy
    whose input ``log_scale`` moved by +0.1 re-quantizes every live state
    (``requantized``), and serving after it must equal the new cell's own
    recurrence from the migrated state (``migrate_state_codes``).  Both
    must drop no step and serve no wrong answer.

``contract_violations`` is the serving contract; the bench's exit and the
``stream`` suite of ``benchmarks/torch_check_regression.py`` both call it.
``--fast`` is the smoke size (``FAST_KW``: two small scales, a short churn,
8 swapped streams); its record has ``full_size`` false, and only a full
record must reach 1,000 concurrent streams.

    python3 benchmarks/torch_stream_serving.py [--device cuda] [--fast]
        [--out PATH]

Runs on the card by default and fails without one; ``--device cpu`` runs
the plain path (its times are the CPU's, not the card's).
"""
from __future__ import annotations

import argparse
import json
import os
import copy
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))   # traffic.py (numpy only)

DEFAULT_OUT = os.path.join(ROOT, "experiments", "TORCH_stream.json")
SCALES = (64, 256, 1024, 4096)
SCHEMA_VERSION = 1
# the smoke size (chip_smoke.py's phase 16 and torch_run.py --fast)
FAST_KW = dict(scales=(16, 64), t_steps=4, reps=2, block=64,
               churn_events=24, swap_streams=8, full=False)
SWAP_BACKEND = "fused"   # the lanes of the hot swaps (K1 on the card)
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
        before = build.launch_counts().get(kname, 0)
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            _, router = _replay(cell, xs, backend, block, depth)
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
        launched = build.launch_counts().get(kname, 0) - before
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
        xs = stream_batch(n, t_steps, cell.cell.n_in, seed + n)
        ref, _, ref_s = cell.predict_sequence(xs, backend="take")
        ref, ref_s = ref.cpu().numpy(), ref_s.cpu().numpy()
        for be in backends:
            _replay(cell, xs[:, :2], be, block, depth)     # warm-up
            runs = []
            for _ in range(max(reps, 1)):
                before = build.launch_counts()
                dt, router = _replay(cell, xs, be, block, depth)
                runs.append((dt, router, {
                    k: v - before.get(k, 0)
                    for k, v in build.launch_counts().items()}))
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


def stream_batch(n: int, t: int, n_in: int, seed: int):
    """``[n, t, n_in]`` inputs in [0, 1) from ``seed`` (the reference
    bench's ``_stream_batch``)."""
    import numpy as np
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, t, n_in)).astype(np.float32)


def _swap_fleet(cell, xs, half: int, block: int, depth: int):
    """A fleet serving ``cell`` as tenant ``"cell"`` on ``SWAP_BACKEND``
    with one stream per row of ``xs``, each fed its first ``half`` steps."""
    from repro_torch.serve import LUTFleet
    fleet = LUTFleet(block=block, depth=depth)
    fleet.register("cell", cell, backend=SWAP_BACKEND)
    for sid in range(len(xs)):
        fleet.open_stream("cell", sid)
        fleet.submit_stream("cell", sid, xs[sid, :half])
    return fleet


def _deploy(fleet, cell):
    """Deploy ``cell`` to the tenant through a saved artifact."""
    with tempfile.TemporaryDirectory() as d:
        return fleet.deploy("cell", cell.save(os.path.join(d, "v2.npz")))


def _swap_record(fleet, event, n_streams: int, wrong: int) -> dict:
    s = fleet.summary("cell")
    return {
        "streams": n_streams, "requests": s["requests"],
        "deploy_ok": bool(event.ok), "to_version": event.to_version,
        "state_migration": s["swap_history"][-1].get("state_migration"),
        "dropped": s["requests"] - s["completed"], "wrong": int(wrong),
    }


def hot_swap_carried(cell, n_streams: int, t_steps: int, block: int,
                     depth: int, seed: int) -> dict:
    """Deploy v2 (the same tables and in-boundary) while steps are in
    flight: live state carries verbatim, and every stream's whole sequence
    still equals the offline scan."""
    xs = stream_batch(n_streams, t_steps, cell.cell.n_in, seed)
    half = t_steps // 2
    fleet = _swap_fleet(cell, xs, half, block, depth)
    fleet.tick()                                   # steps now in flight
    event = _deploy(fleet, cell)
    for sid in range(n_streams):
        fleet.submit_stream("cell", sid, xs[sid, half:])
    fleet.pump()
    ref = cell.predict_sequence(xs, backend=SWAP_BACKEND)[0].cpu().numpy()
    lane = fleet._lanes["cell"]
    wrong = sum(int((lane.sessions[sid].codes() != ref[sid]).any(axis=-1)
                    .sum()) for sid in range(n_streams))
    return _swap_record(fleet, event, n_streams, wrong)


def hot_swap_requantized(cell, params, n_streams: int, t_steps: int,
                         block: int, depth: int, seed: int) -> dict:
    """Deploy a v2 folded from ``params`` with the input ``log_scale`` moved
    by +0.1: every live state is re-quantized onto the new boundary, and
    serving after the swap equals v2's own recurrence from the migrated
    state."""
    import numpy as np
    import torch
    from repro_torch.stream import cell as cell_mod

    params2 = copy.deepcopy(params)
    with torch.no_grad():
        params2.in_q.log_scale.add_(0.1)
    cell2 = cell_mod.compile_cell(params2, cell.cell)
    xs = stream_batch(n_streams, t_steps, cell.cell.n_in, seed)
    half = t_steps // 2
    fleet = _swap_fleet(cell, xs, half, block, depth)
    fleet.pump()                  # drained: the v1/v2 boundary is exact
    lane = fleet._lanes["cell"]
    s_before = np.stack([lane.store.get(sid) for sid in range(n_streams)])
    event = _deploy(fleet, cell2)
    for sid in range(n_streams):
        fleet.submit_stream("cell", sid, xs[sid, half:])
    fleet.pump()
    s_mig = cell_mod.migrate_state_codes(cell, cell2, s_before)
    expect = cell2.predict_sequence(xs[:, half:], s0_codes=s_mig,
                                    backend=SWAP_BACKEND)[0].cpu().numpy()
    wrong = sum(int((lane.sessions[sid].codes()[half:] != expect[sid])
                    .any(axis=-1).sum()) for sid in range(n_streams))
    return _swap_record(fleet, event, n_streams, wrong)


def hot_swaps(cell, params, n_streams: int, t_steps: int, block: int,
              depth: int, seed: int) -> dict:
    """Both stateful swaps (the reference bench's seeds: +3 and +4)."""
    out = {"carried": hot_swap_carried(cell, n_streams, max(t_steps, 4),
                                       block, depth, seed + 3),
           "requantized": hot_swap_requantized(
               cell, params, n_streams, max(t_steps, 4), block, depth,
               seed + 4)}
    for mode, hs in out.items():
        print(f"hot_swap[{mode}] migration={hs['state_migration']} "
              f"dropped={hs['dropped']} wrong={hs['wrong']} "
              f"requests={hs['requests']}", flush=True)
    return out


def contract_violations(results: dict) -> list:
    """The streaming serving contract: the reference's
    (``benchmarks/stream_serving.py`` ``contract_violations``, the same
    messages), plus streams of the churn left open, which the reference's
    record does not carry."""
    bad = []
    for p in results["scaling"]:
        if not p["bit_identical"]:
            bad.append(f"scale {p['streams']}: streamed codes not "
                       "bit-identical to the offline scan")
    for be, r in results["churn"]["per_backend"].items():
        if not r["bit_identical"]:
            bad.append(f"churn[{be}]: streamed codes not bit-identical")
        if r["dropped"]:
            bad.append(f"churn[{be}]: {r['dropped']} steps dropped")
        if not r.get("closed", True):
            bad.append(f"churn[{be}]: closed streams left open")
    for mode, hs in results["hot_swap"].items():
        if not hs["deploy_ok"]:
            bad.append(f"hot_swap[{mode}]: deploy did not land")
        if hs["state_migration"] != mode:
            bad.append(f"hot_swap[{mode}]: migration recorded as "
                       f"{hs['state_migration']!r}")
        if hs["dropped"]:
            bad.append(f"hot_swap[{mode}]: {hs['dropped']} steps dropped")
        if hs["wrong"]:
            bad.append(f"hot_swap[{mode}]: {hs['wrong']} wrong answers")
    if results["full_size"]:
        peak = max(p["streams"] for p in results["scaling"])
        if peak < 1000:
            bad.append(f"full sweep peaked at {peak} concurrent streams "
                       "(< 1000)")
    return bad


def sweep(cell, params, dev, *, scales=SCALES, t_steps: int = 49,
          block: int = 256, depth: int = 2, reps: int = 3,
          churn_events: int = 60, swap_streams: int = 32, seed: int = 0,
          full: bool = True) -> dict:
    """The whole record: scaling on ``fused`` and ``pallas``, churn per
    backend, both hot swaps."""
    import torch
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    cc = cell.cell
    return {
        "schema_version": SCHEMA_VERSION,
        "device": {"type": dev.type, "name": name,
                   "nvidia_smi": _smi() if dev.type == "cuda" else None},
        "cell": {"task": "seqmnist_reduced", "n_in": cc.n_in,
                 "n_state": cc.n_state, "n_out": cc.n_out,
                 "layers": len(cc.net.layers)},
        "block": block, "depth": depth, "t_steps": t_steps,
        "reps": reps, "full_size": full,
        "scaling": scaling(cell, scales, t_steps, block, depth, reps,
                           seed + 1, ("fused", "pallas")),
        "churn": churn(cell, churn_events, CHURN_BLOCK, depth, seed + 2),
        "hot_swap": hot_swaps(cell, params, swap_streams, t_steps, block,
                              depth, seed),
    }


def make_cell(seed: int, dev):
    """(parameters, compiled cell) of ``seqmnist_reduced`` from ``seed``."""
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble
    from repro_torch.stream import cell as cell_mod
    cc = paper_tasks.stream_task_config("seqmnist_reduced")
    params = assemble.init(seed, cc.net, device=dev)
    return params, cell_mod.compile_cell(params, cc)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--fast", action="store_true",
                    help="the smoke size (FAST_KW)")
    ap.add_argument("--scales", default=",".join(map(str, SCALES)))
    ap.add_argument("--steps", type=int, default=49)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--churn-events", type=int, default=60)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    from repro_torch import device as _device

    dev = _device.resolve(args.device)
    params, cell = make_cell(args.seed, dev)
    kw = (FAST_KW if args.fast else dict(
        scales=[int(s) for s in args.scales.split(",")], t_steps=args.steps,
        block=args.block, reps=args.reps, churn_events=args.churn_events))
    results = sweep(cell, params, dev, depth=args.depth, seed=args.seed,
                    **kw)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"{results['device']} -> {args.out}")
    bad = contract_violations(results)
    if bad:
        raise SystemExit("stream serving contract violated:\n  "
                         + "\n  ".join(bad))


if __name__ == "__main__":
    main()
