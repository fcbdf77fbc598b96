"""Multi-tenant fleet serving on the port -> ``experiments/TORCH_fleet.json``.

The port's counterpart of ``benchmarks/fleet_serving.py``: three tenants
(``nid``, ``jsc_openml`` and ``mnist`` at their Table II widths, random
tables from ``--seed``) replayed through ONE
:class:`~repro_torch.serve.fleet.LUTFleet` versus three isolated
``LUTEngine`` deployments, all on the ``fused`` backend (K1 for ``nid`` and
``jsc_openml``, K2 for ``mnist`` on the card).

  * **online**: the same ragged arrival trace served arrival-driven.  An
    isolated engine ticks on each of its arrivals (ragged events become
    underfilled padded blocks); the fleet, with ``min_fill=block``,
    coalesces arrivals into full blocks across tenants.  Rows/s (best of
    ``--reps``, modes interleaved), blocks, padded rows, and the kernel
    launches of one counted fleet replay (which must equal its blocks).
  * **offline**: everything queued up front, then pumped to idle.
  * **bit-identity**: every tenant's fleet-served codes against its
    artifact's ``take`` codes, per event.
  * **hot swap under live load**: a good deploy mid-stream (zero dropped,
    zero wrong), a corrupted artifact rejected and the rollback recorded.
  * **admission**: a tenant with a tight queue budget sheds a burst.

    python3 benchmarks/torch_fleet_serving.py [--device cuda] [--out PATH]

Runs on the card by default and fails without one; ``--device cpu
--reduced`` rehearses it on the reduced configs (its times are the CPU's,
not the card's).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))   # traffic.py (numpy only)

DEFAULT_OUT = os.path.join(ROOT, "experiments", "TORCH_fleet.json")
TASKS = {"nid": "nid", "jsc": "jsc_openml", "mnist": "mnist"}
BACKEND = "fused"
LUT_KERNELS = ("lut_cascade_resident", "lut_cascade_streamed", "lut_lookup")


def smi() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True)
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"
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
    return (tables, maps, float(rs.uniform(-2.0, 0.0)),
            float(rs.uniform(-3.0, 0.0)))


def make_nets(dev, seed: int, reduced: bool) -> dict:
    """Tenant id -> artifact at Table II widths (reduced configs when
    ``reduced``), random tables from ``seed``.  The artifacts keep the
    default backend (``take``), which a deploy's smoke check runs; the
    lanes and engines serve ``fused``."""
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    nets = {}
    for i, (mid, task) in enumerate(TASKS.items()):
        cfg = (paper_tasks.reduced(mid) if reduced
               else paper_tasks.task_config(task))
        nets[mid] = pipeline.CompiledLUTNetwork(
            cfg, *random_network(cfg, seed + i), device=dev)
    return nets


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize()


def replay_fleet_online(fleet, trace, inputs, dev):
    """Submit each event, tick once (lanes below min_fill hold), pump the
    tail.  Returns (seconds, requests by event)."""
    _sync(dev)
    t0 = time.perf_counter()
    reqs_by_event = []
    for ev, xs in zip(trace, inputs):
        reqs, _ = fleet.submit_many(ev.model_id, xs)
        reqs_by_event.append(reqs)
        fleet.tick()
    fleet.pump()
    _sync(dev)
    return time.perf_counter() - t0, reqs_by_event


def replay_isolated_online(engines, trace, inputs, dev) -> float:
    """Each tenant's engine ticks on each of its arrivals."""
    _sync(dev)
    t0 = time.perf_counter()
    for ev, xs in zip(trace, inputs):
        eng = engines[ev.model_id]
        eng.submit_many(xs)
        eng.tick()
    for eng in engines.values():
        while eng.queue:
            eng.tick()
        eng.drain()
    _sync(dev)
    return time.perf_counter() - t0


def replay_fleet_offline(fleet, trace, inputs, dev) -> float:
    """Queue everything, then pump to idle."""
    _sync(dev)
    t0 = time.perf_counter()
    for ev, xs in zip(trace, inputs):
        fleet.submit_many(ev.model_id, xs)
    fleet.pump()
    _sync(dev)
    return time.perf_counter() - t0


def replay_isolated_offline(engines, trace, inputs, dev) -> float:
    """Queue everything per tenant, run tenants back to back."""
    _sync(dev)
    t0 = time.perf_counter()
    for mid, eng in engines.items():
        for ev, xs in zip(trace, inputs):
            if ev.model_id == mid:
                eng.submit_many(xs)
        while eng.queue:
            eng.tick()
        eng.drain()
    _sync(dev)
    return time.perf_counter() - t0


def sweep(nets, dev, *, n_events: int, block: int, depth: int, reps: int,
          seed: int) -> dict:
    import numpy as np
    import traffic
    from repro_torch.kernels import build
    from repro_torch.serve import LUTFleet, make_reference
    from repro_torch.serve.lut_engine import LUTEngine

    mids = tuple(nets)
    trace = traffic.ragged_trace(mids, n_events=n_events, seed=seed + 10,
                                 gap_prob=0.0)
    inputs = traffic.make_inputs(
        trace, {m: n.cfg.in_features for m, n in nets.items()},
        seed=seed + 11)
    rows_total = traffic.total_rows(trace)

    def fleet(min_fill):
        fl = LUTFleet(block=block, depth=depth, min_fill=min_fill)
        for mid, net in nets.items():
            fl.register(mid, net, reference=make_reference(net),
                        backend=BACKEND)
        return fl

    def engines(d):
        return {m: LUTEngine(n, block=block, depth=d, backend=BACKEND)
                for m, n in nets.items()}

    fleet_on, fleet_off = fleet(block), fleet(1)
    iso_sync, iso_async = engines(1), engines(2)
    # warm-up, not timed
    replay_fleet_online(fleet_on, trace, inputs, dev)
    replay_fleet_offline(fleet_off, trace, inputs, dev)
    replay_isolated_online(iso_sync, trace, inputs, dev)
    replay_isolated_online(iso_async, trace, inputs, dev)

    # one counted replay each: blocks, padded rows and the fleet's kernel
    # launches (one K1/K2 launch a block on the fused backend)
    def blocks(stats):
        return (sum(s.ticks for s in stats), sum(s.rows_padded for s in stats))
    f0 = blocks([fleet_on.stats(m) for m in mids])
    build.reset_counters()
    replay_fleet_online(fleet_on, trace, inputs, dev)
    launches = {k: v for k, v in build.launch_counts().items()
                if k in LUT_KERNELS and v}
    f1 = blocks([fleet_on.stats(m) for m in mids])
    i0 = blocks([e.stats for e in iso_sync.values()])
    replay_isolated_online(iso_sync, trace, inputs, dev)
    i1 = blocks([e.stats for e in iso_sync.values()])
    counters = {"fleet_blocks": f1[0] - f0[0],
                "fleet_rows_padded": f1[1] - f0[1],
                "isolated_blocks": i1[0] - i0[0],
                "isolated_rows_padded": i1[1] - i0[1],
                "fleet_launches": launches}

    best: dict = {}
    reqs_by_event = None
    for _ in range(max(reps, 1)):
        dt, reqs = replay_fleet_online(fleet_on, trace, inputs, dev)
        if dt < best.get("on_fleet", float("inf")):
            best["on_fleet"], reqs_by_event = dt, reqs
        for mode, fn, arg in (
                ("on_sync", replay_isolated_online, iso_sync),
                ("on_async", replay_isolated_online, iso_async),
                ("off_fleet", replay_fleet_offline, fleet_off),
                ("off_sync", replay_isolated_offline, iso_sync),
                ("off_async", replay_isolated_offline, iso_async)):
            best[mode] = min(best.get(mode, float("inf")),
                             fn(arg, trace, inputs, dev))

    per_tenant = []
    for mid, net in nets.items():
        identical, rows = True, 0
        for ev, xs, reqs in zip(trace, inputs, reqs_by_event):
            if ev.model_id != mid:
                continue
            rows += len(xs)
            ref = net.predict_codes(xs, backend="take").cpu().numpy()
            identical &= bool(np.array_equal(
                np.stack([r.codes for r in reqs]), ref))
        s, s_off = fleet_on.summary(mid), fleet_off.summary(mid)
        per_tenant.append({
            "model_id": mid, "task": TASKS[mid],
            "rows_per_replay": rows, "bit_identical": identical,
            "p50_request_us": s["p50_request_us"],
            "p99_request_us": s["p99_request_us"],
            # every replay of both fleets; a lane that failed and degraded
            # to ``take`` would still answer bit-identically
            "failures": s["failures"] + s_off["failures"],
            "degrades": s["degrades"] + s_off["degrades"]})

    def rate(dt):
        return rows_total / dt

    return {
        "tenants": {m: TASKS[m] for m in mids}, "backend": BACKEND,
        "events": n_events, "rows_per_replay": rows_total, "block": block,
        "depth": depth, "min_fill": block, "reps": reps,
        "online": {
            "fleet_rows_per_s": rate(best["on_fleet"]),
            "isolated_sync_rows_per_s": rate(best["on_sync"]),
            "isolated_async_rows_per_s": rate(best["on_async"]),
            "speedup_vs_isolated_sync": best["on_sync"] / best["on_fleet"],
            "speedup_vs_isolated_async": best["on_async"] / best["on_fleet"],
            **counters},
        "offline": {
            "fleet_rows_per_s": rate(best["off_fleet"]),
            "isolated_sync_rows_per_s": rate(best["off_sync"]),
            "isolated_async_rows_per_s": rate(best["off_async"]),
            "fleet_vs_isolated_sync": best["off_sync"] / best["off_fleet"]},
        "per_tenant": per_tenant,
    }


def hot_swap_under_load(net, mid: str, block: int, depth: int) -> dict:
    """Deploy a good v2 and a corrupted candidate while requests are queued
    and in flight; count drops, wrong answers and the recorded rollback.

    The smoke check runs the candidate's own default backend (``take``
    here).  Had the artifact defaulted to ``fused``, its persisted fused
    plan would keep the good tables and pass the corrupted candidate, in
    the reference as in the port (ROADMAP C.5)."""
    import numpy as np
    from repro_torch.serve import LUTFleet, make_reference

    ref = make_reference(net)
    fleet = LUTFleet(block=block, depth=depth)
    fleet.register(mid, net, reference=ref, backend=BACKEND)
    x = np.random.default_rng(1).uniform(
        -1.0, 1.0, (4 * block, net.cfg.in_features)).astype(np.float32)
    reqs, _ = fleet.submit_many(mid, x)
    fleet.tick()                          # blocks in flight on v1
    with tempfile.TemporaryDirectory() as d:
        good = net.save(os.path.join(d, "v2.npz"))
        z = np.load(good)
        arrays = {k: z[k] for k in z.files}
        last = f"table_{len(net.cfg.layers) - 1}"
        arrays[last] = (arrays[last] ^ 1).astype(arrays[last].dtype)
        bad = os.path.join(d, "corrupt.npz")
        np.savez_compressed(bad, **arrays)
        ev_good = fleet.deploy(mid, good, reference=ref)
        more, _ = fleet.submit_many(mid, x[:block])    # lands on v2
        ev_bad = fleet.deploy(mid, bad, reference=ref)
        fleet.pump()
    every = reqs + more
    expect = net.predict_codes(np.concatenate([x, x[:block]]),
                               backend="take").cpu().numpy()
    got = np.stack([r.codes for r in every])
    return {"good_deploy_ok": bool(ev_good.ok),
            "to_version": ev_good.to_version,
            "corrupt_deploy_rejected": bool(not ev_bad.ok),
            "rollback_recorded": bool(
                fleet.summary(mid)["swap_history"][-1]["ok"] is False),
            "dropped": sum(not r.done for r in every),
            "wrong": int((got != expect).any(axis=-1).sum()),
            "requests": len(every)}


def admission_stress(net, mid: str, block: int) -> dict:
    """A tenant with a tight queue budget under a burst sheds at the door;
    everything admitted completes."""
    import numpy as np
    from repro_torch.serve import LUTFleet, TenantSLO, make_reference

    budget = 2 * block
    fleet = LUTFleet(block=block)
    fleet.register(mid, net, reference=make_reference(net),
                   slo=TenantSLO(max_queue=budget, policy="shed"))
    x = np.random.default_rng(2).uniform(
        -1.0, 1.0, (4 * block, net.cfg.in_features)).astype(np.float32)
    _, decision = fleet.submit_many(mid, x)
    fleet.pump()
    s = fleet.summary(mid)
    return {"max_queue": budget, "offered": len(x),
            "accepted": decision.accept, "shed": s["shed"],
            "completed": s["completed"]}


def violations(results: dict) -> list:
    bad = [f"{t['model_id']}: fleet codes not bit-identical to take"
           for t in results["per_tenant"] if not t["bit_identical"]]
    hs = results["hot_swap"]
    if hs["dropped"] or hs["wrong"] or not hs["corrupt_deploy_rejected"] \
            or not hs["good_deploy_ok"] or not hs["rollback_recorded"]:
        bad.append(f"hot swap: {hs}")
    bad += [f"{t['model_id']}: {t['failures']} failures, {t['degrades']} "
            "degrades in a clean run" for t in results["per_tenant"]
            if t["failures"] or t["degrades"]]
    on = results["online"]
    # on the card every fused block launches K1 or K2 once; on the CPU the
    # plain versions run and nothing is launched
    want = on["fleet_blocks"] if results["device"]["type"] == "cuda" else 0
    if sum(on["fleet_launches"].values()) != want:
        bad.append(f"launches {on['fleet_launches']} != {want} (blocks "
                   f"{on['fleet_blocks']})")
    ad = results["admission"]
    if ad["accepted"] + ad["shed"] != ad["offered"] or \
            ad["completed"] != ad["accepted"]:
        bad.append(f"admission: {ad}")
    return bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced configs (a CPU rehearsal)")
    ap.add_argument("--events", type=int, default=128)
    ap.add_argument("--block", type=int, default=256)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    import torch
    from repro_torch import device as _device

    dev = _device.resolve(args.device)
    nets = make_nets(dev, args.seed, args.reduced)
    results = {
        "device": {"type": dev.type,
                   "name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": (torch.cuda.device_count()
                             if dev.type == "cuda" else 0),
                   "nvidia_smi": smi() if dev.type == "cuda" else None},
        "reduced": args.reduced, "seed": args.seed,
        **sweep(nets, dev, n_events=args.events, block=args.block,
                depth=args.depth, reps=args.reps, seed=args.seed),
    }
    results["hot_swap"] = hot_swap_under_load(nets["nid"], "nid", args.block,
                                              args.depth)
    results["admission"] = admission_stress(nets["nid"], "nid", args.block)
    bad = violations(results)
    results["contract_violations"] = bad
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    on, off = results["online"], results["offline"]
    print(f"online rows/s: fleet {on['fleet_rows_per_s']:,.0f}, isolated "
          f"sync {on['isolated_sync_rows_per_s']:,.0f}, async "
          f"{on['isolated_async_rows_per_s']:,.0f} (blocks "
          f"{on['fleet_blocks']} vs {on['isolated_blocks']}, launches "
          f"{on['fleet_launches']})")
    print(f"offline rows/s: fleet {off['fleet_rows_per_s']:,.0f}, isolated "
          f"sync {off['isolated_sync_rows_per_s']:,.0f}")
    for t in results["per_tenant"]:
        print(f"{t['model_id']} ({t['task']}): bit_identical "
              f"{t['bit_identical']}, p50/p99 request "
              f"{t['p50_request_us']}/{t['p99_request_us']} us")
    print(f"hot swap {results['hot_swap']}; admission "
          f"{results['admission']}")
    print(f"{results['device']} -> {args.out}")
    if bad:
        raise SystemExit("fleet contract violated:\n  " + "\n  ".join(bad))


if __name__ == "__main__":
    main()
