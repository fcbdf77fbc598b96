"""Fault-injected chaos soak on the port -> ``experiments/TORCH_chaos.json``.

The port's counterpart of ``benchmarks/chaos_soak.py``: the multi-tenant
fleet replayed under ``tests/traffic.py``'s ragged and churned traffic
while the fault injector (``repro_torch.serve.faults``) breaks it on
purpose:

  * **one scenario per fault class**: transient executor exceptions
    (retry), persistent exceptions (breaker trip, degrade to ``take``),
    hangs and slow starts (the deadline abandons the block, its rows are
    recomputed), device loss (slot 1 of a 2-slot placement: remesh onto
    the survivor; a sole slot: unplaced fallback) and a corrupt deploy
    candidate (rejected by the smoke check mid-incident).  Each reports
    injected and detected counts, wrong answers against ``predict_codes``
    and lost accepted requests (both must be 0).
  * **degraded-mode throughput**: the same trace clean and through a
    trip-and-degrade incident; degraded/clean rows/s must clear 0.05.
  * **stream failover, per backend**: a churned trace of the
    ``seqmnist_reduced`` cell through ``stream/replica.py``; the primary
    dies mid-trace, the standby recovers every stream from its last
    checkpoint plus the replayed acked tail, bit-identically.
  * **seeded soak**: a ``FaultPlan.seeded`` schedule over a longer trace.

Nets: the reduced ``nid`` and ``jsc`` configs, parameters from the port's
``assemble.init(seed)`` folded on the device, as the reference's soak uses
reduced nets (the seams and supervision do not depend on the widths).
Lanes serve ``fused`` (K1) unless a scenario names another backend.

    python3 benchmarks/torch_chaos_soak.py [--device cuda] [--out PATH]

Runs on the card by default and fails without one; ``--device cpu``
rehearses it (its times are the CPU's, not the card's).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "tests"))   # traffic.py (numpy only)
import traffic  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "experiments", "TORCH_chaos.json")
BACKEND = "fused"
DEGRADED_FLOOR = 0.05


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


def make_nets(tasks, seed: int, dev) -> dict:
    """Reduced configs, port init folded on ``dev``; every backend warmed
    outside the deadline-supervised replays."""
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble
    nets = {}
    for i, task in enumerate(tasks):
        cfg = paper_tasks.reduced(task)
        nets[task] = pipeline.compile_network(
            assemble.init(seed + i, cfg, device=dev), cfg)
        x = np.zeros((4, cfg.in_features), np.float32)
        for be in ("take", "onehot", "pallas", "fused"):
            nets[task].predict_codes(x, backend=be)
    return nets


def faulted_replay(nets, inj, policy, *, n_events, block, seed,
                   backends=None, placements=None, at_event=None):
    """Replay one ragged trace through a fresh fleet with ``inj``; returns
    (per-tenant summaries, counters).  ``at_event`` maps an event index to
    a callable run before that event's submit.  ``wrong`` counts served
    codes that differ from ``predict_codes``, ``lost`` accepted requests
    that never completed."""
    from repro_torch.serve import LUTFleet, make_reference

    fleet = LUTFleet(block=block, faults=inj, policy=policy)
    for t, net in nets.items():
        fleet.register(t, net, reference=make_reference(net, n=16),
                       backend=(backends or {}).get(t, BACKEND),
                       placement=(placements or {}).get(t))
    trace = traffic.ragged_trace(list(nets), n_events=n_events, seed=seed)
    inputs = traffic.make_inputs(
        trace, {t: n.cfg.in_features for t, n in nets.items()},
        seed=seed + 1)
    acked = []
    t0 = time.perf_counter()
    for i, (ev, xs) in enumerate(zip(trace, inputs)):
        if at_event and i in at_event:
            at_event[i](fleet)
        reqs, _ = fleet.submit_many(ev.model_id, xs)
        if reqs:
            acked.append((ev.model_id, reqs))
        for _ in range(1 + ev.gap_ticks):
            fleet.tick()
    fleet.pump()
    elapsed = time.perf_counter() - t0
    wrong = lost = accepted = 0
    for mid, reqs in acked:
        accepted += len(reqs)
        lost += sum(not r.done for r in reqs)
        done = [r for r in reqs if r.done]
        if done:
            ref = nets[mid].predict_codes(np.stack([r.x for r in done]),
                                          backend="take").cpu().numpy()
            got = np.stack([r.codes for r in done])
            wrong += int((got != ref).any(axis=-1).sum())
    summaries = {t: fleet.summary(t) for t in nets}
    return summaries, {"accepted": accepted, "wrong": wrong, "lost": lost,
                       "elapsed_s": elapsed}


def cell(name, kind, inj, summaries, counters, scope, *, detected,
         recovered, extra=None):
    s = summaries[scope]
    out = {"name": name, "kind": kind, "scope": scope,
           "injected": inj.fired(kind), "detected": int(detected),
           "recovered": bool(recovered),
           "wrong": counters["wrong"], "lost": counters["lost"],
           "accepted": counters["accepted"],
           "completed": sum(x["completed"] for x in summaries.values()),
           "failures": s["failures"], "deadline_hits": s["deadline_hits"],
           "retries": s["retries"], "breaker_trips": s["breaker_trips"],
           "degrades": s["degrades"],
           "recovery_p99_ms": s["recovery_p99_ms"],
           "elapsed_s": counters["elapsed_s"]}
    out.update(extra or {})
    return out


def scenarios(nets, dev, *, n_events, block, seed) -> dict:
    from repro_torch import backends as lut_backends
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve import (FaultInjector, FaultPlan, FaultSpec,
                                   ResiliencePolicy, make_reference)

    scope = list(nets)[0]
    policy = ResiliencePolicy(backoff_base_s=0.0, breaker_threshold=3)
    deadline = ResiliencePolicy(deadline_s=0.5, backoff_base_s=0.0,
                                breaker_threshold=3)
    kw = dict(n_events=n_events, block=block, seed=seed)
    cells = {}

    def run(name, kind, specs, pol, *, detected, recovered, **replay):
        inj = FaultInjector(FaultPlan(specs))
        summ, ctr = faulted_replay(nets, inj, pol, **kw, **replay)
        s = summ[scope]
        cells[name] = cell(name, kind, inj, summ, ctr, scope,
                           detected=s[detected],
                           recovered=recovered(s, ctr) and not ctr["lost"],
                           extra={"degrade_history": s["degrade_history"]})
        return s

    run("exception_transient", "exception",
        [FaultSpec("exception", at=1, scope=scope, count=2)], policy,
        detected="failures",
        recovered=lambda s, c: s["incidents_recovered"] >= 1
        and s["breaker_trips"] == 0)
    run("breaker_degrade", "exception",
        [FaultSpec("exception", at=0, scope=scope, count=3)], policy,
        detected="failures", recovered=lambda s, c: s["degrades"] >= 1)
    run("hang_deadline", "hang",
        [FaultSpec("hang", at=1, scope=scope, stall_s=2.0)], deadline,
        detected="deadline_hits",
        recovered=lambda s, c: s["deadline_hits"] >= 1)
    run("slow_start", "slow_start",
        [FaultSpec("slow_start", at=0, scope=scope, stall_s=2.0)], deadline,
        detected="deadline_hits",
        recovered=lambda s, c: s["deadline_hits"] >= 1)
    # slot 1 of 2 dies: the same backend remeshes onto the survivor
    two = lut_backends.Placement(make_serving_mesh(slots=2, device=dev))
    run("device_loss_remesh", "device_loss",
        [FaultSpec("device_loss", at=1, scope=scope, device=1)], policy,
        detected="failures",
        recovered=lambda s, c: s["degrade_history"] == [{
            "model_id": scope, "reason": "device_loss",
            "backend": f"{BACKEND}->{BACKEND}", "shards": "2->1"}],
        placements={scope: two})
    one = lut_backends.Placement(make_serving_mesh(slots=1, device=dev))
    run("device_loss_sole", "device_loss",
        [FaultSpec("device_loss", at=1, scope=scope)], policy,
        detected="failures",
        recovered=lambda s, c: s["degrades"] >= 1,
        placements={scope: one})

    # a corrupt candidate deployed while the lane is recovering: the
    # injector flips table bits of the freshly loaded artifact
    swaps = {}

    def deploy(fleet):
        net = nets[scope]
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "v2.npz")
            net.save(path)
            swaps["swap"] = fleet.deploy(scope, path,
                                         reference=make_reference(net, n=16))

    s = run("corrupt_artifact", "corrupt_artifact",
            [FaultSpec("exception", at=0, scope=scope, count=3),
             FaultSpec("corrupt_artifact", at=0, scope=scope)], policy,
            detected="failures",
            recovered=lambda s, c: "swap" in swaps and not swaps["swap"].ok
            and s["version"] == 1,
            backends={scope: "onehot"},
            at_event={max(1, n_events // 2): deploy})
    swap = swaps.get("swap")
    cells["corrupt_artifact"].update(
        detected=int(swap is not None and not swap.ok),
        deploy_rejected=bool(swap is not None and not swap.ok),
        deploy_reason=swap.reason if swap else "deploy not run",
        serving_version=s["version"])
    return cells


def degraded_throughput(nets, dev, *, n_events, block, seed) -> dict:
    """The same trace clean and through a trip-and-degrade incident.  The
    clean run must neither fail nor degrade, and on the card it must launch
    K1 once a block (a lane degraded to ``take`` would launch nothing)."""
    from repro_torch.kernels import build
    from repro_torch.serve import (FaultInjector, FaultPlan, FaultSpec,
                                   ResiliencePolicy)
    scope = list(nets)[0]
    policy = ResiliencePolicy(backoff_base_s=0.0, breaker_threshold=3)
    kw = dict(n_events=n_events, block=block, seed=seed)
    build.reset_counters()
    summ, ctr = faulted_replay(nets, None, policy, **kw)
    clean = sum(s["completed"] for s in summ.values()) / ctr["elapsed_s"]
    clean_blocks = sum(s["ticks"] for s in summ.values())
    clean_launches = build.launch_counts().get("lut_cascade_resident", 0)
    clean_faults = {t: (s["failures"], s["degrades"])
                    for t, s in summ.items()}
    inj = FaultInjector(FaultPlan(
        [FaultSpec("exception", at=0, scope=scope, count=3)]))
    summ, ctr = faulted_replay(nets, inj, policy, **kw)
    degraded = sum(s["completed"] for s in summ.values()) / ctr["elapsed_s"]
    return {"clean_rows_per_s": clean, "degraded_rows_per_s": degraded,
            "throughput_ratio": degraded / clean, "floor": DEGRADED_FLOOR,
            "wrong": ctr["wrong"], "lost": ctr["lost"],
            "degrades": summ[scope]["degrades"],
            "clean_blocks": clean_blocks,
            "clean_launches": clean_launches,
            "clean_launches_expected": (clean_blocks if dev.type == "cuda"
                                        else 0),
            "clean_failures_degrades": clean_faults}


def stream_failover(comp, backend, *, n_events, block, seed,
                    checkpoint_every=8) -> dict:
    """Churned stream traffic through the replicated tenant; the primary
    dies mid-trace with blocks in flight, the standby takes over and the
    rest of the trace replays on it.  Every stream's combined codes
    (primary-delivered up to the checkpoint, then the standby's) must equal
    the uninterrupted ``predict_sequence`` scan."""
    from repro_torch.serve import LUTFleet
    from repro_torch.stream.replica import (ReplicatedStreamTenant,
                                            StandbyReplica)

    trace = traffic.stream_churn_trace(["cell"], n_events=n_events,
                                       seed=seed)
    inputs = traffic.make_stream_inputs(trace, {"cell": comp.cell.n_in},
                                        seed=seed + 1)
    seqs = traffic.stream_sequences(trace, inputs)
    kill = max(2, (2 * len(trace)) // 3)
    primary = LUTFleet(block=block)
    primary.register("cell", comp, block=block, backend=backend)
    standby = StandbyReplica("cell", comp, block=block, backend=backend)
    tenant = ReplicatedStreamTenant(primary, "cell", standby,
                                    checkpoint_every=checkpoint_every)
    for ev, x in zip(trace[:kill], inputs[:kill]):
        if ev.action == "open":
            tenant.open_stream(ev.stream_id)
        elif ev.action == "feed":
            tenant.submit(ev.stream_id, x)
        else:
            tenant.close_stream(ev.stream_id)
        for _ in range(1 + ev.gap_ticks):
            primary.tick()
        tenant.maybe_checkpoint()
    primary.tick()      # progress past the checkpoint, then the primary dies
    lane1 = primary._stream_lane("cell")
    pre = {sid: [r.codes for r in s.steps]
           for sid, s in lane1.sessions.items()}
    ckpt = standby.checkpoint
    t0 = time.perf_counter()
    fleet2, replayed = standby.activate()
    fleet2.pump()
    recovery_ms = (time.perf_counter() - t0) * 1e3
    for ev, x in zip(trace[kill:], inputs[kill:]):
        if ev.action == "open":
            fleet2.open_stream("cell", ev.stream_id)
        elif ev.action == "feed":
            fleet2.submit_stream("cell", ev.stream_id, x)
        else:
            fleet2.close_stream("cell", ev.stream_id)
        for _ in range(1 + ev.gap_ticks):
            fleet2.tick()
    fleet2.pump()
    lane2 = fleet2._stream_lane("cell")
    mismatched = lost = steps = 0
    for (_, sid), xs_full in seqs.items():
        ref = comp.predict_sequence(xs_full[None], backend="take")[0][0]
        ref = ref.cpu().numpy()
        if sid in lane2.sessions:
            applied = (ckpt.applied_for(sid)
                       if ckpt is not None and sid in ckpt.stream_ids else 0)
            combined = (pre.get(sid, [])[:applied]
                        + [r.codes for r in lane2.sessions[sid].steps])
        else:
            combined = pre.get(sid, [])   # finalized before the failure
        lost += max(0, len(ref) - len(combined))
        ok = len(combined) == len(ref) and all(
            np.array_equal(c, ref[t]) for t, c in enumerate(combined))
        mismatched += 0 if ok else 1
        steps += len(ref)
    return {"backend": backend, "events": len(trace),
            "killed_at_event": kill, "streams": len(seqs), "steps": steps,
            "checkpoints_shipped": standby.checkpoints_received,
            "replayed_steps": int(sum(replayed.values())),
            "restored_streams": len(replayed), "recovery_ms": recovery_ms,
            "mismatched_streams": mismatched, "lost_steps": lost}


def soak(nets, *, n_events, block, seed) -> dict:
    from repro_torch.serve import FaultInjector, FaultPlan, ResiliencePolicy
    plan = FaultPlan.seeded(seed, scopes=tuple(nets),
                            kinds=("exception", "hang", "slow_start"),
                            n_faults=12, max_at=80, stall_s=1.0)
    inj = FaultInjector(plan)
    policy = ResiliencePolicy(deadline_s=0.5, max_retries=10,
                              backoff_base_s=0.0, breaker_threshold=10)
    summ, ctr = faulted_replay(nets, inj, policy, n_events=n_events,
                               block=block, seed=seed,
                               backends={t: "onehot" for t in nets})
    total = {k: sum(s[k] for s in summ.values())
             for k in ("failures", "deadline_hits", "retries",
                       "breaker_trips", "degrades")}
    return {"events": n_events, "faults_planned": len(plan.specs),
            "injected": {k: inj.fired(k)
                         for k in ("exception", "hang", "slow_start")},
            "accepted": ctr["accepted"],
            "completed": sum(s["completed"] for s in summ.values()),
            "wrong": ctr["wrong"], "lost": ctr["lost"], "detected": total,
            "recovery_p99_ms": max(s["recovery_p99_ms"]
                                   for s in summ.values()),
            "elapsed_s": ctr["elapsed_s"]}


def contract_violations(results: dict) -> list:
    """The chaos serving contract (the reference's ``contract_violations``,
    ``benchmarks/chaos_soak.py``)."""
    bad = []
    for name, sc in results["scenarios"].items():
        if sc["wrong"]:
            bad.append(f"{name}: {sc['wrong']} wrong answers")
        if sc["lost"]:
            bad.append(f"{name}: {sc['lost']} accepted requests lost")
        if sc["injected"] == 0:
            bad.append(f"{name}: fault never injected")
        elif sc["detected"] == 0:
            bad.append(f"{name}: fault injected but never detected")
        if not sc["recovered"]:
            bad.append(f"{name}: lane did not recover")
    d = results["degraded"]
    if d["wrong"] or d["lost"]:
        bad.append(f"degraded: {d['wrong']} wrong / {d['lost']} lost")
    if any(f or g for f, g in d["clean_failures_degrades"].values()):
        bad.append("degraded: the clean run failed or degraded "
                   f"{d['clean_failures_degrades']}")
    if d["clean_launches"] != d["clean_launches_expected"]:
        bad.append(f"degraded: the clean run launched K1 "
                   f"{d['clean_launches']} times for "
                   f"{d['clean_launches_expected']} blocks")
    if d["throughput_ratio"] < d["floor"]:
        bad.append(f"degraded throughput ratio {d['throughput_ratio']} "
                   f"below the {d['floor']} floor")
    for be, r in results["stream_failover"].items():
        if r["checkpoints_shipped"] < 1:
            bad.append(f"stream_failover[{be}]: no checkpoint ever shipped")
        if r["mismatched_streams"]:
            bad.append(f"stream_failover[{be}]: {r['mismatched_streams']} "
                       "streams not bit-identical after failover")
        if r["lost_steps"]:
            bad.append(f"stream_failover[{be}]: {r['lost_steps']} acked "
                       "steps lost")
    s = results["soak"]
    if s["wrong"] or s["lost"]:
        bad.append(f"soak: {s['wrong']} wrong / {s['lost']} lost")
    if (sum(s["injected"].values())
            and not (s["detected"]["failures"]
                     + s["detected"]["deadline_hits"])):
        bad.append("soak: faults injected but none detected")
    return bad


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--events", type=int, default=36)
    ap.add_argument("--soak-events", type=int, default=120)
    ap.add_argument("--stream-events", type=int, default=60)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--stream-backends", default="take,fused,pallas")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args()

    import torch
    from repro_torch import device as _device
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble
    from repro_torch.stream import cell as cell_mod

    dev = _device.resolve(args.device)
    nets = make_nets(("nid", "jsc"), args.seed, dev)
    cc = paper_tasks.stream_task_config("seqmnist_reduced")
    comp = cell_mod.compile_cell(
        assemble.init(args.seed, cc.net, device=dev), cc)
    kw = dict(block=args.block, seed=args.seed)
    results = {
        "device": {"type": dev.type,
                   "name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": (torch.cuda.device_count()
                             if dev.type == "cuda" else 0),
                   "nvidia_smi": smi() if dev.type == "cuda" else None},
        "params": {"tasks": list(nets), "backend": BACKEND,
                   "events": args.events, "soak_events": args.soak_events,
                   "stream_events": args.stream_events,
                   "stream_cell": "seqmnist_reduced", **kw},
        "scenarios": scenarios(nets, dev, n_events=args.events, **kw),
        "degraded": degraded_throughput(nets, dev, n_events=args.events,
                                        **kw),
        "stream_failover": {
            be: stream_failover(comp, be, n_events=args.stream_events, **kw)
            for be in args.stream_backends.split(",")},
        "soak": soak(nets, n_events=args.soak_events, **kw),
    }
    bad = contract_violations(results)
    results["contract_violations"] = bad
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("scenario,kind,injected,detected,recovered,wrong,lost,"
          "recovery_p99_ms")
    for name, sc in results["scenarios"].items():
        print(f"{name},{sc['kind']},{sc['injected']},{sc['detected']},"
              f"{sc['recovered']},{sc['wrong']},{sc['lost']},"
              f"{sc['recovery_p99_ms']}")
    d = results["degraded"]
    print(f"degraded throughput ratio {d['throughput_ratio']:.4f} "
          f"({d['degraded_rows_per_s']:,.0f} vs {d['clean_rows_per_s']:,.0f}"
          " rows/s)")
    for be, r in results["stream_failover"].items():
        print(f"stream_failover[{be}]: {r['streams']} streams / {r['steps']}"
              f" steps, {r['replayed_steps']} replayed, recovery "
              f"{r['recovery_ms']:.1f} ms, {r['mismatched_streams']} "
              f"mismatched, {r['lost_steps']} lost")
    s = results["soak"]
    print(f"soak: {sum(s['injected'].values())} faults over {s['events']} "
          f"events, {s['wrong']} wrong, {s['lost']} lost")
    print(f"{results['device']} -> {args.out}")
    if bad:
        raise SystemExit("chaos serving contract violated:\n  "
                         + "\n  ".join(bad))


if __name__ == "__main__":
    main()
