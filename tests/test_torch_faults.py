"""The port's resilience tier (``serve/faults.py``, ``supervision.py``, the
fleet's supervision and ``stream/replica.py``) held against the JAX
package under the same fault plans.

Exact agreement on: ``FaultPlan.seeded`` specs, the fired-event log, the
breaker state machine, the failure and degrade events, every served code
(against each other and against ``predict_codes``: zero wrong, zero
lost), and the codes a stream failover recovers.  Device loss of slot 2
of 4 remeshes onto the 3 survivors in process (the reference needs a
4-device subprocess for this, ``tests/test_faults.py``).  Injected hangs
are clock skew, so no test sleeps; no wall-clock value is compared.
"""
import dataclasses

import numpy as np
import pytest

from repro import serve as jserve
from repro.dist import elastic as jelastic
from repro.launch.mesh import make_serving_mesh as jmesh
from repro.stream import replica as jreplica
from repro_torch import backends as tbackends
from repro_torch import serve as tserve
from repro_torch.dist import elastic as telastic
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.serve.lut_engine import LUTEngine
from repro_torch.stream import replica as treplica
from repro_torch.stream.session import StreamRouter
from test_torch_fleet import _cell_pair
from test_torch_placement import shared_net

TASKS = ("nid", "jsc")
PKGS = ((0, jserve), (1, tserve))


@pytest.fixture(scope="module")
def nets():
    return {task: shared_net(task, i) for i, task in enumerate(TASKS)}


@pytest.fixture(scope="module")
def cells():
    return _cell_pair(0)


def _rows(cfg, n, seed):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, cfg.in_features)).astype(np.float32)


def _events(inj):
    return [(e.kind, e.seam, e.scope, e.crossing) for e in inj.events]


def _lane_log(fleet, mid):
    lane = fleet._lanes[mid]
    return ([(e.kind, e.consecutive) for e in lane.failure_log],
            [dataclasses.replace(e, t=0.0) for e in lane.degrade_log])


# ---------------------------------------------------------------------------
# the harness: plans, clock, crossings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,kw", [
    (7, {}), (8, dict(n_faults=12, max_at=9, max_count=3)),
    (3, dict(kinds=("exception", "device_loss", "corrupt_artifact"),
             stall_s=0.25))])
def test_seeded_plans_match_jax(seed, kw):
    scopes = ("m0", "m1", "m2")
    a = jserve.FaultPlan.seeded(seed, scopes=scopes, **kw)
    b = tserve.FaultPlan.seeded(seed, scopes=scopes, **kw)
    assert [dataclasses.astuple(s) for s in b.specs] == \
        [dataclasses.astuple(s) for s in a.specs]
    for seam in ("executor_call", "lane_dispatch", "registry_load"):
        assert len(b.specs_for(seam)) == len(a.specs_for(seam))
    for pkg in (jserve, tserve):
        with pytest.raises(ValueError, match="at least one"):
            pkg.FaultPlan.seeded(0, scopes=())
        with pytest.raises(ValueError, match="unknown fault kind"):
            pkg.FaultSpec("segfault")
        with pytest.raises(ValueError, match="count >= 1"):
            pkg.FaultSpec("exception", count=0)


def test_injector_crossings_and_event_log_match_jax():
    """Scoped specs take precedence over scope-blind ones, hangs skew the
    clock, and a seeded plan fires the same events in both packages over
    the same crossing sequence."""
    logs = []
    for _, pkg in PKGS:
        inj = pkg.FaultInjector(pkg.FaultPlan([
            pkg.FaultSpec("exception", at=0, scope="a"),
            pkg.FaultSpec("hang", at=1, scope=None, stall_s=2.0)]))
        with pytest.raises(pkg.ExecutorFault, match="scope='a'"):
            inj.executor_call(scope="a")
        inj.executor_call(scope="b")
        soak = pkg.FaultInjector(pkg.FaultPlan.seeded(
            5, scopes=("a", "b"), n_faults=10, max_at=12, max_count=2))
        raised = []
        for i in range(30):
            scope = "ab"[i % 2]
            try:
                soak.executor_call(scope=scope)
            except pkg.ExecutorFault:
                raised.append(i)
            soak.lane_dispatch(scope=scope)
        logs.append((_events(inj), inj.clock.skew, _events(soak), raised,
                     soak.clock.skew, soak.fired("hang"), soak.fired()))
    assert logs[1] == logs[0]
    assert logs[1][0] == [("exception", "executor_call", "a", 0),
                          ("hang", "executor_call", "b", 1)]


def test_breaker_and_policy_match_jax():
    runs = []
    for _, pkg in PKGS:
        br = pkg.CircuitBreaker(threshold=2, cooldown_s=1.0)
        trace = [br.state(0.0), br.record_failure(0.1), br.record_failure(0.2),
                 br.state(0.3), br.allow_dispatch(0.3), br.state(1.3),
                 br.record_failure(1.4), br.state(1.5)]
        br.force_half_open(1.6)
        trace.append(br.state(1.7))
        br.record_success()
        trace += [br.state(1.8), br.consecutive_failures, br.trips]
        p = pkg.ResiliencePolicy(backoff_base_s=0.01, backoff_factor=3.0)
        trace += [p.backoff_s(n) for n in (0, 1, 2, 3)]
        runs.append(trace)
    assert runs[1] == runs[0]
    assert runs[1][:8] == ["closed", False, True, "open", False,
                           "half_open", True, "open"]
    for field, bad in (("deadline_s", 0.0), ("breaker_threshold", 0),
                       ("backoff_factor", 0.5), ("breaker_cooldown_s", -1.0)):
        with pytest.raises(ValueError):
            tserve.ResiliencePolicy(**{field: bad})
    assert telastic.plan_serving_remesh(4, 0) == \
        telastic.RemeshPlan(**dataclasses.asdict(
            jelastic.plan_serving_remesh(4, 0)))


# ---------------------------------------------------------------------------
# the engine's seam
# ---------------------------------------------------------------------------

def test_engine_dispatch_is_exception_safe_and_drain_bounded(nets):
    net = nets["jsc"][1]
    inj = tserve.FaultInjector(tserve.FaultPlan([
        tserve.FaultSpec("exception", at=0),
        tserve.FaultSpec("hang", at=1, stall_s=5.0)]))
    eng = LUTEngine(net, block=8, depth=2, faults=inj, scope="jsc")
    reqs = eng.submit_many(_rows(net.cfg, 5, seed=1))
    with pytest.raises(tserve.ExecutorFault):
        eng.dispatch_block()
    assert [r.rid for r in eng.queue] == [r.rid for r in reqs]
    assert all(r.attempts == 1 for r in reqs)
    assert eng.inflight == 0 and eng.stats.ticks == 0
    eng.dispatch_block()                      # the hang skews the clock
    assert eng.oldest_age() >= 5.0
    with pytest.raises(tserve.DrainTimeout, match=r"'jsc'.*5 requests") as ei:
        eng.drain(timeout=1.0)
    assert ei.value.scope == "jsc" and ei.value.requests == 5
    eng.drain()
    np.testing.assert_array_equal(
        np.stack([r.codes for r in reqs]),
        net.predict_codes(np.stack([r.x for r in reqs])).numpy())


def test_stream_router_not_wedged_by_poisoned_batch(cells):
    _, comp = cells
    inj = tserve.FaultInjector(tserve.FaultPlan(
        [tserve.FaultSpec("exception", at=0)]))
    eng = LUTEngine(comp.net, cell=comp, block=4, faults=inj, scope="cell")
    router = StreamRouter(comp, engine=eng)
    xs = np.random.default_rng(9).uniform(0.0, 3.0, (3, 5, 4)).astype(
        np.float32)
    sessions = [router.open(i) for i in range(3)]
    for i in range(3):
        router.feed(i, xs[i])
    with pytest.raises(tserve.ExecutorFault):
        router.tick()
    router.pump()
    ref = comp.predict_sequence(xs)[0].numpy()
    for i, s in enumerate(sessions):
        np.testing.assert_array_equal(s.codes(), ref[i])


# ---------------------------------------------------------------------------
# supervision: deadlines, retries, breaker, degradation
# ---------------------------------------------------------------------------

SCENARIOS = {
    # kind of fault: (specs, policy, register kwargs)
    "deadline": ([("hang", dict(at=0, scope="jsc", stall_s=5.0))],
                 dict(deadline_s=1.0, backoff_base_s=0.0), {}),
    "slow_start": ([("slow_start", dict(at=0, scope="jsc", stall_s=5.0))],
                   dict(deadline_s=1.0, backoff_base_s=0.0), {}),
    "transient": ([("exception", dict(at=0, scope="jsc", count=2))],
                  dict(backoff_base_s=0.0), {}),
    "persistent": ([("exception", dict(at=0, scope="jsc", count=3))],
                   dict(backoff_base_s=0.0), dict(backend="onehot")),
    "sole_device": ([("device_loss", dict(at=0, scope="jsc"))],
                    dict(backoff_base_s=0.0), dict(mesh=1)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_supervision_scenarios_match_jax(name, nets):
    """One scenario per fault class: zero wrong answers (codes equal
    ``predict_codes`` and the JAX fleet's), zero lost accepted requests,
    and the same counters, fired events, failure and degrade logs."""
    specs, policy, reg = SCENARIOS[name]
    x = _rows(nets["jsc"][1].cfg, 20, seed=5)
    runs = []
    for k, pkg in PKGS:
        inj = pkg.FaultInjector(pkg.FaultPlan(
            [pkg.FaultSpec(kind, **kw) for kind, kw in specs]))
        fleet = pkg.LUTFleet(block=8, faults=inj,
                             policy=pkg.ResiliencePolicy(**policy))
        kw = dict(reg)
        if "mesh" in kw:
            kw["mesh"] = (jmesh(1) if k == 0 else
                          make_serving_mesh(slots=kw["mesh"], device="cpu"))
        fleet.register("jsc", nets["jsc"][k],
                       reference=pkg.make_reference(nets["jsc"][k], n=8),
                       **kw)
        reqs, _ = fleet.submit_many("jsc", x)
        fleet.pump()
        s = fleet.summary("jsc")
        runs.append((np.stack([np.asarray(r.codes) for r in reqs]),
                     [r.done for r in reqs], _events(inj),
                     _lane_log(fleet, "jsc"),
                     {key: s[key] for key in (
                         "completed", "failures", "deadline_hits", "retries",
                         "breaker_trips", "degrades", "breaker",
                         "incidents_recovered", "degrade_history")},
                     [r.attempts for r in reqs]))
    (jc, jdone, *jrest), (tc, tdone, *trest) = runs
    assert all(tdone) and all(jdone)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(
        tc, nets["jsc"][1].predict_codes(x).numpy())
    (jev, (jfail, jdeg), jsum, jatt), (tev, (tfail, tdeg), tsum, tatt) = \
        jrest, trest
    assert tev == jev and tfail == jfail and tsum == jsum and tatt == jatt
    assert [dataclasses.astuple(e) for e in tdeg] == \
        [dataclasses.astuple(e) for e in jdeg]
    assert tsum["completed"] == 20 and tsum["breaker"] == "closed"
    assert len(tev) >= 1 and tsum["failures"] >= 1


def test_open_breaker_quarantines_arrivals_like_jax(nets):
    """Mid-incident arrivals go through the quarantine door: shed for an
    SLO-less tenant, deferred (then served) for a defer tenant; decisions,
    counters and codes equal the JAX fleet's."""
    runs = []
    for k, pkg in PKGS:
        inj = pkg.FaultInjector(pkg.FaultPlan([
            pkg.FaultSpec("exception", at=0, scope="jsc"),
            pkg.FaultSpec("exception", at=0, scope="nid")]))
        fleet = pkg.LUTFleet(block=8, faults=inj, policy=pkg.ResiliencePolicy(
            breaker_threshold=1, backoff_base_s=0.0, breaker_cooldown_s=60.0))
        fleet.register("jsc", nets["jsc"][k], backend="onehot")
        fleet.register("nid", nets["nid"][k], backend="onehot",
                       slo=pkg.TenantSLO(policy="defer"))
        rj, _ = fleet.submit_many("jsc", _rows(nets["jsc"][1].cfg, 8, 9))
        rn, _ = fleet.submit_many("nid", _rows(nets["nid"][1].cfg, 6, 10))
        fleet.tick()
        decs = [fleet.submit_many(m, _rows(nets[m][1].cfg, 4, s))[1]
                for m, s in (("jsc", 11), ("nid", 12))]
        fleet.pump()
        runs.append(([(d.accept, d.shed, d.defer, d.reason) for d in decs],
                     [fleet.summary(m)["completed"] for m in TASKS],
                     [fleet.summary(m)["shed"] for m in TASKS],
                     [np.stack([np.asarray(r.codes) for r in rs])
                      for rs in (rj, rn)]))
    assert runs[1][:3] == runs[0][:3]
    assert runs[1][0] == [(0, 4, 0, "quarantined"), (0, 0, 4, "quarantined")]
    for t, j in zip(runs[1][3], runs[0][3]):
        np.testing.assert_array_equal(t, j)


def test_device_loss_remeshes_onto_3_of_4_slots_in_process(nets):
    """A 4-slot placed lane loses slot 2 at its second dispatch: the fleet
    re-plans the same backend over slots 0, 1, 3 (``elastic``'s verdict as
    the JAX package gives it) and every answer equals the JAX package's
    unplaced codes."""
    jnet, tnet = nets["jsc"]
    for backend, strategy in (("take", "batch"), ("fused", "batch"),
                              ("pallas", "units")):
        inj = tserve.FaultInjector(tserve.FaultPlan(
            [tserve.FaultSpec("device_loss", at=1, scope="m", device=2)]))
        fleet = tserve.LUTFleet(block=16, faults=inj,
                                policy=tserve.ResiliencePolicy(
                                    backoff_base_s=0.0))
        pl = tbackends.Placement(make_serving_mesh(slots=4, device="cpu"),
                                 strategy=strategy)
        fleet.register("m", tnet, backend=backend, placement=pl)
        x = _rows(tnet.cfg, 50, seed=0)
        reqs, _ = fleet.submit_many("m", x)
        fleet.pump()
        assert all(r.done for r in reqs)
        np.testing.assert_array_equal(np.stack([r.codes for r in reqs]),
                                      np.asarray(jnet.predict_codes(x)))
        lane = fleet._lanes["m"]
        ev = lane.degrade_log[0]
        assert (ev.reason, ev.from_shards, ev.to_shards) == (
            "device_loss", 4, 3)
        assert ev.from_backend == ev.to_backend == backend
        assert ev.plan_reason == jelastic.plan_serving_remesh(
            4, 3, tenants=1).reason
        assert [s.id for s in lane.placement.mesh.slots] == [0, 1, 3]
        assert lane.placement.strategy == strategy
        assert inj.dead_devices == {2}
        with pytest.raises(tserve.DeviceLost):
            inj.check_placement(pl)


def test_exhausted_fallback_raises_loudly(nets):
    net = nets["jsc"][1]
    inj = tserve.FaultInjector(tserve.FaultPlan(
        [tserve.FaultSpec("exception", at=0, scope="jsc", count=10)]))
    fleet = tserve.LUTFleet(block=8, faults=inj, policy=tserve.ResiliencePolicy(
        breaker_threshold=1, backoff_base_s=0.0))
    fleet.register("jsc", net, backend="take")
    fleet.submit_many("jsc", _rows(net.cfg, 4, seed=15))
    with pytest.raises(tserve.ExecutorFault):
        fleet.pump()


def test_corrupt_artifact_flips_the_same_bits(nets, tmp_path):
    """The registry_load seam corrupts a disk-loaded port artifact exactly
    as the reference corrupts its own."""
    jnet, tnet = nets["nid"]
    path = tnet.save(str(tmp_path / "a.npz"))
    out = []
    for k, pkg in PKGS:
        inj = pkg.FaultInjector(pkg.FaultPlan(
            [pkg.FaultSpec("corrupt_artifact", at=0, scope="m")]))
        if k == 0:
            from repro.pipeline import CompiledLUTNetwork
            net = CompiledLUTNetwork.load(path)
        else:
            from repro_torch.pipeline import CompiledLUTNetwork
            net = CompiledLUTNetwork.load(path, device="cpu")
        out.append(np.asarray(inj.registry_load("m", net).tables[-1]))
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_array_equal(out[1] ^ 1, tnet.tables[-1])


# ---------------------------------------------------------------------------
# stream-state replication + failover
# ---------------------------------------------------------------------------

def test_checkpoint_bytes_cross_packages():
    states = np.arange(6, dtype=np.uint8).reshape(3, 2)
    a = treplica.StreamCheckpoint("m", 4, ["a", "b", "c"], states, [2, 5, 0])
    b = jreplica.StreamCheckpoint.from_bytes(a.to_bytes())
    c = treplica.StreamCheckpoint.from_bytes(b.to_bytes())
    for ck in (b, c):
        assert (ck.model_id, ck.seq, ck.stream_ids, ck.applied) == \
            ("m", 4, ["a", "b", "c"], [2, 5, 0])
        np.testing.assert_array_equal(ck.states, states)
    assert c.state_for("nope") is None and c.applied_for("b") == 5
    with pytest.raises(ValueError, match="length mismatch"):
        treplica.StreamCheckpoint("m", 1, ["a"], states, [1])
    log = treplica.ReplicationLog()
    log.open("s")
    rows = np.arange(20, dtype=np.float32).reshape(5, 4)
    assert log.ack("s", rows[:3]) == 3 and log.ack("s", rows[3]) == 4
    ck = treplica.StreamCheckpoint("m", 1, ["s"], np.zeros((1, 2)), [3])
    assert log.prune(ck) == 3
    np.testing.assert_array_equal(log.tail("s", 3), rows[3:4])
    with pytest.raises(ValueError, match="stale checkpoint"):
        log.tail("s", 2)


def _failover(pkg, rmod, comp, xs, backend):
    """The reference test's failover: 6 steps, checkpoint, 4 more acked,
    one block past the checkpoint retires, the primary dies, the standby
    replays.  Returns (combined codes per stream, replayed, final states)."""
    primary = pkg.LUTFleet(block=8)
    primary.register("cell", comp, block=8, backend=backend)
    standby = rmod.StandbyReplica("cell", comp, block=8, backend=backend)
    tenant = rmod.ReplicatedStreamTenant(primary, "cell", standby,
                                         checkpoint_every=6)
    n = xs.shape[0]
    for i in range(n):
        tenant.open_stream(i)
        tenant.submit(i, xs[i, :6])
    primary.pump()
    assert tenant.maybe_checkpoint() is not None
    applied = {i: standby.checkpoint.applied_for(i) for i in range(n)}
    for i in range(n):
        tenant.submit(i, xs[i, 6:])
    primary.tick()
    primary.drain()
    lane = primary._stream_lane("cell")
    before = {i: [np.asarray(r.codes) for r in lane.sessions[i].steps]
              for i in range(n)}
    fleet2, replayed = standby.activate()
    fleet2.pump()
    combined, finals = [], []
    for i in range(n):
        rec = fleet2._stream_lane("cell").sessions[i].steps
        combined.append(np.stack(before[i][:applied[i]]
                                 + [np.asarray(r.codes) for r in rec]))
        finals.append(np.asarray(fleet2.close_stream("cell", i).final_state,
                                 np.int32))
    return np.stack(combined), replayed, np.stack(finals)


@pytest.mark.parametrize("backend", ["take", "fused", "pallas"])
def test_stream_failover_recovers_codes_equal_to_jax(backend, cells):
    """Kill the primary mid-trace: the standby recovers every stream from
    its last checkpoint plus the replayed acked tail, and the combined
    codes and final states equal the JAX failover's and the offline scan."""
    jcomp, tcomp = cells
    xs = np.random.default_rng(20).uniform(0.0, 3.0, (3, 10, 4)).astype(
        np.float32)
    jcodes, jrep, jfin = _failover(jserve, jreplica, jcomp, xs, None)
    tcodes, trep, tfin = _failover(tserve, treplica, tcomp, xs, backend)
    assert trep == jrep == {0: 4, 1: 4, 2: 4}
    np.testing.assert_array_equal(tcodes, jcodes)
    np.testing.assert_array_equal(tfin, jfin)
    ref, _, s_fin = tcomp.predict_sequence(xs, backend="take")
    np.testing.assert_array_equal(tcodes, ref.numpy())
    np.testing.assert_array_equal(tfin, s_fin.numpy())


def test_replication_never_logs_rejected_steps(cells):
    _, comp = cells
    primary = tserve.LUTFleet(block=8)
    primary.register("cell", comp, block=8)
    standby = treplica.StandbyReplica("cell", comp, block=8)
    tenant = treplica.ReplicatedStreamTenant(primary, "cell", standby)
    tenant.open_stream("s")
    tenant.submit("s", np.ones((3, 4), np.float32))
    tenant.close_stream("s")
    with pytest.raises(ValueError, match="closing"):
        tenant.submit("s", np.ones((1, 4), np.float32))
    with pytest.raises(KeyError):
        tenant.submit("ghost", np.ones((1, 4), np.float32))
    assert standby.log.acked("s") == 3 and standby.live_stream_ids() == []
    with pytest.raises(ValueError, match="checkpoint_every"):
        treplica.ReplicatedStreamTenant(primary, "cell", standby,
                                        checkpoint_every=0)
