"""The port's fleet tier (``serve/fleet.py``, ``registry.py``,
``admission.py``) held against the JAX ``LUTFleet`` on the same nets and
the same ``tests/traffic.py`` traces.

Every comparison is exact: each tenant's codes, the ``FleetStats``
counters, the admission decisions, the swap history (a corrupted
candidate's rollback included), the ``ExecutorCache`` eviction order and
``executor_cost_bytes``, and the stream lane's per-stream codes and final
states under churn and a stateful hot swap.  No wall-clock value is
compared.  The JAX side runs ``take``; the port's other backends are held
against the port's ``take``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import traffic
from repro import pipeline as jpipeline
from repro import serve as jserve
from repro.stream import cell as jcell
from repro_torch import pipeline as tpipeline
from repro_torch import serve as tserve
from repro_torch.core import assemble as tassemble
from repro_torch.serve.lut_engine import LUTEngine
from repro_torch.stream import cell as tcell
from test_torch_placement import shared_net

TASKS = ("nid", "jsc", "mnist")
PKGS = ((0, jserve), (1, tserve))
# the counters a fleet keeps that do not read a clock
COUNTERS = ("requests", "completed", "shed", "deferred", "ticks",
            "rows_padded", "failures", "deadline_hits", "retries",
            "breaker_trips", "degrades", "version", "queue_depth",
            "latency_window", "breaker")


@pytest.fixture(scope="module")
def nets():
    return {task: shared_net(task, i) for i, task in enumerate(TASKS)}


def _fresh(pair):
    """New (JAX, port) artifacts over a pair's tables: no plans yet."""
    jnet, tnet = pair
    args = (jnet.tables, jnet.mappings, jnet.in_log_scale, jnet.out_log_scale)
    return (jpipeline.CompiledLUTNetwork(jnet.cfg, *args),
            tpipeline.CompiledLUTNetwork(tnet.cfg, *args, device="cpu"))


def _rows(cfg, n, seed):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (n, cfg.in_features)).astype(np.float32)


def _counters(fleet, mid):
    s = fleet.summary(mid)
    return {k: s[k] for k in COUNTERS}


def _swaps(fleet, mid):
    return [e.summary() for e in fleet.registry.history(mid)]


def _replay(fleet, trace, inputs, deploy_at=None):
    """Submit each event's rows (gap ticks between), optionally calling
    ``deploy_at[1](fleet)`` before event ``deploy_at[0]``, then pump.
    Returns per-tenant (requests, decision) lists."""
    out = {}
    for i, (ev, xs) in enumerate(zip(trace, inputs)):
        if deploy_at is not None and i == deploy_at[0]:
            deploy_at[1](fleet)
        reqs, dec = fleet.submit_many(ev.model_id, xs)
        out.setdefault(ev.model_id, []).append((reqs, dec))
        for _ in range(ev.gap_ticks):
            fleet.tick()
    fleet.pump()
    return out


def _decisions(log):
    return {m: [(d.accept, d.shed, d.defer, d.reason) for _, d in pairs]
            for m, pairs in log.items()}


def _codes(log):
    return {m: np.concatenate([np.stack([np.asarray(r.codes) for r in reqs])
                               for reqs, _ in pairs if reqs])
            for m, pairs in log.items()}


@pytest.mark.parametrize("block,depth,min_fill,backend", [
    (64, 2, 1, "fused"), (32, 1, 32, "pallas"), (16, 3, 4, "onehot")])
def test_fleet_matches_jax_fleet_on_ragged_trace(block, depth, min_fill,
                                                 backend, nets):
    """Same trace, same block/depth/min_fill: every tenant's codes, every
    counter and every admission decision equal the JAX fleet's."""
    trace = traffic.ragged_trace(TASKS, n_events=24, seed=block,
                                 batches=(1, 8, 33), jitter=3)
    inputs = traffic.make_inputs(
        trace, {t: nets[t][1].cfg.in_features for t in TASKS}, seed=4)
    fleets = []
    for k, be in ((0, None), (1, backend)):
        fleet = (jserve.LUTFleet if k == 0 else tserve.LUTFleet)(
            block=block, depth=depth, min_fill=min_fill)
        mk = jserve.make_reference if k == 0 else tserve.make_reference
        for t in TASKS:
            fleet.register(t, nets[t][k], reference=mk(nets[t][k], n=16),
                           backend=be)
        fleets.append((fleet, _replay(fleet, trace, inputs)))
    (jf, jlog), (tf, tlog) = fleets
    assert _decisions(tlog) == _decisions(jlog)
    jc, tc = _codes(jlog), _codes(tlog)
    for t in TASKS:
        np.testing.assert_array_equal(tc[t], jc[t], err_msg=t)
        assert _counters(tf, t) == _counters(jf, t), t
        assert tf.summary(t)["completed"] == traffic.rows_per_model(trace)[t]


def test_admission_shed_and_defer_match_jax(nets):
    """Queue budgets (shed and defer) under a bursty trace: the decisions,
    the shed/deferred counters and the served codes equal the JAX
    fleet's; deferred rows are all served."""
    slos = {"nid": dict(max_queue=40, policy="shed"),
            "jsc": dict(max_queue=24, policy="defer"),
            "mnist": dict(max_queue=12, policy="defer")}
    trace = traffic.ragged_trace(TASKS, n_events=30, seed=11,
                                 batches=(8, 33), burst_prob=0.6)
    inputs = traffic.make_inputs(
        trace, {t: nets[t][1].cfg.in_features for t in TASKS}, seed=12)
    logs = []
    for k, pkg in ((0, jserve), (1, tserve)):
        fleet = pkg.LUTFleet(block=16, depth=2)
        for t in TASKS:
            fleet.register(t, nets[t][k], slo=pkg.TenantSLO(**slos[t]))
        logs.append((fleet, _replay(fleet, trace, inputs)))
    (jf, jlog), (tf, tlog) = logs
    assert _decisions(tlog) == _decisions(jlog)
    assert any(d[1] for d in _decisions(tlog)["nid"])      # shed happened
    assert any(d[2] for d in _decisions(tlog)["jsc"])      # deferred too
    for t in TASKS:
        assert _counters(tf, t) == _counters(jf, t), t
        np.testing.assert_array_equal(_codes(tlog)[t], _codes(jlog)[t])
    s = tf.summary("jsc")
    assert s["completed"] == traffic.rows_per_model(trace)["jsc"]
    # the pure controller, decision for decision
    for n, depth, p99 in ((10, 3, 0.0), (4, 0, 250.0), (9, 8, 50.0)):
        for slo in (dict(max_queue=8), dict(max_queue=8, policy="defer"),
                    dict(p99_budget_us=100.0)):
            a = jserve.AdmissionController().decide(
                n=n, queue_depth=depth, p99_us=p99,
                slo=jserve.TenantSLO(**slo))
            b = tserve.AdmissionController().decide(
                n=n, queue_depth=depth, p99_us=p99,
                slo=tserve.TenantSLO(**slo))
            assert (a.accept, a.shed, a.defer, a.reason) == \
                (b.accept, b.shed, b.defer, b.reason)


def _corrupt(path_good, path_bad, n_layers):
    """Flip the low bit of every last-layer table entry of a saved
    artifact: valid codes, wrong answers (as tests/test_fleet.py)."""
    z = np.load(path_good)
    arrays = {k: z[k] for k in z.files}
    last = f"table_{n_layers - 1}"
    arrays[last] = (arrays[last] ^ 1).astype(arrays[last].dtype)
    np.savez_compressed(path_bad, **arrays)


def test_hot_swap_history_and_rollback_match_jax(nets, tmp_path):
    """Under load: a good deploy versions up, a corrupted file and an
    injector-corrupted candidate are rejected and rolled back; the swap
    history, counters and codes equal the JAX fleet's, and no request is
    dropped."""
    jnet, tnet = nets["nid"]
    good = str(tmp_path / "good.npz")
    bad = str(tmp_path / "bad.npz")
    tnet.save(good)
    _corrupt(good, bad, len(tnet.cfg.layers))
    x1, x2 = _rows(tnet.cfg, 50, seed=9), _rows(tnet.cfg, 30, seed=10)
    runs = []
    for k, pkg in ((0, jserve), (1, tserve)):
        inj = pkg.FaultInjector(pkg.FaultPlan(
            [pkg.FaultSpec("corrupt_artifact", at=2, scope="nid")]))
        kw = {} if k == 0 else {"device": "cpu"}
        fleet = pkg.LUTFleet(block=16, depth=2, faults=inj, **kw)
        ref = pkg.make_reference(nets["nid"][k], n=32)
        fleet.register("nid", good, reference=ref)
        reqs, _ = fleet.submit_many("nid", x1)
        fleet.tick()                                   # blocks in flight
        events = [fleet.deploy("nid", good, reference=ref),    # ok: v2
                  fleet.deploy("nid", bad, reference=ref),     # rejected
                  fleet.deploy("nid", good, reference=ref)]    # injected
        more, _ = fleet.submit_many("nid", x2)
        fleet.pump()
        with pytest.raises(ValueError, match="rejected"):
            fleet.deploy("nid", bad, reference=ref, strict=True)
        runs.append((fleet, reqs + more, [e.ok for e in events],
                     [(e.kind, e.seam, e.scope, e.crossing)
                      for e in inj.events]))
    (jf, jreqs, jok, jev), (tf, treqs, tok, tev) = runs
    assert tok == jok == [True, False, False]
    assert tev == jev == [("corrupt_artifact", "registry_load", "nid", 2)]
    assert _swaps(tf, "nid") == _swaps(jf, "nid")
    assert "mismatch" in _swaps(tf, "nid")[1]["reason"]
    assert _counters(tf, "nid") == _counters(jf, "nid")
    assert tf.summary("nid")["version"] == 2
    assert all(r.done for r in treqs) and len(treqs) == 80
    np.testing.assert_array_equal(
        np.stack([r.codes for r in treqs]),
        np.stack([np.asarray(r.codes) for r in jreqs]))


def test_executor_cache_eviction_order_and_cost_match_jax(nets):
    """Three tenants through a 2-entry cache, then a byte budget: the
    cached keys after every step, the hit/miss/eviction counts and
    ``executor_cost_bytes`` equal the JAX registry's."""
    nets = {t: _fresh(nets[t]) for t in TASKS}
    for t in TASKS:
        jnet, tnet = nets[t]
        for be in ("take", "fused"):
            jnet.compile_backend(be)
            tnet.compile_backend(be)
        assert (tserve.registry.executor_cost_bytes(tnet)
                == jserve.registry.executor_cost_bytes(jnet)), t
    traces = []
    for k, pkg in ((0, jserve), (1, tserve)):
        for budget in (dict(max_entries=2), dict(max_bytes=1)):
            cache = pkg.ExecutorCache(**budget)
            fleet = pkg.LUTFleet(block=32, depth=2, cache=cache)
            steps = []
            for t in TASKS:
                fleet.register(t, nets[t][k], backend="fused"
                               if t == "mnist" else None)
                reqs, _ = fleet.submit_many(t, _rows(nets[t][1].cfg, 10, 13))
                fleet.pump()
                steps.append(list(cache._entries))
            fleet.registry.executor(TASKS[0])
            fleet.registry.executor(TASKS[0])
            steps.append(list(cache._entries))
            traces.append((steps, vars(cache.stats), cache.bytes_held))
    assert traces[2:] == traces[:2]
    _, stats, _ = traces[0]
    assert stats == {"hits": 1, "misses": 4, "evictions": 2}


# ---------------------------------------------------------------------------
# the stream lane
# ---------------------------------------------------------------------------

def _cell_pair(seed, shift=0.0):
    """(JAX, port) compiled tiny cells folded from one parameter tree; the
    input boundary's log-scale moved by ``shift`` (a requantizing swap)."""
    from repro.core.assemble import AssembleConfig, LayerSpec
    jc = jcell.StreamCellConfig(
        net=AssembleConfig(
            in_features=6, input_bits=2, input_signed=False,
            layers=(LayerSpec(12, 3, 2, False), LayerSpec(4, 3, 2, True)),
            subnet_width=8, subnet_depth=2, skip_step=2),
        n_in=4, n_state=2)
    tc = tcell.StreamCellConfig(
        net=tpipeline.config_from_dict(jpipeline.config_to_dict(jc.net)),
        n_in=4, n_state=2)
    tree = tassemble.params_to_reference(
        tassemble.init(seed, tc.net, device="cpu"))
    tree["in_q"]["log_scale"] = tree["in_q"]["log_scale"] + np.float32(shift)
    jcomp = jcell.compile_cell(jax.tree.map(jnp.asarray, tree), jc)
    tcomp = tcell.compile_cell(
        tassemble.params_from_reference(tree, device="cpu"), tc)
    return jcomp, tcomp


def _stream_replay(fleet, cell_v2, cell_v3, trace, inputs):
    for i, (ev, xs) in enumerate(zip(trace, inputs)):
        if i == len(trace) // 3:
            fleet.deploy("cell", cell_v2)        # requantized swap
        if i == 2 * len(trace) // 3:
            fleet.deploy("cell", cell_v3)        # carried swap
        if ev.action == "open":
            fleet.open_stream("cell", ev.stream_id)
        elif ev.action == "feed":
            fleet.submit_stream("cell", ev.stream_id, xs)
        else:
            fleet.close_stream("cell", ev.stream_id)
        for _ in range(ev.gap_ticks):
            fleet.tick()
    fleet.pump()
    lane = fleet._stream_lane("cell")
    return {sid: (np.stack([np.asarray(r.codes) for r in s.steps])
                  if s.steps else np.zeros((0, 2), np.int32),
                  None if s.final_state is None
                  else np.asarray(s.final_state, np.int32))
            for sid, s in lane.sessions.items()}


@pytest.mark.parametrize("backend", ["take", "fused"])
def test_stream_lane_churn_and_stateful_swap_match_jax(backend):
    """Streams open, burst-feed and close mid-trace while two versions are
    hot-swapped in (re-quantized, then carried state): every stream's
    codes and final state, the swap history with its migration modes and
    the counters equal the JAX fleet's."""
    cells = [_cell_pair(0), _cell_pair(1, 0.5), _cell_pair(2, 0.5)]
    trace = traffic.stream_churn_trace(("cell",), n_events=48, seed=5)
    inputs = traffic.make_stream_inputs(trace, {"cell": 4}, seed=6,
                                        high=3.0)
    runs = []
    for k, pkg in ((0, jserve), (1, tserve)):
        fleet = pkg.LUTFleet(block=8, depth=2)
        fleet.register("cell", cells[0][k],
                       backend=None if k == 0 else backend)
        runs.append((fleet, _stream_replay(fleet, cells[1][k], cells[2][k],
                                           trace, inputs)))
    (jf, js), (tf, ts) = runs
    assert ts.keys() == js.keys() and len(ts) > 3
    for sid in js:
        np.testing.assert_array_equal(ts[sid][0], js[sid][0],
                                      err_msg=f"stream {sid}")
        assert (ts[sid][1] is None) == (js[sid][1] is None)
        if js[sid][1] is not None:
            np.testing.assert_array_equal(ts[sid][1], js[sid][1])
    swaps = _swaps(tf, "cell")
    assert swaps == _swaps(jf, "cell")
    assert [s.get("state_migration") for s in swaps] == ["requantized",
                                                         "carried"]
    assert _counters(tf, "cell") == _counters(jf, "cell")


# ---------------------------------------------------------------------------
# the port's own fleet surfaces
# ---------------------------------------------------------------------------

def test_small_tenant_not_stalled_and_min_fill(nets):
    """Continuous cross-tenant batching (3 rows dispatch beside 300) and
    the batching-delay threshold, as tests/test_fleet.py checks them."""
    tnid, tjsc = nets["nid"][1], nets["jsc"][1]
    fleet = tserve.LUTFleet(block=256, depth=2)
    fleet.register("big", tnid)
    fleet.register("small", tjsc)
    big, _ = fleet.submit_many("big", _rows(tnid.cfg, 300, seed=5))
    small, _ = fleet.submit_many("small", _rows(tjsc.cfg, 3, seed=6))
    fleet.tick()
    assert all(r.done for r in small) and fleet.queue_depth("big") > 0
    fleet.pump()
    assert all(r.done for r in big)
    fleet = tserve.LUTFleet(block=8, depth=1, min_fill=8)
    fleet.register("jsc", tjsc)
    first, _ = fleet.submit_many("jsc", _rows(tjsc.cfg, 3, seed=21))
    fleet.tick()
    assert fleet.stats("jsc").ticks == 0 and not any(r.done for r in first)
    fleet.submit_many("jsc", _rows(tjsc.cfg, 5, seed=22))
    fleet.tick()
    assert fleet.stats("jsc").ticks == 1
    assert fleet.stats("jsc").rows_padded == 0
    with pytest.raises(ValueError, match="min_fill"):
        tserve.LUTFleet(min_fill=0)


def test_fleet_validation_registry_and_engine_hooks(nets, tmp_path):
    tnet = nets["jsc"][1]
    fleet = tserve.LUTFleet(block=8)
    fleet.register("jsc", tnet)
    with pytest.raises(KeyError, match="unknown model"):
        fleet.submit_many("nope", np.zeros((1, 4), np.float32))
    with pytest.raises(ValueError, match="in_features"):
        fleet.submit_many("jsc", np.zeros((4,), np.float32))
    with pytest.raises(ValueError, match="depth"):
        tserve.LUTFleet(depth=0)
    with pytest.raises(ValueError, match="not both"):
        tserve.LUTFleet(registry=tserve.TenantRegistry(),
                        cache=tserve.ExecutorCache())
    with pytest.raises(ValueError, match="stream tenant"):
        fleet.open_stream("jsc", 0)
    reg = tserve.TenantRegistry(device="cpu")
    reg.register("m", tnet)
    with pytest.raises(ValueError, match="already registered"):
        reg.register("m", tnet)
    ev = reg.deploy("m", tnet)                  # no reference: self-check
    assert ev.ok and "self-check" in ev.reason and reg.get("m").version == 2
    ok, reason, n = tserve.smoke_check(tnet, None)
    assert ok and n == 64
    wrong = tserve.Reference(x=tserve.make_reference(tnet, n=8).x,
                             codes=tserve.make_reference(tnet, n=8).codes + 1)
    assert not tserve.smoke_check(tnet, wrong)[0]
    reg.unregister("m")
    assert "m" not in reg
    # a path registers onto the registry's device (here the CPU)
    path = tnet.save(os.path.join(str(tmp_path), "a.npz"))
    reg.register("p", path)
    assert reg.get("p").net.device.type == "cpu"
    # the engine takes a pre-built executor and refuses mismatches
    ex = tnet.compile_backend("take")
    eng = LUTEngine(tnet, block=8, executor=ex)
    x = _rows(tnet.cfg, 10, seed=19)
    np.testing.assert_array_equal(eng.run(x), tnet.predict(x).numpy())
    with pytest.raises(ValueError, match="backend"):
        LUTEngine(tnet, backend="fused", executor=ex)
    with pytest.raises(ValueError, match="mesh"):
        LUTEngine(tnet, mesh=object(), executor=ex)
    reqs = eng.submit_many(x[:2], 5.0)
    assert [r.t_submit for r in reqs] == [5.0, 5.0]


def test_corrupt_tables_under_a_persisted_fused_plan_pass_in_both_packages(
        nets, tmp_path):
    """ROADMAP C.5, held so both packages agree: an artifact defaulting to
    ``fused`` with its fused plan persisted answers the smoke check from
    the plan's packed tables, so corrupting ``table_<l>`` at load passes a
    reference check in the reference and in the port alike; without a
    reference the self-check (fused against take) rejects it."""
    out = []
    for k, pkg in PKGS:
        net = _fresh(nets["nid"])[k]
        net.backend = "fused"
        net.compile_backend("fused")
        path = net.save(str(tmp_path / f"fused{k}.npz"))
        inj = pkg.FaultInjector(pkg.FaultPlan(
            [pkg.FaultSpec("corrupt_artifact", at=0, scope="m"),
             pkg.FaultSpec("corrupt_artifact", at=1, scope="m")]))
        reg = pkg.TenantRegistry(faults=inj, **({} if k == 0 else
                                                {"device": "cpu"}))
        ref = pkg.make_reference(net, n=64)
        reg.register("m", net, reference=ref)
        with_ref = reg.deploy("m", path, reference=ref)
        cand = reg.get("m").net
        x = ref.x
        split = not np.array_equal(
            np.asarray(cand.predict_codes(x, backend="fused")),
            np.asarray(cand.predict_codes(x, backend="take")))
        self_check = reg.deploy("m", path)
        out.append((with_ref.ok, split, self_check.ok, self_check.reason))
    assert out[1] == out[0]
    assert out[1][:3] == (True, True, False)
