"""The port's LUTEngine held against the JAX engine on the shared ragged
traffic traces: results, completion order and padding stats identical at
depth 1 and 2 (the CPU engine is synchronous underneath)."""
import numpy as np
import pytest

import traffic
from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.serve.lut_engine import LUTEngine as JEngine
from repro_torch import pipeline as tpipeline
from repro_torch.serve.lut_engine import DrainTimeout, LUTEngine

MODELS = ("nid_reduced", "jsc_reduced")


def _arrays(cfg, seed):
    rs = np.random.RandomState(seed)
    tables, maps = [], []
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        tables.append(rs.randint(0, 2 ** spec.bits,
                                 size=(spec.units, entries)).astype(np.int32))
        maps.append(None if spec.assemble else rs.randint(
            0, cfg.prev_width(l), size=(spec.units, spec.fan_in)
        ).astype(np.int32))
    return tables, maps, float(rs.uniform(-2, 0)), float(rs.uniform(-3, 0))


def _pair(task, seed=0):
    cfg = jtasks.task_config(task)
    arrays = _arrays(cfg, seed)
    return (jpipeline.CompiledLUTNetwork(cfg, *arrays),
            tpipeline.CompiledLUTNetwork(cfg, *arrays, device="cpu"))


def _replay(engines, trace, inputs):
    """Online replay: per event, submit its rows and tick that model's
    engine; then tick every engine empty and drain.  Returns the per-tick
    completion counts."""
    log = []
    reqs = {m: [] for m in engines}
    for ev, x in zip(trace, inputs):
        eng = engines[ev.model_id]
        reqs[ev.model_id] += eng.submit_many(x)
        done = eng.tick()
        log.append((ev.model_id, done))
    for m, eng in engines.items():
        while eng.queue:
            log.append((m, eng.tick()))
        log.append((m, eng.drain()))
    return log, reqs


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("backend", ["take", "fused"])
def test_engine_matches_jax_engine_on_ragged_trace(depth, backend):
    pairs = {m: _pair(m, seed=i) for i, m in enumerate(MODELS)}
    trace = traffic.ragged_trace(MODELS, n_events=16, seed=depth)
    inputs = traffic.make_inputs(
        trace, {m: pairs[m][0].cfg.in_features for m in MODELS}, seed=3)
    j_eng = {m: JEngine(p[0], block=32, depth=depth, backend=backend)
             for m, p in pairs.items()}
    t_eng = {m: LUTEngine(p[1], block=32, depth=depth, backend=backend)
             for m, p in pairs.items()}
    j_log, j_reqs = _replay(j_eng, trace, inputs)
    t_log, t_reqs = _replay(t_eng, trace, inputs)
    assert t_log == j_log
    for m in MODELS:
        assert [r.rid for r in t_reqs[m]] == [r.rid for r in j_reqs[m]]
        assert all(r.done for r in t_reqs[m])
        np.testing.assert_array_equal(
            np.stack([r.codes for r in t_reqs[m]]),
            np.stack([r.codes for r in j_reqs[m]]))
        np.testing.assert_array_equal(
            np.stack([r.logits for r in t_reqs[m]]),
            np.stack([r.logits for r in j_reqs[m]]))
        ts, js = t_eng[m].stats, j_eng[m].stats
        assert (ts.ticks, ts.requests, ts.rows_padded) == \
            (js.ticks, js.requests, js.rows_padded)
        assert t_eng[m].inflight == 0


def test_engine_run_matches_predict_and_counts_padding():
    jnet, net = _pair("nid_reduced", seed=4)
    x = np.random.RandomState(5).uniform(-1, 1, (100, 593)).astype(np.float32)
    sync = LUTEngine(net, block=32, depth=1)
    async_ = LUTEngine(net, block=32, depth=2)
    np.testing.assert_array_equal(async_.run(x), sync.run(x))
    np.testing.assert_array_equal(sync.run(x), net.predict(x).numpy())
    assert async_.stats.ticks == 4 and async_.stats.rows_padded == 28
    assert sync.stats.summary()["rows_padded"] == 56
    assert async_.stats.latency_us(99) >= async_.stats.latency_us(50) > 0


def test_engine_completion_trails_dispatch_at_depth_2():
    _, net = _pair("jsc_reduced", seed=6)
    eng = LUTEngine(net, block=4, depth=2)
    x = np.random.RandomState(7).uniform(-1, 1, (12, 16)).astype(np.float32)
    reqs = [eng.submit(row) for row in x]
    assert eng.tick() == 0 and eng.inflight == 1 and not reqs[0].done
    assert eng.tick() == 4 and reqs[0].done and not reqs[4].done
    assert eng.tick() == 4
    assert eng.drain() == 4
    want = net.predict_codes(x).numpy()
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(r.codes, want[i])
    assert eng.tick() == 0


def test_drain_timeout_raises_and_abandon_requeues():
    _, net = _pair("jsc_reduced", seed=8)
    eng = LUTEngine(net, block=4, depth=2)
    x = np.random.RandomState(9).uniform(-1, 1, (6, 16)).astype(np.float32)
    reqs = eng.submit_many(x)
    eng.tick()
    t_dispatch = eng._inflight[0][4]
    eng._now = lambda: t_dispatch + 5.0
    assert eng.oldest_age() == pytest.approx(5.0)
    with pytest.raises(DrainTimeout, match="timed out") as info:
        eng.drain(timeout=1.0)
    assert info.value.requests == 4 and info.value.age_s == pytest.approx(5.0)
    assert eng.abandon_oldest() == reqs[:4]
    assert [r.attempts for r in reqs[:4]] == [1] * 4
    assert list(eng.queue) == reqs
    assert eng.drain(timeout=1.0) == 0


def test_engine_attributes_are_fixed_at_construction():
    _, net = _pair("nid_reduced", seed=10)
    eng = LUTEngine(net, block=16, backend="fused")
    assert eng.block == 16 and eng.backend == "fused" and eng.depth == 1
    with pytest.raises(AttributeError, match="fixed at construction"):
        eng.block = 64
    with pytest.raises(AttributeError, match="fixed at construction"):
        eng.backend = "take"
    with pytest.raises(ValueError, match="depth"):
        LUTEngine(net, depth=0)
