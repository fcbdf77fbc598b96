"""The autotuner's measurement path (``repro_torch.kernels.autotune``,
``FusedCascadeBackend.autotune_plan``) held against the JAX package's.

No test times anything: the port's ``measure_tuning`` takes a ``clock``
and its ``autotune_plan`` times nothing on the CPU, and the reference's
``time.perf_counter`` is patched in the test to a fixed clock.  Networks
are random tables and mappings drawn by numpy and handed to both
packages; codes must be exactly equal, and measured plans cross between
the packages both ways.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from repro import backends as jbackends
from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.kernels import autotune as jautotune
from repro_torch import backends as tbackends
from repro_torch import pipeline as tpipeline
from repro_torch.kernels import autotune
from repro_torch.kernels.lut_cascade import SMEM_PER_BLOCK

TASKS = sorted(jtasks.TASKS)


def _layers(cfg):
    layers, off = [], 0
    for l, spec in enumerate(cfg.layers):
        layers.append((cfg.prev_width(l), spec.units,
                       2 ** (cfg.in_bits(l) * spec.fan_in), off, spec.fan_in,
                       cfg.in_bits(l), int(spec.assemble)))
        off += spec.units
    return layers


def arrays(task):
    """Random tables (codes below 2^bits), mappings and log-scales."""
    cfg = jtasks.reduced(task)
    rs = np.random.RandomState(7)
    tables, maps = [], []
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        tables.append(rs.randint(0, 2 ** spec.bits,
                                 size=(spec.units, entries)).astype(np.int32))
        maps.append(None if spec.assemble else rs.randint(
            0, cfg.prev_width(l), size=(spec.units, spec.fan_in)
        ).astype(np.int32))
    return cfg, (tables, maps, float(rs.uniform(-2, 0)),
                 float(rs.uniform(-3, 0)))


@functools.lru_cache(maxsize=None)
def nets(task):
    """(JAX network, port network on the CPU) over the same arrays."""
    cfg, arr = arrays(task)
    return (jpipeline.CompiledLUTNetwork(cfg, *arr),
            tpipeline.CompiledLUTNetwork.from_numpy(
                jpipeline.config_to_dict(cfg), *arr, device="cpu"))


def _fixed_clock():
    return 1.0


def _reference_autotune(monkeypatch, plan, **kw):
    """The reference's ``autotune_plan`` under the fixed clock."""
    with monkeypatch.context() as m:
        m.setattr(jautotune.time, "perf_counter", _fixed_clock)
        return jbackends.get("fused").autotune_plan(plan, **kw)


def _codes(cfg, plan, n, seed):
    return np.random.RandomState(seed).randint(
        0, plan.meta["input_span"], (n, cfg.in_features)).astype(np.int32)


def _take(tnet, codes):
    be = tbackends.get("take")
    return be.run(tnet.compile_backend("take").plan,
                  torch.from_numpy(codes)).numpy()


@pytest.mark.parametrize("device", ["cpu", "tpu"])
def test_measurement_grid_equals_reference(device, monkeypatch):
    """Every paper task and table width: the same candidates, in order."""
    monkeypatch.setattr(jautotune, "device_kind", lambda name=None: device)
    for task, itemsize in itertools.product(TASKS, (1, 2, 4)):
        layers = _layers(jtasks.task_config(task))
        want = jautotune.measurement_grid(layers, table_itemsize=itemsize,
                                          table_dtype="int8")
        got = autotune.measurement_grid(layers, table_itemsize=itemsize,
                                        table_dtype="int8", device=device)
        assert [t.to_meta() for t in got] == [t.to_meta() for t in want], \
            (task, itemsize)


def test_choice_table_equals_reference_and_gpu_is_the_h100_row():
    assert (autotune.choice_table(devices=("cpu", "tpu"))
            == jautotune.choice_table(devices=("cpu", "tpu")))
    for dev in ("cpu", "tpu"):
        assert autotune.DEVICE_MODELS[dev] == jautotune.DEVICE_MODELS[dev]
    assert autotune.DEVICE_MODELS["gpu"] == {
        "peak_flops": 67e12, "hbm_bw": 3.35e12, "vmem_bytes": SMEM_PER_BLOCK}
    doc = autotune.choice_table(devices=("gpu",))
    assert {c["task"] for c in doc["choices"]} == set(TASKS)
    for c in doc["choices"]:
        layers = _layers(jtasks.task_config(c["task"]))
        assert c["device"] == "gpu"
        assert c["tuning"]["mode"] == autotune.hopper_mode(
            layers, c["table_itemsize"])


# per-(rep, candidate) durations in seconds: distinct, tied, one rep
CLOCK_CASES = {
    "distinct": ([[0.3, 0.1, 0.2], [0.25, 0.15, 0.05], [0.4, 0.2, 0.1]], 3),
    "ties": ([[0.2, 0.1, 0.1], [0.1, 0.3, 0.2]], 2),
    "one_rep": ([[0.3, 0.3, 0.2]], 1),
}


@pytest.mark.parametrize("case", list(CLOCK_CASES))
def test_measure_tuning_equals_reference_under_one_clock(case, monkeypatch):
    """The same winner and report for the same clock readings; the warm-up
    call of each runner reads no clock."""
    durations, reps = CLOCK_CASES[case]
    ticks = []
    for r, row in enumerate(durations):
        for c, d in enumerate(row):
            start = 10.0 * (r * len(row) + c)
            ticks += [start, start + d]
    candidates = [autotune.KernelTuning(mode="resident", block_b=64),
                  autotune.KernelTuning(mode="streamed", unit_tile=16),
                  autotune.KernelTuning(mode="streamed", block_b=1024)]
    calls = []

    def factory(t):
        return lambda: calls.append(t)

    got = autotune.measure_tuning(factory, candidates, reps=reps,
                                  clock=iter(ticks).__next__)
    jcands = [jautotune.KernelTuning(**t.to_meta()) for t in candidates]
    monkeypatch.setattr(jautotune.time, "perf_counter", iter(ticks).__next__)
    want = jautotune.measure_tuning(factory, jcands, reps=reps)
    monkeypatch.undo()
    assert got[0].to_meta() == want[0].to_meta()
    assert got[0].source == "measured"
    assert got[1] == want[1]
    assert len(calls) == 2 * len(candidates) * (reps + 1)
    with pytest.raises(ValueError, match="empty"):
        autotune.measure_tuning(factory, [])


@pytest.mark.parametrize("task", ["nid", "jsc"])
def test_autotune_plan_on_cpu_equals_reference(task, monkeypatch):
    """The reference's grid winner under one clock, a report row a
    candidate, the input plan untouched, and codes equal to ``take``."""
    jnet, tnet = nets(task)
    jplan = jnet.compile_backend("fused").plan
    tplan = tnet.compile_backend("fused").plan
    want = _reference_autotune(monkeypatch, jplan, rows=64, reps=1)
    got = tbackends.get("fused").autotune_plan(tplan, rows=64, reps=1,
                                               device="cpu")
    assert got.meta == want.meta
    assert got.meta["tuning"] == dict(
        want.meta["tuning_report"][0]["tuning"], source="measured")
    assert jautotune.KernelTuning.from_meta(
        got.meta["tuning"]).source == "measured"
    assert tplan.meta["tuning"]["source"] == "default"
    assert "tuning_report" not in tplan.meta
    codes = _codes(tnet.cfg, tplan, 129, seed=3)
    np.testing.assert_array_equal(
        tbackends.get("fused").run(got, torch.from_numpy(codes)).numpy(),
        _take(tnet, codes))


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_measured_plan_crosses_packages(direction, monkeypatch, tmp_path):
    jnet, tnet = nets("nid")
    cfg, arr = arrays("nid")
    if direction == "port_to_jax":
        src = tpipeline.CompiledLUTNetwork.from_numpy(
            jpipeline.config_to_dict(cfg), *arr, device="cpu")
        tuned = tbackends.get("fused").autotune_plan(
            src.compile_backend("fused").plan, rows=64, reps=1,
            device="cpu")
        src._plans["fused"] = tuned
        loaded = jpipeline.CompiledLUTNetwork.load(
            src.save(str(tmp_path / "port.npz")))
        plan = loaded.compile_backend("fused").plan
        x = np.random.RandomState(5).uniform(
            -1, 1, (65, cfg.in_features)).astype(np.float32)
        got = np.asarray(loaded.predict_codes(x, backend="fused"))
        want = tnet.predict_codes(x, backend="take").numpy()
    else:
        src = jpipeline.CompiledLUTNetwork(cfg, *arr)
        tuned = _reference_autotune(monkeypatch,
                                    src.compile_backend("fused").plan,
                                    rows=64, reps=1)
        src._plans["fused"] = tuned
        loaded = tpipeline.CompiledLUTNetwork.load(
            src.save(str(tmp_path / "jax.npz")), device="cpu")
        plan = loaded.compile_backend("fused").plan
        x = np.random.RandomState(5).uniform(
            -1, 1, (65, cfg.in_features)).astype(np.float32)
        got = loaded.predict_codes(x, backend="fused").numpy()
        want = np.asarray(jnet.predict_codes(x, backend="take"))
    assert plan.meta["tuning"] == tuned.meta["tuning"]
    assert plan.meta["tuning"]["source"] == "measured"
    assert plan.meta["tuning_report"] == tuned.meta["tuning_report"]
    np.testing.assert_array_equal(got, want)


# v2 layer tuples whose K2 plan is the ring route at 4-byte tables
RING_LAYERS = {"ring_3": (64, 512), "ring_2": (64, 2048)}


@pytest.mark.parametrize("case", ["nid", "mnist", "ring_3", "ring_2"])
def test_card_grid_is_one_candidate_a_launch(case):
    """On the card ``block_b`` is not read, and ``unit_tile`` only where it
    changes K2's cluster plan: the grid keeps the first candidate of each
    distinct launch, and all 20 roofline candidates map onto those."""
    if case in RING_LAYERS:
        w0, units = RING_LAYERS[case]
        layers = [(w0, units, 1024, 0, 6, 2, 0),
                  (units, 10, 1024, units, 6, 2, 0)]
        itemsize = 4
    else:
        layers = _layers(jtasks.task_config(case))
        itemsize = 1
    grid = autotune.measurement_grid(layers, table_itemsize=itemsize,
                                     device="gpu")
    launches = [autotune.hopper_launch(t, layers, itemsize) for t in grid]
    routes = [k[0] if k[0] == "resident" else
              ("ring" if k[3] else "cluster") for k in launches]
    assert routes == {"nid": ["resident", "cluster"], "mnist": ["cluster"],
                      "ring_3": ["ring"] * 3, "ring_2": ["ring"] * 2}[case]
    assert len(set(launches)) == len(launches)
    every = [autotune.KernelTuning(mode=r["mode"], block_b=r["block_b"],
                                   unit_tile=r["unit_tile"] or 8)
             for r in autotune.roofline_candidates(
                 layers, table_itemsize=itemsize, device="gpu")]
    assert len(every) == 20
    assert {autotune.hopper_launch(t, layers, itemsize)
            for t in every} == set(launches)
