"""The artifact: cross-loading between the JAX package and the port, plan
persistence and migration, config (de)serialization and folded inference.
"""
import json

import numpy as np
import pytest
import torch

from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.core import folding as jfolding
from repro_torch import backends as tbackends
from repro_torch import pipeline as tpipeline
from repro_torch.core import folding as tfolding

BACKENDS = ("take", "onehot", "pallas", "fused")


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


def _x(cfg, n, seed):
    return np.random.RandomState(seed).uniform(
        -1.0, 1.0, (n, cfg.in_features)).astype(np.float32)


@pytest.mark.parametrize("task", ["nid_reduced", "jsc_reduced",
                                  "mnist_reduced"])
def test_jax_artifact_loads_in_port(tmp_path, task):
    """A JAX-saved artifact with a persisted fused plan: the port restores
    the plan as saved, runs it, and predicts identical codes and logits on
    every backend."""
    cfg = jtasks.task_config(task)
    jnet = jpipeline.CompiledLUTNetwork(cfg, *_arrays(cfg, 1))
    jnet.compile_backend("fused")
    path = jnet.save(str(tmp_path / "jax.npz"))
    net = tpipeline.CompiledLUTNetwork.load(path, device="cpu")
    assert set(net._plans) == {"fused"}
    restored = net._plans["fused"]
    x = _x(cfg, 41, seed=2)
    want = np.asarray(jnet.predict_codes(x, backend="take"))
    want_logits = np.asarray(jnet.predict(x, backend="take"))
    for be in BACKENDS:
        codes, logits = net.codes_and_logits(x, backend=be)
        np.testing.assert_array_equal(codes.numpy(), want, err_msg=be)
        np.testing.assert_array_equal(logits.numpy(), want_logits)
    assert net.compile_backend("fused").plan is restored


@pytest.mark.parametrize("task", ["nid_reduced", "jsc_reduced",
                                  "mnist_reduced"])
def test_port_artifact_loads_in_jax(tmp_path, task):
    """A port-saved artifact with a port-written fused plan loads in the
    reference and predicts identical codes, with the plan reused."""
    cfg = jtasks.task_config(task)
    arrays = _arrays(cfg, 3)
    net = tpipeline.CompiledLUTNetwork.from_numpy(
        jpipeline.config_to_dict(cfg), *arrays, device="cpu")
    net.compile_backend("fused")
    net.extra_meta = {"note": "port"}
    path = net.save(str(tmp_path / "port"))
    jnet = jpipeline.CompiledLUTNetwork.load(path)
    assert jnet.extra_meta == {"note": "port"}
    jplan = jnet._plans["fused"]
    x = _x(cfg, 33, seed=4)
    want = net.predict_codes(x, backend="take").numpy()
    for be in ("take", "fused"):
        np.testing.assert_array_equal(
            np.asarray(jnet.predict_codes(x, backend=be)), want, err_msg=be)
    assert jnet.compile_backend("fused").plan is jplan


def test_port_round_trip_keeps_plans_and_backend(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_LUT_BACKEND", raising=False)
    cfg = jtasks.reduced("jsc")
    net = tpipeline.CompiledLUTNetwork(cfg, *_arrays(cfg, 5), backend="fused",
                                       device="cpu")
    net.compile_backend("fused")
    net.compile_backend("take")
    path = net.save(str(tmp_path / "a.npz"))
    loaded = tpipeline.CompiledLUTNetwork.load(path, device="cpu")
    assert loaded.backend == "fused"
    assert set(loaded._plans) == {"fused"}   # layered plans are not persisted
    for k, buf in net._plans["fused"].buffers.items():
        assert loaded._plans["fused"].buffers[k].tobytes() == buf.tobytes()
    x = _x(cfg, 9, seed=6)
    np.testing.assert_array_equal(loaded.predict_codes(x).numpy(),
                                  net.predict_codes(x, backend="take").numpy())
    assert loaded.num_entries() == net.num_entries()


def test_v1_fused_plan_migrates_with_buffers_reused(tmp_path):
    cfg = jtasks.reduced("nid")
    net = tpipeline.CompiledLUTNetwork(cfg, *_arrays(cfg, 7), device="cpu")
    v2 = net.compile_backend("fused").plan
    v1 = tbackends.ExecutionPlan(
        backend="fused",
        meta={"plan_format": "fused-packed-v1",
              "layers": [lm[:4] for lm in v2.meta["layers"]],
              "table_dtype": v2.meta["table_dtype"]},
        buffers={"amat": v2.buffers["amat"], "tables": v2.buffers["tables"]})
    fresh = tpipeline.CompiledLUTNetwork(cfg, *_arrays(cfg, 7), device="cpu")
    fresh._plans["fused"] = v1
    plan = fresh.compile_backend("fused").plan
    assert plan.meta["plan_format"] == "fused-packed-v2"
    assert plan.buffers["tables"] is v1.buffers["tables"]
    assert plan.meta["tuning"]["source"] == "default"
    x = _x(cfg, 17, seed=8)
    np.testing.assert_array_equal(fresh.predict_codes(x, backend="fused").numpy(),
                                  net.predict_codes(x, backend="take").numpy())
    # an unrecognizable plan is re-planned instead of run
    other = tpipeline.CompiledLUTNetwork(cfg, *_arrays(cfg, 7), device="cpu")
    other._plans["fused"] = tbackends.ExecutionPlan(
        backend="fused", meta={"plan_format": "alien"}, buffers={})
    assert (other.compile_backend("fused").plan.meta["plan_format"]
            == "fused-packed-v2")


def test_newer_artifact_format_is_refused(tmp_path):
    cfg = jtasks.reduced("jsc")
    net = tpipeline.CompiledLUTNetwork(cfg, *_arrays(cfg, 9), device="cpu")
    path = net.save(str(tmp_path / "n.npz"))
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    meta = json.loads(bytes(arrays["meta_json"]).decode())
    meta["format_version"] = tpipeline.ARTIFACT_VERSION + 1
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="newer"):
        tpipeline.CompiledLUTNetwork.load(path, device="cpu")


@pytest.mark.parametrize("task", tuple(jtasks.TASKS))
def test_config_dicts_round_trip_between_packages(task):
    cfg = jtasks.task_config(task)
    d = json.loads(json.dumps(jpipeline.config_to_dict(cfg)))
    tcfg = tpipeline.config_from_dict(d)
    assert tpipeline.config_to_dict(tcfg) == jpipeline.config_to_dict(cfg)
    assert jpipeline.config_from_dict(tpipeline.config_to_dict(tcfg)) == cfg
    for l in range(len(cfg.layers)):
        assert tcfg.quant_spec(l).bits == cfg.quant_spec(l).bits
        assert tcfg.quant_spec(l).signed == cfg.quant_spec(l).signed
        assert tcfg.in_bits(l) == cfg.in_bits(l)
        assert tcfg.prev_width(l) == cfg.prev_width(l)


def test_config_validation_matches_reference():
    from repro.core import assemble as jassemble
    from repro_torch.core import assemble as tassemble
    bad = [dict(units=5, fan_in=3, bits=2, assemble=True),
           dict(units=4, fan_in=40, bits=2, assemble=False),
           dict(units=4, fan_in=2, bits=2, assemble=False, add_terms=2)]
    for spec in bad:
        with pytest.raises(ValueError):
            jassemble.AssembleConfig(16, 2, (jassemble.LayerSpec(**spec),))
        with pytest.raises(ValueError):
            tassemble.AssembleConfig(16, 2, (tassemble.LayerSpec(**spec),))
    add = dict(units=4, fan_in=2, bits=2, assemble=False, add_terms=2,
               add_bits=3)
    jl = jassemble.lower_additive(jassemble.AssembleConfig(
        16, 2, (jassemble.LayerSpec(**add),)))
    tl = tassemble.lower_additive(tassemble.AssembleConfig(
        16, 2, (tassemble.LayerSpec(**add),)))
    assert tpipeline.config_to_dict(tl) == jpipeline.config_to_dict(jl)


def test_folded_apply_codes_matches_reference():
    cfg = jtasks.reduced("nid")
    tables, maps, ils, ols = _arrays(cfg, 10)
    import jax.numpy as jnp
    jnet = jfolding.FoldedNetwork(
        cfg=cfg, tables=[jnp.asarray(t) for t in tables],
        in_q={"log_scale": jnp.asarray(ils)},
        out_q={"log_scale": jnp.asarray(ols)},
        mappings=[None if m is None else jnp.asarray(m) for m in maps])
    tnet = tfolding.FoldedNetwork(
        cfg=tpipeline.config_from_dict(jpipeline.config_to_dict(cfg)),
        tables=[torch.from_numpy(t) for t in tables],
        in_q={"log_scale": ils}, out_q={"log_scale": ols},
        mappings=[None if m is None else torch.from_numpy(m) for m in maps])
    x = _x(cfg, 19, seed=11)
    want = np.asarray(jfolding.folded_apply_codes(jnet, x, lut_impl="take"))
    for be in BACKENDS:
        np.testing.assert_array_equal(
            tfolding.folded_apply_codes(tnet, x, lut_impl=be).numpy(), want)
    np.testing.assert_allclose(
        tfolding.folded_logits(tnet, x).numpy(),
        np.asarray(jfolding.folded_logits(jnet, x)), rtol=0, atol=0)
    assert tnet.num_entries() == jnet.num_entries()
    comp = tpipeline.CompiledLUTNetwork.from_folded(tnet)
    assert comp.device.type == "cpu"
    np.testing.assert_array_equal(comp.predict_codes(x).numpy(), want)


def test_executor_is_planned_once_and_outputs_agree():
    cfg = jtasks.reduced("nid")
    net = tpipeline.CompiledLUTNetwork(cfg, *_arrays(cfg, 12), device="cpu")
    ex = net.compile_backend("fused")
    assert ex is net.compile_backend("fused") and ex.capabilities.fused
    x = _x(cfg, 9, seed=13)
    codes, logits = ex.codes_and_logits(x)
    np.testing.assert_array_equal(codes.numpy(), ex.predict_codes(x).numpy())
    np.testing.assert_array_equal(logits.numpy(), ex(x).numpy())
    assert codes.dtype == torch.int32 and logits.dtype == torch.float32
