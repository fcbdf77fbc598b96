"""Every port backend held against the JAX ``take`` backend, the port's
fused plan against the reference's plan, and the plain cascade (the CPU
stand-in of kernels K1/K2) against the reference's Pallas kernels run in
interpret mode.

Networks are random tables and mappings drawn by numpy and handed to both
packages' constructors; integer codes must be exactly equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import traffic
from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.core import assemble as jassemble
from repro.kernels import autotune as jautotune
from repro.kernels.lut_cascade import lut_cascade_pallas
from repro_torch import backends as tbackends
from repro_torch import pipeline as tpipeline
from repro_torch.backends.base import (BackendCapabilities, ExecutionPlan,
                                       LookupBackend)
from repro_torch.configs import paper_tasks as ttasks
from repro_torch.kernels import (autotune, build, lut_cascade, lut_gather,
                                 ops)

TASKS = tuple(jtasks.TASKS)


def random_arrays(cfg, seed):
    """Tables with codes below 2^bits, random mappings, log-scales."""
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


@functools.lru_cache(maxsize=None)
def nets(task):
    """(JAX network, port network on the CPU) over the same arrays."""
    cfg = jtasks.task_config(task)
    arrays = random_arrays(cfg, seed=sorted(TASKS).index(task))
    jnet = jpipeline.CompiledLUTNetwork(cfg, *arrays)
    tnet = tpipeline.CompiledLUTNetwork.from_numpy(
        jpipeline.config_to_dict(cfg), *arrays, device="cpu")
    return jnet, tnet


def _x(cfg, n, seed):
    return np.random.RandomState(seed).uniform(
        -1.0, 1.0, (n, cfg.in_features)).astype(np.float32)


@pytest.mark.parametrize("batch", traffic.ADVERSARIAL_BATCHES)
@pytest.mark.parametrize("task", TASKS)
def test_port_backends_match_jax_take(task, batch):
    """take / onehot / pallas (plain) / fused (plain) == JAX take, codes and
    logits exactly, on every paper config and adversarial batch."""
    jnet, tnet = nets(task)
    x = _x(jnet.cfg, batch, seed=batch)
    want = np.asarray(jnet.predict_codes(x, backend="take"))
    want_logits = np.asarray(jnet.predict(x, backend="take"))
    assert tbackends.available()[:4] == ("take", "onehot", "pallas", "fused")
    for be in ("take", "onehot", "pallas", "fused"):
        codes, logits = tnet.codes_and_logits(x, backend=be)
        np.testing.assert_array_equal(codes.numpy(), want, err_msg=be)
        np.testing.assert_array_equal(logits.numpy(), want_logits,
                                      err_msg=be)


@pytest.mark.parametrize("task", TASKS)
def test_fused_plan_byte_identical_to_reference(task):
    jnet, tnet = nets(task)
    jplan = jnet.compile_backend("fused").plan
    tplan = tnet.compile_backend("fused").plan
    assert set(tplan.buffers) == set(jplan.buffers)
    for k, buf in jplan.buffers.items():
        assert tplan.buffers[k].dtype == buf.dtype, k
        assert tplan.buffers[k].shape == buf.shape, k
        assert tplan.buffers[k].tobytes() == buf.tobytes(), k
    assert tplan.meta == jplan.meta


@functools.lru_cache(maxsize=None)
def folded_by_reference():
    """nid_reduced folded by the reference's own compile_network."""
    cfg = jtasks.reduced("nid")
    params = jassemble.init(jax.random.PRNGKey(3), cfg)
    return jpipeline.compile_network(params, cfg)


def test_reference_folded_network_runs_on_every_port_backend():
    """A reduced config folded by the reference's own compile_network."""
    jnet = folded_by_reference()
    cfg = jnet.cfg
    tnet = tpipeline.CompiledLUTNetwork.from_numpy(
        jpipeline.config_to_dict(cfg), jnet.tables, jnet.mappings,
        jnet.in_log_scale, jnet.out_log_scale, device="cpu")
    x = _x(cfg, 65, seed=4)
    want = np.asarray(jnet.predict_codes(x, backend="take"))
    for be in tbackends.available():
        np.testing.assert_array_equal(
            tnet.predict_codes(x, backend=be).numpy(), want, err_msg=be)


def _reduced_fused(seed=0):
    jnet = folded_by_reference()
    cfg = jnet.cfg
    plan = jnet.compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in lm) for lm in plan.meta["layers"])
    codes = np.random.RandomState(seed + 1).randint(
        0, plan.meta["input_span"], size=(33, cfg.in_features)).astype(np.int32)
    maps = [torch.from_numpy(plan.buffers[f"map_{l}"])
            if f"map_{l}" in plan.buffers else None
            for l in range(len(layers))]
    return plan, layers, codes, maps


@pytest.mark.parametrize("mode,unit_tile", [
    ("resident", 8), ("streamed", 4), ("streamed", 8), ("streamed", 16),
])
def test_plain_cascade_matches_reference_pallas_kernels(mode, unit_tile):
    """The plain version of K1/K2 == the reference's resident and streamed
    Pallas kernels (interpret mode) on nid_reduced, ragged batch 33."""
    plan, layers, codes, maps = _reduced_fused()
    want = np.asarray(lut_cascade_pallas(
        jnp.asarray(codes), jnp.asarray(plan.buffers["amat"]),
        jnp.asarray(plan.buffers["tables"]), layers=layers, block_b=16,
        mode=mode, unit_tile=unit_tile, interpret=True))
    got = lut_cascade.lut_cascade_plain(
        torch.from_numpy(codes), torch.from_numpy(plan.buffers["tables"]),
        maps, layers)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["xla", "pallas", None])
def test_cascade_dispatch_on_cpu_runs_the_plain_version(impl):
    plan, layers, codes, maps = _reduced_fused(seed=5)
    tables = torch.from_numpy(plan.buffers["tables"])
    want = lut_cascade.lut_cascade_plain(torch.from_numpy(codes), tables,
                                         maps, layers)
    build.reset_counters()
    got = ops.lut_cascade(torch.from_numpy(codes), None, tables,
                          layers=layers, mappings=maps,
                          tuning=autotune.KernelTuning(impl=impl))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert not any(build.launch_counts().values())


def test_cascade_dispatch_rejects_bad_requests():
    plan, layers, codes, maps = _reduced_fused(seed=6)
    tables = torch.from_numpy(plan.buffers["tables"])
    c = torch.from_numpy(codes)
    with pytest.raises(ValueError, match="v2"):
        ops.lut_cascade(c, None, tables, layers=tuple(l[:4] for l in layers),
                        mappings=None, tuning={"impl": "xla"})
    with pytest.raises(ValueError, match="impl"):
        ops.lut_cascade(c, None, tables, layers=layers, mappings=maps,
                        tuning={"impl": "triton"})
    with pytest.raises(ValueError, match="unknown lut_lookup impl"):
        ops.lut_lookup(tables, c, impl="nope")


def test_kernel_wrappers_raise_on_cpu_tensors():
    """No fallback: a kernel wrapper given CPU tensors raises instead of
    running the plain version."""
    table = torch.zeros((4, 8), dtype=torch.int32)
    addr = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        lut_gather.lut_lookup_cuda(table, addr)
    plan, layers, codes, maps = _reduced_fused(seed=7)
    operands = lut_cascade.prepare(torch.from_numpy(plan.buffers["tables"]),
                                   layers, maps)
    for launch in (lut_cascade.lut_cascade_resident,
                   lut_cascade.lut_cascade_streamed):
        with pytest.raises(ValueError, match="CUDA"):
            launch(torch.from_numpy(codes), operands)


def test_lookup_plain_versions_agree():
    rs = np.random.RandomState(8)
    table = torch.from_numpy(rs.randint(0, 50, (6, 16)).astype(np.int32))
    addr = torch.from_numpy(rs.randint(0, 16, (9, 6)).astype(np.int32))
    want = table[torch.arange(6), addr.long()]
    for impl in ("take", "onehot", "pallas"):
        np.testing.assert_array_equal(
            ops.lut_lookup(table, addr, impl=impl).numpy(), want.numpy())


@pytest.mark.parametrize("task", TASKS)
def test_autotune_matches_reference_on_cpu(task):
    cfg = jtasks.task_config(task)
    layers, off = [], 0
    for l, spec in enumerate(cfg.layers):
        layers.append((cfg.prev_width(l), spec.units,
                       2 ** (cfg.in_bits(l) * spec.fan_in), off, spec.fan_in,
                       cfg.in_bits(l), int(spec.assemble)))
        off += spec.units
    for itemsize in (1, 2, 4):
        assert (autotune.roofline_candidates(layers, table_itemsize=itemsize,
                                             device="cpu")
                == jautotune.roofline_candidates(
                    layers, table_itemsize=itemsize, device="cpu"))
        assert (autotune.default_tuning(layers, table_itemsize=itemsize,
                                        device="cpu").to_meta()
                == jautotune.default_tuning(
                    layers, table_itemsize=itemsize).to_meta())
        assert (autotune.resident_bytes(layers, itemsize)
                == jautotune.resident_bytes(layers, itemsize))


@pytest.mark.parametrize("task,mode,table_bytes", [
    ("mnist", "streamed", 327_040), ("jsc_cernbox", "streamed", 325_120),
    ("jsc_openml", "resident", 81_280), ("nid", "resident", 5_952),
])
def test_hopper_mode_by_shared_memory_fit(task, mode, table_bytes):
    _, tnet = nets(task)
    plan = tnet.compile_backend("fused").plan
    assert plan.buffers["tables"].nbytes == table_bytes
    itemsize = plan.buffers["tables"].dtype.itemsize
    assert autotune.hopper_mode(plan.meta["layers"], itemsize) == mode
    tuned = autotune.default_tuning(plan.meta["layers"],
                                    table_itemsize=itemsize, device="cuda")
    assert tuned.mode == mode and tuned.impl is None


def test_kernel_tuning_meta_round_trip_drops_unknown_keys():
    t = autotune.KernelTuning(impl="pallas", mode="streamed", unit_tile=16)
    assert autotune.KernelTuning.from_meta(t.to_meta()) == t
    assert autotune.KernelTuning.from_meta(
        dict(t.to_meta(), num_warps=8)) == t
    assert autotune.KernelTuning.from_meta(None) == autotune.KernelTuning()


def test_port_task_configs_equal_reference():
    assert ttasks.task_names() == jtasks.task_names()
    for task in TASKS:
        assert (tpipeline.config_to_dict(ttasks.task_config(task))
                == jpipeline.config_to_dict(jtasks.task_config(task)))
    with pytest.raises(ValueError, match="unknown task"):
        ttasks.task_config("nope")


def test_registry_register_and_env_resolution(monkeypatch):
    class EchoBackend(LookupBackend):
        name = "echo"

        def capabilities(self):
            return BackendCapabilities(name="echo", fused=False,
                                       needs_pallas=False)

        def plan(self, net):
            return ExecutionPlan(backend="echo", meta={}, buffers={})

        def run(self, plan, codes):
            return codes

    tbackends.register("echo", EchoBackend)
    try:
        assert isinstance(tbackends.get("echo"), EchoBackend)
        monkeypatch.setenv("REPRO_LUT_BACKEND", "echo")
        assert tbackends.resolve().name == "echo"
        assert tbackends.resolve("take").name == "take"
    finally:
        tbackends.unregister("echo")
    with pytest.raises(ValueError, match="unknown lookup backend"):
        tbackends.get("echo")
