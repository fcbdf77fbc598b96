"""Placements of the port (``backends/placement.py``, ``launch/mesh.py``) on
4 CPU slots, held against the unplaced run and the JAX package.

Batch and units placements over 4 slots give the unplaced codes on
``take``, ``onehot`` and ``pallas`` (K3's plain twin on the CPU), ragged
blocks included, as ``tests/test_sharded_backends.py`` holds the
reference on 4 forced host devices; the 4-slot codes equal the JAX
package's unplaced codes exactly.  Networks are drawn by the port's
``assemble.init``, carried to the reference's layout
(``params_to_reference``), folded by the JAX package and handed to the
port's constructor, so both packages serve the same tables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import traffic
from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro_torch import backends as tbackends
from repro_torch import pipeline as tpipeline
from repro_torch.core import assemble as tassemble
from repro_torch.launch.mesh import (DeviceMesh, DeviceSlot,
                                     make_serving_mesh, mesh_devices)
from repro_torch.serve.lut_engine import LUTEngine
from repro_torch.stream import cell as tcell

# below, off and above the 4-slot shard count (as test_sharded_backends.py)
SHARD_BATCHES = tuple(b for b in traffic.ADVERSARIAL_BATCHES if b % 4)
LAYERED = ("take", "onehot", "pallas")


def shared_net(task, seed, cfg=None):
    """(JAX artifact, port artifact on the CPU) folded from one parameter
    tree (the reference's ``reduced(task)`` config unless ``cfg``)."""
    cfg = jtasks.reduced(task) if cfg is None else cfg
    tree = tassemble.params_to_reference(tassemble.init(
        seed, tpipeline.config_from_dict(jpipeline.config_to_dict(cfg)),
        device="cpu"))
    jnet = jpipeline.compile_network(jax.tree.map(jnp.asarray, tree), cfg)
    tnet = tpipeline.CompiledLUTNetwork.from_numpy(
        jpipeline.config_to_dict(cfg), jnet.tables, jnet.mappings,
        jnet.in_log_scale, jnet.out_log_scale, device="cpu")
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return {task: shared_net(task, i)
            for i, task in enumerate(("nid", "mnist"))}


@pytest.fixture(scope="module")
def mesh4():
    return make_serving_mesh(slots=4, device="cpu")


def _x(cfg, b, seed):
    return np.random.default_rng(seed).uniform(
        -1.0, 1.0, (b, cfg.in_features)).astype(np.float32)


@pytest.mark.parametrize("strategy", ["batch", "units"])
@pytest.mark.parametrize("task", ["nid", "mnist"])
def test_placements_4_slots_equal_unplaced_and_jax(task, strategy, nets,
                                                   mesh4):
    """Every layered backend (and ``fused`` under ``batch``) over 4 slots
    at ragged batches: codes == the port's unplaced ``take`` == the JAX
    package's unplaced codes."""
    jnet, tnet = nets[task]
    pl = tbackends.Placement(mesh4, strategy=strategy)
    names = LAYERED + (("fused",) if strategy == "batch" else ())
    for b in SHARD_BATCHES:
        x = _x(tnet.cfg, b, seed=b)
        want = np.asarray(jnet.predict_codes(x, backend="take"))
        ref = tnet.predict_codes(x, backend="take").numpy()
        np.testing.assert_array_equal(ref, want, err_msg=f"{task} b={b}")
        for be in names:
            got = tnet.compile_backend(be, placement=pl).predict_codes(x)
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"{task}/{be}/{b}")


def test_units_runner_pads_unit_slices(nets):
    """3 slots over layers whose units 3 does not divide: each slot holds
    ceil(units / 3) rows of every table and mapping (padded with zero rows
    and mappings to input 0), and the gathered codes still equal take."""
    _, tnet = nets["mnist"]
    mesh = make_serving_mesh(slots=3, device="cpu")
    units = [s.units for s in tnet.cfg.layers]
    assert any(u % 3 for u in units)
    plan = tnet.compile_backend("take").plan
    bufs = tbackends.placement.unit_shard_buffers(
        plan.meta["layers"], lambda l: plan.buffers[f"table_{l}"],
        lambda l: plan.buffers.get(f"mapping_{l}"), 3)
    for l, u in enumerate(units):
        assert bufs[2 * l].shape[0] == bufs[2 * l + 1].shape[0] == \
            -(-u // 3) * 3
        assert not bufs[2 * l][u:].any() and not bufs[2 * l + 1][u:].any()
    x = _x(tnet.cfg, 5, seed=9)
    want = tnet.predict_codes(x, backend="take").numpy()
    for be in LAYERED:
        pl = tbackends.Placement(mesh, strategy="units")
        np.testing.assert_array_equal(
            tnet.compile_backend(be, placement=pl).predict_codes(x).numpy(),
            want, err_msg=be)


def test_executor_cache_is_keyed_by_placement_and_fused_refuses_units(
        nets, mesh4):
    _, tnet = nets["nid"]
    assert (tnet.compile_backend("fused", mesh=mesh4)
            is tnet.compile_backend("fused", mesh=mesh4))
    assert (tnet.compile_backend("fused")
            is not tnet.compile_backend("fused", mesh=mesh4))
    # an equal mesh rebuilt from scratch hits the same executor; another
    # slot layout does not
    again = make_serving_mesh(slots=4, device="cpu")
    assert (tnet.compile_backend("take", mesh=again)
            is tnet.compile_backend("take", mesh=mesh4))
    assert (tnet.compile_backend("take", mesh=make_serving_mesh(
        slots=2, device="cpu"))
            is not tnet.compile_backend("take", mesh=mesh4))
    # planning does not depend on the placement
    assert (tnet.compile_backend("fused", mesh=mesh4).plan
            is tnet.compile_backend("fused").plan)
    with pytest.raises(ValueError, match="not both"):
        tnet.compile_backend("take", mesh=mesh4,
                             placement=tbackends.Placement(mesh4))
    with pytest.raises(ValueError, match="unit sharding"):
        tnet.compile_backend(
            "fused", placement=tbackends.Placement(mesh4, strategy="units"))
    with pytest.raises(ValueError, match="unknown placement strategy"):
        tbackends.Placement(mesh4, strategy="diagonal")


def test_capabilities_flags_match_reference():
    from repro import backends as jbackends
    for name in ("take", "onehot", "pallas", "fused"):
        tcap = tbackends.get(name).capabilities()
        jcap = jbackends.get(name).capabilities()
        assert tcap.unit_shardable == jcap.unit_shardable, name
        assert (tbackends.get(name).supports_unit_sharding
                == jbackends.get(name).supports_unit_sharding), name


def test_serving_mesh_slots_and_validation():
    mesh = make_serving_mesh(slots=4, device="cpu")
    assert mesh_devices(mesh) == 4 and mesh.shape == {"data": 4}
    assert [s.id for s in mesh.devices.flat] == [0, 1, 2, 3]
    assert all(s.device == torch.device("cpu") for s in mesh.slots)
    assert make_serving_mesh(device="cpu").size == 1
    with pytest.raises(ValueError, match="asked for 2 devices"):
        make_serving_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="slots must be"):
        make_serving_mesh(slots=0, device="cpu")
    with pytest.raises(ValueError, match="unique"):
        DeviceMesh((DeviceSlot(0, torch.device("cpu")),) * 2)
    with pytest.raises(ValueError, match="one axis"):
        DeviceMesh(mesh.slots, ("pod", "data"))
    # a survivor mesh keeps its slots' ids (the fleet's remesh)
    sub = DeviceMesh(tuple(s for s in mesh.slots if s.id != 2))
    assert [s.id for s in sub.slots] == [0, 1, 3] and sub.shape == {"data": 3}


def test_named_axis_and_placement_over_it(nets):
    """A mesh axis of another name: a placement splits over all its slots
    on both strategies, and the executor is keyed by the slots, not the
    axis name."""
    _, tnet = nets["nid"]
    slots = make_serving_mesh(slots=3, device="cpu").slots
    mesh = DeviceMesh(slots, ("replica",))
    x = _x(tnet.cfg, 33, seed=3)
    want = tnet.predict_codes(x, backend="take").numpy()
    for backend, strategy in (("fused", "batch"), ("take", "units")):
        pl = tbackends.Placement(mesh, strategy=strategy)
        assert pl.cache_key() == tbackends.Placement(
            DeviceMesh(slots), strategy=strategy).cache_key()
        np.testing.assert_array_equal(
            tnet.compile_backend(backend, placement=pl).predict_codes(
                x).numpy(), want)


def test_cuda_slots_fail_loudly_without_a_card(nets):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_serving_mesh(slots=2)
    _, tnet = nets["nid"]
    mesh = DeviceMesh((DeviceSlot(0, torch.device("cuda", 0)),
                       DeviceSlot(1, torch.device("cuda", 0))))
    with pytest.raises((RuntimeError, AssertionError)):
        tnet.compile_backend("take", placement=tbackends.Placement(
            mesh, strategy="units"))
    with pytest.raises((RuntimeError, AssertionError)):
        tnet.compile_backend("take", mesh=mesh).predict_codes(
            _x(tnet.cfg, 4, seed=1))


@pytest.mark.parametrize("strategy", ["batch", "units"])
def test_engine_and_stream_cell_under_placement(strategy, nets, mesh4):
    """The engine over a placed executor and a stream cell's step under a
    placement give the unplaced results."""
    _, tnet = nets["nid"]
    pl = tbackends.Placement(mesh4, strategy=strategy)
    x = _x(tnet.cfg, 37, seed=5)
    eng = LUTEngine(tnet, block=16, depth=2, backend="pallas", placement=pl)
    np.testing.assert_array_equal(
        eng.run(x), tnet.predict(x, backend="take").numpy())
    _, net = shared_net("jsc", 7)
    n_state = 2
    comp = tcell.CompiledStreamCell(net, net.cfg.in_features - n_state,
                                    n_state)
    xs = np.random.default_rng(2).uniform(
        -1.0, 1.0, (9, 5, comp.cell.n_in)).astype(np.float32)
    want = comp.predict_sequence(xs, backend="take")
    got = comp.predict_sequence(xs, backend="pallas", placement=pl)
    for w, g in zip(want, got):
        assert torch.equal(w, g)
