"""The port's serving benches (``benchmarks/torch_lut_backends.py``,
``torch_lut_throughput.py``, the hot swaps of ``torch_stream_serving.py``
and ``torch_run.py``'s CLI) against the reference's on the CPU.

Networks are the port's init carried to the reference's layout and folded
by JAX (``test_torch_placement.shared_net``), handed to the benches in
place of the ones they fold; rows come from the benches' own seeded
``numpy`` draws.  Every code comparison is
exact; no time is compared.
"""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from benchmarks import stream_serving as jstream
from benchmarks import torch_lut_backends as bk
from benchmarks import torch_lut_throughput as tp
from benchmarks import torch_run
from benchmarks import torch_stream_serving as tstream
from repro import backends as jbackends
from repro import pipeline as jpipeline
from repro.stream import cell as jcell
from repro_torch import pipeline as tpipeline
from repro_torch.core import assemble as tassemble
from repro_torch.stream import cell as tcell
from test_torch_placement import shared_net

ROOT = os.path.join(os.path.dirname(__file__), "..")
TASKS = ("mnist", "jsc", "nid")


@pytest.fixture(scope="module")
def nets():
    """(JAX, port) networks a task, folded once by JAX from the port's
    init carried to the reference's layout."""
    return {task: shared_net(task, i) for i, task in enumerate(TASKS)}


@pytest.fixture
def bench_nets(nets, monkeypatch):
    """The benches draw these networks in place of folding their own."""
    def make_network(task, seed, dev):
        return nets[task][1]
    monkeypatch.setattr(bk, "make_network", make_network)
    monkeypatch.setattr(tp, "make_network", make_network)
    return nets


@pytest.mark.parametrize("task", TASKS)
def test_backend_sweep_bit_identical_and_equal_to_jax(task, bench_nets):
    """Every registered backend equals ``take`` at ragged and block
    batches, and ``take`` equals the JAX package's codes on the same
    network and rows; the record keeps the reference's schema."""
    batches = (3, 17)
    res = bk.sweep(tasks=(task,), batches=batches, reps=1, device="cpu")
    assert res["schema_version"] == 1
    assert sorted(res["backends"]) == sorted(jbackends.available())
    for name, caps in res["backends"].items():
        assert caps["fused"] == jbackends.get(name).capabilities().fused
    cells = res["tasks"][task]["cells"]
    assert [c["batch"] for c in cells] == list(batches)
    jnet, tnet = bench_nets[task]
    assert bk.violations(res) == []
    for c in cells:
        assert set(c["us"]) == set(jbackends.available())
        assert c["speedup_vs_take"]["take"] == 1.0
        x = bk.random_rows(tnet.cfg.in_features, c["batch"], 1)
        np.testing.assert_array_equal(
            tnet.predict_codes(x, backend="take").numpy(),
            np.asarray(jnet.predict_codes(x, backend="take")))


def test_throughput_sweep_on_cpu_slots(bench_nets):
    """Kernel, engine and mesh sweeps at a tiny size: mesh cells of 1, 2
    and 4 CPU slots bit-identical to the unplaced ``take`` codes, which
    equal the JAX package's."""
    res = tp.sweep(blocks=(8, 32), mesh_sizes=(1, 2, 4), reps=1, rows=64,
                   kernel_rows=64, mesh_rows=96, device="cpu")
    assert res["schema_version"] == 2
    assert [(c["backend"], c["block"]) for c in res["kernel"]] == [
        (n, b) for b in (8, 32) for n in jbackends.available()]
    assert res["fused_tuning"]["mode"] == "resident"
    assert [(c["backend"], c["block"]) for c in res["engine"]] == [
        (n, b) for n in jbackends.available() for b in (8, 32)]
    for c in res["engine"]:
        assert c["async_speedup"] == round(
            c["async"]["rows_per_s"] / c["sync"]["rows_per_s"], 3)
    mesh = [(c["backend"], c["mesh"], c["slots"], c["physical_devices"],
             c["bit_identical"]) for c in res["mesh"]]
    assert mesh == [(n, m, m, 1, True) for n in tp.MESH_BACKENDS
                    for m in (1, 2, 4)]
    assert not [b for b in tp.exits(res, fast=True) if "mesh" in b]
    jnet, tnet = bench_nets["nid"]
    x = bk.random_rows(tnet.cfg.in_features, 96, 1)
    np.testing.assert_array_equal(
        tnet.predict_codes(x, backend="take").numpy(),
        np.asarray(jnet.predict_codes(x, backend="take")))


def _mesh_cell(m, phys, rate, ok=True):
    return {"backend": "fused", "mesh": m, "slots": m,
            "physical_devices": phys, "rows_per_s": rate,
            "bit_identical": ok}


@pytest.mark.parametrize("mesh,kernel_fastest,fast,want", [
    # slots sharing one card may fall: only distinct cards promise a curve
    ([_mesh_cell(1, 1, 3e5), _mesh_cell(2, 1, 2e5), _mesh_cell(4, 1, 1e5)],
     True, False, []),
    ([_mesh_cell(1, 1, 3e5), _mesh_cell(2, 2, 2e5)], True, False,
     ["mesh scaling"]),
    ([_mesh_cell(1, 1, 3e5), _mesh_cell(2, 2, 2e5)], True, True, []),
    ([_mesh_cell(1, 1, 3e5, ok=False)], True, True, ["NOT bit-identical"]),
    ([_mesh_cell(1, 1, 3e5)], False, True, ["NOT fastest"]),
])
def test_throughput_exits(mesh, kernel_fastest, fast, want):
    res = {"mesh": mesh, "kernel": [
        {"backend": "fused", "block": 64, "fused_fastest": False},
        {"backend": "fused", "block": 256, "fused_fastest": kernel_fastest}]}
    got = tp.exits(res, fast)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert w in g


def _cell_pair(seed):
    """(JAX cell, its parameters, port cell, its parameters) folded from
    one parameter tree of the reference bench's smoke cell."""
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
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = tassemble.params_from_reference(tree, device="cpu")
    return (jcell.compile_cell(jparams, jc), jparams,
            tcell.compile_cell(tparams, tc), tparams)


def test_stream_hot_swaps_match_reference():
    """The carried and the requantized swap on one cell, the port's lanes
    on ``fused`` and the reference bench's (``_hot_swap_*``) on ``take``:
    the same migration mode, requests and version, 0 wrong, 0 dropped."""
    jcomp, jparams, tcomp, tparams = _cell_pair(0)
    kw = dict(n_streams=8, t_steps=4, block=8, depth=2)
    want = {"carried": jstream._hot_swap_carried(jcomp, seed=3, **kw),
            "requantized": jstream._hot_swap_requantized(
                jcomp, jparams, seed=4, **kw)}
    got = {"carried": tstream.hot_swap_carried(tcomp, seed=3, **kw),
           "requantized": tstream.hot_swap_requantized(
               tcomp, tparams, seed=4, **kw)}
    assert got == want
    for mode, hs in got.items():
        assert (hs["state_migration"], hs["wrong"], hs["dropped"],
                hs["deploy_ok"]) == (mode, 0, 0, True)


def test_run_cli_choices_equal_reference():
    """``torch_run.py --only`` takes the reference harness's nine choices
    (read from its source: importing it would set up JAX devices)."""
    with open(os.path.join(ROOT, "benchmarks", "run.py")) as f:
        tree = ast.parse(f.read())
    choices = [ast.literal_eval(kw.value) for node in ast.walk(tree)
               if isinstance(node, ast.Call) and node.args
               and isinstance(node.args[0], ast.Constant)
               and node.args[0].value == "--only"
               for kw in node.keywords if kw.arg == "choices"]
    assert choices == [list(torch_run.CHOICES)]
