"""The port's hardware surfaces against the JAX package: the analytic cost
model (``core.hwcost``), the Verilog emission and its structural LUT count
(``core.rtl``), the don't-care analysis (``core.dontcare``) and the
artifact's ``hw_report`` / ``to_verilog``.  Numbers are held equal, the
Verilog byte for byte, on the same folded tables."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.core import assemble as jassemble
from repro.core import dontcare as jdontcare
from repro.core import folding as jfolding
from repro.core import hwcost as jhwcost
from repro.core import rtl as jrtl
from repro.data import synthetic as jsynthetic
from repro_torch import pipeline as tpipeline
from repro_torch.configs import paper_tasks as ttasks
from repro_torch.core import assemble as tassemble
from repro_torch.core import dontcare as tdontcare
from repro_torch.core import folding as tfolding
from repro_torch.core import hwcost as thwcost
from repro_torch.core import rtl as trtl

TASKS = sorted(jtasks.TASKS)
ERROR_BOUND = 0.02      # tests/test_hwcost_calibration.py's bound


def _tcfg(cfg):
    return tpipeline.config_from_dict(jpipeline.config_to_dict(cfg))


def _additive_cfg():
    layers = (jassemble.LayerSpec(12, 3, 2, False, add_terms=2, add_bits=3),
              jassemble.LayerSpec(4, 3, 2, True),
              jassemble.LayerSpec(1, 4, 2, False))
    return dataclasses.replace(jtasks.reduced("nid"), layers=layers)


def _folded_pair(cfg, seed):
    """The same random folded network in both packages (tables below
    2^bits, random mappings and log-scales)."""
    rs = np.random.RandomState(seed)
    tables, maps = [], []
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        tables.append(rs.randint(0, 2 ** spec.bits,
                                 size=(spec.units, entries)).astype(np.int32))
        maps.append(None if spec.assemble else rs.randint(
            0, cfg.prev_width(l), size=(spec.units, spec.fan_in)
        ).astype(np.int32))
    ils, ols = float(rs.uniform(-2, 0)), float(rs.uniform(-3, 0))
    jnet = jfolding.FoldedNetwork(
        cfg=cfg, tables=[jnp.asarray(t) for t in tables],
        in_q={"log_scale": jnp.asarray(ils)},
        out_q={"log_scale": jnp.asarray(ols)},
        mappings=[None if m is None else jnp.asarray(m) for m in maps])
    tnet = tfolding.FoldedNetwork(
        cfg=_tcfg(cfg), tables=[torch.from_numpy(t) for t in tables],
        in_q={"log_scale": ils}, out_q={"log_scale": ols},
        mappings=[None if m is None else torch.from_numpy(m) for m in maps])
    return jnet, tnet


@pytest.fixture(scope="module")
def verilog():
    """Per task: (reference Verilog, port Verilog, port network), emitted
    once from the same folded tables."""
    out = {}
    for i, task in enumerate(TASKS):
        jnet, tnet = _folded_pair(jtasks.task_config(task), i)
        out[task] = (jrtl.emit_verilog(jnet), trtl.emit_verilog(tnet), tnet,
                     jnet)
    return out


def test_decomposition_tables_and_timing_fit_match_reference():
    for k in range(1, 25):
        assert thwcost.plut_per_bit(k) == jhwcost.plut_per_bit(k)
        assert thwcost.logic_levels(k) == jhwcost.logic_levels(k)
        for every in (1, 2, 3):
            assert thwcost._effective_levels(k, every) == \
                jhwcost._effective_levels(k, every)
    assert thwcost.fit_timing() == jhwcost.fit_timing()
    assert thwcost.PAPER_TABLE3 == jhwcost.PAPER_TABLE3
    for fan_ins, bits, out_bits in (((6, 6), 1, None), ((3, 3, 3), 2, 8),
                                    ((2,) * 6, 3, 6)):
        assert thwcost.tree_area(fan_ins, bits, out_bits) == \
            jhwcost.tree_area(fan_ins, bits, out_bits)


@pytest.mark.parametrize("every", [1, 3])
@pytest.mark.parametrize("task", TASKS + ["additive"])
def test_report_matches_reference(task, every):
    cfg = _additive_cfg() if task == "additive" else jtasks.task_config(task)
    want = jhwcost.report(cfg, pipeline_every=every)
    got = thwcost.report(_tcfg(cfg), pipeline_every=every)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert thwcost.network_luts(_tcfg(cfg)) == jhwcost.network_luts(cfg)
    assert thwcost.network_ffs(_tcfg(cfg), every) == \
        jhwcost.network_ffs(cfg, every)


@pytest.mark.parametrize("task", TASKS)
def test_emit_verilog_is_byte_identical(task, verilog):
    want, got, _, _ = verilog[task]
    assert got == want


@pytest.mark.parametrize("every", [1, 2])
def test_emit_verilog_options_are_byte_identical(every):
    jnet, tnet = _folded_pair(jtasks.reduced("mnist"), 11)
    assert trtl.emit_verilog(tnet, module_name="m", pipeline_every=every) == \
        jrtl.emit_verilog(jnet, module_name="m", pipeline_every=every)


@pytest.mark.parametrize("task", TASKS)
def test_count_luts_and_calibration_match_reference(task, verilog):
    """``count_luts`` of the port's Verilog equals the reference's count and
    the analytic model within the calibration bound; ``calibrated_report``
    gives the reference's numbers."""
    want, got, tnet, jnet = verilog[task]
    counted = trtl.count_luts(got)
    assert counted == jrtl.count_luts(want)
    analytic = thwcost.network_luts(tnet.cfg)
    assert abs(counted - analytic) / analytic <= ERROR_BOUND
    cal = {"analytic_luts": analytic, "rtl_luts": counted,
           "ratio": counted / max(analytic, 1)}
    rep = thwcost.calibrated_report(tnet, calibration=cal)
    want_rep = jhwcost.calibrated_report(jnet, calibration=cal)
    assert dataclasses.asdict(rep) == dataclasses.asdict(want_rep)


def test_calibration_vs_rtl_matches_reference():
    jnet, tnet = _folded_pair(jtasks.reduced("nid"), 3)
    for every in (1, 3):
        got = thwcost.calibration_vs_rtl(tnet, pipeline_every=every)
        assert got == jhwcost.calibration_vs_rtl(jnet, pipeline_every=every)
        assert dataclasses.asdict(thwcost.calibrated_report(
            tnet, pipeline_every=every)) == dataclasses.asdict(
                jhwcost.calibrated_report(jnet, pipeline_every=every))


def test_count_luts_refuses_what_is_not_a_module():
    with pytest.raises(ValueError, match="no ROMs"):
        trtl.count_luts("module empty(); endmodule")
    v = ("  wire [7:0] l0_a0 = {x[7:0]};\n"
         "  reg [3:0] l0_r0;\n"
         "  wire [5:0] l1_a0 = {l0_c[5:0]};\n"
         "  reg [0:0] l1_r0;\n")
    assert trtl.count_luts(v) == jrtl.count_luts(v) == 17
    with pytest.raises(ValueError, match="no matching address"):
        trtl.count_luts(v + "  reg [3:0] l9_r0;\n")


@pytest.fixture(scope="module")
def folded_nid():
    """``nid_reduced`` folded from the same parameters in both packages."""
    cfg = jtasks.reduced("nid")
    tnet_params = tassemble.init(0, _tcfg(cfg), device="cpu")
    tree = tassemble.params_to_reference(tnet_params)
    jparams = jax.tree.map(jnp.asarray, tree)
    data = jsynthetic.load("nid", n_train=2048, n_test=64)
    return (cfg, data, jfolding.fold_network(jparams, cfg),
            tfolding.fold_network(tnet_params, _tcfg(cfg)))


@pytest.mark.parametrize("rows", [64, 1024, 2048])
def test_dontcare_analyze_matches_reference(rows, folded_nid):
    cfg, data, jnet, tnet = folded_nid
    for t, j in zip(tnet.tables, jnet.tables):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    want = jdontcare.analyze(jnet, data.x_train[:rows])
    got = tdontcare.analyze(tnet, data.x_train[:rows])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.lut_reduction == want.lut_reduction
    assert got.optimized_luts <= got.structural_luts
    assert got.structural_luts == thwcost.network_luts(tnet.cfg)


def test_compiled_network_hw_report_and_verilog_match_reference(tmp_path):
    """``CompiledLUTNetwork.hw_report`` / ``to_verilog`` of an artifact
    loaded in each package."""
    cfg = jtasks.reduced("jsc")
    jnet, tnet = _folded_pair(cfg, 5)
    port = tpipeline.CompiledLUTNetwork.from_folded(tnet)
    path = port.save(str(tmp_path / "jsc.npz"))
    ref = jpipeline.CompiledLUTNetwork.load(path)
    assert dataclasses.asdict(port.hw_report()) == \
        dataclasses.asdict(ref.hw_report())
    assert dataclasses.asdict(port.hw_report(pipeline_every=1)) == \
        dataclasses.asdict(ref.hw_report(pipeline_every=1))
    assert port.to_verilog() == ref.to_verilog()
    assert port.to_verilog(module_name="n", pipeline_every=2) == \
        ref.to_verilog(module_name="n", pipeline_every=2)


def test_stream_cell_networks_report_as_the_reference():
    for name in ttasks.stream_task_names():
        tcfg = ttasks.stream_task_config(name).net
        jcfg = jpipeline.config_from_dict(tpipeline.config_to_dict(tcfg))
        assert dataclasses.asdict(thwcost.report(tcfg)) == \
            dataclasses.asdict(jhwcost.report(jcfg))
