"""The port's paper tables (``benchmarks/torch_paper_tables.py``) against
the reference's (``benchmarks/paper_tables.py``).

The analytic tables (Table III, Fig. 2) and the configurations (Table IV's
baselines, Fig. 5's options) are compared exactly.  The trainings are too
slow for tier-1 in JAX, so both packages' table functions run once with a
recording stand-in for ``Toolflow`` and the trainers: each must drive the
same flows (configuration, hyperparameters, step budgets, seeds, stages,
data).  The port then runs Table II's ``nid`` row, Table IV and Fig. 5's
random-mapping variant for real at a smoke budget on the CPU, serving every
folded network.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from benchmarks import paper_tables as ref
from benchmarks import torch_paper_tables as port

SMOKE = dict(steps=4, n_train=1024)     # 60 pretrain steps (the floor)


def test_table3_equals_reference():
    assert port.table3() == ref.table3()


@pytest.mark.parametrize("max_fan_in,bits", [(64, 2), (16, 3)])
def test_fig2_equals_reference(max_fan_in, bits):
    assert (port.fig2_assembly_scaling(max_fan_in, bits)
            == ref.fig2_assembly_scaling(max_fan_in, bits))


@pytest.mark.parametrize("model", ["neuralut_assemble", "logicnets",
                                   "neuralut", "polylut"])
def test_baseline_configs_equal_reference(model):
    got = port._baseline_configs("nid")
    want = ref._baseline_configs("nid")
    assert list(got) == list(want)
    assert dataclasses.asdict(got[model]) == dataclasses.asdict(want[model])
    with pytest.raises(ValueError):
        port._baseline_configs("mnist")


@pytest.mark.parametrize("option", [1, 2, 3])
def test_fig5_options_equal_reference(option):
    assert (dataclasses.asdict(port._fig5_option(option))
            == dataclasses.asdict(ref._fig5_option(option)))


class _Recorder:
    """Stand-ins for ``Toolflow`` and the trainers that record what a
    table asks for and train nothing."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _data(data):
        x = np.asarray(data.x_train)
        return (x.shape, np.asarray(data.x_test).shape,
                float(x[:64].sum()), int(np.asarray(data.y_train).sum()))

    def modules(self):
        rec = self

        class Flow:
            def __init__(self, cfg, **kw):
                kw.pop("device", None)
                self.entry = {"cfg": dataclasses.asdict(cfg), "hyper": kw,
                              "stages": []}
                self.params = None
                rec.calls.append(("flow", self.entry))

            def _stage(self, name, data=None):
                self.entry["stages"].append(name)
                if data is not None:
                    self.entry["data"] = rec._data(data)
                return self

            def pretrain(self, data):
                return self._stage("pretrain", data)

            def prune(self):
                return self._stage("prune")

            def retrain(self, data=None):
                return self._stage("retrain", data)

            def accuracy(self, data=None, *, folded=False, max_eval=2048):
                return 0.5

        def train(cfg, data, *, steps, seed=0, device=None, **kw):
            rec.calls.append(("train", dataclasses.asdict(cfg), steps, seed,
                              kw, rec._data(data)))
            return types.SimpleNamespace(params=None)

        def dense_mlp_reference(data, widths, *, steps, seed=0, device=None,
                                **kw):
            rec.calls.append(("fp_fc", list(widths), steps, seed, kw,
                              rec._data(data)))
            return 0.875

        return (types.SimpleNamespace(Toolflow=Flow),
                types.SimpleNamespace(
                    train=train, dense_mlp_reference=dense_mlp_reference,
                    accuracy=lambda cfg, params, data, **kw: 0.5))


@pytest.fixture(scope="module")
def recorded():
    """Run both packages' Table II, Table IV and Fig. 5 (seed 0) on the
    recording stand-ins; returns {package: (calls, rows by table)}."""
    out = {}
    for name, mod in (("ref", ref), ("port", port)):
        rec = _Recorder()
        flow_mod, trainer = rec.modules()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "pipeline", flow_mod)
            mp.setattr(mod, "lut_trainer", trainer)
            rows = {"table2": mod.table2(), "table4": mod.table4(),
                    "fig5": mod.fig5(seeds=(0,))}
        out[name] = (rec.calls, rows)
    return out


def test_tables_drive_the_reference_flows(recorded):
    """Same flows in the same order: configurations, hyperparameters and
    step budgets (220 steps, 73 pretrain, 250 FP-FC, 80 in Fig. 5), seeds,
    stages and data."""
    ref_calls, _ = recorded["ref"]
    port_calls, _ = recorded["port"]
    assert len(port_calls) == len(ref_calls) == 3 * 2 + 4 + 9
    assert port_calls == ref_calls
    hyper = [c[1]["hyper"] for c in ref_calls if c[0] == "flow"]
    assert {h["retrain_steps"] for h in hyper} == {port.STEPS}
    assert {h["pretrain_steps"] for h in hyper} == {73, port.FIG5_PRETRAIN}
    assert {c[2] for c in ref_calls if c[0] == "fp_fc"} == {port.FC_STEPS}


def test_fig5_random_mapping_variant_retrains_only(recorded):
    """``wo_learned_mappings`` runs ``retrain`` with no pretrain or prune
    (random mappings) in both packages; the other variants run all three."""
    for pkg in ("ref", "port"):
        flows = [c[1] for c in recorded[pkg][0] if c[0] == "flow"][4:]
        assert [f["stages"] for f in flows] == [
            ["pretrain", "prune", "retrain"], ["retrain"],
            ["pretrain", "prune", "retrain"]] * 3, pkg


def test_row_keys_and_hwcost_columns_equal_reference(recorded):
    _, want = recorded["ref"]
    _, got = recorded["port"]
    for table in ("table2", "table4", "fig5"):
        assert [set(r) >= set(w) for r, w in
                zip(got[table], want[table])] == [True] * len(want[table])
    for table in ("table4", "fig5"):
        cols = port.HWCOST_COLS[table]
        assert ([{c: r[c] for c in cols} for r in got[table]]
                == [{c: r[c] for c in cols} for r in want[table]])
    assert got["fig5"] == want["fig5"]


@pytest.fixture(scope="module")
def smoke_rows():
    """Table II's ``nid`` row and Table IV at a smoke budget on the CPU,
    every folded network served (one torch thread: the numbers must not
    depend on the core count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {"table2": port.table2(0, fc_steps=2, tasks=("nid",),
                                      device="cpu", serve=port.serve_folded,
                                      **SMOKE),
                "table4": port.table4(0, device="cpu",
                                      serve=port.serve_folded, **SMOKE)}
    finally:
        torch.set_num_threads(threads)


def test_smoke_rows_fold_exactly_and_serve_take(smoke_rows, recorded):
    _, want = recorded["ref"]
    rows = smoke_rows["table2"] + smoke_rows["table4"]
    assert [r.get("task", r.get("model")) for r in rows] == [
        "nid", "neuralut_assemble", "logicnets", "neuralut", "polylut"]
    assert set(smoke_rows["table2"][0]) >= set(want["table2"][0])
    for r, w in zip(smoke_rows["table4"], want["table4"]):
        assert set(r) >= set(w) | {"folded_acc", "fold_exact", "served"}
        for c in port.HWCOST_COLS["table4"]:
            assert r[c] == w[c], (r["model"], c)
    for r in rows:
        s = r["served"]
        assert r["fold_exact"] and r["folded_acc"] == r.get("ours_acc",
                                                            r.get("acc"))
        assert s["ok"] and s["served_acc_equal"] and s["cpu_load_equal"]
        assert s["fused"]["codes_equal_take"]
        assert s["pallas"]["codes_equal_take"]
        assert s["blocks"] == 2 and s["rows"] == 2048


def test_fig5_random_mapping_flow_runs():
    """The ablation's flow for real: random mappings, no dense model."""
    data = port.synthetic.load("jsc_openml", n_train=512, n_test=256)
    flow = port._fig5_flow(port._fig5_option(1), False, data, 0, steps=2,
                           device="cpu")
    assert list(flow.stages) == ["retrain"]
    assert flow.mappings is None and flow.dense_params is None
    assert not flow.stages["retrain"].metrics["learned_mappings"]
    assert 0.0 <= flow.accuracy() <= 1.0


def _record(per_seed2, per_seed4, fig5_rows):
    return {"seeds": [0, 1], "fig5_seeds": [0, 1],
            "table2": {"per_seed": per_seed2},
            "table3": {"rows": port.table3()},
            "table4": {"per_seed": per_seed4},
            "fig2": {"rows": port.fig2_assembly_scaling()},
            "fig5": {"rows": fig5_rows}}


def _seed_rows(recorded):
    _, rows = recorded["ref"]
    t2 = {"0": rows["table2"], "1": [dict(r, ours_acc=r["ours_acc"] + 0.02)
                                     for r in rows["table2"]]}
    t4 = {"0": rows["table4"], "1": rows["table4"]}
    return t2, t4, rows["fig5"]


def test_over_seeds_adds_means_and_keeps_reference_keys(recorded):
    t2, t4, _ = _seed_rows(recorded)
    rows = port.over_seeds("table2", t2)
    assert [r["task"] for r in rows] == ["mnist", "jsc", "nid"]
    r = rows[0]
    assert set(r) >= set(t2["0"][0]) | {"acc_mean", "acc_std", "seeds"}
    assert r["ours_acc_seeds"] == [0.5, 0.52]
    assert r["acc_mean"] == 0.51 and r["acc_std"] == 0.01
    assert port.over_seeds("table4", t4)[2]["acc_std"] == 0.0


@pytest.mark.parametrize("fault", [None, "hwcost", "fold", "served",
                                   "accuracy"])
def test_compare_holds_the_contract(recorded, fault):
    """Exact hwcost columns, exact folds and served codes fail the run;
    an accuracy mean outside 0.03 is reported, not failed."""
    t2, t4, f5 = _seed_rows(recorded)
    ref_rec = _record(t2, t4, f5)
    t2 = {s: [dict(r, served={"ok": True}) for r in rows]
          for s, rows in t2.items()}
    if fault == "hwcost":
        t4 = {s: [dict(r, luts=r["luts"] + (r["model"] == "polylut"))
                  for r in rows] for s, rows in t4.items()}
    elif fault == "fold":
        t2["1"] = [dict(r, fold_exact=r["task"] != "jsc") for r in t2["1"]]
    elif fault == "served":
        t2["0"] = [dict(r, served={"ok": r["task"] != "nid"})
                   for r in t2["0"]]
    elif fault == "accuracy":
        t4 = {s: [dict(r, acc=r["acc"] + 0.05) for r in rows]
              for s, rows in t4.items()}
    res = port.compare(_record(t2, t4, f5), ref_rec)
    assert len(res["failures"]) == (0 if fault in (None, "accuracy") else 1)
    assert res["accuracy_within_gate"] == (fault != "accuracy")
    assert {a["table"] for a in res["accuracy"]} == {"table2", "table4",
                                                     "fig5"}


@pytest.mark.parametrize("port_seeds,ref_seeds,shared", [
    (2, 4, [0, 1]), (4, 4, [0, 1, 2, 3]), (4, 2, [0, 1])])
def test_compare_takes_means_over_the_shared_seeds(recorded, port_seeds,
                                                   ref_seeds, shared):
    """A miss is checked over more seeds by a ``--seeds 0,...,9 --tables
    table2`` run: each mean is taken over the seeds both records hold."""
    _, rows = recorded["ref"]

    def acc(r, a, **kw):      # the fold is exact: folded == quantized
        return dict(r, ours_acc=a, folded_acc=a, **kw)

    ref_rec = {"table2": {"per_seed": {
        str(s): [acc(r, 0.60 + 0.01 * s) for r in rows["table2"]]
        for s in range(ref_seeds)}}}
    jsc = [0.70, 0.70, 0.62, 0.62]
    mine = {str(s): [acc(r, jsc[s] if r["task"] == "jsc" else 0.60 + 0.01 * s,
                         served={"ok": True})
                     for r in rows["table2"]] for s in range(port_seeds)}
    res = port.compare({"table2": {"per_seed": mine}}, ref_rec)
    assert res["failures"] == []
    assert {tuple(a["seeds"]) for a in res["accuracy"]} == {tuple(shared)}
    got = {(a["row"], a["column"]): a for a in res["accuracy"]}
    assert all(got[(t, c)]["diff"] == 0.0 and got[(t, c)]["within"]
               for t in ("mnist", "nid") for c in ("acc_mean",
                                                   "folded_acc_mean"))
    m = got[("jsc", "acc_mean")]
    want_port = round(float(np.mean([jsc[s] for s in shared])), 4)
    want_ref = round(float(np.mean([0.60 + 0.01 * s for s in shared])), 4)
    assert (m["port"], m["reference"]) == (want_port, want_ref)
    assert m["diff"] == round(want_port - want_ref, 4) and not m["within"]
    assert got[("jsc", "folded_acc_mean")]["diff"] == m["diff"]


@pytest.mark.parametrize("logits,want", [
    ([[-1.0], [0.0], [2.5]], [0, 0, 1]),
    ([[0.1, 3.0, 2.0], [4.0, -1.0, 4.5]], [1, 2])])
def test_served_accuracy_uses_the_trainers_class_rule(logits, want):
    """``serve_folded`` scores the engine's logits by the rule
    ``lut_trainer.accuracy`` applies: a positive logit is class 1 of a
    single output, otherwise the largest logit's class."""
    got = port.lut_trainer.predicted_classes(np.asarray(logits, np.float32))
    assert got.tolist() == want
