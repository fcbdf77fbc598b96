"""The port's regression gate (``benchmarks/torch_check_regression.py``)
against the reference's (``benchmarks/check_regression.py``).

Each record is written once under the reference's file name and once
under the port's in a temporary directory; the reference's extractor and
the port's must give the same metrics and the same violations, on a clean
record, on each kind of injected fault and on each committed ``TORCH_*``
record of the port.  ``compare`` is held to the reference's in both modes,
and ``refresh`` must refuse a record with violations and leave the
reference's accuracy baseline alone.
"""
import json
import os

import pytest

from benchmarks import check_regression as ref
from benchmarks import torch_check_regression as port

ROOT = os.path.join(os.path.dirname(__file__), "..")
EXPERIMENTS = os.path.join(ROOT, "experiments")
# record kind -> (the reference's file name, the port's)
FILES = {
    "throughput": ("BENCH_lut_throughput.json", port.THROUGHPUT),
    "backends": ("BENCH_lut_backends.json", port.BACKENDS),
    "search": ("BENCH_assembly_search.json", port.SEARCH),
    "fleet": ("BENCH_fleet.json", port.FLEET),
    "stream": ("BENCH_stream.json", port.STREAM),
    "chaos": ("BENCH_chaos.json", port.CHAOS),
}
# suite -> the record kinds it reads
READS = {"throughput": ("throughput", "backends"), "kernel": ("throughput",),
         "accuracy": ("search",), "fleet": ("fleet",),
         "stream": ("stream",), "search": ("search",), "chaos": ("chaos",)}


def _throughput():
    rates = {"take": 1.0e5, "fused": 3.0e5}
    return {
        "schema_version": 2, "task": "nid",
        "kernel": [{"backend": b, "block": blk,
                    "rows_per_s": rates[b] * blk / 256,
                    "fused_margin": 3.0, "fused_fastest": True,
                    "launches_per_chunk": {}}
                   for blk in (64, 256, 1024) for b in rates],
        "engine": [{"backend": b, "block": blk,
                    "sync": {"rows_per_s": rates[b], "p50_tick_us": 900.0,
                             "p99_tick_us": 1200.0},
                    "async": {"rows_per_s": 1.2 * rates[b],
                              "p50_tick_us": 800.0, "p99_tick_us": 1100.0},
                    "async_speedup": 1.2 + blk / 1e4}
                   for b in rates for blk in (64, 256, 1024)],
        "mesh": [{"backend": b, "mesh": m, "slots": m,
                  "physical_devices": 1, "rows_per_s": 3.1e5,
                  "bit_identical": True, "launches_per_call": {}}
                 for b in rates for m in (1, 2, 4)],
    }


def _backends():
    names = ("take", "onehot", "pallas", "fused")
    return {"schema_version": 1, "backends": {n: {} for n in names},
            "tasks": {t: {"config": {}, "cells": [
                {"batch": b, "us": {n: 100.0 + i for i, n in
                                    enumerate(names)},
                 "speedup_vs_take": {n: 1.0 for n in names},
                 "bit_identical": {n: True for n in names},
                 "launches_per_call": {n: {} for n in names}}
                for b in (256, 1024)]} for t in ("mnist", "jsc", "nid")}}


def _point(name, acc, additive=False, beta=False, cal=1.0):
    return {"name": name, "accuracy": acc, "luts": 100, "adp": 50.0,
            "calibration": cal, "additive": additive, "learned_beta": beta}


def _search():
    tasks = {
        "nid_reduced": [_point("base", 0.81), _point("add2", 0.80, True),
                        _point("depth1", 0.78), _point("beta-1", 0.7)],
        "jsc_reduced": [_point("base", 0.79), _point("lbeta", 0.78,
                                                      beta=True),
                        _point("fanin-1", 0.75)],
    }
    return {
        "schema_version": 1, "budget": {"min_frontier": 3},
        "tasks": {t: {"frontier": f, "best_accuracy": f[0]["accuracy"],
                      "frontier_points": len(f),
                      "bit_identical": {p["name"]: {"take": True,
                                                    "fused": True}
                                        for p in f}}
                  for t, f in tasks.items()},
        "dist_compare": {"tasks": {t: {"survivors_match": True}
                                   for t in tasks},
                         "speedup": 0.9},
    }


def _fleet():
    return {
        "online": {"fleet_rows_per_s": 2.6e5,
                   "isolated_sync_rows_per_s": 1.5e5,
                   "speedup_vs_isolated_sync": 1.73},
        "offline": {"fleet_rows_per_s": 2.7e5},
        "per_tenant": [{"model_id": m, "bit_identical": True,
                        "p99_request_us": 5000.0 + i}
                       for i, m in enumerate(("nid", "jsc", "mnist"))],
        "hot_swap": {"good_deploy_ok": True, "to_version": 2,
                     "corrupt_deploy_rejected": True,
                     "rollback_recorded": True, "dropped": 0, "wrong": 0,
                     "requests": 1280},
        "admission": {"shed": 512},
    }


def _stream():
    return {
        "schema_version": 1, "full_size": True,
        "scaling": [{"streams": n, "backend": b,
                     "steps_per_s": 5e4 + n + (b == "pallas"),
                     "p99_step_us": 2e4 - n, "bit_identical": True}
                    for n in (64, 1024) for b in ("fused", "pallas")],
        "churn": {"per_backend": {b: {"bit_identical": True,
                                      "completed": 131, "dropped": 0,
                                      "closed": True}
                                  for b in ("take", "fused")}},
        "hot_swap": {m: {"streams": 32, "requests": 256, "deploy_ok": True,
                         "to_version": 2, "state_migration": m,
                         "dropped": 0, "wrong": 0}
                     for m in ("carried", "requantized")},
    }


def _chaos():
    sc = {"injected": 1, "detected": 1, "recovered": True, "wrong": 0,
          "lost": 0, "recovery_p99_ms": 4.0}
    fo = {"checkpoints_shipped": 9, "replayed_steps": 19,
          "recovery_ms": 9.9, "mismatched_streams": 0, "lost_steps": 0}
    return {
        "scenarios": {n: dict(sc, name=n, recovery_p99_ms=r) for n, r in
                      (("exception_transient", 4.0),
                       ("breaker_degrade", 30.0), ("hang_deadline", 0.0))},
        "degraded": {"throughput_ratio": 0.72, "floor": 0.05, "wrong": 0,
                     "lost": 0, "clean_failures_degrades": {"nid": [0, 0]},
                     "clean_launches": 99, "clean_launches_expected": 99},
        "stream_failover": {b: dict(fo) for b in ("take", "fused")},
        "soak": {"injected": {"exception": 3}, "wrong": 0, "lost": 0,
                 "detected": {"failures": 23, "deadline_hits": 20},
                 "recovery_p99_ms": 1890.0},
    }


CLEAN = {"throughput": _throughput, "backends": _backends,
         "search": _search, "fleet": _fleet, "stream": _stream,
         "chaos": _chaos}


def _set(path, value):
    """A fault: set ``record[path...] = value``."""
    def fault(rec):
        node = rec
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
    return fault


# (suite, record kind, fault) -- each must raise at least one violation
FAULTS = {
    "mesh_not_bit_identical": ("throughput", "throughput",
                               _set(("mesh", 4, "bit_identical"), False)),
    "backend_not_bit_identical": (
        "throughput", "backends",
        _set(("tasks", "nid", "cells", 1, "bit_identical", "pallas"),
             False)),
    "fused_not_fastest_at_256": (
        "kernel", "throughput", _set(("kernel", 3, "fused_fastest"), False)),
    "frontier_too_small": (
        "accuracy", "search",
        _set(("tasks", "jsc_reduced", "frontier_points"), 2)),
    "artifact_not_bit_identical": (
        "accuracy", "search",
        _set(("tasks", "nid_reduced", "bit_identical", "base", "fused"),
             False)),
    "tenant_not_bit_identical": (
        "fleet", "fleet", _set(("per_tenant", 1, "bit_identical"), False)),
    "fleet_swap_dropped": ("fleet", "fleet",
                           _set(("hot_swap", "dropped"), 3)),
    "admission_shed_nothing": ("fleet", "fleet",
                               _set(("admission", "shed"), 0)),
    "stream_not_bit_identical": (
        "stream", "stream", _set(("scaling", 2, "bit_identical"), False)),
    "churn_dropped": ("stream", "stream",
                      _set(("churn", "per_backend", "fused", "dropped"), 2)),
    "swap_wrong": ("stream", "stream",
                   _set(("hot_swap", "requantized", "wrong"), 5)),
    "swap_dropped": ("stream", "stream",
                     _set(("hot_swap", "carried", "dropped"), 1)),
    "swap_mode": ("stream", "stream",
                  _set(("hot_swap", "carried", "state_migration"),
                       "requantized")),
    "full_size_under_1000": ("stream", "stream", lambda rec: [
        p.update(streams=512) for p in rec["scaling"]]),
    "survivors_differ": (
        "search", "search",
        _set(("dist_compare", "tasks", "nid_reduced", "survivors_match"),
             False)),
    "no_wider_point": ("search", "search", lambda rec: [
        p.update(additive=False, learned_beta=False)
        for t in rec["tasks"].values() for p in t["frontier"]]),
    "wider_point_off_rtl": (
        "search", "search",
        _set(("tasks", "nid_reduced", "frontier", 1, "calibration"), 1.2)),
    "chaos_lost": ("chaos", "chaos",
                   _set(("scenarios", "hang_deadline", "lost"), 4)),
    "failover_mismatch": (
        "chaos", "chaos",
        _set(("stream_failover", "fused", "mismatched_streams"), 1)),
}


def _write(tmp_path, records: dict) -> str:
    for kind, rec in records.items():
        for name in FILES[kind]:
            with open(os.path.join(tmp_path, name), "w") as f:
                json.dump(rec, f)
    return str(tmp_path)


def _both(suite, d):
    want = getattr(ref, f"extract_{suite}")(d)
    got = getattr(port, f"extract_{suite}")(d)
    return got, want


@pytest.mark.parametrize("suite", sorted(READS))
def test_clean_record_same_metrics_no_violations(suite, tmp_path):
    d = _write(tmp_path, {k: CLEAN[k]() for k in READS[suite]})
    got, want = _both(suite, d)
    assert got == want
    assert got[0] and got[1] == []


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_injected_fault_same_violations(fault, tmp_path):
    suite, kind, inject = FAULTS[fault]
    records = {k: CLEAN[k]() for k in READS[suite]}
    inject(records[kind])
    got, want = _both(suite, _write(tmp_path, records))
    assert got == want
    assert got[1], f"{fault}: no violation"


def test_port_contract_flags_streams_left_open(tmp_path):
    """The port's stream record also carries whether the churn closed its
    streams, which the reference's record lacks: the port's contract
    reports one more violation, and the metrics stay equal."""
    rec = _stream()
    rec["churn"]["per_backend"]["take"]["closed"] = False
    got, want = _both("stream", _write(tmp_path, {"stream": rec}))
    assert got[0] == want[0] and want[1] == []
    assert got[1] == ["churn[take]: closed streams left open"]


@pytest.mark.parametrize("suite", sorted(READS))
def test_committed_records_same_metrics_and_violations(suite, tmp_path):
    """The port's committed card records through both extractors."""
    records = {}
    for kind in READS[suite]:
        with open(os.path.join(EXPERIMENTS, FILES[kind][1])) as f:
            records[kind] = json.load(f)
    got, want = _both(suite, _write(tmp_path, records))
    assert got == want
    assert got[1] == []


def test_suites_keep_the_reference_tolerances_and_modes():
    assert list(port.SUITES) == list(ref.SUITES)
    for name, s in port.SUITES.items():
        r = ref.SUITES[name]
        assert (s.name, s.tolerance, s.mode) == (r.name, r.tolerance, r.mode)
    assert os.path.samefile(port.SUITES["accuracy"].baseline,
                            ref.SUITES["accuracy"].baseline)


BASE = {"up": {"value": 100.0, "higher_is_better": True},
        "down": {"value": 100.0, "higher_is_better": False},
        "zero": {"value": 0.0, "higher_is_better": True},
        "gone": {"value": 1.0, "higher_is_better": True}}


@pytest.mark.parametrize("mode,tol", [("relative", 0.3), ("absolute", 0.03),
                                      ("absolute", 40.0)])
@pytest.mark.parametrize("case", [
    {"up": (60.0, True), "down": (150.0, False)},      # regressions
    {"up": (140.0, True), "down": (60.0, False)},      # improvements
    {"up": (100.0, True), "down": (100.0, False)},     # inside
    {"up": (100.0, True), "zero": (5.0, True)},        # missing, ref 0
    {"up": (99.99, True), "down": (100.01, False), "zero": (-1.0, True),
     "new": (3.0, True)},
])
def test_compare_equals_reference(case, mode, tol):
    base = {"metrics": BASE}
    assert (port.compare(base, case, tol, mode)
            == ref.compare(base, case, tol, mode))


def test_refresh_refuses_violations_and_the_reference_baseline(tmp_path):
    bad = _stream()
    bad["hot_swap"]["carried"]["wrong"] = 1
    d = _write(tmp_path, {"stream": bad})
    with pytest.raises(SystemExit, match="refusing"):
        port.refresh(port.SUITES["stream"], str(tmp_path / "b.json"), d)
    with pytest.raises(SystemExit, match="reference"):
        port.refresh(port.SUITES["accuracy"], experiments=d)


def test_refresh_then_gate_passes(tmp_path, capsys):
    d = _write(tmp_path, {"stream": _stream(), "search": _search()})
    for suite in ("stream", "search"):
        path = port.refresh(port.SUITES[suite], str(tmp_path / f"{suite}.b"),
                            d)
        assert not port.run_suite(port.SUITES[suite], baseline_path=path,
                                  experiments=d)
    worse = _stream()
    for p in worse["scaling"]:
        p["p99_step_us"] *= 2
    d2 = tmp_path / "worse"
    d2.mkdir()
    assert port.run_suite(port.SUITES["stream"],
                          baseline_path=str(tmp_path / "stream.b"),
                          experiments=_write(d2, {"stream": worse}))
    assert "REGRESSION stream/scale64/p99_step_us" in capsys.readouterr().out
