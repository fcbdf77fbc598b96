"""Regression gates over the port's committed ``TORCH_*.json`` records, by
suite: the port's counterpart of ``benchmarks/check_regression.py``.

Each suite extracts metrics and contract violations from the port's
records exactly as the reference's suite does from its ``BENCH_*.json``
records, and compares the metrics with a baseline at the reference's
tolerance and mode:

  * ``throughput``: engine, mesh and backend timings from
    ``TORCH_lut_throughput.json`` and ``TORCH_lut_backends.json`` against
    ``TORCH_BENCH_baseline.json`` (relative, 30%); mesh or backend codes
    that differ are violations.
  * ``kernel``: streaming rows/s a backend and block from
    ``TORCH_lut_throughput.json`` against ``TORCH_KERNEL_baseline.json``
    (relative, 30%); ``fused`` not fastest at a block >= 256 is a
    violation.
  * ``accuracy``: each task's best frontier accuracy from
    ``TORCH_assembly_search_reduced.json`` against the reference's own
    ``ACC_baseline.json`` (absolute, 0.03: the port's accuracy rule);
    a frontier under the budget's ``min_frontier`` or an artifact not
    bit-identical after save/load is a violation.  ``--refresh`` leaves
    this baseline alone: it is the reference's.
  * ``fleet``: ``TORCH_fleet.json`` against ``TORCH_FLEET_baseline.json``
    (relative, 35%), the serving contract as violations.
  * ``stream``: ``TORCH_stream.json`` against
    ``TORCH_STREAM_baseline.json`` (relative, 35%); the contract is
    ``torch_stream_serving.contract_violations``, which the bench's own
    exit also uses.
  * ``search``: the ``dist_compare`` section of
    ``TORCH_assembly_search_reduced.json`` against
    ``TORCH_SEARCH_baseline.json`` (relative, 35%); survivors that differ,
    a wider-space point failing the RTL cross-check and no wider-space
    point anywhere are violations.
  * ``chaos``: ``TORCH_chaos.json`` against ``TORCH_CHAOS_baseline.json``
    (relative, 50%); the contract is ``torch_chaos_soak
    .contract_violations``.

A higher-is-better metric regresses below ``ref * (1 - tol)`` (``ref -
tol`` in absolute mode), a lower-is-better one above ``ref * (1 + tol)``;
a metric of the baseline that the records no longer produce fails; a new
one is reported and ignored until the baseline is refreshed.  The gate
touches no device: it reads JSON.

    python3 benchmarks/torch_check_regression.py
        [--suite throughput|kernel|accuracy|fleet|stream|search|chaos|all]
        [--refresh] [--tolerance T] [--baseline PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import Callable, Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
EXPERIMENTS = os.path.join(HERE, "..", "experiments")
BASELINE = os.path.join(EXPERIMENTS, "TORCH_BENCH_baseline.json")
KERNEL_BASELINE = os.path.join(EXPERIMENTS, "TORCH_KERNEL_baseline.json")
ACC_BASELINE = os.path.join(EXPERIMENTS, "ACC_baseline.json")
FLEET_BASELINE = os.path.join(EXPERIMENTS, "TORCH_FLEET_baseline.json")
STREAM_BASELINE = os.path.join(EXPERIMENTS, "TORCH_STREAM_baseline.json")
SEARCH_BASELINE = os.path.join(EXPERIMENTS, "TORCH_SEARCH_baseline.json")
CHAOS_BASELINE = os.path.join(EXPERIMENTS, "TORCH_CHAOS_baseline.json")
# the records each suite reads
THROUGHPUT = "TORCH_lut_throughput.json"
BACKENDS = "TORCH_lut_backends.json"
SEARCH = "TORCH_assembly_search_reduced.json"
FLEET = "TORCH_fleet.json"
STREAM = "TORCH_stream.json"
CHAOS = "TORCH_chaos.json"
SCHEMA_VERSION = 1

Metrics = Dict[str, Tuple[float, bool]]  # name -> (value, higher_is_better)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Per-suite metric extraction (a missing record raises FileNotFoundError:
# the gate must not pass because a bench did not run)
# ---------------------------------------------------------------------------

def extract_throughput(experiments: str = EXPERIMENTS
                       ) -> Tuple[Metrics, List[str]]:
    """Engine rows/s by depth, the best async speedup at block >= 256, mesh
    rows/s, backend µs; codes that differ are violations."""
    metrics: Metrics = {}
    violations: List[str] = []

    tp = _load(os.path.join(experiments, THROUGHPUT))
    for c in tp["engine"]:
        stem = f"engine/{c['backend']}/block{c['block']}"
        for mode in ("sync", "async"):
            metrics[f"{stem}/{mode}_rows_per_s"] = (
                c[mode]["rows_per_s"], True)
    # one aggregate ratio, not per-cell ratios (which amplify noise)
    big = [c["async_speedup"] for c in tp["engine"] if c["block"] >= 256]
    if big:
        metrics["engine/best_async_speedup_block_ge_256"] = (max(big), True)
    for c in tp["mesh"]:
        stem = f"mesh/{c['backend']}/x{c['mesh']}"
        metrics[f"{stem}/rows_per_s"] = (c["rows_per_s"], True)
        if not c["bit_identical"]:
            violations.append(f"{stem}: mesh-sharded codes not bit-identical")

    bk = _load(os.path.join(experiments, BACKENDS))
    for task, t in bk["tasks"].items():
        for cell in t["cells"]:
            for name, us in cell["us"].items():
                metrics[f"backends/{task}/batch{cell['batch']}/{name}_us"] = (
                    us, False)
            for name, ok in cell["bit_identical"].items():
                if not ok:
                    violations.append(
                        f"backends/{task}/batch{cell['batch']}/{name}: "
                        "not bit-identical")
    return metrics, violations


def extract_kernel(experiments: str = EXPERIMENTS
                   ) -> Tuple[Metrics, List[str]]:
    """Streaming rows/s a backend and block; ``fused`` not fastest (at the
    bench's ``NOISE_FLOOR``) at a block >= 256 is a violation."""
    metrics: Metrics = {}
    violations: List[str] = []
    tp = _load(os.path.join(experiments, THROUGHPUT))
    for c in tp["kernel"]:
        metrics[f"kernel/{c['backend']}/block{c['block']}"
                "/stream_rows_per_s"] = (c["rows_per_s"], True)
        if (c["backend"] == "fused" and c["block"] >= 256
                and not c["fused_fastest"]):
            violations.append(
                f"kernel/fused/block{c['block']}: fused cascade is not the "
                "fastest backend at a serving block size")
    return metrics, violations


def extract_accuracy(experiments: str = EXPERIMENTS
                     ) -> Tuple[Metrics, List[str]]:
    """Best frontier accuracy a task; a frontier under the budget's
    ``min_frontier`` and a backend not bit-identical after save/load are
    violations."""
    metrics: Metrics = {}
    violations: List[str] = []
    doc = _load(os.path.join(experiments, SEARCH))
    min_frontier = doc.get("budget", {}).get("min_frontier", 3)
    for task, t in doc["tasks"].items():
        metrics[f"accuracy/{task}/best_frontier_acc"] = (
            t["best_accuracy"], True)
        if t["frontier_points"] < min_frontier:
            violations.append(
                f"accuracy/{task}: frontier has {t['frontier_points']} < "
                f"{min_frontier} points")
        for point, per_backend in t.get("bit_identical", {}).items():
            for backend, ok in per_backend.items():
                if not ok:
                    violations.append(
                        f"accuracy/{task}/{point}: {backend} not "
                        "bit-identical after save/load")
    return metrics, violations


def extract_fleet(experiments: str = EXPERIMENTS
                  ) -> Tuple[Metrics, List[str]]:
    """Online and offline rows/s, the online speedup, each tenant's p99;
    the serving contract (bit-identity, hot swap, admission) as
    violations."""
    metrics: Metrics = {}
    violations: List[str] = []
    doc = _load(os.path.join(experiments, FLEET))

    on, off = doc["online"], doc["offline"]
    metrics["fleet/online/fleet_rows_per_s"] = (on["fleet_rows_per_s"], True)
    metrics["fleet/online/isolated_sync_rows_per_s"] = (
        on["isolated_sync_rows_per_s"], True)
    metrics["fleet/offline/fleet_rows_per_s"] = (
        off["fleet_rows_per_s"], True)
    metrics["fleet/online/speedup_vs_isolated_sync"] = (
        on["speedup_vs_isolated_sync"], True)

    for t in doc["per_tenant"]:
        if not t["bit_identical"]:
            violations.append(
                f"fleet/{t['model_id']}: fleet-served codes not "
                "bit-identical to the artifact's reference")
        metrics[f"fleet/{t['model_id']}/p99_request_us"] = (
            t["p99_request_us"], False)
    hs = doc["hot_swap"]
    if not hs["good_deploy_ok"]:
        violations.append("fleet/hot_swap: good deploy did not land")
    if hs["dropped"]:
        violations.append(
            f"fleet/hot_swap: {hs['dropped']} requests dropped")
    if hs["wrong"]:
        violations.append(
            f"fleet/hot_swap: {hs['wrong']} wrong answers served")
    if not hs["corrupt_deploy_rejected"]:
        violations.append(
            "fleet/hot_swap: corrupted artifact was NOT rejected")
    if not hs["rollback_recorded"]:
        violations.append(
            "fleet/hot_swap: rejection missing from swap history")
    if doc["admission"]["shed"] <= 0:
        violations.append(
            "fleet/admission: over-budget burst shed nothing")
    return metrics, violations


def extract_stream(experiments: str = EXPERIMENTS
                   ) -> Tuple[Metrics, List[str]]:
    """Steps/s and p99 step µs a scale point, keyed by its stream count as
    the reference keys them (where a scale has a point per backend, the
    later point's figures stand); the contract is the bench's own."""
    import torch_stream_serving

    metrics: Metrics = {}
    doc = _load(os.path.join(experiments, STREAM))
    for p in doc["scaling"]:
        stem = f"stream/scale{p['streams']}"
        metrics[f"{stem}/steps_per_s"] = (p["steps_per_s"], True)
        metrics[f"{stem}/p99_step_us"] = (p["p99_step_us"], False)
    return metrics, torch_stream_serving.contract_violations(doc)


def extract_chaos(experiments: str = EXPERIMENTS
                  ) -> Tuple[Metrics, List[str]]:
    """Recovery p99 a scenario (clamped to 25 ms: shorter recoveries are
    scheduler noise), the degraded/clean ratio, failover recovery ms and
    replayed steps a backend, the soak's recovery p99; the contract is the
    bench's own."""
    import torch_chaos_soak

    floor_ms = 25.0
    metrics: Metrics = {}
    doc = _load(os.path.join(experiments, CHAOS))
    for name, sc in doc["scenarios"].items():
        if sc["recovery_p99_ms"] > 0:
            metrics[f"chaos/{name}/recovery_p99_ms"] = (
                max(sc["recovery_p99_ms"], floor_ms), False)
    metrics["chaos/degraded/throughput_ratio"] = (
        doc["degraded"]["throughput_ratio"], True)
    for be, r in doc["stream_failover"].items():
        metrics[f"chaos/failover/{be}/recovery_ms"] = (
            max(r["recovery_ms"], floor_ms), False)
        metrics[f"chaos/failover/{be}/replayed_steps"] = (
            float(r["replayed_steps"]), True)
    if doc["soak"]["recovery_p99_ms"] > 0:
        metrics["chaos/soak/recovery_p99_ms"] = (
            max(doc["soak"]["recovery_p99_ms"], floor_ms), False)
    return metrics, torch_chaos_soak.contract_violations(doc)


def extract_search(experiments: str = EXPERIMENTS
                   ) -> Tuple[Metrics, List[str]]:
    """Frontier size and best accuracy a task and the sliced-vs-single
    speedup; survivors that differ, a wider-space point off the RTL
    calibration and no wider-space point at all are violations."""
    metrics: Metrics = {}
    violations: List[str] = []
    doc = _load(os.path.join(experiments, SEARCH))
    dc = doc.get("dist_compare")
    if not dc:
        raise SystemExit(
            f"{SEARCH} has no dist_compare section; run "
            "benchmarks/torch_assembly_search.py --dist-compare first")
    wider_anywhere = False
    for task, t in dc["tasks"].items():
        st = doc["tasks"][task]
        metrics[f"search/{task}/frontier_points"] = (
            float(st["frontier_points"]), True)
        metrics[f"search/{task}/best_frontier_acc"] = (
            st["best_accuracy"], True)
        if not t["survivors_match"]:
            violations.append(
                f"search/{task}: sharded rung survivors differ from the "
                "single-device run")
        for p in st["frontier"]:
            if p.get("additive") or p.get("learned_beta"):
                wider_anywhere = True
                if abs(p["calibration"] - 1.0) > 0.05:
                    violations.append(
                        f"search/{task}/{p['name']}: wider-space point "
                        f"fails the RTL cross-check "
                        f"(calibration {p['calibration']})")
    metrics["search/dist/speedup"] = (dc["speedup"], True)
    if not wider_anywhere:
        violations.append(
            "search: no frontier point uses an additive unit or learned "
            "beta — the wider space collapsed out of the search")
    return metrics, violations


# ---------------------------------------------------------------------------
# Suites
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Suite:
    name: str
    extract: Callable[..., Tuple[Metrics, List[str]]]
    baseline: str
    tolerance: float
    mode: str  # "relative" | "absolute"
    refreshable: bool = True   # False: the baseline is the reference's


SUITES: Dict[str, Suite] = {
    "throughput": Suite("throughput", extract_throughput, BASELINE,
                        tolerance=0.30, mode="relative"),
    "kernel": Suite("kernel", extract_kernel, KERNEL_BASELINE,
                    tolerance=0.30, mode="relative"),
    "accuracy": Suite("accuracy", extract_accuracy, ACC_BASELINE,
                      tolerance=0.03, mode="absolute", refreshable=False),
    "fleet": Suite("fleet", extract_fleet, FLEET_BASELINE,
                   tolerance=0.35, mode="relative"),
    "stream": Suite("stream", extract_stream, STREAM_BASELINE,
                    tolerance=0.35, mode="relative"),
    "search": Suite("search", extract_search, SEARCH_BASELINE,
                    tolerance=0.35, mode="relative"),
    "chaos": Suite("chaos", extract_chaos, CHAOS_BASELINE,
                   tolerance=0.50, mode="relative"),
}


def compare(baseline: dict, metrics: Metrics, tolerance: float,
            mode: str = "relative"):
    """Returns (regressions, missing, improved) against
    ``baseline['metrics']``: beyond ``ref * (1 ± tol)`` in relative mode,
    ``ref ± tol`` in absolute mode; a relative metric whose reference is 0
    is not compared."""
    regressions, missing, improved = [], [], []
    base = baseline["metrics"]
    for name, entry in base.items():
        if name not in metrics:
            missing.append(name)
            continue
        ref = entry["value"]
        cur, hib = metrics[name]
        if mode == "relative":
            if ref == 0:
                continue
            lo, hi = ref * (1.0 - tolerance), ref * (1.0 + tolerance)
        else:
            lo, hi = ref - tolerance, ref + tolerance
        if hib and cur < lo:
            regressions.append((name, ref, cur))
        elif not hib and cur > hi:
            regressions.append((name, ref, cur))
        elif (cur > hi) if hib else (cur < lo):
            improved.append((name, ref, cur))
    return regressions, missing, improved


def refresh(suite: Suite, path: str = None,
            experiments: str = EXPERIMENTS) -> str:
    """Rewrite the suite's baseline from the records; refuses a record with
    contract violations and the reference's accuracy baseline."""
    if not suite.refreshable and path is None:
        raise SystemExit(
            f"the {suite.name} baseline ({os.path.relpath(suite.baseline)})"
            " is the reference's and is not rewritten")
    metrics, violations = suite.extract(experiments)
    if violations:
        raise SystemExit(
            "refusing to bake invariant violations into the baseline:\n  "
            + "\n  ".join(violations))
    doc = {
        "schema_version": SCHEMA_VERSION,
        "suite": suite.name,
        "metrics": {name: {"value": v, "higher_is_better": hib}
                    for name, (v, hib) in sorted(metrics.items())},
    }
    path = os.path.abspath(path or suite.baseline)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    return path


def run_suite(suite: Suite, tolerance: float = None,
              baseline_path: str = None,
              experiments: str = EXPERIMENTS) -> bool:
    """Gate one suite; prints the report, returns True when it failed."""
    tolerance = suite.tolerance if tolerance is None else tolerance
    baseline_path = baseline_path or suite.baseline
    if not os.path.exists(baseline_path):
        raise SystemExit(
            f"no baseline at {baseline_path}; run with --refresh after the "
            "sweeps to create one")
    baseline = _load(baseline_path)
    if baseline.get("schema_version") != SCHEMA_VERSION:
        raise SystemExit(
            f"baseline schema {baseline.get('schema_version')} != expected "
            f"{SCHEMA_VERSION}; refresh the baseline")
    if baseline.get("suite", suite.name) != suite.name:
        raise SystemExit(
            f"{baseline_path} holds suite {baseline.get('suite')!r}, not "
            f"{suite.name!r}")

    metrics, violations = suite.extract(experiments)
    regressions, missing, improved = compare(baseline, metrics, tolerance,
                                             suite.mode)
    tol_txt = (f"+-{tolerance:.0%}" if suite.mode == "relative"
               else f"+-{tolerance:g} abs")
    for name, ref, cur in improved:
        print(f"IMPROVED   {name}: {ref:g} -> {cur:g}")
    new = sorted(set(metrics) - set(baseline["metrics"]))
    for name in new:
        print(f"NEW        {name}: {metrics[name][0]:g} "
              "(ignored until baseline refresh)")

    failed = False
    for v in violations:
        print(f"VIOLATION  {v}")
        failed = True
    for name in missing:
        print(f"MISSING    {name}: in baseline but not produced by sweeps")
        failed = True
    for name, ref, cur in regressions:
        direction = "down" if cur < ref else "up"
        print(f"REGRESSION {name}: {ref:g} -> {cur:g} "
              f"({direction}, tol {tol_txt})")
        failed = True

    checked = len(baseline["metrics"]) - len(missing)
    print(f"[{suite.name}] checked {checked} metrics vs "
          f"{os.path.relpath(baseline_path)} ({tol_txt}): "
          f"{len(regressions)} regressions, {len(violations)} violations, "
          f"{len(missing)} missing, {len(improved)} improved, {len(new)} new")
    if not failed:
        print(f"{suite.name} gate: OK")
    return failed


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--suite", default="throughput",
                    choices=[*SUITES, "all"],
                    help="which regression suite to gate (default: "
                         "throughput)")
    ap.add_argument("--refresh", action="store_true",
                    help="rewrite the suite's baseline from the records "
                         "(all: every suite but accuracy)")
    ap.add_argument("--tolerance", type=float, default=None,
                    help="override the suite's default tolerance "
                         "(relative fraction or absolute, per suite mode)")
    ap.add_argument("--baseline", default=None,
                    help="override the suite's baseline path "
                         "(single suite only)")
    args = ap.parse_args()

    suites = list(SUITES.values()) if args.suite == "all" \
        else [SUITES[args.suite]]
    if args.baseline and len(suites) > 1:
        raise SystemExit("--baseline requires a single --suite")
    if args.tolerance is not None and len(suites) > 1:
        # one number cannot serve a relative AND an absolute suite
        raise SystemExit("--tolerance requires a single --suite")

    if args.refresh:
        for s in suites:
            if s.refreshable or args.baseline:
                print(f"baseline refreshed: {refresh(s, args.baseline)}")
            else:
                print(f"baseline kept: {os.path.relpath(s.baseline)} is the "
                      "reference's")
        return

    failed = False
    for s in suites:
        failed |= run_suite(s, tolerance=args.tolerance,
                            baseline_path=args.baseline)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
