"""Quickstart on the port: the full NeuraLUT-Assemble toolflow in one
script (the counterpart of ``examples/quickstart.py``).

One ``Toolflow`` drives the paper's phases end to end (dense pre-train with
the hardware-aware regularizer -> structured pruning -> sparse retrain ->
exhaustive fold, K4 on the card), producing a ``CompiledLUTNetwork`` that
is planned onto every registered lookup backend (``compile_backend``;
``fused`` runs the whole cascade in one kernel launch, K1 or K2, and
``pallas`` one K3 launch a layer), saved with its plans, reloaded,
verified bit-exact, costed with the FPGA model and emitted as Verilog.
Then the hardware-aware assembly search, three of its frontier artifacts
served as tenants of one ``LUTFleet`` (registry, SLOs, a hot swap), a
SeqMNIST recurrent cell trained with truncated BPTT and streamed
statefully through the fleet across a mid-stream hot swap, the fused
cascade autotuned on this machine, and the assembly search again, sliced
over a slot mesh (``launch.mesh.make_serving_mesh``; on one card the
slots share it) whose rung survivors equal the sequential run's.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on CUDA unless ``--device`` says else.  Writes its artifacts and
Verilog next to this file (``examples/torch_*.npz``, ``*.v``).
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import numpy as np
import torch

from repro_torch import backends
from repro_torch import device as _device
from repro_torch.configs import paper_tasks
from repro_torch.core import dontcare
from repro_torch.data import synthetic
from repro_torch.pipeline import CompiledLUTNetwork, Toolflow
from repro_torch.search import SearchBudget
from repro_torch.serve.lut_engine import LUTEngine

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path (default: the card)")
    args = ap.parse_args()
    dev = _device.resolve(args.device)
    t_start = time.perf_counter()

    cfg = paper_tasks.reduced("nid")
    data = synthetic.load("nid", n_train=8192, n_test=2048)
    print(f"== NID surrogate: {data.x_train.shape[1]} one-bit inputs, "
          f"{len(data.x_train)} train rows, on {dev}")

    flow = Toolflow(cfg, pretrain_steps=120, retrain_steps=250, lasso=1e-4,
                    sgdr_t0=100, device=dev)

    print("== phase 1: dense pre-training with group-lasso (hardware-aware)")
    flow.pretrain(data).prune()
    cov = flow.stages["prune"].metrics["coverage"]
    print(f"   learned mappings cover {cov[0] * 100:.0f}% of inputs at L0")

    print("== phase 2: sparse retraining with learned mappings")
    flow.retrain()
    acc = flow.accuracy()
    print(f"   quantized accuracy: {acc * 100:.2f}%")

    print("== phase 3: compiling into the L-LUT artifact")
    compiled = flow.compile()
    acc_f = flow.accuracy(folded=True)
    print(f"   folded accuracy:    {acc_f * 100:.2f}%  "
          f"(bit-exact: {abs(acc - acc_f) < 1e-12})")
    print(f"   total L-LUT entries: {compiled.num_entries()}")

    x = np.asarray(data.x_test[:256], np.float32)
    print("== phase 3b: planning lookup backends (repro_torch.backends "
          "registry)")
    ref = compiled.predict_codes(x).cpu().numpy()
    for name in backends.available():
        ex = compiled.compile_backend(name)   # reusable planned executor
        same = bool(np.array_equal(ex.predict_codes(x).cpu().numpy(), ref))
        print(f"   backend {name:>7}: fused={ex.capabilities.fused!s:>5}  "
              f"bit-identical: {same}")
    fused_plan = compiled.compile_backend("fused").plan
    print(f"   fused plan: tables packed to {fused_plan.meta['table_dtype']}"
          f", {fused_plan.meta['vmem_bytes']} B resident, one kernel "
          f"launch for {len(fused_plan.meta['layers'])} layers")

    path = os.path.join(HERE, "torch_nid_assemble.npz")
    compiled.save(path)                       # plans ride along in the .npz
    reloaded = CompiledLUTNetwork.load(path, device=dev)
    same = bool(np.array_equal(compiled.predict_codes(x).cpu().numpy(),
                               reloaded.predict_codes(x).cpu().numpy()))
    print(f"   saved + reloaded {path} (round-trip bit-exact: {same}; "
          f"pre-planned: {sorted(reloaded._plans)})")
    eng = LUTEngine(reloaded, block=64, backend="fused")
    served = eng.run(x[:100])
    direct = reloaded.predict(x[:100]).cpu().numpy()
    print(f"   micro-batching engine: {eng.stats.ticks} ticks, "
          f"{eng.stats.rows_padded} padded rows, serve==predict: "
          f"{bool(np.allclose(served, direct))}")

    print("== phase 4: hardware report (xcvu9p model) + RTL")
    for pe in (1, 3):
        r = compiled.hw_report(pipeline_every=pe)
        print(f"   pipeline_every={pe}: {r.luts} LUTs, {r.ffs} FFs, "
              f"Fmax {r.fmax_mhz:.0f} MHz, latency {r.latency_ns:.2f} ns, "
              f"area-delay {r.area_delay:.0f} LUTxns")
    dc = dontcare.analyze(compiled.folded(), data.x_train[:2048])
    print(f"   don't-care pass: {dc.structural_luts} -> "
          f"{dc.optimized_luts} LUTs ({dc.lut_reduction:.2f}x; the paper's "
          f"ref [20] direction — explains Vivado's measured-vs-structural "
          f"gap)")
    out = os.path.join(HERE, "torch_nid_assemble.v")
    with open(out, "w") as f:
        f.write(compiled.to_verilog(pipeline_every=3))
    print(f"   wrote {out}")

    print("== phase 5: hardware-aware assembly search (DESIGN.md §8)")
    # Search the (fan-in, widths, depth, beta, skips) space around the base
    # design and get back the accuracy/area-delay Pareto frontier, each
    # point a deployable artifact.  The smoke budget keeps this short.
    result = Toolflow.search("nid_reduced", SearchBudget.smoke(), device=dev)
    print(f"   {len(result.evaluated)} candidates "
          f"({len(result.rejected)} rejected by validity rules), "
          f"{len(result.promoted)} fully trained, "
          f"{len(result.frontier)}-point frontier in {result.seconds:.0f}s:")
    print(f"   {'point':>10} {'acc':>6} {'LUTs':>6} {'ADP':>9} (calibrated)")
    for p in result.frontier:
        print(f"   {p.name:>10} {p.accuracy:6.3f} {p.luts:6d} {p.adp:9.1f}")
    best_path = os.path.join(HERE, "torch_nid_frontier_best.npz")
    result.frontier[0].compiled.save(best_path)
    print(f"   saved the most accurate frontier artifact to {best_path}")

    print("== phase 6: multi-tenant fleet serving (DESIGN.md §9)")
    # Serve several frontier artifacts from ONE process: each Pareto point
    # becomes a tenant with its own version history and SLO, scheduled with
    # continuous cross-tenant batching over a shared in-flight budget.
    from repro_torch.serve import LUTFleet, TenantSLO, make_reference

    import traffic

    points = result.frontier[:3]
    fleet = LUTFleet(block=64, depth=2, device=dev)
    for p in points:
        fleet.register(p.name, p.compiled,
                       reference=make_reference(p.compiled),
                       slo=TenantSLO(max_queue=4096, policy="shed"))
    ids = [p.name for p in points]
    trace = traffic.ragged_trace(ids, n_events=30, seed=0)
    inputs = traffic.make_inputs(
        trace, {p.name: p.compiled.cfg.in_features for p in points}, seed=1)
    for ev, xs in zip(trace, inputs):
        fleet.submit_many(ev.model_id, xs)
        fleet.tick()
    fleet.pump()
    for p in points:
        s = fleet.summary(p.name)
        print(f"   tenant {p.name:>10}: v{s['version']} "
              f"{s['completed']} rows, {s['ticks']} blocks, "
              f"p99 {s['p99_request_us'] / 1e3:.1f} ms, shed {s['shed']}")
    # zero-downtime hot swap: redeploy the best artifact from its .npz
    # mid-stream — the smoke check gates it, the lane adopts v2 seamlessly
    rng = np.random.default_rng(2)
    live = rng.uniform(-1.0, 1.0, (100, points[0].compiled.cfg.in_features)
                       ).astype(np.float32)
    fleet.submit_many(ids[0], live)
    event = fleet.deploy(ids[0], best_path,
                         reference=make_reference(points[0].compiled))
    fleet.pump()
    s = fleet.summary(ids[0])
    print(f"   hot swap {ids[0]}: ok={event.ok} v{event.from_version}->"
          f"v{event.to_version}, queue drained to {s['queue_depth']}, "
          f"history={len(s['swap_history'])} event(s)")

    print("== phase 7: streaming SeqMNIST through the fleet (DESIGN.md §10)")
    # A sequential task: 784 binarized pixels fed 16 per step through an
    # assembled-LUT recurrent cell (8 state codes cross the step boundary),
    # trained with truncated BPTT and served STATEFULLY — the fleet keeps
    # each stream's state codes between steps and migrates them across a
    # mid-stream version swap.
    seq = paper_tasks.stream_task_data("seqmnist_reduced", n_train=512,
                                       n_test=64, device=dev)
    cell_cfg = paper_tasks.stream_task_config("seqmnist_reduced")
    sflow = Toolflow(cell_cfg, pretrain_steps=40, retrain_steps=80,
                     batch_size=64, tbptt=7, device=dev)
    cell = sflow.run(seq)
    print(f"   last-step accuracy (smoke budget): fake-quant "
          f"{sflow.accuracy(max_eval=64):.3f}, folded "
          f"{sflow.accuracy(folded=True, max_eval=64):.3f}")

    sfleet = LUTFleet(block=32, depth=2, device=dev)
    sfleet.register("seqmnist", cell)
    xs = seq.x_test[:8]
    for sid in range(len(xs)):
        sfleet.open_stream("seqmnist", sid)
        sfleet.submit_stream("seqmnist", sid, xs[sid, :25])
    sfleet.tick()                                 # steps in flight on v1
    cell_path = os.path.join(HERE, "torch_seqmnist_cell.npz")
    cell.save(cell_path)
    event = sfleet.deploy("seqmnist", cell_path)  # stateful hot swap
    for sid in range(len(xs)):
        sfleet.submit_stream("seqmnist", sid, xs[sid, 25:])
    sfleet.pump()
    ref = cell.predict_sequence(xs)[0].cpu().numpy()
    identical = True
    for sid in range(len(xs)):
        sess = sfleet.close_stream("seqmnist", sid)
        identical &= bool(np.array_equal(sess.codes(), ref[sid]))
    s = sfleet.summary("seqmnist")
    print(f"   {len(xs)} live streams hot-swapped v{event.from_version}->"
          f"v{event.to_version} (state "
          f"{s['swap_history'][-1]['state_migration']}), "
          f"{s['completed']}/{s['requests']} steps served, "
          f"streamed == offline: {identical}")

    print("== phase 8: autotuning the fused cascade (docs/PERF_TUNING.md)")
    # Every fused plan carries a KernelTuning: fresh plans get the roofline
    # model's pick (source="default"); autotune_plan measures the candidate
    # grid on THIS machine and stamps the winner into the plan, where it
    # survives save/load inside the artifact.
    fused = backends.get("fused")
    t0 = fused_plan.meta["tuning"]
    tuned_plan = fused.autotune_plan(compiled.compile_backend("fused").plan,
                                     rows=1024, reps=2, device=dev)
    t1 = tuned_plan.meta["tuning"]
    report = tuned_plan.meta["tuning_report"]
    print(f"   default (roofline): mode={t0['mode']} block_b={t0['block_b']}"
          f"  ->  measured: mode={t1['mode']} block_b={t1['block_b']} "
          f"impl={t1['impl']} ({len(report)} candidates timed)")
    cin = torch.from_numpy(np.random.default_rng(3).integers(
        0, fused_plan.meta["input_span"],
        (64, cfg.in_features)).astype(np.int32)).to(dev)
    same = bool(torch.equal(fused.run(tuned_plan, cin),
                            fused.run(fused_plan, cin)))
    print(f"   tuned plan bit-identical: {same} "
          f"(tuning changes WHERE the cascade runs, never WHAT it returns)")

    print("== phase 9: sharded assembly search (DESIGN.md §8)")
    # The phase-5 search also runs SLICED: each shape group's stacked
    # population is split into contiguous slices, and a slot mesh spreads
    # the slices over devices (a worker thread and a stream a slot) with
    # straggler-aware rung promotion and elastic remesh.  Slicing is what
    # fixes the slice programs, so the mesh and a sequential run pick
    # bit-identical rung survivors (tests/test_torch_search.py).  On one
    # card the slots share it.  The wider space rides along: "add2"
    # candidates are PolyLUT-Add additive units, "lbeta" learns per-layer
    # bit-widths.
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.search import DistributedSearchBudget, run_search

    budget = DistributedSearchBudget.from_budget(
        dataclasses.replace(SearchBudget.smoke(), rungs=(8,), promote=1,
                            min_frontier=1, max_promote_extra=0,
                            pretrain_steps=16, retrain_steps=24),
        population_slices=4)
    slots = max(2, torch.cuda.device_count() if dev.type == "cuda" else 0)
    mesh = make_serving_mesh(slots=slots,
                             device=None if dev.type == "cuda" else dev)
    sharded = run_search("nid_reduced", budget, mesh=mesh)
    d = sharded.dist
    print(f"   engine: mode={d['mode']} slices={d['slices']} "
          f"slots={d['devices']} stragglers={len(d['straggler_events'])} "
          f"remeshes={len(d['remesh_events'])}")
    for rung in sharded.rungs:
        print(f"   rung @{rung['steps']} steps -> survivors: "
              f"{', '.join(rung['survivors'])}")
    top = sharded.frontier[0]
    print(f"   promoted {top.name}: acc={top.accuracy:.3f} "
          f"LUTs={top.luts} (same survivors on any mesh width)")
    print(f"== all nine phases in {time.perf_counter() - t_start:.1f} s "
          f"on {dev}")


if __name__ == "__main__":
    main()
