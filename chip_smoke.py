#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``src/repro_torch``, holds
each against its plain PyTorch version on the card at the main paths'
shapes, and drives both main paths:

* serving (slice 1): full-width ``mnist`` (fused backend, streamed kernel
  K2, split over a thread-block cluster since slice 6) and full ``nid``
  (fused backend, resident kernel K1; per-layer ``pallas`` backend, lookup
  kernel K3) from a saved and reloaded artifact
  through ``LUTEngine``, with random tables drawn with
  ``numpy.random.RandomState(seed)``;
* the toolflow (slices 2 and 5): full-width ``mnist`` pre-trained dense,
  pruned, re-trained and folded through the per-unit affine K4 (its dense
  and per-unit routes and the dense dx reduction, each held bit for bit
  against K4's first kernel), then saved, reloaded and served; one training
  step on the card against the CPU; ``nid_reduced`` trained to the
  reference test's accuracy gate;
* LM serving (slice 3): full-width ``gemma-2b`` (random bf16 weights from
  ``torch.Generator("cuda").manual_seed(seed)``) serving six requests on
  four slots through ``ServeEngine``, every layer's prefill attention
  through K5's wgmma kernel (slice 4); decode against prefill on the card,
  and a 2-layer f32 cut of it (K5's TF32 kernel, slice 6) on the card
  against the CPU;
* stream serving and the hardware surfaces (slice 8): the recurrent
  ``seqmnist_reduced`` cell trained on the card through
  ``Toolflow(cell, tbptt=8)`` (K4), folded, saved and reloaded, then 1,024
  concurrent streams x 49 steps served through ``StreamRouter`` on the
  ``fused`` (K1) and ``pallas`` (K3) backends, every stream against the
  offline scan on the card and the CPU; ``hw_report``, ``to_verilog``,
  ``count_luts``, ``calibration_vs_rtl`` and ``dontcare.analyze`` of the
  card-folded ``mnist`` artifact, its Verilog against a CPU load's;
* the serving tier (slice 9): four tenants (``nid``, ``jsc_openml``,
  ``mnist`` on ``fused``, K1/K2; ``nid`` again on ``pallas``, K3) served
  from saved artifacts through one ``LUTFleet`` on a ragged trace, every
  tenant against ``take`` on the card and a CPU load; a hot swap to the
  card-trained ``mnist`` artifact under load and a corrupted candidate
  rolled back; ``nid`` batch-split (K1) and units-split (K3) over 2 device
  slots; one fault scenario per class through ``FaultInjector``; stream
  failover of the phase-8 cell through ``ReplicatedStreamTenant``;
* the assembly search (slice 10): K4's per-unit route at a stacked
  population of ``mnist`` candidates (one launch a stage for the whole
  group), one population step on the card against the CPU, the idle
  share of a rung's steps, ``Toolflow.search("nid")`` on the default
  budget with every frontier artifact served on ``take``, ``fused`` (K1)
  and ``pallas`` (K3) against a CPU load, and ``nid_reduced``'s rungs over
  2 device slots against the sequential run, with a straggling and a lost
  slot;
* the remaining LM families (slice 11): hymba-1.5b (32 layers) and
  rwkv6-7b (32 layers) at full width and depth, mixtral-8x22b cut to 2
  layers and dbrx-132b to 1 (memory), each served on four slots through
  ``ServeEngine`` with K5's wgmma kernel in every attention prefill and
  decode against prefill; a folded 4,104-wide stream cell in the WKV slot
  of an rwkv6-7b block (1,024 streams x 49 steps on ``fused``, K1, and
  ``pallas``, K3) against the offline scan on the card and the CPU; the
  ``rwkv_mix_reduced`` trunk on the card against the CPU; whisper-small
  (12 + 12 layers, 1,536 frames) encoded, prefilled and decoded with K5
  non-causal, causal and cross at Sq = 1; a 2-layer f32 cut of each family
  (K5's TF32 kernel) against the CPU; every K5 layout the paths launched
  held against the plain version, and K5 alone at each new layout beside
  SDPA;
* LM training (slice 12): full-width, full-depth gemma-2b (f32 masters
  drawn on the card, bf16 compute, remat, the chunked loss) trained 5
  steps through ``train/loop.run`` on ``tokens.SyntheticCorpus`` batches
  of 4 x 1,024, with K5's wgmma kernel in every forward and remat
  recompute (36 launches a step) and a plain backward; whisper-small
  trained through the CLI (``launch.train``); K5 at those layouts held
  against the plain version, its gradient against ``mha_ref``'s, timed
  beside SDPA; one f32 smoke train step of gemma-2b, mixtral-8x22b,
  rwkv6-7b, hymba-1.5b and whisper-small on the card against the CPU; a
  failure injected into a checkpointed run replayed to the uninterrupted
  run's state, and the card's checkpoint restored on the CPU; the folded
  LUT router example (``examples/torch_lut_router_moe.py``);
* distribution and the dry run (slice 13): full-width gemma-2b trained 2
  steps through ``launch.steps.build_cell``'s meshed train step on a
  one-rank NCCL (1, 1) ``DeviceMesh`` (``DTensor`` parameters and moments
  placed by ``dist.sharding``, K5 36 times a step, held against the plain
  version; losses against phase 12's unmeshed steps); whisper-small
  through ``launch.train --mesh 1,1``; ``dist.compress`` of a gemma-2b
  gradient leaf on the card against the CPU, and ``compressed_psum`` on a
  one-rank group; tensor parallelism (slice 15): full-width gemma-2b
  trained 2 steps through ``build_cell``'s train step on a ``(data,
  model) = (1, 2)`` mesh of two processes of this script on the one card
  (a gloo group between them), each block on its weight shards, K5 36
  times a step a rank at 4 of the 8 heads, held against the plain version
  and timed beside SDPA, losses and grad norms against phase 12's beside
  bf16's summation-order floor, each rank's peak memory; a 1,024-token
  prefill at the same mesh against the unmeshed prefill; the dry run
  (``launch.dryrun``, torch's fake process group, meta ``DTensor``s) of
  gemma-2b ``train_4k`` on 16 x 16 and mixtral-8x22b ``decode_32k`` on 2 x
  16 x 16 in a subprocess;
* the autotuner's measurement path (slice 14): ``autotune_plan`` on the
  fused plans of phase 4's ``nid`` (K1) and ``mnist`` (K2) artifacts at
  2,048 rows, each distinct launch of the grid (K1, or K2 on one cluster
  plan) timed once and counted;
  the measured plans saved, reloaded with ``source == "measured"`` and
  served against ``take`` on a held-out batch;
* the paper's tables (slice 17): Table IV of
  ``benchmarks/torch_paper_tables.py`` at the reference's budget (four
  trainings on ``nid``: the Assemble flow and the LogicNets-, NeuraLUT-
  and PolyLUT-style baselines, K4 at their layouts, the PolyLUT monomials
  among them), every folded artifact served on ``fused`` (K1) and
  ``pallas`` (K3) against ``take`` and a CPU load, the ``hwcost`` columns
  of Tables III and IV and Fig. 2 against the reference's record
  (``experiments/TORCH_paper_tables_reference.json``), every K4 layout
  held against the plain version and the reference kernel;
* the serving benches and their gate (slice 18): ``benchmarks/
  torch_lut_backends.py`` (every backend on the reduced ``mnist``,
  ``jsc`` and ``nid`` against ``take``), ``torch_lut_throughput.py``
  (kernel stream, engine depth 1 against 2, batch placement over 1, 2 and
  4 slots of the card) and both stateful hot swaps of
  ``torch_stream_serving.py`` at their smoke sizes, their records read
  back through ``torch_check_regression.py``'s extractors (contracts and
  launch counts fail the phase; drift against the committed baselines and
  the timing contracts are reported), ``torch_roofline.py --lut``'s
  ``gpu`` rows against the card's own plans, and K1 and K3 at the
  throughput bench's layout.

Served codes are checked against the ``take`` backend on the card and the
plain CPU path, folded codes against the quantized model, and every kernel
is timed.  Any failed phase exits nonzero.  The last three lines of
standard output are a JSON object with every kernel's launches, error and
times, the card's ``name, power.limit``, then ``{"ok": true, "device":
{...}}``; a ``{"fleet": ...}``, a ``{"search": ...}``, an
``{"lm_families": ...}``, an ``{"lm_train": ...}``, an
``{"lm_dist": ...}``, an ``{"autotune": ...}``, a ``{"paper_tables":
...}`` and a ``{"benches": ...}`` line come before them.  A full report goes to ``build/chip_smoke/report.json``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tests"))   # traffic.py (numpy only)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate (data sheet)
INT_OPS_PER_S = 67e12         # H100 SXM non-tensor f32 rate, used for int32
F32_FLOPS_PER_S = 67e12       # H100 SXM non-tensor f32 FMA rate (K4's unit)
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core rate
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 tensor-core rate
SOURCES = {
    "lut_cascade_resident": "src/repro_torch/kernels/csrc/lut_kernels.cu",
    "lut_cascade_streamed": "src/repro_torch/kernels/csrc/lut_kernels.cu",
    "lut_lookup": "src/repro_torch/kernels/csrc/lut_kernels.cu",
    "unit_affine_dense": "src/repro_torch/kernels/csrc/subnet_mlp.cu",
    "unit_affine_units": "src/repro_torch/kernels/csrc/subnet_mlp.cu",
    "unit_affine_dx": "src/repro_torch/kernels/csrc/subnet_mlp.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_attention_wgmma":
        "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
}
REPLACES = {
    "lut_cascade_resident": "src/repro/kernels/lut_cascade.py:136",
    "lut_cascade_streamed": "src/repro/kernels/lut_cascade.py:193",
    "lut_lookup": "src/repro/kernels/lut_gather.py:40",
    "unit_affine_dense": "src/repro/kernels/subnet_mlp.py:23",
    "unit_affine_units": "src/repro/kernels/subnet_mlp.py:23",
    "unit_affine_dx": "src/repro/kernels/subnet_mlp.py:23",
    "flash_attention": "src/repro/kernels/flash_attention.py:29",
    "flash_attention_wgmma": "src/repro/kernels/flash_attention.py:29",
}
# K4 against its plain version: (batch, units, din, dout, stride-0 unit
# axis, activate) -- dense layer 0 of mnist, a hidden stage, the last
# affine, backward dx of dense layer 0 on the per-unit route, a sparse first
# stage, the fold's enumeration batch, and ragged batches
K4_SHAPES = ((256, 2160, 784, 64, True, False), (256, 2160, 64, 64, False, True),
             (256, 2160, 64, 1, False, False), (256, 2160, 64, 784, False, False),
             (256, 2160, 6, 64, False, True), (64, 2160, 6, 64, False, True),
             (1, 2160, 6, 64, False, True), (33, 2160, 6, 64, False, True),
             (257, 2160, 6, 64, False, True))
# K4's dense route on shared rows [B, din] (batch, units, din, dout,
# activate): layer 0's first affine and bypass, layer 2's (F = 360), the
# fold's first affine and bypass (64 codes of 6 bits), and a ragged batch
K4_DENSE_CASES = ((256, 2160, 784, 64, True), (256, 2160, 784, 1, False),
                  (256, 2160, 360, 64, True), (256, 2160, 360, 1, False),
                  (64, 2160, 6, 64, True), (64, 2160, 6, 1, False),
                  (257, 2160, 784, 64, True), (33, 2160, 6, 64, True))
# the dense gradient dx [B, din] (batch, units, din, dout): layers 0 and 2,
# first affine and bypass
K4_DX_CASES = ((256, 2160, 784, 64), (256, 2160, 784, 1),
               (256, 2160, 360, 64), (256, 2160, 360, 1))
# K4's launch counters: the total, then one per route, and the name its
# kernels carry in a profiler trace
K4_ROUTES = ("unit_affine", "unit_affine_dense", "unit_affine_units",
             "unit_affine_dx")
K4_KERNELS = {"unit_affine_dense": "unit_affine_dense_kernel",
              "unit_affine_units": "unit_affine_units_kernel",
              "unit_affine_dx": "unit_affine_dx"}
# the main path each kernel's launches are read from (a kernel that several
# paths run has a row for each)
PATHS = {
    "lut_cascade_resident": "nid/fused",
    "lut_cascade_streamed": "mnist/fused",
    "lut_lookup": "nid/pallas",
    "unit_affine_dense": "mnist toolflow",
    "unit_affine_units": "mnist toolflow",
    "unit_affine_dx": "mnist toolflow",
    "flash_attention": "gemma-2b f32 cut",
    "flash_attention_wgmma": "gemma-2b serve",
}
K4_GRAD_RTOL = 1e-4           # gradients: rtol, and atol 1e-5 x the largest
K4_GRAD_ATOL = 1e-5           # |gradient| (summation order only)


def fail(msg: str) -> None:
    """Report a failed phase and exit nonzero before any result line."""
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    """``name, power.limit`` of the first card, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def random_network(cfg, seed: int):
    """Tables (codes below 2^bits), random mappings and log-scales."""
    import numpy as np
    rs = np.random.RandomState(seed)
    tables, maps = [], []
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        tables.append(rs.randint(0, 2 ** spec.bits,
                                 size=(spec.units, entries)).astype(np.int32))
        maps.append(None if spec.assemble else rs.randint(
            0, cfg.prev_width(l), size=(spec.units, spec.fan_in)
        ).astype(np.int32))
    return tables, maps, float(rs.uniform(-2.0, 0.0)), float(rs.uniform(-3.0, 0.0))


def per_call_ms(fn, calls: int = 40, reps: int = 5) -> float:
    """Device time per call: CUDA events around ``calls`` back-to-back
    calls, median over ``reps`` runs (after a warm-up)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


TRACE_LEADS = (8, 64, 512)  # spin launches opening each try's session
TRAIL_CYCLES = 20_000_000   # a spin of about 10 ms closing each session
# host calls that start one device kernel, copy or fill apiece
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")
LEAD_LOST: list = []   # how many spin launches each session's trace lost
RETRACED: list = []    # each timing whose trace was incomplete, by try


def profile(fn, calls: int = 10, lead: int = TRACE_LEADS[0]):
    """(wall s, {kernel name: (launches, device s)}, lost) of ``calls``
    calls under torch.profiler; device times come from the CUDA trace, and
    ``lost`` counts the host's launch calls (``LAUNCH_CALLS``) whose device
    work the trace does not hold.  Once the process has run a while, the
    trace loses device work, mostly the first of a profiling session and
    now and then a whole session's (torch 2.11, CUDA 12.8 on an H100), so
    the session opens with ``lead`` spin-kernel launches and a sync and
    closes with a long spin and a sync, all left out of the result;
    ``traced_ms`` checks the counts that remain.  How many spin launches
    each session lost is appended to ``LEAD_LOST``."""
    import torch
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(lead):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(TRAIL_CYCLES)
        torch.cuda.synchronize()
    kernels, spun, launched, traced = {}, 0, -lead - 1, 0
    for ev in prof.key_averages():
        if "CUDA" not in str(getattr(ev, "device_type", None)):
            launched += ev.count if ev.key in LAUNCH_CALLS else 0
            continue
        if "spin" in ev.key:
            spun += ev.count
            continue
        traced += ev.count
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us:
            kernels[ev.key] = (ev.count, dev_us * 1e-6)
    LEAD_LOST.append(lead + 1 - spun)
    return wall, kernels, launched - traced


def _untraced(what: str, got) -> None:
    """Record and print a device time that no try could measure."""
    RETRACED.append({"kernel": what, "untraced": True})
    print(f"device time of {what} not measured: no trace of "
          f"{len(TRACE_LEADS)} held every launch (last: {got})", flush=True)


def traced_ms(fn, sub: str, calls: int = 10, per_call: int = 1):
    """Device ms per call of ``fn``'s kernels whose name holds ``sub``: their
    traced time in ``profile(fn, calls)`` over the launches the trace
    holds, times ``per_call``.  Only a trace that holds exactly ``calls *
    per_call`` of them counts (a lost launch would read as a faster
    kernel): an incomplete one is taken again with a longer lead, and
    after ``TRACE_LEADS`` tries the time is None, not a number."""
    for lead in TRACE_LEADS:
        hits = [v for key, v in profile(fn, calls, lead)[1].items()
                if sub in key]
        n = sum(c for c, _ in hits)
        if n == calls * per_call:
            return sum(sec for _, sec in hits) * 1e3 / n * per_call
        RETRACED.append({"kernel": sub, "lead": lead, "traced": n,
                         "expected": calls * per_call,
                         "lead_lost": LEAD_LOST[-1]})
    _untraced(sub, f"{n} of {calls * per_call} launches")
    return None


def traced_all_ms(fn, calls: int = 10):
    """(device ms per call, kernel names) of every kernel ``fn`` launches
    (a library call's), tried as ``traced_ms`` does while the trace lacks
    the device work of some launch call; (None, []) if no try held it
    all."""
    for lead in TRACE_LEADS:
        _, prof, lost = profile(fn, calls, lead)
        if prof and not lost:
            return (sum(sec for _, sec in prof.values()) * 1e3 / calls,
                    sorted(key[:120] for key in prof))
        RETRACED.append({"kernel": "library", "lead": lead, "lost": lost,
                         "lead_lost": LEAD_LOST[-1]})
    _untraced("a library call", f"{lost} launch calls without device work")
    return None, []


def cascade_work(layers, batch: int, table_bytes: int, map_bytes: int):
    """(bytes, int ops) one cascade pass must at least move and do."""
    w0, n_out = layers[0][0], layers[-1][1]
    byts = batch * (w0 + n_out) * 4 + table_bytes + map_bytes
    ops = sum(batch * l[1] * 2 * l[4] for l in layers)
    return byts, ops


def bound(byts: int, ops: int, ops_per_s: float = INT_OPS_PER_S):
    """(bound_ms, bound_by) from bytes and operations."""
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def serve_artifact(path, backend: str, kname: str, xs, dev, smi: str,
                   label: str) -> dict:
    """Serve ``xs`` from the artifact at ``path`` through ``LUTEngine``
    (block 1024, depth 2) on the card with the launch counts set to 0 just
    before; fail unless ``kname`` launched and the codes equal ``take`` on
    the card and the plain CPU path.  Returns the serving numbers."""
    import numpy as np
    import torch
    from repro_torch import pipeline
    from repro_torch.kernels import build
    from repro_torch.serve.lut_engine import LUTEngine

    net = pipeline.CompiledLUTNetwork.load(path, device=dev)
    eng = LUTEngine(net, block=1024, depth=2, backend=backend)
    eng.run(xs[:1024])                       # warm-up, not counted
    eng = LUTEngine(net, block=1024, depth=2, backend=backend)
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    reqs = eng.submit_many(xs)
    while eng.queue:
        eng.tick()
    eng.drain()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    if counts.get(kname, 0) < 1:
        fail(f"{label}: kernel {kname} was not launched (counts {counts})")
    got = np.stack([r.codes for r in reqs])
    take = net.predict_codes(xs, backend="take").cpu().numpy()
    cpu = pipeline.CompiledLUTNetwork.load(path, device="cpu")
    plain = cpu.predict_codes(xs, backend=backend).numpy()
    if not (np.array_equal(got, take) and np.array_equal(got, plain)):
        fail(f"{label}: served codes differ from take on the card or from "
             "the plain CPU path")
    logits = np.stack([r.logits for r in reqs])
    if logits.shape != (len(xs), net.cfg.layers[-1].units) or \
            not np.isfinite(logits).all():
        fail(f"{label}: bad logits {logits.shape}")
    rows = len(xs)
    print(f"serve {label}: {rows} rows, codes == take == CPU, "
          f"{rows / wall:,.0f} rows/s, p50 {eng.stats.latency_us(50):.0f}"
          f" us, p99 {eng.stats.latency_us(99):.0f} us, launches "
          f"{counts} [{smi}]", flush=True)
    return {"rows": rows, "block": 1024, "depth": 2, "launches": counts,
            "rows_per_s": rows / wall,
            "p50_tick_us": eng.stats.latency_us(50),
            "p99_tick_us": eng.stats.latency_us(99)}


def k4_inputs(b, u, din, dout, stride0, gen, dev, dtype=None):
    """K4 operands at the main path's scales: x in [0, 1) (quantized
    activations are non-negative and O(1)), He-scaled weights, small bias;
    with ``stride0`` the unit axis of x is a broadcast view (dense mode)."""
    import math
    import torch
    dtype = dtype or torch.float32
    x = torch.rand((b, din) if stride0 else (b, u, din), generator=gen)
    w = torch.randn((u, din, dout), generator=gen) * math.sqrt(2.0 / din)
    bias = torch.randn((u, dout), generator=gen) * 0.1
    x, w, bias = (t.to(dev, dtype) for t in (x, w, bias))
    if stride0:
        x = x[:, None, :].expand(b, u, din)
    return x, w, bias


def check_unit_affine(dev) -> dict:
    """K4 against its plain version (TF32 off) at the main path's shapes,
    in f32 and bf16, its gradient against autograd through the plain
    version, and bit-identical rows at two batch sizes; each route equal bit
    for bit to the reference kernel (K4's first version) on every
    ``K4_SHAPES`` and ``K4_DENSE_CASES`` case and on batch-major per-unit
    x in f32 and bf16; the same rows
    as a stride-0 view, as shared rows and materialised give equal bits; the
    dense dx reduction within the gradient tolerance of plain autograd and
    bit-stable across runs and batch sizes.  Returns the max |diff| against
    the plain version by route; fails on any disagreement.

    Tolerance: f32 rtol = atol = 1e-5 (tests/test_kernels.py), times
    sqrt(din/64) where din > 64 (the two sides sum in different orders);
    bf16 3e-2; gradients rtol 1e-4, atol 1e-5 x the largest |gradient|."""
    import math
    import torch
    from repro_torch.kernels import subnet_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)
    t0 = time.perf_counter()
    worst = {"unit_affine_dense": 0.0, "unit_affine_units": 0.0,
             "unit_affine_dx": 0.0}

    def hold(x, w, bias, act, label):
        """The route against the plain version (f32) and the reference
        kernel (f32, bf16: bit for bit)."""
        got = subnet_mlp.unit_affine_cuda(x, w, bias, activate=act)
        torch.cuda.synchronize()
        want = subnet_mlp.unit_affine_plain(x, w, bias, activate=act)
        tol = 1e-5 * max(1.0, math.sqrt(x.shape[-1] / 64))
        err = float((got - want).abs().max())
        key = f"unit_affine_{subnet_mlp.route(x)}"
        worst[key] = max(worst[key], err)
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            fail(f"K4 {label}: max |diff| {err}")
        for dt in (torch.float32, torch.bfloat16):
            xd, wd, bd = (t.to(dt) for t in (x, w, bias))
            got = subnet_mlp.unit_affine_cuda(xd, wd, bd, activate=act)
            ref = subnet_mlp.unit_affine_reference_cuda(xd, wd, bd,
                                                        activate=act)
            if not torch.equal(got, ref):
                fail(f"K4 {label} {dt}: {int((got != ref).sum())} outputs "
                     "differ from the reference kernel")

    for b, u, din, dout, s0, act in K4_SHAPES:
        x, w, bias = k4_inputs(b, u, din, dout, s0, gen, dev)
        hold(x, w, bias, act, f"[{b},{u},{din}]x[{u},{din},{dout}]")
    for b, u, din, dout, act in K4_DENSE_CASES:
        x, w, bias = k4_inputs(b, u, din, dout, True, gen, dev)
        hold(x[:, 0, :], w, bias, act,
             f"shared rows [{b},{din}]x[{u},{din},{dout}]")
    x, w, bias = k4_inputs(256, 2160, 64, 64, False, gen, dev, torch.bfloat16)
    got = subnet_mlp.unit_affine_cuda(x, w, bias, activate=True).float()
    want = subnet_mlp.unit_affine_plain(x, w, bias, activate=True).float()
    if not torch.allclose(got, want, rtol=3e-2, atol=3e-2):
        fail(f"K4 bf16: max |diff| {float((got - want).abs().max())}")
    # the fixed reduction order: one row gives the same bits at any batch
    x, w, bias = k4_inputs(257, 2160, 6, 64, False, gen, dev)
    full = subnet_mlp.unit_affine_cuda(x, w, bias, activate=True)
    part = subnet_mlp.unit_affine_cuda(x[:33].contiguous(), w, bias,
                                       activate=True)
    if not torch.equal(full[:33], part):
        fail("K4: rows differ between batch sizes 257 and 33")
    # one layout-free result: a stride-0 view, shared rows and the
    # materialised copy (what the fold relies on)
    for b, u, din, dout in ((256, 2160, 784, 64), (64, 2160, 6, 64)):
        view, w, bias = k4_inputs(b, u, din, dout, True, gen, dev)
        outs = [subnet_mlp.unit_affine_cuda(t, w, bias, activate=True)
                for t in (view, view[:, 0, :], view.contiguous())]
        if not (torch.equal(outs[0], outs[1])
                and torch.equal(outs[0], outs[2])):
            fail(f"K4 [{b},{u},{din}]->{dout}: stride-0, shared-rows and "
                 "materialised inputs give different bits")
        del outs
    # per-unit x with its batch axis contiguous (a permute of [din, U, B]):
    # odd units start 8 bytes off a 16-byte boundary when B is 2 or 6
    for b, u, din, dout in ((2, 2160, 64, 64), (6, 2160, 6, 64),
                            (4, 2160, 64, 64)):
        _, w, bias = k4_inputs(b, u, din, dout, False, gen, dev)
        x = torch.rand((din, u, b), generator=gen).to(dev).permute(2, 1, 0)
        hold(x, w, bias, True, f"batch-major [{b},{u},{din}]->{dout}")
    # gradients: dx through K4 on w^T (stride-0 view, per-unit x) or by the
    # dense reduction (shared rows), dw and db plain, vs plain autograd
    cases = [(256, 2160, 784, 64, "view", False),
             (256, 2160, 64, 64, "units", True)]
    cases += [(b, u, din, dout, "rows", dout > 1)
              for b, u, din, dout in K4_DX_CASES]
    for b, u, din, dout, how, act in cases:
        x, w, bias = k4_inputs(b, u, din, dout, how != "units", gen, dev)
        b, (u, din, dout) = x.shape[0], w.shape
        leaf = (x if how == "units" else x[:, 0, :]).clone().requires_grad_()
        w.requires_grad_()
        bias.requires_grad_()
        xin = leaf[:, None, :].expand(b, u, din) if how != "units" else leaf
        cot = torch.randn((b, u, dout), generator=gen).to(dev)
        grads = []
        for fn, xx in ((subnet_mlp.unit_affine,
                        leaf if how == "rows" else xin),
                       (subnet_mlp.unit_affine_plain, xin)):
            for t in (leaf, w, bias):
                t.grad = None
            (fn(xx, w, bias, activate=act) * cot).sum().backward()
            grads.append([t.grad.clone() for t in (leaf, w, bias)])
        for name, g, p in zip(("dx", "dw", "db"), *grads):
            scale = float(p.abs().max())
            if how == "rows" and name == "dx":
                worst["unit_affine_dx"] = max(worst["unit_affine_dx"],
                                              float((g - p).abs().max()))
            if not torch.allclose(g, p, rtol=K4_GRAD_RTOL,
                                  atol=K4_GRAD_ATOL * scale):
                fail(f"K4 gradient {name} ({how}) [{b},{u},{din}]->{dout}: "
                     f"max |diff| {float((g - p).abs().max())} of {scale}")
        del grads
    # the dense dx reduction: the same bits from run to run and for the
    # first 33 rows of a batch of 257 as for a batch of 33
    _, w, _ = k4_inputs(1, 2160, 784, 64, True, gen, dev)
    dy = torch.randn((257, w.shape[0], w.shape[2]), generator=gen).to(dev)
    first = subnet_mlp.unit_affine_dx_cuda(dy, w)
    again = subnet_mlp.unit_affine_dx_cuda(dy, w)
    part = subnet_mlp.unit_affine_dx_cuda(dy[:33].contiguous(), w)
    if not (torch.equal(first, again) and torch.equal(first[:33], part)):
        fail("K4 dense dx: bits differ between runs or batch sizes")
    torch.cuda.synchronize()
    print(f"K4 vs plain: {len(K4_SHAPES)} f32 shapes and "
          f"{len(K4_DENSE_CASES)} shared-rows cases, max |diff| "
          f"{ {k: f'{v:.3e}' for k, v in worst.items()} }; every route "
          "equal to the reference kernel in f32 and bf16; stride-0, shared "
          "rows and materialised x equal; bf16 within 3e-2, gradients within "
          "rtol 1e-4 (dense dx too), rows and dense dx bit-identical across "
          f"batch sizes and runs ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    return worst


# K5 against its plain version: tests/test_kernels.py's 15 cases at D 32,
# (hq, hkv, sq, skv, causal, window)
K5_CASES = tuple((hq, hkv, sq, skv, causal, window)
                 for hq, hkv in ((4, 4), (4, 2), (8, 1))
                 for sq, skv, causal, window in ((64, 64, True, None),
                                                 (64, 64, False, None),
                                                 (100, 100, True, 32),
                                                 (1, 96, True, None),
                                                 (1, 96, True, 24)))
K5_F32_TOL = 2e-5             # the reference test's rtol = atol
K5_BF16_RTOL = 2 ** -7        # one bf16 ulp: both sides compute in f32 from
K5_BF16_ATOL = 1e-5           # the same bf16 values and round once (the
                              # wgmma kernel with p split into two bf16 terms)
GEMMA_PROMPTS = (1024, 700, 512, 130, 33, 7)
GEMMA_NEW_TOKENS = 16
# decode vs prefill in bf16 through 18 layers: prefill's [S, d] GEMMs and
# decode's [1, d] GEMMs accumulate in other orders, so the bf16 residual
# stream differs by ulps that grow with depth; a sanity bound of 5% of the
# largest logit, with the argmax held equal.  The exact check is the f32
# one on the 2-layer cut, at the reference's tolerance
DECODE_VS_PREFILL_REL = 0.05
DECODE_VS_PREFILL_F32_TOL = 2e-4   # tests/test_archs.py:123, rtol = atol
CARD_VS_CPU_TOL = 1e-4        # f32, summation order only


def k5_inputs(b, hq, hkv, sq, skv, d, seed, dev, dtype=None):
    """q, k, v with standard normal entries (numpy seed), on the card."""
    import numpy as np
    import torch
    rs = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rs.standard_normal(shape).astype(
        np.float32)).to(dev, dtype or torch.float32)
        for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))


# K5's wgmma kernel against the plain version, bf16, (b, hq, hkv, sq, skv, d,
# window, q_offset): gemma-2b at every serve prompt length, a window of 256,
# minitron-4b's D 128 GQA ([1, 24, S, 128] on 8 KV heads), and Sq < Skv
# with q_offset as the reference's decode cases have it
K5_WGMMA_CASES = ([(1, 8, 1, s, s, 256, None, 0) for s in GEMMA_PROMPTS]
                  + [(1, 8, 1, 1024, 1024, 256, 256, 0),
                     (1, 24, 8, 1024, 1024, 128, None, 0),
                     (1, 24, 8, 130, 130, 128, None, 0),
                     (1, 8, 1, 1, 96, 256, None, 95),
                     (2, 4, 2, 1, 96, 128, 24, 95),
                     (2, 4, 2, 1, 96, 64, None, 95),
                     (2, 4, 2, 100, 100, 64, 32, 0)])


def check_flash_attention(dev) -> dict:
    """K5's two kernels against the plain version.  The TF32 kernel: the
    reference test's 15 cases (f32, D 32), gemma-2b's prefill shapes
    ([1, 8, S, 256] q on [1, 1, S, 256] k/v, causal, S in 1024 / 130 / 7)
    in f32 and bf16, a window of 256 at S 1024, q as the strided view the
    model passes, and the head dims 8, 16 and 96 in f32 and bf16 (the smoke
    configs' 16 among them).  The wgmma kernel: the cases of ``K5_WGMMA_CASES``,
    with q contiguous and as the model's strided view.
    Also reports, as information, what rounding p once to bf16 instead of
    splitting it would do on gemma's 1024 case.  Returns the max |diff| of
    each kernel (the TF32 kernel's f32 checks); fails on any
    disagreement."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    t0 = time.perf_counter()
    worst, worst_bf16, worst_wgmma, n = 0.0, 0.0, 0.0, 0

    def hold(fn, q, k, v, label, **kw):
        nonlocal worst, worst_bf16, worst_wgmma, n
        got = fn(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        n += 1
        if q.dtype == torch.float32:
            worst = max(worst, err)
            ok = torch.allclose(got, want, rtol=K5_F32_TOL, atol=K5_F32_TOL)
        else:
            if fn is fa.flash_attention_wgmma_cuda:
                worst_wgmma = max(worst_wgmma, err)
            else:
                worst_bf16 = max(worst_bf16, err)
            ok = torch.allclose(got.float(), want.float(), rtol=K5_BF16_RTOL,
                                atol=K5_BF16_ATOL)
        if not ok:
            fail(f"K5 {fn.__name__} {label} {q.dtype}: max |diff| {err}")

    tf32 = fa.flash_attention_tf32_cuda
    for hq, hkv, sq, skv, causal, window in K5_CASES:
        hold(tf32, *k5_inputs(2, hq, hkv, sq, skv, 32, hq + sq, dev),
             f"[{hq},{hkv},{sq},{skv},{causal},{window}]", causal=causal,
             window=window, q_offset=skv - sq)
    for s in (1024, 130, 7):
        q, k, v = k5_inputs(1, 8, 1, s, s, 256, s, dev)
        hold(tf32, q, k, v, f"gemma S {s}")
        hold(tf32, *(t.bfloat16() for t in (q, k, v)), f"gemma S {s}")
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        hold(tf32, qt, k, v, f"gemma S {s} strided q")
    hold(tf32, *k5_inputs(1, 8, 1, 1024, 1024, 256, 3, dev), "window 256",
         window=256)
    for d in (8, 16, 96):
        q, k, v = k5_inputs(2, 4, 2, 300, 300, d, d, dev)
        for dt in (torch.float32, torch.bfloat16):
            hold(tf32, *(t.to(dt) for t in (q, k, v)), f"D {d}")
            hold(tf32, *(t.to(dt) for t in (q[:, :, -1:], k, v)),
                 f"D {d} Sq 1", q_offset=299)
    n_tf32 = n

    wgmma = fa.flash_attention_wgmma_cuda
    for b, hq, hkv, sq, skv, d, window, q_offset in K5_WGMMA_CASES:
        q, k, v = k5_inputs(b, hq, hkv, sq, skv, d, sq + d, dev,
                            torch.bfloat16)
        qt = q.transpose(1, 2).contiguous().transpose(1, 2)
        for qq, how in ((q, ""), (qt, " strided q")):
            hold(wgmma, qq, k, v, f"[{b},{hq},{hkv},{sq},{skv},{d}] window "
                 f"{window} q_offset {q_offset}{how}", window=window,
                 q_offset=q_offset)

    # information only: p rounded once to bf16 (split_p=False)
    q, k, v = k5_inputs(1, 8, 1, 1024, 1024, 256, 1024, dev, torch.bfloat16)
    want = fa.flash_attention_plain(q, k, v).float()
    tol = K5_BF16_ATOL + K5_BF16_RTOL * want.abs()
    single = {}
    for split in (True, False):
        got = wgmma(q, k, v, split_p=split).float()
        diff = (got - want).abs()
        single["split" if split else "single"] = {
            "max_abs_diff": float(diff.max()),
            "max_diff_over_tolerance": float((diff / tol).max()),
            "elements_outside_tolerance": int((diff > tol).sum())}
    torch.cuda.synchronize()
    print(f"K5 vs plain: {n_tf32} checks of the TF32 kernel, f32 max |diff| "
          f"{worst:.3e} (tolerance {K5_F32_TOL}), bf16 max |diff| "
          f"{worst_bf16:.3e}; {n - n_tf32} checks of the wgmma kernel, max "
          f"|diff| {worst_wgmma:.3e} (rtol {K5_BF16_RTOL}, atol "
          f"{K5_BF16_ATOL}) ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(f"K5 wgmma on gemma S 1024, p split vs p rounded once to bf16 "
          f"(information): {single}", flush=True)
    return {"flash_attention": worst, "flash_attention_wgmma": worst_wgmma,
            "single_p": single}


def serve_gemma(dev, smi: str, seed: int) -> dict:
    """The LM serving path at full width: ``gemma-2b`` (18 layers, bf16,
    random weights) serves six requests on four slots through
    ``ServeEngine`` with the launch counts set to 0 just before; fails
    unless K5's wgmma kernel launched exactly once per layer per prefill
    (108) and its TF32 kernel never, every request got its 16 tokens in
    range, every logit was finite, decode matches prefill on the card (in
    bf16 within a sanity bound with the same argmax, and in f32 on a
    2-layer cut at the reference's 2e-4, where the TF32 kernel runs once
    per layer), and that 2-layer cut agrees with the CPU.  Returns the
    serving numbers."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.kernels import build
    from repro_torch.models import lm
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = lm_archs.get("gemma-2b")
    out = {"arch": cfg.name, "slots": 4, "context": 2048,
           "prompts": list(GEMMA_PROMPTS), "new_tokens": GEMMA_NEW_TOKENS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    eng = ServeEngine(cfg, model, slots=4, context=2048, device=dev)
    torch.cuda.synchronize()
    out["init_s"] = time.perf_counter() - t0
    del model
    params = eng.params                      # the bf16 copy, made once
    # warm-up (cuBLAS handles, the kernel library), not counted
    ServeEngine(cfg, params, slots=4, context=2048, device=dev).run(
        [Request(rid=-1, prompt=np.arange(40, dtype=np.int32), max_tokens=3)])

    rs = np.random.RandomState(seed)
    reqs = [Request(rid=i, prompt=rs.randint(0, cfg.vocab, n).astype(np.int32),
                    max_tokens=GEMMA_NEW_TOKENS)
            for i, n in enumerate(GEMMA_PROMPTS)]
    reqs[2] = dataclasses.replace(reqs[2], temperature=0.8, top_k=50,
                                  top_p=0.9)
    eng = ServeEngine(cfg, params, slots=4, context=2048, device=dev,
                      rng_seed=seed)
    finite = []
    sample = eng._sample

    def checked_sample(logits, req):
        finite.append(bool(np.isfinite(logits).all()))
        return sample(logits, req)

    eng._sample = checked_sample
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    out["launches"] = counts
    out["k5_launches"] = counts.get("flash_attention_wgmma", 0)
    want = cfg.n_layers * len(GEMMA_PROMPTS)
    if out["k5_launches"] != want or counts.get("flash_attention", 0):
        fail(f"gemma-2b serve: K5's wgmma kernel launched "
             f"{out['k5_launches']} times, not {want} (one per layer per "
             "prefill, none in decode), and its TF32 kernel "
             f"{counts.get('flash_attention', 0)} times, not 0")
    if len(done) != len(reqs) or any(
            len(r.out_tokens) != GEMMA_NEW_TOKENS
            or not all(0 <= t < cfg.vocab for t in r.out_tokens)
            for r in done):
        fail("gemma-2b serve: a request did not finish with "
             f"{GEMMA_NEW_TOKENS} tokens in range")
    if not all(finite) or len(finite) != eng.stats.tokens_out + len(reqs):
        fail("gemma-2b serve: non-finite logits")
    st = eng.stats
    out.update(
        wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(),
        prefill_ms={n: ms for n, ms in zip(GEMMA_PROMPTS, st.prefill_ms)},
        decode_ticks=st.decode_steps, decode_tokens=st.tokens_out,
        decode_ms_median=statistics.median(st.decode_ms),
        decode_ms_total=sum(st.decode_ms),
        decode_tokens_per_s=st.tokens_out / (sum(st.decode_ms) / 1e3),
        tokens_per_s=(st.tokens_out + len(reqs)) / wall,
        tokens={r.rid: r.out_tokens for r in done})
    print(f"gemma-2b serve: 6 requests on 4 slots in {wall:.3f} s, K5 "
          f"(wgmma) launches {out['k5_launches']}, prefill ms by prompt length "
          f"{ {n: round(ms, 2) for n, ms in out['prefill_ms'].items()} }, "
          f"{st.decode_steps} decode ticks, median "
          f"{out['decode_ms_median']:.2f} ms/tick, "
          f"{out['decode_tokens_per_s']:.1f} decode tokens/s, "
          f"{out['tokens_per_s']:.1f} tokens/s overall, peak memory "
          f"{out['peak_bytes'] / 2**30:.2f} GiB [{smi}]", flush=True)

    # the device's idle share of one prefill of 1024 and one decode tick
    toks = torch.from_numpy(reqs[0].prompt[None]).to(dev)
    wall_p, prof, _ = profile(lambda: lm.prefill(params, cfg, toks, 2048),
                           calls=1)
    busy = sum(sec for _, sec in prof.values())
    k5_hits = [v for key, v in prof.items()
               if "flash_attention_wgmma_kernel" in key
               or "flash_attention_kernel" in key]
    k5 = sum(sec for _, sec in k5_hits)
    k5_n = sum(c for c, _ in k5_hits)
    out["prefill_profile"] = {"wall_s": wall_p, "device_busy_s": busy,
                              "k5_device_s": k5, "k5_launches": k5_n,
                              "k5_device_ms_per_layer": k5 * 1e3 / max(k5_n, 1),
                              "device_idle_share": 1.0 - busy / wall_p,
                              "k5_share_of_busy": k5 / busy}
    cache = eng.cache
    tok4 = torch.zeros((4, 1), dtype=torch.int32, device=dev)
    wall_d, prof, _ = profile(lambda: lm.decode_step(params, cfg, cache, tok4),
                           calls=1)
    busy_d = sum(sec for _, sec in prof.values())
    out["decode_profile"] = {"wall_s": wall_d, "device_busy_s": busy_d,
                             "device_idle_share": 1.0 - busy_d / wall_d}
    print(f"profile gemma-2b prefill 1024: wall {wall_p * 1e3:.2f} ms, "
          f"device busy {busy * 1e3:.2f} ms, K5 {k5 * 1e3:.2f} ms in "
          f"{k5_n} launches ({k5 / busy:.3f} of busy), idle share {1.0 - busy / wall_p:.3f}; "
          f"decode tick (4 slots): wall {wall_d * 1e3:.2f} ms, device busy "
          f"{busy_d * 1e3:.2f} ms, idle share {1.0 - busy_d / wall_d:.3f} "
          f"[{smi}]", flush=True)

    # decode vs prefill on the card in bf16 (tests/test_archs.py:109 at
    # full depth), n = 129: a sanity bound and the argmax
    p = torch.from_numpy(reqs[0].prompt[None, :130]).to(dev)
    full, _ = lm.prefill(params, cfg, p, 2048)
    _, c = lm.prefill(params, cfg, p[:, :129], 2048)
    dec, _ = lm.decode_step(params, cfg, c, p[:, 129:130])
    full, dec = full[:, :cfg.vocab], dec[:, :cfg.vocab]
    err = float((dec - full).abs().max())
    scale = float(full.abs().max())
    out["decode_vs_prefill"] = {"max_abs_diff": err, "max_abs_logit": scale,
                                "argmax_equal": bool(
                                    torch.equal(dec.argmax(-1),
                                                full.argmax(-1)))}
    print(f"gemma-2b decode vs prefill (bf16, n = 129): max |diff| {err:.4f} "
          f"of max |logit| {scale:.4f} (limit {DECODE_VS_PREFILL_REL} of "
          f"it), argmax equal {out['decode_vs_prefill']['argmax_equal']}",
          flush=True)
    if not err <= DECODE_VS_PREFILL_REL * scale:
        fail(f"gemma-2b decode vs prefill: max |diff| {err} > "
             f"{DECODE_VS_PREFILL_REL} x {scale}")
    if not out["decode_vs_prefill"]["argmax_equal"]:
        fail("gemma-2b decode vs prefill: the argmax differs")
    del eng, params, cache, c, full, dec
    torch.cuda.empty_cache()

    # card vs CPU: full width cut to 2 layers, f32, prompt 130
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    card = lm.init_params(cfg2, torch.Generator(dev).manual_seed(seed), dev)
    cpu = lm.compute_copy(card, cfg2, "cpu")
    prompt = torch.from_numpy(reqs[0].prompt[None, :130])
    build.reset_counters()
    got, _ = lm.prefill(card, cfg2, prompt.to(dev), 2048)
    out["k5_tf32_launches_f32_cut"] = build.launch_counts().get(
        "flash_attention", 0)
    if out["k5_tf32_launches_f32_cut"] != 2:
        fail("gemma-2b card vs CPU: K5's TF32 kernel did not run once per "
             "layer")
    # decode matches prefill on the card in f32, n = 129
    _, c = lm.prefill(card, cfg2, prompt[:, :129].to(dev), 2048)
    dec, _ = lm.decode_step(card, cfg2, c, prompt[:, 129:130].to(dev))
    full, dec = got[:, :cfg.vocab], dec[:, :cfg.vocab]
    err = float((dec - full).abs().max())
    out["decode_vs_prefill_f32"] = {"layers": 2, "max_abs_diff": err,
                                    "max_abs_logit": float(full.abs().max())}
    print(f"gemma-2b (2 layers, f32) decode vs prefill on the card (n = "
          f"129): max |diff| {err:.3e} (tolerance rtol = atol = "
          f"{DECODE_VS_PREFILL_F32_TOL})", flush=True)
    if not torch.allclose(dec, full, rtol=DECODE_VS_PREFILL_F32_TOL,
                          atol=DECODE_VS_PREFILL_F32_TOL):
        fail(f"gemma-2b (2 layers, f32) decode vs prefill: max |diff| {err}")
    del c, full, dec
    want, _ = lm.prefill(cpu, cfg2, prompt, 2048)
    got = got.cpu()
    err = float((got - want).abs().max())
    out["card_vs_cpu_max_abs_diff"] = err
    print(f"gemma-2b (2 layers, f32) card vs CPU prefill logits: max |diff| "
          f"{err:.3e} (tolerance rtol = atol = {CARD_VS_CPU_TOL})",
          flush=True)
    if not torch.allclose(got, want, rtol=CARD_VS_CPU_TOL,
                          atol=CARD_VS_CPU_TOL):
        fail(f"gemma-2b card vs CPU: max |diff| {err}")
    del card, cpu
    torch.cuda.empty_cache()
    return out


def k5_by_prompt(dev, seed: int, smi: str) -> dict:
    """K5's wgmma kernel alone on one gemma-2b layer (q the model's strided
    view, bf16, causal) at every serve prompt length: ms by CUDA events and
    device ms from the profiler's trace."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for s in GEMMA_PROMPTS:
        q, k, v = k5_inputs(1, 8, 1, s, s, 256, seed + s, dev, torch.bfloat16)
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
        fn = lambda: fa.flash_attention_wgmma_cuda(q, k, v)  # noqa: E731
        out[s] = {"ms": per_call_ms(fn), "device_ms": traced_ms(
            fn, "flash_attention_wgmma_kernel")}
    print(f"K5 wgmma alone by prompt length (ms, device ms): "
          f"{ {s: (round(v['ms'], 4), v['device_ms']) for s, v in out.items()} } "
          f"[{smi}]", flush=True)
    return out


def k5_tf32_d16(dev, seed: int, smi: str) -> dict:
    """K5's TF32 kernel on bf16 at head dim 16 (the smoke configs'), on
    gemma-2b's heads and a 1024-token causal prefill: ms by CUDA events,
    device ms from the profiler, the bf16 bound and one SDPA call."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    q, k, v = k5_inputs(1, 8, 1, 1024, 1024, 16, seed + 16, dev,
                        torch.bfloat16)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    if fa.route(q, k, v) != fa.TF32:
        fail("K5: bf16 at head dim 16 does not route to the TF32 kernel")
    fn = lambda: fa.flash_attention_tf32_cuda(q, k, v)  # noqa: E731
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    ops = 4 * 8 * 16 * 1024 * 1025 // 2
    byts = (2 * q.numel() + k.numel() + v.numel()) * 2
    out = {"shape": "q [1, 8, 1024, 16] strided, k/v [1, 1, 1024, 16], bf16",
           "ms": per_call_ms(fn), "device_ms": traced_ms(fn, "flash_attention_tf32_kernel"),
           "library_ms": per_call_ms(sdpa),
           "library_device_ms": traced_all_ms(sdpa)[0]}
    out["bound_ms"], out["bound_by"] = bound(byts, ops, BF16_FLOPS_PER_S)
    print(f"time flash_attention (TF32 kernel, bf16, head dim 16): "
          f"{ {k: (round(v, 5) if isinstance(v, float) else v) for k, v in out.items()} } "
          f"[{smi}]", flush=True)
    return out


def k2_plan(ops, unit_tile: int, batch: int) -> dict:
    """K2's cluster plan at these operands: cluster size, rows a tile,
    route, bytes a CTA, clusters resident at once, clusters launched."""
    from repro_torch.kernels import lut_cascade as lc
    isz = ops.tables.element_size()
    cp = lc.plan_cluster(ops.layers, isz, unit_tile=unit_tile,
                         max_entries=ops.tables.shape[1])
    fit = lc.max_active_clusters(0, isz, lc.act_itemsize(ops.layers),
                                 bool(cp.ring_units), cp.cluster,
                                 cp.smem_bytes)
    return {"cluster": cp.cluster, "rows": cp.rows, "route": cp.route,
            "ring_units": cp.ring_units, "smem_bytes": cp.smem_bytes,
            "max_active_clusters": fit,
            "clusters_launched": min(-(-batch // cp.rows), fit)}


def k1_plan(ops, batch: int) -> dict:
    """K1's plan at these operands and batch: rows a tile, CTAs an SM (the
    plan's, and what the runtime reports), CTAs launched, tiles, bytes a
    CTA."""
    from repro_torch.kernels import lut_cascade as lc
    isz = ops.tables.element_size()
    p = lc.resident_plan(ops, batch, 0)
    return {"rows": p.rows, "ctas_per_sm": p.ctas_per_sm,
            "occupancy": lc.resident_occupancy(
                0, isz, lc.act_itemsize(ops.layers), p.smem_bytes),
            "grid": p.grid, "tiles": p.tiles, "smem_bytes": p.smem_bytes}


def finite_net(net) -> bool:
    """Every float tensor of a parameter network is finite."""
    import torch
    from repro_torch.core import assemble
    return all(bool(torch.isfinite(t).all()) for t in assemble.leaves(net)
               if t.dtype.is_floating_point)


def train_mnist(dev, smi: str, art_dir: Path) -> dict:
    """The toolflow's main path at full width: ``mnist`` (Table II, uncut)
    pre-trained dense for 3 steps, pruned, re-trained sparse for 3 steps
    and folded on the card, then saved, reloaded and served (fused, K2).
    Each stage runs with the launch counts set to 0 just before it; fails
    unless K4 launched in every stage, loss and parameters are finite,
    folded codes equal ``apply_codes`` on the card, and the served codes
    equal ``take`` and the CPU path."""
    import numpy as np
    import torch
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble, folding
    from repro_torch.data import synthetic
    from repro_torch.kernels import build

    cfg = paper_tasks.task_config("mnist")
    t0 = time.perf_counter()
    data = synthetic.load("mnist", n_test=8192)
    out = {"data_s": time.perf_counter() - t0, "steps": 3, "batch": 256}
    flow = pipeline.Toolflow(cfg, pretrain_steps=3, retrain_steps=3,
                             batch_size=256, device=dev)
    launches = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        build.reset_counters()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t
        launches[name] = build.launch_counts()
        if launches[name].get("unit_affine", 0) < 1:
            fail(f"mnist toolflow: K4 was not launched in {name} "
                 f"(counts {launches[name]})")
        if launches[name].get("unit_affine_reference", 0):
            fail(f"mnist toolflow: {name} reached K4's reference kernel")
        return res

    torch.cuda.reset_peak_memory_stats()
    stage("pretrain", lambda: flow.pretrain(data))
    out["peak_bytes_pretrain"] = torch.cuda.max_memory_allocated()
    flow.prune()
    stage("retrain", lambda: flow.retrain())
    comp = stage("compile", lambda: flow.compile(backend="fused"))
    out["fold_s"] = out["compile_s"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = launches
    out["k4_launches"] = {k: sum(c.get(k, 0) for c in launches.values())
                          for k in K4_ROUTES}
    for st in ("pretrain", "retrain"):
        loss = flow.stages[st].metrics["final_loss"]
        out[f"{st}_final_loss"] = loss
        if not np.isfinite(loss):
            fail(f"mnist toolflow: {st} loss is {loss}")
    if not (finite_net(flow.dense_params) and finite_net(flow.params)):
        fail("mnist toolflow: non-finite parameters")
    print(f"mnist toolflow: pretrain {out['pretrain_s']:.2f} s, retrain "
          f"{out['retrain_s']:.2f} s (3 steps each), fold {out['fold_s']:.3f}"
          f" s, losses {out['pretrain_final_loss']:.4f} / "
          f"{out['retrain_final_loss']:.4f}, peak memory "
          f"{out['peak_bytes'] / 2**30:.2f} GiB (pretrain "
          f"{out['peak_bytes_pretrain'] / 2**30:.3f} GiB), K4 launches by "
          f"stage {[launches[k]['unit_affine'] for k in launches]}, by route "
          f"{out['k4_launches']} [{smi}]", flush=True)

    xs = data.x_test[:8192]
    xt = torch.from_numpy(xs).to(dev)
    folded = folding.folded_apply_codes(comp.folded(), xt)
    quantized = assemble.apply_codes(flow.params, cfg, xt)
    if not torch.equal(folded, quantized):
        fail(f"mnist toolflow: folded codes differ from apply_codes on "
             f"{int((folded != quantized).any(1).sum())} of 8192 rows")
    cpu = assemble.params_from_reference(
        assemble.params_to_reference(flow.params), device="cpu")
    cpu_tables = folding.fold_network(cpu, cfg).tables
    out["fold_entries"] = comp.num_entries()
    out["fold_diff_card_vs_cpu"] = int(sum(
        int((torch.from_numpy(t) != c).sum())
        for t, c in zip(comp.tables, cpu_tables)))
    print(f"mnist fold: folded == apply_codes on the card over 8192 rows; "
          f"{out['fold_diff_card_vs_cpu']} of {out['fold_entries']} table "
          "entries differ between a card fold and a CPU fold", flush=True)

    comp.compile_backend("fused")
    path = comp.save(str(art_dir / "mnist_trained_fused.npz"))
    out["artifact"] = path
    out["serve"] = serve_artifact(path, "fused", "lut_cascade_streamed", xs,
                                  dev, smi, "mnist/trained/fused")
    out["step"] = step_metrics(flow, cfg, data, dev, smi)
    return out


def step_metrics(flow, cfg, data, dev, smi: str) -> dict:
    """Steady-state dense and sparse training steps of the flow's models:
    host ms per step (synchronized, 3 steps after a warm-up), K4 launches
    and device time per step by route, and the device idle share of one
    profiled step.  Fails unless a dense step runs the dense dx reduction
    once for each K4 call on shared rows (first affine and bypass of every
    mapping layer) and no step reaches K4's reference kernel."""
    import torch
    from repro_torch.core import assemble
    from repro_torch.kernels import build
    from repro_torch.train import lut_trainer, optim

    xb = torch.from_numpy(data.x_train[:256]).to(dev)
    yb = torch.from_numpy(data.y_train[:256]).to(dev)
    ocfg = optim.AdamWConfig(lr=5e-3, weight_decay=1e-4)
    out = {}
    for mode, net, lasso in (("dense", flow.dense_params, 1e-4),
                             ("sparse", flow.params, 0.0)):
        state = [optim.adamw_init(assemble.leaves(net))]

        def step():
            state[0], _ = lut_trainer.train_step(
                net, cfg, ocfg, state[0], xb, yb, dense=mode == "dense",
                lasso=lasso)

        step()
        torch.cuda.synchronize()
        build.reset_counters()
        t0 = time.perf_counter()
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 3 * 1e3
        counts = build.launch_counts()
        k4 = {k: counts.get(k, 0) / 3 for k in K4_ROUTES}
        want_dx = 2 * sum(not s.assemble for s in cfg.layers) \
            if mode == "dense" else 0
        if k4["unit_affine_dx"] != want_dx or \
                counts.get("unit_affine_reference", 0):
            fail(f"train step {mode}: K4 launches {counts}, expected "
                 f"{want_dx} dense dx reductions a step and no reference "
                 "kernel")
        wall, prof, _ = profile(step, calls=1)
        busy = sum(sec for _, sec in prof.values())
        k4_dev = {k: sum(sec for key, (_, sec) in prof.items()
                         if K4_KERNELS[k] in key) for k in K4_ROUTES[1:]}
        k4_dev["unit_affine"] = sum(k4_dev.values())
        # where the rest of the device time goes: the five largest kernels
        top = sorted(((sec, n, key[:60]) for key, (n, sec) in prof.items()),
                     reverse=True)[:5]
        out[mode] = {"ms": ms, "k4_launches": k4, "profiled_wall_s": wall,
                     "device_busy_s": busy, "k4_device_s": k4_dev,
                     "device_idle_share": 1.0 - busy / wall,
                     "top_kernels": [(key, n, sec * 1e3)
                                     for sec, n, key in top]}
        print(f"train step {mode}: {ms:.2f} ms/step, K4 launches/step "
              f"{ {k: round(v, 2) for k, v in k4.items()} }, profiled step "
              f"wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms "
              f"(K4 ms { {k: round(v * 1e3, 3) for k, v in k4_dev.items()} }"
              f"), idle share {1.0 - busy / wall:.3f}; largest kernels (name, "
              f"launches, ms) {out[mode]['top_kernels']} [{smi}]",
              flush=True)
    return out


def hold_step(cpu, card, losses, lr: float, label: str) -> float:
    """Fail unless the loss and the updated parameters of one training step
    on the card (``card``) agree with the CPU's (``cpu``) at rtol 1e-4
    (atol 1e-6); elements whose CPU gradient is below 1e-6 are rounding
    noise that Adam moves by up to lr either way, and are held to 2 lr.
    Returns the largest difference outside them."""
    import torch
    from repro_torch.core import assemble

    worst = 0.0
    for pc, pg in zip(assemble.leaves(cpu), assemble.leaves(card)):
        grad = pc.grad if isinstance(pc, torch.nn.Parameter) else None
        pg = pg.detach().cpu()
        pc = pc.detach()
        if not pc.dtype.is_floating_point:
            if not torch.equal(pc, pg):
                fail(f"{label}: an integer leaf changed")
            continue
        noise = (grad.abs() < 1e-6 if grad is not None
                 else torch.zeros_like(pc, dtype=torch.bool))
        diff = (pc - pg).abs()
        worst = max(worst, float(diff[~noise].max()) if (~noise).any()
                    else 0.0)
        if not torch.allclose(pg[~noise], pc[~noise], rtol=1e-4,
                              atol=1e-6) or \
                bool((diff[noise] > 2 * lr + 1e-6).any()):
            fail(f"{label}: parameters differ by up to {float(diff.max())}")
    if abs(losses[0] - losses[1]) > 1e-4 * abs(losses[0]):
        fail(f"{label}: loss {losses}")
    return worst


def step_card_vs_cpu(dev) -> dict:
    """One training step of ``mnist_reduced`` (dense and sparse) on the card
    and on the CPU from the same initial parameters and batch, held by
    :func:`hold_step` (the noise elements are the last bias before BN,
    which BN cancels)."""
    import torch
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble
    from repro_torch.data import synthetic
    from repro_torch.train import lut_trainer, optim

    cfg = paper_tasks.reduced("mnist")
    data = synthetic.load("mnist", n_train=256, n_test=16)
    lr = 5e-3
    ocfg = optim.AdamWConfig(lr=lr, weight_decay=1e-4)
    out = {}
    for dense in (True, False):
        cpu = assemble.init(3, cfg, dense=dense, device="cpu")
        card = assemble.params_from_reference(
            assemble.params_to_reference(cpu), device=dev)
        losses = []
        for net, d in ((cpu, "cpu"), (card, dev)):
            opt = optim.adamw_init(assemble.leaves(net))
            _, loss = lut_trainer.train_step(
                net, cfg, ocfg, opt, torch.from_numpy(data.x_train).to(d),
                torch.from_numpy(data.y_train).to(d), dense=dense,
                lasso=1e-4 if dense else 0.0)
            losses.append(float(loss))
        worst = hold_step(cpu, card, losses, lr,
                          f"card vs CPU step (dense={dense})")
        out["dense" if dense else "sparse"] = {"loss_cpu": losses[0],
                                               "loss_card": losses[1],
                                               "max_param_diff": worst}
    print(f"one step card vs CPU (mnist_reduced): {out}", flush=True)
    return out


def train_nid(dev, smi: str) -> dict:
    """``nid_reduced`` on the data and step counts of
    tests/test_paper_flow.py, trained on the card: accuracy above 0.75 and
    folded accuracy equal to the quantized model's."""
    import torch
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.data import synthetic

    cfg = paper_tasks.reduced("nid")
    data = synthetic.load("nid", n_train=4096, n_test=1024)
    t0 = time.perf_counter()
    flow = pipeline.Toolflow(cfg, pretrain_steps=120, retrain_steps=200,
                             device=dev)
    flow.run(data)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acc = flow.accuracy(max_eval=1024)
    facc = flow.accuracy(folded=True, max_eval=1024)
    print(f"nid_reduced on the card: accuracy {acc:.4f}, folded {facc:.4f},"
          f" {secs:.1f} s for 320 steps and the fold [{smi}]", flush=True)
    if not acc > 0.75:
        fail(f"nid_reduced accuracy {acc} <= 0.75")
    if acc != facc:
        fail(f"nid_reduced folded accuracy {facc} != {acc}")
    return {"accuracy": acc, "folded_accuracy": facc, "seconds": secs}


STREAM_STEPS = (20, 30)      # pretrain, retrain steps of the stream cell
STREAM_STREAMS = 1024        # concurrent streams served
STREAM_BLOCK = 256           # rows a block of the cell-mode engine


def stream_cell_step_card_vs_cpu(dev, cc, data) -> dict:
    """One truncated-BPTT step of ``seqmnist_reduced`` (64 sequences of 49
    steps, windows of 8), dense and sparse, on the card and on the CPU from
    the same parameters, held by :func:`hold_step`."""
    import torch
    from repro_torch.core import assemble
    from repro_torch.train import lut_trainer, optim

    lr = 5e-3
    ocfg = optim.AdamWConfig(lr=lr, weight_decay=1e-4)
    xb = torch.from_numpy(data.x_train[:64])
    yb = torch.from_numpy(data.y_train[:64])
    out = {}
    for dense in (True, False):
        cpu = assemble.init(5, cc.net, dense=dense, device="cpu")
        card = assemble.params_from_reference(
            assemble.params_to_reference(cpu), device=dev)
        losses = []
        for net, d in ((cpu, "cpu"), (card, dev)):
            opt = optim.adamw_init(assemble.leaves(net))
            _, loss = lut_trainer.train_stream_step(
                net, cc, ocfg, opt, xb.to(d), yb.to(d), window=8,
                dense=dense, lasso=1e-4 if dense else 0.0)
            losses.append(float(loss))
        worst = hold_step(cpu, card, losses, lr,
                          f"stream step card vs CPU (dense={dense})")
        out["dense" if dense else "sparse"] = {
            "loss_cpu": losses[0], "loss_card": losses[1],
            "max_param_diff": worst}
    print(f"one stream step card vs CPU (seqmnist_reduced): {out}",
          flush=True)
    return out


def serve_streams(card, cpu_codes, xs, backend: str, dev, smi: str) -> dict:
    """Serve ``xs [N, T, n_in]`` as N concurrent streams through a
    ``StreamRouter`` (block 256, depth 2) on ``backend`` with the launch
    counts set to 0 just before; fail unless every stream's codes and final
    state equal the offline ``take`` scan on the card and the CPU
    (``cpu_codes``) and the backend's kernel launched once a block (K1) or
    once a layer a block (K3).  Returns the serving numbers and the
    idle share of 10 profiled block ticks."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.stream.session import StreamRouter

    want, want_s = cpu_codes
    n, t = xs.shape[:2]
    warm = StreamRouter(card, block=STREAM_BLOCK, depth=2, backend=backend)
    warm.run_sequences({i: xs[i, :2] for i in range(STREAM_BLOCK)})
    router = StreamRouter(card, block=STREAM_BLOCK, depth=2, backend=backend)
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    for sid in range(n):
        router.open(sid)
        router.feed(sid, xs[sid])
    router.pump()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    blocks = router.engine.stats.ticks
    layers = len(card.cell.net.layers)
    kname, per_block, other = (("lut_cascade_resident", 1, "lut_lookup")
                               if backend == "fused" else
                               ("lut_lookup", layers, "lut_cascade_resident"))
    if counts.get(kname, 0) != per_block * blocks or counts.get(other, 0) \
            or counts.get("lut_cascade_streamed", 0):
        fail(f"stream/{backend}: launches {counts}, expected {kname} "
             f"{per_block} x {blocks} blocks and no other LUT kernel")
    for sid in range(n):
        s = router.sessions[sid]
        if not (np.array_equal(s.codes(), want[sid])
                and np.array_equal(router.store.get(sid), want_s[sid])):
            fail(f"stream/{backend}: stream {sid} differs from the offline "
                 "take scan")
    steps = n * t
    out = {"streams": n, "steps_per_stream": t, "steps": steps,
           "block": STREAM_BLOCK, "depth": 2, "blocks": blocks,
           "rows_padded": router.engine.stats.rows_padded,
           "state_bytes": router.store.nbytes, "launches": counts,
           "wall_s": wall, "steps_per_s": steps / wall,
           "p50_step_us": router.latency_us(50),
           "p99_step_us": router.latency_us(99),}
    # one steady block tick at a time under the profiler (the router holds
    # a block in flight, so a tick dispatches one block and retires one)
    prof_router = StreamRouter(card, block=STREAM_BLOCK, depth=2,
                               backend=backend)
    for sid in range(n):
        prof_router.open(sid)
        prof_router.feed(sid, xs[sid])
    for _ in range(4):
        prof_router.tick()
    pwall, prof, _ = profile(prof_router.tick, calls=10)
    busy = sum(sec for _, sec in prof.values())
    out.update(profiled_ticks=10, profiled_wall_s=pwall,
               device_busy_s=busy, device_idle_share=1.0 - busy / pwall,
               device_kernels={key[:60]: (c, sec * 1e3)
                               for key, (c, sec) in prof.items()})
    print(f"stream/{backend}: {n} streams x {t} steps, every stream == "
          f"offline take on the card and the CPU, {steps / wall:,.0f} "
          f"steps/s, step latency p50 {out['p50_step_us']:.0f} us p99 "
          f"{out['p99_step_us']:.0f} us, {blocks} blocks ({out['rows_padded']}"
          f" rows padded), state {out['state_bytes']} B, launches {counts}; "
          f"10 profiled ticks: wall {pwall * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.3f} ms, idle share {1.0 - busy / pwall:.3f} [{smi}]",
          flush=True)
    return out


def state_sensitivity(cpu, xs, want) -> dict:
    """Shows that the served-vs-offline check of ``serve_streams`` can catch
    a state served to the wrong stream: on the CPU cell's ``take`` scan of
    ``xs [N, T, n_in]``, the distinct states across streams at each step,
    and the streams whose codes change in two faulty scans, one that hands
    every stream the previous stream's state at each step (a cross-stream
    leak) and one that resets the state to the initial code each step.
    Fails unless the final states differ across streams, the leak changes
    the codes of at least a tenth of the streams and the reset those of
    some stream."""
    import torch
    n, t = xs.shape[:2]
    x = torch.as_tensor(xs, dtype=torch.float32)
    s0 = cpu.init_state_codes(n)
    s = leak_s = s0
    distinct, leak, reset = [], [], []
    for i in range(t):
        _, _, s = cpu.step(x[:, i], s, backend="take")
        distinct.append(len(torch.unique(s, dim=0)))
        c, _, leak_s = cpu.step(x[:, i], torch.roll(leak_s, 1, 0),
                                backend="take")
        leak.append(c)
        reset.append(cpu.step(x[:, i], s0, backend="take")[0])
    changed = {name: int((torch.stack(c, 1) != want).flatten(1).any(1).sum())
               for name, c in (("leak", leak), ("reset", reset))}
    out = {"distinct_states_by_step": distinct,
           "final_distinct_states": distinct[-1],
           "streams_changed": changed}
    if distinct[-1] < 2 or 10 * changed["leak"] < n or not changed["reset"]:
        fail(f"stream: the states carry too little to show a cross-stream "
             f"leak: {out}")
    return out


def stream_kernels(card, rs, dev, smi: str, b: int = STREAM_BLOCK,
                   path: str = "seqmnist/stream",
                   task: str = "seqmnist_reduced cell") -> list:
    """K1 on one block of the cell (``b`` rows) and K3 per launch (the mean
    of the cell's layers at ``b`` rows), each held against its plain
    version at the block and at ragged batches; returns their rows for the
    kernel table (launches filled in by the caller)."""
    import torch
    from repro_torch.kernels import lut_cascade, lut_gather

    plan = card.net.compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    tables = plan.tensor("tables", dev)
    maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    ops = lut_cascade.prepare(tables, layers, maps)
    span = 2 ** layers[0][5]
    err1 = 0
    for rows in (1, 3, 255, b, 257, 1024):
        codes = torch.from_numpy(rs.randint(0, span, size=(
            rows, layers[0][0])).astype("int32")).to(dev)
        got = lut_cascade.lut_cascade_resident(codes, ops)
        torch.cuda.synchronize()
        want = lut_cascade.lut_cascade_plain(codes, tables, maps, layers)
        err1 = max(err1, int((got - want).abs().max()))
    lplan = card.net.compile_backend("pallas").plan
    shapes = []
    err3 = 0
    for l in range(len(lplan.meta["layers"])):
        table = lplan.tensor(f"table_{l}", dev)
        for rows in (1, 257, b):
            addr = torch.from_numpy(rs.randint(0, table.shape[1], size=(
                rows, table.shape[0])).astype("int32")).to(dev)
            got = lut_gather.lut_lookup_cuda(table, addr)
            torch.cuda.synchronize()
            err3 = max(err3, int((got - lut_gather.lut_lookup_plain(
                table, addr)).abs().max()))
        shapes.append((table, addr))
    if err1 or err3:
        fail(f"stream cell kernels disagree with their plain versions: K1 "
             f"{err1}, K3 {err3}")
    codes = torch.from_numpy(rs.randint(0, span, size=(
        b, layers[0][0])).astype("int32")).to(dev)
    byts, n_ops = cascade_work(layers, b, tables.numel()
                               * tables.element_size(), ops.map_words * 4)
    rows = []
    # K3's yardstick is one torch.gather a layer, as in phase 5; no single
    # PyTorch call computes K1's cascade
    for name, kern, plain, lib, nbytes, per, sub in (
            ("lut_cascade_resident",
             lambda: lut_cascade.lut_cascade_resident(codes, ops),
             lambda: lut_cascade.lut_cascade_plain(codes, tables, maps,
                                                   layers),
             None, byts, 1, "cascade_resident_kernel"),
            ("lut_lookup",
             lambda: [lut_gather.lut_lookup_cuda(t, a) for t, a in shapes],
             lambda: [lut_gather.lut_lookup_plain(t, a) for t, a in shapes],
             lambda: [torch.gather(t, 1, a.t().long()).t()
                      for t, a in shapes],
             sum(a.numel() * 8 + t.numel() * 4 for t, a in shapes),
             len(shapes), "lut_lookup_kernel")):
        ms = per_call_ms(kern) / per
        plain_ms = per_call_ms(plain) / per
        device_ms = traced_ms(kern, sub, 10, per)
        device_ms = None if device_ms is None else device_ms / per
        lib_ms = lib_dev_ms = None
        if lib is not None:
            lib_ms = per_call_ms(lib) / per
            lib_dev_ms = traced_all_ms(lib)[0]
            lib_dev_ms = None if lib_dev_ms is None else lib_dev_ms / per
        bound_ms, bound_by = bound(nbytes // per, n_ops if per == 1 else 0)
        rows.append({"name": name, "path": path, "task": task, "batch": b,
                     "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": err1 if per == 1 else err3})
        print(f"time {name} ({task}, batch {b}, per launch): "
              f"kernel {ms:.4f} ms (device {device_ms} ms), plain "
              f"{plain_ms:.4f} ms, library {lib_ms} ms (device {lib_dev_ms}"
              f" ms), bound {bound_ms:.6f} ms ({bound_by})"
              + (f", plan {k1_plan(ops, b)}" if per == 1 else "")
              + f" [{smi}]", flush=True)
    rows[0]["plan"] = k1_plan(ops, b)
    return rows


def stream_phase(dev, smi: str, seed: int, art_dir: Path) -> dict:
    """Slice 8's main path: ``seqmnist_reduced`` at its own widths trained
    on the card through ``Toolflow(cell, tbptt=8)`` (K4 in pretrain and
    retrain, launch counts set to 0 just before), folded, saved, reloaded,
    and 1,024 concurrent streams x 49 steps served on ``fused`` (K1) and
    ``pallas`` (K3); the folded cell equals the training graph's codes,
    and the served codes the offline ``take`` scan on the card and the
    CPU."""
    import numpy as np
    import torch
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.kernels import build
    from repro_torch.stream import cell as stream_cell

    cc = paper_tasks.stream_task_config("seqmnist_reduced")
    data = paper_tasks.stream_task_data("seqmnist_reduced", n_train=2048,
                                        n_test=STREAM_STREAMS)
    out = {"task": "seqmnist_reduced", "steps": STREAM_STEPS, "tbptt": 8}
    flow = pipeline.Toolflow(cc, pretrain_steps=STREAM_STEPS[0],
                             retrain_steps=STREAM_STEPS[1], batch_size=64,
                             tbptt=8, device=dev)
    launches = {}
    for name, fn in (("pretrain", lambda: flow.pretrain(data)),
                     ("prune", flow.prune), ("retrain", flow.retrain),
                     ("compile", lambda: flow.compile(backend="fused"))):
        torch.cuda.synchronize()
        build.reset_counters()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[f"{name}_s"] = time.perf_counter() - t
        launches[name] = build.launch_counts()
        if name in ("pretrain", "retrain") and (
                launches[name].get("unit_affine", 0) < 1
                or launches[name].get("unit_affine_reference", 0)):
            fail(f"stream toolflow: K4 launches in {name}: {launches[name]}")
    out["launches"] = launches
    for st in ("pretrain", "retrain"):
        loss = flow.stages[st].metrics["final_loss"]
        out[f"{st}_final_loss"] = loss
        if not np.isfinite(loss):
            fail(f"stream toolflow: {st} loss is {loss}")
    comp = flow.compiled
    xs = data.x_test[:STREAM_STREAMS]
    folded = comp.predict_sequence(xs, backend="take")[0]
    graph = stream_cell.apply_sequence_codes(flow.params, cc, xs)
    if not torch.equal(folded, graph):
        fail("stream toolflow: the folded cell differs from the training "
             "graph's codes")
    out["accuracy"] = flow.accuracy(max_eval=STREAM_STREAMS)
    out["folded_accuracy"] = flow.accuracy(folded=True,
                                           max_eval=STREAM_STREAMS)
    print(f"stream toolflow (seqmnist_reduced, tbptt 8): pretrain "
          f"{out['pretrain_s']:.2f} s ({STREAM_STEPS[0]} steps), retrain "
          f"{out['retrain_s']:.2f} s ({STREAM_STEPS[1]} steps), fold "
          f"{out['compile_s']:.3f} s, losses {out['pretrain_final_loss']:.4f}"
          f" / {out['retrain_final_loss']:.4f}, K4 launches by stage "
          f"{ {k: v.get('unit_affine', 0) for k, v in launches.items()} }; "
          f"folded == training graph over {STREAM_STREAMS} x 49 steps; "
          f"accuracy {out['accuracy']:.4f}, folded "
          f"{out['folded_accuracy']:.4f} [{smi}]", flush=True)

    path = comp.save(str(art_dir / "seqmnist_cell.npz"))
    out["artifact"] = path
    card = stream_cell.CompiledStreamCell.load(path, device=dev)
    cpu = stream_cell.CompiledStreamCell.load(path, device="cpu")
    want, _, want_s = cpu.predict_sequence(xs, backend="take")
    take, _, take_s = card.predict_sequence(xs, backend="take")
    if not (torch.equal(take.cpu(), want) and torch.equal(take_s.cpu(),
                                                          want_s)):
        fail("stream: the card's offline take scan differs from the CPU's")
    out["state_sensitivity"] = state_sensitivity(cpu, xs, want)
    print(f"stream state: {out['state_sensitivity']['final_distinct_states']}"
          f" distinct final states over {STREAM_STREAMS} streams (at most "
          f"{max(out['state_sensitivity']['distinct_states_by_step'])} a "
          f"step); streams whose codes a faulty scan changes: "
          f"{out['state_sensitivity']['streams_changed']}", flush=True)
    ref = (want.numpy(), want_s.numpy())
    out["serve"] = {be: serve_streams(card, ref, xs, be, dev, smi)
                    for be in ("fused", "pallas")}
    out["step_card_vs_cpu"] = stream_cell_step_card_vs_cpu(dev, cc, data)
    out["kernels"] = stream_kernels(card, np.random.RandomState(seed + 8),
                                    dev, smi)
    return out


def hw_surfaces(path: str, dev, smi: str) -> dict:
    """``hw_report``, ``to_verilog`` (its length and sha256), ``count_luts``,
    ``calibration_vs_rtl`` and ``dontcare.analyze`` (on 4,096 training
    rows) of the card-folded ``mnist`` artifact; fails unless its Verilog
    equals byte for byte the Verilog of the same artifact loaded on the
    CPU and the don't-care reports agree."""
    import dataclasses
    import hashlib
    from repro_torch import pipeline
    from repro_torch.core import dontcare, hwcost, rtl
    from repro_torch.data import synthetic

    t0 = time.perf_counter()
    card = pipeline.CompiledLUTNetwork.load(path, device=dev)
    cpu = pipeline.CompiledLUTNetwork.load(path, device="cpu")
    rep = card.hw_report()
    verilog = card.to_verilog()
    if verilog != cpu.to_verilog():
        fail("hw surfaces: the card artifact's Verilog differs from the "
             "CPU load's")
    counted = rtl.count_luts(verilog)
    cal = hwcost.calibration_vs_rtl(card.folded())
    if counted != cal["rtl_luts"] or abs(cal["ratio"] - 1.0) > 0.02:
        fail(f"hw surfaces: count_luts {counted}, calibration {cal}")
    x = synthetic.load("mnist").x_train[:4096]
    dc = dontcare.analyze(card.folded(), x)
    if dataclasses.asdict(dc) != dataclasses.asdict(
            dontcare.analyze(cpu.folded(), x)):
        fail("hw surfaces: the don't-care analysis differs between the "
             "card and the CPU")
    out = {"hw_report": dataclasses.asdict(rep),
           "verilog_bytes": len(verilog.encode()),
           "verilog_sha256": hashlib.sha256(verilog.encode()).hexdigest(),
           "count_luts": counted, "calibration": cal,
           "dontcare": dict(dataclasses.asdict(dc),
                            lut_reduction=dc.lut_reduction),
           "seconds": time.perf_counter() - t0}
    print(f"hw surfaces (mnist, folded on the card): {rep}; Verilog "
          f"{out['verilog_bytes']} B sha256 {out['verilog_sha256'][:16]}.. "
          f"== CPU load's; count_luts {counted}, calibration ratio "
          f"{cal['ratio']}; don't-care {dc.structural_luts} -> "
          f"{dc.optimized_luts} LUTs ({dc.lut_reduction:.3f}x) "
          f"({out['seconds']:.1f} s)", flush=True)
    return out


FLEET_EVENTS = 128           # the reference fleet benchmark's trace length
FLEET_BLOCK = 256            # rows a block of every fleet lane
FLEET_TENANTS = (("nid", "nid", "fused", "lut_cascade_resident"),
                 ("jsc_openml", "jsc_openml", "fused", "lut_cascade_resident"),
                 ("mnist", "mnist", "fused", "lut_cascade_streamed"),
                 ("nid_k3", "nid", "pallas", "lut_lookup"))
LUT_KERNELS = ("lut_cascade_resident", "lut_cascade_streamed", "lut_lookup")
PLACED_BLOCK = 1024          # a placed lane's block: 512 rows a slot of 2


def lut_launches() -> dict:
    """The LUT kernels' launch counts since the last reset."""
    from repro_torch.kernels import build
    counts = build.launch_counts()
    return {k: counts.get(k, 0) for k in LUT_KERNELS}


def fleet_codes(reqs) -> "np.ndarray":
    import numpy as np
    return np.stack([r.codes for r in reqs])


def fleet_replay(fleet, paths, dev, seed: int, smi: str) -> dict:
    """The four tenants serve a ragged trace (``tests/traffic.py``) with the
    launch counts set to 0 just before; fails unless every tenant's codes
    equal its artifact's ``take`` codes on the card and on a CPU load, K1
    and K2 launched once a block of their lanes, K3 once a layer a block
    of its lane (5 at ``nid``), and no lane degraded."""
    import numpy as np
    import torch
    import traffic
    from repro_torch import pipeline
    from repro_torch.kernels import build

    mids = tuple(m for m, *_ in FLEET_TENANTS)
    nets = {m: fleet.registry.get(m).net for m in mids}
    trace = traffic.ragged_trace(mids, n_events=FLEET_EVENTS, seed=seed + 9)
    inputs = traffic.make_inputs(
        trace, {m: n.cfg.in_features for m, n in nets.items()},
        seed=seed + 10)
    for m, net in nets.items():                  # lanes and operands built
        fleet.submit_many(m, np.zeros((1, net.cfg.in_features), np.float32))
    fleet.pump()
    before = {m: fleet.stats(m).ticks for m in mids}
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    log = {m: [] for m in mids}
    for ev, xs in zip(trace, inputs):
        reqs, dec = fleet.submit_many(ev.model_id, xs)
        if not dec.admitted_all:
            fail(f"fleet: {ev.model_id} shed or deferred rows: {dec}")
        log[ev.model_id].append((xs, reqs))
        for _ in range(1 + ev.gap_ticks):
            fleet.tick()
    fleet.pump()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = lut_launches()
    blocks = {m: fleet.stats(m).ticks - before[m] for m in mids}
    want = {"lut_cascade_resident": blocks["nid"] + blocks["jsc_openml"],
            "lut_cascade_streamed": blocks["mnist"],
            "lut_lookup": len(nets["nid_k3"].cfg.layers) * blocks["nid_k3"]}
    if counts != want:
        fail(f"fleet: launches {counts}, expected {want} for blocks {blocks}")
    out = {"events": len(trace), "rows": traffic.total_rows(trace),
           "wall_s": wall, "blocks": blocks, "launches": counts,
           "tenants": {}}
    for mid, task, backend, _ in FLEET_TENANTS:
        pairs = log[mid]
        if not pairs:
            continue
        xs = np.concatenate([x for x, _ in pairs])
        got = np.concatenate([fleet_codes(r) for _, r in pairs])
        card = nets[mid].predict_codes(xs, backend="take").cpu().numpy()
        cpu = pipeline.CompiledLUTNetwork.load(
            paths[mid], device="cpu").predict_codes(xs, backend="take")
        if not (np.array_equal(got, card) and np.array_equal(got,
                                                             cpu.numpy())):
            fail(f"fleet: {mid} codes differ from its artifact's take codes "
                 "on the card or the CPU")
        s = fleet.summary(mid)
        if s["degrades"] or s["failures"]:
            fail(f"fleet: lane {mid} failed or degraded: {s}")
        out["tenants"][mid] = {
            "task": task, "backend": backend, "rows": len(xs),
            "blocks": blocks[mid], "rows_per_s": len(xs) / wall,
            "p50_request_us": fleet.stats(mid).latency_us(50),
            "p99_request_us": fleet.stats(mid).latency_us(99)}
    print(f"fleet replay: {out['rows']} rows in {len(trace)} events over 4 "
          f"tenants, {out['rows'] / wall:,.0f} rows/s, every tenant == take "
          f"on the card and the CPU; blocks {blocks}, launches {counts}; "
          + ", ".join(f"{m} p50/p99 {t['p50_request_us']:.0f}/"
                      f"{t['p99_request_us']:.0f} us"
                      for m, t in out["tenants"].items()) + f" [{smi}]",
          flush=True)
    return out


def fleet_idle_share(fleet, smi: str) -> dict:
    """The device's idle share over 10 profiled fleet ticks with every lane
    holding work (one block a lane a tick).  A trace that lacks the device
    work of some launch call would read as idle time, so it is taken again
    with a longer lead, as ``traced_all_ms`` does; after ``TRACE_LEADS``
    tries the share is None ("not measured")."""
    import numpy as np
    rs = np.random.RandomState(7)
    for lead in TRACE_LEADS:
        for mid, *_ in FLEET_TENANTS:           # 3 warm + 11 profiled ticks
            net = fleet.registry.get(mid).net
            fleet.submit_many(mid, rs.uniform(-1.0, 1.0, (
                16 * FLEET_BLOCK, net.cfg.in_features)).astype(np.float32))
        for _ in range(3):
            fleet.tick()
        wall, prof, lost = profile(fleet.tick, calls=10, lead=lead)
        fleet.pump()
        if prof and not lost:
            break
        RETRACED.append({"kernel": "fleet ticks", "lead": lead,
                         "lost": lost, "lead_lost": LEAD_LOST[-1]})
    else:
        _untraced("the fleet's ticks", f"{lost} launch calls without "
                  "device work")
        return {"profiled_ticks": 10, "wall_s": wall, "device_busy_s": None,
                "device_idle_share": None, "device_kernels": {}}
    busy = sum(sec for _, sec in prof.values())
    out = {"profiled_ticks": 10, "wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall, "trace_lead": lead,
           "device_kernels": {k[:60]: (c, sec * 1e3)
                              for k, (c, sec) in prof.items()}}
    print(f"fleet, 10 profiled ticks: wall {wall * 1e3:.2f} ms, device busy "
          f"{busy * 1e3:.3f} ms, idle share {out['device_idle_share']:.3f} "
          f"[{smi}]", flush=True)
    return out


def fleet_hot_swap(fleet, inj, trained: str, seed: int) -> dict:
    """Deploy the card-trained ``mnist`` artifact (phase 6) onto the
    ``mnist`` lane with blocks in flight, then again with the injector
    corrupting the candidate's tables.  Fails unless no request is
    dropped, blocks dispatched before the swap answer with the random
    version's codes and every later one with the trained version's, the
    corrupted candidate is rejected by the smoke check and the rollback is
    in the swap history."""
    import numpy as np
    import torch
    from repro_torch import pipeline

    v1 = fleet.registry.get("mnist").net
    v2 = pipeline.CompiledLUTNetwork.load(trained, device=v1.device)
    rs = np.random.RandomState(seed + 11)
    x = rs.uniform(0.0, 1.0, (6 * FLEET_BLOCK, v1.cfg.in_features)
                   ).astype(np.float32)
    first, _ = fleet.submit_many("mnist", x[:4 * FLEET_BLOCK])
    fleet.tick()                                # blocks in flight on v1
    queued = {id(r) for r in fleet._lanes["mnist"].engine.queue}
    ok = fleet.deploy("mnist", trained)         # self-checked
    second, _ = fleet.submit_many("mnist", x[4 * FLEET_BLOCK:])
    bad = fleet.deploy("mnist", trained)        # corrupted at load
    third, _ = fleet.submit_many("mnist", x[:FLEET_BLOCK])
    fleet.pump()
    torch.cuda.synchronize()
    every = first + second + third
    if not all(r.done for r in every):
        fail("hot swap: requests dropped")
    dispatched = {id(r) for r in first} - queued
    on_v1 = [r for r in every if id(r) in dispatched]
    on_v2 = [r for r in every if id(r) not in dispatched]
    for reqs, net, name in ((on_v1, v1, "v1"), (on_v2, v2, "v2")):
        if reqs and not np.array_equal(fleet_codes(reqs), net.predict_codes(
                np.stack([r.x for r in reqs]), backend="take").cpu().numpy()):
            fail(f"hot swap: rows served by {name} differ from its take codes")
    hist = fleet.summary("mnist")["swap_history"]
    if not (ok.ok and not bad.ok and inj.fired("corrupt_artifact") == 1
            and hist[-1]["ok"] is False
            and fleet.summary("mnist")["version"] == 2):
        fail(f"hot swap: good {ok}, corrupted {bad}, history {hist}")
    changed = int((v1.predict_codes(x[:256], backend="take")
                   != v2.predict_codes(x[:256], backend="take")).any(1).sum())
    out = {"requests": len(every), "dropped": 0, "served_by_v1": len(on_v1),
           "served_by_v2": len(on_v2), "versions_differ_on": changed,
           "swap_history": hist}
    print(f"fleet hot swap: trained mnist deployed with {len(on_v1)} rows in "
          f"flight on v1 and {len(on_v2)} served by v2 (the versions differ "
          f"on {changed} of 256 rows), 0 dropped; corrupted candidate "
          f"rejected ({bad.reason}), rollback recorded", flush=True)
    return out


def fleet_placements(paths, dev, seed: int, smi: str) -> dict:
    """``nid`` on ``fused`` batch-split over 2 slots (K1 at 512 rows a
    slot) and on ``pallas`` units-split over 2 slots (K3 on half of every
    layer's units), the slots over ``cuda:0..n-1`` (both on ``cuda:0`` on
    one card); fails unless the codes equal the unplaced ones and each
    block launched K1 once a slot or K3 once a layer a slot.  The same rows
    through an unplaced lane give the rows/s to compare with."""
    import numpy as np
    import torch
    from repro_torch import backends, pipeline
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve import LUTFleet

    mesh = make_serving_mesh(slots=2)
    physical = torch.cuda.device_count()
    rs = np.random.RandomState(seed + 12)
    out = {"slots": mesh.size, "physical_devices": physical,
           "slot_devices": [str(s.device) for s in mesh.slots]}

    def serve(backend, placement, x):
        """(requests, seconds, launches, blocks, degrades) of ``x`` through
        a fresh one-tenant fleet, its lane warmed first."""
        fleet = LUTFleet(block=PLACED_BLOCK, depth=2, device=dev)
        fleet.register("nid", paths["nid"], backend=backend,
                       placement=placement)
        fleet.submit_many("nid", x[:8])
        fleet.pump()
        torch.cuda.synchronize()
        build.reset_counters()
        t0 = time.perf_counter()
        reqs, _ = fleet.submit_many("nid", x)
        fleet.pump()
        torch.cuda.synchronize()
        return (reqs, time.perf_counter() - t0, lut_launches(),
                fleet.stats("nid").ticks - 1, fleet.stats("nid").degrades)

    for name, backend, kname, per_slot in (
            ("batch", "fused", "lut_cascade_resident", 1),
            ("units", "pallas", "lut_lookup", None)):
        net = pipeline.CompiledLUTNetwork.load(paths["nid"], device=dev)
        x = rs.uniform(-1.0, 1.0, (4 * PLACED_BLOCK + 77, net.cfg.in_features)
                       ).astype(np.float32)
        _, base_s, _, _, _ = serve(backend, None, x)
        reqs, wall, counts, blocks, degrades = serve(
            backend, backends.Placement(mesh, strategy=name), x)
        per_block = mesh.size * (per_slot or len(net.cfg.layers))
        unplaced = net.predict_codes(x, backend=backend).cpu().numpy()
        if not np.array_equal(fleet_codes(reqs), unplaced):
            fail(f"placement {name}: codes differ from the unplaced run")
        if counts[kname] != per_block * blocks or degrades:
            fail(f"placement {name}: launches {counts} for {blocks} blocks")
        out[name] = {"backend": backend, "rows": len(x), "blocks": blocks,
                     "launches": counts, "rows_per_s": len(x) / wall,
                     "unplaced_rows_per_s": len(x) / base_s}
        print(f"placement {name} ({backend}) over {mesh.size} slots on "
              f"{physical} physical device(s) {out['slot_devices']}: {len(x)}"
              f" rows == unplaced, {blocks} blocks, launches {counts}, "
              f"{len(x) / wall:,.0f} rows/s (unplaced "
              f"{len(x) / base_s:,.0f}) [{smi}]", flush=True)
    return out


def fleet_faults(paths, dev, seed: int) -> dict:
    """One scenario per fault class through ``FaultInjector`` on the
    ``nid`` lane (``jsc_openml`` beside it): a transient exception
    (retried), a persistent one (breaker trip, degrade to ``take``), a hang
    (the deadline abandons the block), device loss on slot 1 of 2 (remesh
    onto the survivor) and a corrupt deploy (rejected).  Fails unless every
    answer equals ``take``, no accepted request is lost, and the lane
    degraded exactly where the scenario injects it."""
    import numpy as np
    import traffic
    from repro_torch import backends
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.serve import (FaultInjector, FaultPlan, FaultSpec,
                                   LUTFleet, ResiliencePolicy,
                                   make_reference)

    policy = ResiliencePolicy(backoff_base_s=0.0)
    deadline = ResiliencePolicy(deadline_s=0.5, backoff_base_s=0.0)
    two = backends.Placement(make_serving_mesh(slots=2))
    scenarios = {
        "transient": ([FaultSpec("exception", at=1, scope="nid", count=2)],
                      policy, {}, 0),
        "persistent": ([FaultSpec("exception", at=1, scope="nid", count=3)],
                       policy, {}, 1),
        "hang": ([FaultSpec("hang", at=1, scope="nid", stall_s=2.0)],
                 deadline, {}, 0),
        "device_loss": ([FaultSpec("device_loss", at=1, scope="nid",
                                   device=1)], policy,
                        {"placement": two}, 1),
        "corrupt_deploy": ([FaultSpec("corrupt_artifact", at=0,
                                      scope="nid")], policy, {}, 0),
    }
    trace = traffic.ragged_trace(("nid", "jsc_openml"), n_events=24,
                                 seed=seed + 13, batches=(1, 8, 33, 257))
    out = {}
    for name, (specs, pol, reg, degrades) in scenarios.items():
        inj = FaultInjector(FaultPlan(specs))
        fleet = LUTFleet(block=FLEET_BLOCK, faults=inj, policy=pol,
                         device=dev)
        for mid in ("nid", "jsc_openml"):
            fleet.register(mid, paths[mid], backend="fused",
                           **(reg if mid == "nid" else {}))
        nets = {m: fleet.registry.get(m).net for m in ("nid", "jsc_openml")}
        ref = make_reference(nets["nid"], n=64)
        inputs = traffic.make_inputs(
            trace, {m: n.cfg.in_features for m, n in nets.items()},
            seed=seed + 14)
        acked, swap = [], None
        for i, (ev, xs) in enumerate(zip(trace, inputs)):
            if name == "corrupt_deploy" and i == len(trace) // 2:
                swap = fleet.deploy("nid", paths["nid"], reference=ref)
            reqs, _ = fleet.submit_many(ev.model_id, xs)
            acked.append((ev.model_id, xs, reqs))
            fleet.tick()
        fleet.pump()
        lost = sum(not r.done for _, _, reqs in acked for r in reqs)
        wrong = sum(int((fleet_codes(reqs) != nets[m].predict_codes(
            xs, backend="take").cpu().numpy()).any(1).sum())
            for m, xs, reqs in acked if reqs)
        s = fleet.summary("nid")
        out[name] = {"injected": inj.fired(), "wrong": wrong, "lost": lost,
                     "failures": s["failures"], "retries": s["retries"],
                     "deadline_hits": s["deadline_hits"],
                     "breaker_trips": s["breaker_trips"],
                     "degrades": s["degrades"],
                     "degrade_history": s["degrade_history"],
                     "other_lane_degrades":
                         fleet.summary("jsc_openml")["degrades"]}
        if swap is not None:
            out[name]["deploy"] = swap.summary()
        bad = (wrong or lost or not inj.fired() or s["degrades"] != degrades
               or fleet.summary("jsc_openml")["degrades"]
               or (swap is not None and swap.ok))
        if name == "device_loss" and s["degrade_history"] != [{
                "model_id": "nid", "reason": "device_loss",
                "backend": "fused->fused", "shards": "2->1"}]:
            bad = True
        if bad:
            fail(f"fault scenario {name}: {out[name]}")
    print(f"fleet faults: {{name: (injected, failures, degrades)}} "
          f"{ {k: (v['injected'], v['failures'], v['degrades']) for k, v in out.items()} }"
          f"; 0 wrong, 0 lost in every scenario", flush=True)
    return out


def fleet_failover(cell_path: str, dev, seed: int) -> dict:
    """The phase-8 ``seqmnist_reduced`` cell served through
    ``ReplicatedStreamTenant`` on ``fused``; the primary dies mid-trace
    (a churned stream trace) and the standby recovers.  Fails unless every
    stream's combined codes equal the offline ``take`` scan and no acked
    step is lost."""
    import numpy as np
    import traffic
    from repro_torch.serve import LUTFleet
    from repro_torch.stream.cell import CompiledStreamCell
    from repro_torch.stream.replica import (ReplicatedStreamTenant,
                                            StandbyReplica)

    comp = CompiledStreamCell.load(cell_path, device=dev)
    trace = traffic.stream_churn_trace(["cell"], n_events=120, seed=seed + 15,
                                       max_open=48, max_steps=12)
    inputs = traffic.make_stream_inputs(trace, {"cell": comp.cell.n_in},
                                        seed=seed + 16)
    seqs = traffic.stream_sequences(trace, inputs)
    kill = (2 * len(trace)) // 3
    primary = LUTFleet(block=STREAM_BLOCK)
    primary.register("cell", comp, block=STREAM_BLOCK, backend="fused")
    standby = StandbyReplica("cell", cell_path, block=STREAM_BLOCK,
                             backend="fused")
    tenant = ReplicatedStreamTenant(primary, "cell", standby,
                                    checkpoint_every=64)
    for ev, x in zip(trace[:kill], inputs[:kill]):
        if ev.action == "open":
            tenant.open_stream(ev.stream_id)
        elif ev.action == "feed":
            tenant.submit(ev.stream_id, x)
        else:
            tenant.close_stream(ev.stream_id)
        primary.tick()
        tenant.maybe_checkpoint()
    primary.tick()
    pre = {sid: [r.codes for r in s.steps]
           for sid, s in primary._stream_lane("cell").sessions.items()}
    ckpt = standby.checkpoint
    t0 = time.perf_counter()
    fleet2, replayed = standby.activate(device=dev)
    fleet2.pump()
    recovery_s = time.perf_counter() - t0
    for ev, x in zip(trace[kill:], inputs[kill:]):
        if ev.action == "open":
            fleet2.open_stream("cell", ev.stream_id)
        elif ev.action == "feed":
            fleet2.submit_stream("cell", ev.stream_id, x)
        else:
            fleet2.close_stream("cell", ev.stream_id)
        fleet2.tick()
    fleet2.pump()
    lane = fleet2._stream_lane("cell")
    bad = lost = steps = 0
    for (_, sid), xs in seqs.items():
        ref = comp.predict_sequence(xs[None], backend="take")[0][0]
        ref = ref.cpu().numpy()
        if sid in lane.sessions:
            applied = (ckpt.applied_for(sid) if ckpt is not None
                       and sid in ckpt.stream_ids else 0)
            got = pre.get(sid, [])[:applied] + [
                r.codes for r in lane.sessions[sid].steps]
        else:
            got = pre.get(sid, [])
        lost += max(0, len(ref) - len(got))
        bad += not (len(got) == len(ref) and np.array_equal(
            np.stack(got), ref))
        steps += len(ref)
    out = {"streams": len(seqs), "steps": steps, "killed_at_event": kill,
           "checkpoints": standby.checkpoints_received,
           "restored_streams": len(replayed),
           "replayed_steps": int(sum(replayed.values())),
           "recovery_s": recovery_s, "mismatched_streams": bad,
           "lost_steps": lost}
    if bad or lost or not standby.checkpoints_received:
        fail(f"stream failover: {out}")
    print(f"stream failover (seqmnist_reduced, fused): {len(seqs)} streams, "
          f"{steps} steps; primary killed at event {kill}, "
          f"{out['restored_streams']} streams restored from checkpoint "
          f"{standby.checkpoints_received} + {out['replayed_steps']} replayed "
          f"steps in {recovery_s * 1e3:.1f} ms; every stream == the offline "
          "take scan, 0 lost", flush=True)
    return out


def fleet_kernels(net, dev, seed: int, smi: str) -> list:
    """The placed lanes' new call shapes held against their twins and
    timed at the shapes ``fleet_placements`` gives them: K1 at 512 rows of
    ``nid`` (a batch shard of a 1024-row block over 2 slots, and ragged
    shards), K3 on each slot's half of each ``nid`` layer's units at the
    units lane's padded block of 1024 rows (and smaller batches).  Returns
    their kernel-line rows (launches filled in by the caller)."""
    import numpy as np
    import torch
    from repro_torch.backends.placement import unit_shard_buffers
    from repro_torch.kernels import lut_cascade, lut_gather

    rs = np.random.RandomState(seed + 17)
    plan = net.compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    tables = plan.tensor("tables", dev)
    maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    ops = lut_cascade.prepare(tables, layers, maps)
    span = 2 ** layers[0][5]
    err1 = 0
    for rows in (1, 7, 32, 77, 512, 513):
        codes = torch.from_numpy(rs.randint(0, span, size=(
            2 * rows, layers[0][0])).astype(np.int32)).to(dev)
        for shard in (codes[:rows], codes[rows:]):   # both halves' offsets
            got = lut_cascade.lut_cascade_resident(shard, ops)
            torch.cuda.synchronize()
            want = lut_cascade.lut_cascade_plain(shard, tables, maps, layers)
            err1 = max(err1, int((got - want).abs().max()))
    lplan = net.compile_backend("pallas").plan
    bufs = unit_shard_buffers(
        lplan.meta["layers"], lambda l: lplan.buffers[f"table_{l}"],
        lambda l: lplan.buffers.get(f"mapping_{l}"), 2)
    shapes, err3 = [], 0                 # one block's 10 launches: 5 x 2
    for l in range(len(lplan.meta["layers"])):
        full = bufs[2 * l]
        r = full.shape[0] // 2
        for half in (torch.tensor(full[:r], device=dev),
                     torch.tensor(full[r:], device=dev)):
            for rows in (1, 77, 257, 512, PLACED_BLOCK):
                addr = torch.from_numpy(rs.randint(0, half.shape[1], size=(
                    rows, half.shape[0])).astype(np.int32)).to(dev)
                got = lut_gather.lut_lookup_cuda(half, addr)
                torch.cuda.synchronize()
                err3 = max(err3, int((got - lut_gather.lut_lookup_plain(
                    half, addr)).abs().max()))
            shapes.append((half, addr))      # the last: PLACED_BLOCK rows
    if err1 or err3:
        fail(f"fleet shapes: kernels disagree with their plain versions: K1 "
             f"{err1}, K3 {err3}")
    b1 = PLACED_BLOCK // 2
    codes = torch.from_numpy(rs.randint(0, span, size=(
        b1, layers[0][0])).astype(np.int32)).to(dev)
    byts, n_ops = cascade_work(layers, b1, tables.numel()
                               * tables.element_size(), ops.map_words * 4)
    rows = []
    for name, path, task, b, kern, plain, lib, nbytes, per, sub, err in (
            ("lut_cascade_resident", "fleet/nid batch x2",
             "nid, a 512-row shard of a 1024-row block", b1,
             lambda: lut_cascade.lut_cascade_resident(codes, ops),
             lambda: lut_cascade.lut_cascade_plain(codes, tables, maps,
                                                   layers),
             None, byts, 1, "cascade_resident_kernel", err1),
            ("lut_lookup", "fleet/nid units x2",
             "nid, each slot's half of each layer's units at the padded "
             "1024-row block, mean of a block's 10 launches", PLACED_BLOCK,
             lambda: [lut_gather.lut_lookup_cuda(t, a) for t, a in shapes],
             lambda: [lut_gather.lut_lookup_plain(t, a) for t, a in shapes],
             lambda: [torch.gather(t, 1, a.t().long()).t()
                      for t, a in shapes],
             sum(a.numel() * 8 + t.numel() * 4 for t, a in shapes),
             len(shapes), "lut_lookup_kernel", err3)):
        ms = per_call_ms(kern) / per
        plain_ms = per_call_ms(plain) / per
        device_ms = traced_ms(kern, sub, 10, per)
        device_ms = None if device_ms is None else device_ms / per
        lib_ms = None if lib is None else per_call_ms(lib) / per
        lib_dev = None if lib is None else traced_all_ms(lib)[0]
        lib_dev = None if lib_dev is None else lib_dev / per
        bound_ms, bound_by = bound(nbytes // per, n_ops if per == 1 else 0)
        rows.append({"name": name, "path": path, "task": task, "batch": b,
                     "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": err})
        print(f"time {name} ({task}, batch {b}, per launch): kernel "
              f"{ms:.4f} ms (device {device_ms} ms), plain {plain_ms:.4f} "
              f"ms, library {lib_ms} ms (device {lib_dev} ms), bound "
              f"{bound_ms:.6f} ms "
              f"({bound_by})" + (f", plan {k1_plan(ops, b)}" if per == 1
                                 else "") + f" [{smi}]", flush=True)
    rows[0]["plan"] = k1_plan(ops, b1)
    return rows


def fleet_phase(nets, dev, smi: str, seed: int, art_dir: Path,
                trained: str, cell_path: str) -> dict:
    """Slice 9's main path: the multi-tenant fleet at full width
    (``nid``, ``jsc_openml`` and ``mnist`` from phase 4's random tables,
    ``nid`` a second time on ``pallas``), registered from saved artifacts;
    then a hot swap to the phase-6 ``mnist`` artifact under load,
    placements over 2 slots, one scenario per fault class, and stream
    failover of the phase-8 cell."""
    from repro_torch.serve import (FaultInjector, FaultPlan, FaultSpec,
                                   LUTFleet)

    t0 = time.perf_counter()
    paths = {}
    for task in ("nid", "jsc_openml", "mnist"):
        paths[task] = nets[task].save(str(art_dir / f"fleet_{task}.npz"))
    paths["nid_k3"] = paths["nid"]
    inj = FaultInjector(FaultPlan(
        [FaultSpec("corrupt_artifact", at=1, scope="mnist")]))
    fleet = LUTFleet(block=FLEET_BLOCK, depth=2, faults=inj, device=dev)
    for mid, _, backend, _ in FLEET_TENANTS:
        fleet.register(mid, paths[mid], backend=backend)
    out = {"tenants": [{"model_id": m, "task": t, "backend": b, "kernel": k}
                       for m, t, b, k in FLEET_TENANTS],
           "block": FLEET_BLOCK, "depth": 2}
    out["replay"] = fleet_replay(fleet, paths, dev, seed, smi)
    out["idle"] = fleet_idle_share(fleet, smi)
    out["hot_swap"] = fleet_hot_swap(fleet, inj, trained, seed)
    out["degrades"] = {m: fleet.summary(m)["degrades"] for m in fleet.model_ids()}
    if any(out["degrades"].values()):
        fail(f"fleet: a lane degraded without an injected fault: "
             f"{out['degrades']}")
    out["placements"] = fleet_placements(paths, dev, seed, smi)
    out["faults"] = fleet_faults(paths, dev, seed)
    out["failover"] = fleet_failover(cell_path, dev, seed)
    out["kernels"] = fleet_kernels(fleet.registry.get("nid").net, dev, seed,
                                   smi)
    out["seconds"] = time.perf_counter() - t0
    return out


SEARCH_ROWS = 4096           # rows each frontier artifact serves a backend
SEARCH_BLOCK = 1024          # the engine's block serving them
POP_BATCH = 256              # the search's batch (SearchBudget.batch_size)
POP_CPU_BATCH = 64           # the card-vs-CPU population step's batch
# the nid search's best frontier accuracy must pass this (the classes are
# balanced, so chance is about 0.5; the card's runs gave 0.7686)
SEARCH_NID_ACCURACY = 0.70
# the nid search's depth, cut from the default budget (16 candidates, rungs
# 30 / 80, 4 promotions topped up by at most 3) to pay for phase 15;
# promotions keep the default 60 + 150 steps, and every mechanism stays: two
# rungs, promotions, 2 slices, calibration, the frontier on K1 and K3, and
# the frontier top-up: ``min_frontier`` keeps its default 3, which two
# promotions cannot reach, so the top-up always promotes its one extra
SEARCH_NID_CUT = dict(n_candidates=8, rungs=(15, 40), promote=2,
                      max_promote_extra=1)


def _stages(cfg) -> int:
    """K4 calls of one forward of ``cfg``: each layer's affine stages and
    bypasses."""
    n = 0
    for l in range(len(cfg.layers)):
        spec = cfg.subnet_spec(l)
        n += spec.n_affine + len(spec.skip_edges())
    return n


def _largest_signature_group(task: str, budget):
    """The candidates of the largest shape-signature group of
    ``generate_candidates(task_config(task), budget)``, first of the
    largest on a tie."""
    from repro_torch.configs import paper_tasks
    from repro_torch.search import generate_candidates, shape_signature
    cands, _ = generate_candidates(paper_tasks.task_config(task), budget)
    groups: dict = {}
    for c in cands:
        groups.setdefault(shape_signature(c.cfg), []).append(c)
    return max(groups.values(), key=len)


def hold_k4_affine(x, w, bias, act: bool, label: str) -> float:
    """K4's route on these operands against its plain version (f32 rtol =
    atol = 1e-5 x sqrt(din/64) where din > 64, as ``check_unit_affine``)
    and against the reference kernel bit for bit in f32 and bf16; returns
    the max |diff| against the plain version."""
    import math
    import torch
    from repro_torch.kernels import subnet_mlp

    got = subnet_mlp.unit_affine_cuda(x, w, bias, activate=act)
    want = subnet_mlp.unit_affine_plain(x, w, bias, activate=act)
    tol = 1e-5 * max(1.0, math.sqrt(x.shape[-1] / 64))
    err = float((got - want).abs().max()) if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=tol, atol=tol):
        fail(f"K4 {label}: max |diff| {err}")
    for dt in (torch.float32, torch.bfloat16):
        xd, wd = x.to(dt), w.to(dt)
        bd = None if bias is None else bias.to(dt)
        if not torch.equal(
                subnet_mlp.unit_affine_cuda(xd, wd, bd, activate=act),
                subnet_mlp.unit_affine_reference_cuda(xd, wd, bd,
                                                      activate=act)):
            fail(f"K4 {label} {dt}: differs from the reference kernel")
    return err


def _snapshot(t):
    """A copy of ``t`` with its shape and strides (a stride-0 axis stays
    one, reading one copied slice)."""
    import torch
    src = t
    for i, (n, st) in enumerate(zip(t.shape, t.stride())):
        if st == 0 and n > 1:
            src = src.narrow(i, 0, 1)
    span = 1 + sum((n - 1) * st for n, st in zip(src.shape, src.stride()))
    buf = torch.empty(max(span, 1), dtype=t.dtype, device=t.device)
    buf.as_strided(src.shape, src.stride()).copy_(src)
    return buf.as_strided(t.shape, t.stride())


class K4Recorder:
    """While on, keeps the operands and result of the first K4 call of
    each distinct operand layout (shapes, strides, dtype, bias, ReLU) made
    on the card.  It wraps ``subnet_mlp._affine`` and ``_dx_rows``, which
    every forward and gradient of K4's routes goes through; the wrapped
    calls launch and count as before, the recorder itself launches
    nothing."""

    def __init__(self):
        self.calls: dict = {}
        self.seen = 0

    def __enter__(self):
        from repro_torch.kernels import subnet_mlp
        self._orig = affine, dx_rows = (subnet_mlp._affine,
                                        subnet_mlp._dx_rows)

        def rec_affine(x, w, b, activate):
            y = affine(x, w, b, activate)
            self._keep(("affine", bool(activate)), (x, w, b), y)
            return y

        def rec_dx(dy, w):
            dx = dx_rows(dy, w)
            self._keep(("dx",), (dy, w), dx)
            return dx

        subnet_mlp._affine, subnet_mlp._dx_rows = rec_affine, rec_dx
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import subnet_mlp
        subnet_mlp._affine, subnet_mlp._dx_rows = self._orig

    def _keep(self, kind, args, out) -> None:
        if not out.is_cuda:
            return
        self.seen += 1
        key = kind + tuple(None if t is None else
                           (tuple(t.shape), tuple(t.stride()), t.dtype)
                           for t in args)
        if key not in self.calls:
            self.calls[key] = (kind, [None if t is None else _snapshot(t)
                                      for t in args], out.clone())


def hold_k4_record(rec: "K4Recorder", label: str) -> dict:
    """Every call ``rec`` kept, launched again: equal bit for bit to what
    the recorded run got; the forward routes held by
    :func:`hold_k4_affine`, the dense gradient against its plain version
    at the gradient tolerance (rtol 1e-4, atol 1e-5 x the largest
    |dx|).  Returns {route: {"layouts", "max_abs_err"}}."""
    import torch
    from repro_torch.kernels import subnet_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    out: dict = {}
    for key, (kind, args, want) in rec.calls.items():
        shape = [list(k[0]) for k in key[len(kind):] if k is not None]
        if kind[0] == "affine":
            x, w, b = args
            route = f"unit_affine_{subnet_mlp.route(x)}"
            where = f"{label}, {route} {shape}"
            if not torch.equal(subnet_mlp.unit_affine_cuda(
                    x, w, b, activate=kind[1]), want):
                fail(f"K4 {where}: a second launch differs from the "
                     "recorded result")
            err = hold_k4_affine(x, w, b, kind[1], where)
        else:
            dy, w = args
            route = "unit_affine_dx"
            got = subnet_mlp.unit_affine_dx_cuda(dy, w)
            plain = subnet_mlp.unit_affine_dx_plain(dy, w)
            scale = float(plain.abs().max()) if plain.numel() else 0.0
            err = float((got - plain).abs().max()) if got.numel() else 0.0
            if not torch.equal(got, want):
                fail(f"K4 {label}, dx {shape}: a second launch differs "
                     "from the recorded result")
            if not torch.allclose(got, plain, rtol=K4_GRAD_RTOL,
                                  atol=K4_GRAD_ATOL * scale):
                fail(f"K4 {label}, dx {shape}: max |diff| {err} of {scale}")
        r = out.setdefault(route, {"layouts": 0, "max_abs_err": 0.0})
        r["layouts"] += 1
        r["max_abs_err"] = max(r["max_abs_err"], err)
    torch.cuda.synchronize()
    return out


def k4_population(dev, smi: str, seed: int) -> dict:
    """Phase 10, part 1: K4's per-unit route at the population shape.  The
    largest shape-signature group of ``mnist``'s default search space,
    stacked: layer 0's first affine ``[256, P*2160, 6] -> 64`` and its
    ``64 -> 64`` stage held as ``check_unit_affine`` holds K4 (the plain
    version at f32 rtol = atol = 1e-5 x sqrt(din/64) where din > 64, the
    reference kernel bit for bit in f32 and bf16), one launch a stage a
    forward for the whole group, one population step on the card against
    the CPU (``hold_step``: rtol 1e-4), peak memory, and the stages' times
    beside their bounds and one ``torch.baddbmm`` on the same operands."""
    import torch
    from repro_torch.core import assemble, quant
    from repro_torch.data import synthetic
    from repro_torch.kernels import build, subnet_mlp
    from repro_torch.search import SearchBudget
    from repro_torch.train import lut_trainer, optim

    torch.backends.cuda.matmul.allow_tf32 = False
    members = _largest_signature_group("mnist", SearchBudget())
    cfgs = [m.cfg for m in members]
    cfg, p = cfgs[0], len(members)
    seeds = lut_trainer.population_seeds(seed, p)
    bounds = lut_trainer.stack_bounds(cfgs)
    data = synthetic.load("mnist", n_train=POP_BATCH, n_test=16)
    x = torch.from_numpy(data.x_train[:POP_BATCH]).to(dev)
    y = torch.from_numpy(data.y_train[:POP_BATCH]).to(dev)
    pop = lut_trainer.init_population(seeds, cfg, device=dev)
    with torch.no_grad():
        lo, hi = (t.to(dev) for t in bounds["in"])
        h0 = quant.fake_quant_dynamic(pop.in_q.log_scale[:, None],
                                      lo[:, None], hi[:, None], x[:, None, :])
        x0 = assemble.gather_population_inputs(cfg, pop.layers[0], 0, h0)
        sn = pop.layers[0].subnet
        w0, b0 = sn.w[0].detach(), sn.b[0].detach()
        x1 = subnet_mlp.unit_affine_cuda(x0, w0, b0, activate=True)
        w1, b1 = sn.w[1].detach(), sn.b[1].detach()
    if tuple(x0.shape) != (POP_BATCH, p * cfg.layers[0].units,
                           cfg.layers[0].fan_in) or not x0.is_contiguous():
        fail(f"population layer 0 operand {tuple(x0.shape)}, contiguous "
             f"{x0.is_contiguous()}")
    errs = {label: hold_k4_affine(xx, ww, bb, True, f"population {label}")
            for label, (xx, ww, bb) in (("6->64", (x0, w0, b0)),
                                        ("64->64", (x1, w1, b1)))}
    # one launch a stage a forward for the whole group
    stages = _stages(cfg)
    torch.cuda.synchronize()
    build.reset_counters()
    with torch.no_grad():
        lut_trainer.population_forward(pop, cfg, bounds, x, training=False)
    torch.cuda.synchronize()
    fwd = build.launch_counts()
    if (fwd.get("unit_affine_units", 0) != stages
            or fwd.get("unit_affine_dense", 0)
            or fwd.get("unit_affine_reference", 0)):
        fail(f"population forward of P={p}: K4 launches {fwd}, want "
             f"{stages} per-unit (one a stage), none dense or reference")
    # one step at the search's batch: its launches and peak memory
    ocfg = optim.AdamWConfig(lr=5e-3, weight_decay=1e-4)
    opt = optim.adamw_init(assemble.leaves(pop))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    build.reset_counters()
    t_step = time.perf_counter()
    lut_trainer.population_step(pop, cfg, ocfg, opt, bounds, x, y)
    torch.cuda.synchronize()
    t_step = time.perf_counter() - t_step
    step_counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    # one step card vs CPU from the same inits, on POP_CPU_BATCH rows
    nets, losses = [], []
    for d in ("cpu", dev):
        net = lut_trainer.init_population(seeds, cfg, device=d)
        o = optim.adamw_init(assemble.leaves(net))
        _, loss, _ = lut_trainer.population_step(
            net, cfg, ocfg, o, bounds, x[:POP_CPU_BATCH].to(d),
            y[:POP_CPU_BATCH].to(d))
        nets.append(net)
        losses.append(float(loss.sum()))
    worst = hold_step(nets[0], nets[1], losses, 5e-3,
                      f"population step P={p}, card vs CPU")
    del nets
    rows = []
    for label, (xx, ww, bb) in (("6->64", (x0, w0, b0)),
                                ("64->64", (x1, w1, b1))):
        bsz, u, din = xx.shape
        dout = ww.shape[2]
        kern = lambda xx=xx, ww=ww, bb=bb: subnet_mlp.unit_affine_cuda(  # noqa: E731
            xx, ww, bb, activate=True)
        lib = lambda xx=xx, ww=ww, bb=bb: torch.baddbmm(  # noqa: E731
            bb[:, None, :], xx.transpose(0, 1), ww)
        bound_ms, bound_by = bound(
            (bsz * u * din + u * din * dout + u * dout + bsz * u * dout) * 4,
            2 * bsz * u * din * dout, F32_FLOPS_PER_S)
        lib_dev, lib_kernels = traced_all_ms(lib)
        rows.append({
            "name": "unit_affine_units", "path": "search/mnist population",
            "task": f"mnist layer 0 {label}, P={p}", "batch": bsz,
            "shape": [bsz, u, din, dout], "launches": step_counts.get(
                "unit_affine_units", 0),
            "max_abs_err": errs[label],
            "ms": per_call_ms(kern, calls=20),
            "device_ms": traced_ms(kern, "unit_affine_units_kernel"),
            "plain_ms": per_call_ms(
                lambda xx=xx, ww=ww, bb=bb: subnet_mlp.unit_affine_plain(
                    xx, ww, bb, activate=True), calls=10),
            "library_ms": per_call_ms(lib, calls=20),
            "library_device_ms": lib_dev, "library_kernels": lib_kernels,
            "bound_ms": bound_ms, "bound_by": bound_by})
    out = {"task": "mnist", "members": [m.name for m in members], "p": p,
           "units": p * cfg.layers[0].units, "stages_per_forward": stages,
           "forward_launches": fwd, "step_launches": step_counts,
           "step_s": t_step, "peak_bytes": peak,
           "card_vs_cpu": {"batch": POP_CPU_BATCH, "loss_cpu": losses[0],
                           "loss_card": losses[1], "max_param_diff": worst},
           "max_abs_err": errs, "kernels": rows}
    print(f"population K4 at mnist width: P={p} ({out['members']}), "
          f"[{POP_BATCH}, {out['units']}, 6] -> 64 and 64 -> 64 equal to the "
          f"plain version (max |diff| {errs}) and to the reference kernel; "
          f"forward launches {fwd.get('unit_affine_units')} per-unit for "
          f"{stages} stages; a step {t_step * 1e3:.1f} ms, launches "
          f"{step_counts}, peak {peak / 2**30:.2f} GiB; card vs CPU step "
          f"{worst:.3e} [{smi}]", flush=True)
    for r in rows:
        print(f"time unit_affine_units ({r['task']}): kernel {r['ms']:.4f} "
              f"ms (device {r['device_ms']} ms), plain {r['plain_ms']:.4f} "
              f"ms, baddbmm {r['library_ms']:.4f} ms (device "
              f"{r['library_device_ms']} ms), bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']}) [{smi}]", flush=True)
    return out


def rung_idle_share(dev, smi: str, seed: int) -> dict:
    """The device's idle share over population steps of ``nid``'s largest
    rung group (the default budget's), from a trace that holds every
    launch (taken again with a longer lead otherwise; None after
    ``TRACE_LEADS`` tries); also its K4 launches a step, and one step of
    the group on the card against the CPU at the search's batch
    (``hold_step``: rtol 1e-4)."""
    import torch
    from repro_torch.core import assemble
    from repro_torch.data import synthetic
    from repro_torch.kernels import build
    from repro_torch.search import SearchBudget
    from repro_torch.train import lut_trainer, optim

    members = _largest_signature_group("nid", SearchBudget())
    cfgs = [m.cfg for m in members]
    cfg = cfgs[0]
    seeds = lut_trainer.population_seeds(seed, len(cfgs))
    bounds = lut_trainer.stack_bounds(cfgs)
    data = synthetic.load("nid", n_train=POP_BATCH, n_test=16)
    x = torch.from_numpy(data.x_train[:POP_BATCH]).to(dev)
    y = torch.from_numpy(data.y_train[:POP_BATCH]).to(dev)
    ocfg = optim.AdamWConfig(lr=5e-3, weight_decay=1e-4)
    # one step card vs CPU from the same inits on the same batch
    nets, losses = [], []
    for d in ("cpu", dev):
        net = lut_trainer.init_population(seeds, cfg, device=d)
        _, loss, _ = lut_trainer.population_step(
            net, cfg, ocfg, optim.adamw_init(assemble.leaves(net)), bounds,
            x.to(d), y.to(d))
        nets.append(net)
        losses.append(float(loss.sum()))
    worst = hold_step(nets[0], nets[1], losses, 5e-3,
                      f"nid population step P={len(cfgs)}, card vs CPU")
    del nets
    pop = lut_trainer.init_population(seeds, cfg, device=dev)
    state = {"opt": optim.adamw_init(assemble.leaves(pop))}

    def step():
        state["opt"] = lut_trainer.population_step(
            pop, cfg, ocfg, state["opt"], bounds, x, y)[0]

    step()
    torch.cuda.synchronize()
    build.reset_counters()
    step()
    torch.cuda.synchronize()
    counts = build.launch_counts()
    if counts.get("unit_affine_units", 0) < _stages(cfg):
        fail(f"nid population step: K4 launches {counts}")
    for lead in TRACE_LEADS:
        wall, prof, lost = profile(step, calls=10, lead=lead)
        if prof and not lost:
            break
        RETRACED.append({"kernel": "rung steps", "lead": lead, "lost": lost,
                         "lead_lost": LEAD_LOST[-1]})
    else:
        _untraced("a rung's steps", f"{lost} launch calls without device "
                  "work")
        return {"members": [m.name for m in members], "steps": 10,
                "wall_s": wall, "device_busy_s": None,
                "device_idle_share": None, "launches_per_step": counts,
                "card_vs_cpu": {"batch": POP_BATCH, "loss_cpu": losses[0],
                                "loss_card": losses[1],
                                "max_param_diff": worst}}
    busy = sum(sec for _, sec in prof.values())
    top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:6]
    out = {"members": [m.name for m in members], "steps": 10,
           "wall_s": wall, "device_busy_s": busy,
           "device_idle_share": 1.0 - busy / wall, "trace_lead": lead,
           "launches_per_step": counts,
           "card_vs_cpu": {"batch": POP_BATCH, "loss_cpu": losses[0],
                           "loss_card": losses[1], "max_param_diff": worst},
           "top_kernels": {k[:60]: (c, sec * 1e3) for k, (c, sec) in top}}
    print(f"nid rung group P={len(cfgs)} ({out['members']}), 10 profiled "
          f"steps: wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.3f} "
          f"ms, idle share {out['device_idle_share']:.3f}; K4 a step "
          f"{counts.get('unit_affine_units')} per-unit; card vs CPU step "
          f"{worst:.3e} [{smi}]", flush=True)
    return out


def _non_dominated(front) -> bool:
    return all(not (q.accuracy >= p.accuracy and q.adp <= p.adp
                    and (q.accuracy > p.accuracy or q.adp < p.adp))
               for p in front for q in front if p is not q)


def search_nid(dev, smi: str, seed: int, art_dir: Path) -> dict:
    """Phase 10, part 2: ``Toolflow.search("nid", ...)``, the full Table-II
    ``nid`` on the card with the default budget cut in depth
    (``SEARCH_NID_CUT``; sliced in 2, run sequentially).  The frontier
    must be
    non-empty, ranked and non-dominated; every frontier artifact, saved and
    loaded, must answer bit-identically on ``take``, ``fused`` and
    ``pallas`` on the card and from a CPU load, with the fused kernel
    launched once a block and K3 once a layer a block.  The best frontier
    accuracy must pass ``SEARCH_NID_ACCURACY``, and the frontier top-up
    must promote beyond ``promote``.  Every K4 operand layout
    the search launched (population rungs on the per-unit route, the
    promotions' dense, per-unit and dense-gradient routes) is kept by a
    :class:`K4Recorder` and held afterwards by :func:`hold_k4_record`."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import pipeline
    from repro_torch.kernels import autotune, build
    from repro_torch.search import SearchBudget

    budget = dataclasses.replace(SearchBudget(), seed=seed,
                                 population_slices=2, **SEARCH_NID_CUT)
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    with K4Recorder() as rec:
        res = pipeline.Toolflow.search("nid", budget, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    front = res.frontier
    accs = [p.accuracy for p in front]
    if not front or accs != sorted(accs, reverse=True) or \
            not _non_dominated(front):
        fail(f"nid search: frontier not ranked and non-dominated: "
             f"{[(p.name, p.accuracy, p.adp) for p in front]}")
    if not accs[0] > SEARCH_NID_ACCURACY:
        fail(f"nid search: best frontier accuracy {accs[0]} <= "
             f"{SEARCH_NID_ACCURACY}")
    if len(res.promoted) <= budget.promote:
        fail(f"nid search: {len(res.promoted)} promotions, the frontier "
             f"top-up promoted none beyond {budget.promote}")
    k4_routes = ("unit_affine_dense", "unit_affine_units", "unit_affine_dx")
    if counts.get("unit_affine_reference", 0) or \
            not all(counts.get(k, 0) for k in k4_routes):
        fail(f"nid search: K4 launches {counts}")
    t_hold = time.perf_counter()
    held = hold_k4_record(rec, "nid search")
    t_hold = time.perf_counter() - t_hold
    if sorted(held) != sorted(k4_routes):
        fail(f"nid search: recorded K4 routes {sorted(held)}")
    rs = np.random.RandomState(seed + 10)
    xs = rs.uniform(-1.0, 1.0, (SEARCH_ROWS, 593)).astype(np.float32)
    blocks = SEARCH_ROWS // SEARCH_BLOCK
    points = []
    for i, p in enumerate(front):
        path = p.compiled.save(str(art_dir / f"search_nid_{i}.npz"))
        cpu = pipeline.CompiledLUTNetwork.load(path, device="cpu")
        want = cpu.predict_codes(xs, backend="take").numpy()
        net = pipeline.CompiledLUTNetwork.load(path, device=dev)
        plan = net.compile_backend("fused").plan
        layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
        fused_k = ("lut_cascade_resident" if autotune.hopper_mode(
            layers, plan.tensor("tables", dev).element_size()) == "resident"
            else "lut_cascade_streamed")
        served = {}
        for backend, kname, per in (("take", None, 0),
                                    ("fused", fused_k, 1),
                                    ("pallas", "lut_lookup",
                                     len(net.cfg.layers))):
            eng = _warm_engine(net, backend)
            torch.cuda.synchronize()
            build.reset_counters()
            reqs = eng.submit_many(xs)
            while eng.queue:
                eng.tick()
            eng.drain()
            torch.cuda.synchronize()
            got = np.stack([r.codes for r in reqs])
            c = build.launch_counts()
            if not np.array_equal(got, want) or not np.array_equal(
                    cpu.predict_codes(xs, backend=backend).numpy(), want):
                fail(f"nid frontier {p.name}/{backend}: codes differ from "
                     "take on the CPU")
            lut = {k: c.get(k, 0) for k in LUT_KERNELS}
            if kname is not None and (lut[kname] != per * blocks or sum(
                    lut.values()) != per * blocks):
                fail(f"nid frontier {p.name}/{backend}: launches {lut}, "
                     f"want {per * blocks} of {kname}")
            served[backend] = lut
        points.append({
            "name": p.name, "accuracy": p.accuracy, "luts": p.luts,
            "adp": p.adp, "latency_ns": p.latency_ns,
            "fmax_mhz": p.fmax_mhz, "calibration": p.calibration,
            "rung_accuracy": p.rung_accuracy, "learned_beta": p.learned_beta,
            "layers": [[l.units, l.fan_in, l.bits, l.assemble]
                       for l in p.cfg.layers],
            "fused_kernel": fused_k, "launches": served})
    st = res.stage_seconds
    out = {"task": "nid", "budget": dataclasses.asdict(budget),
           "wall_s": wall, "search_seconds": res.seconds,
           "stage_seconds": {k: {"total": sum(v), "each": v}
                             for k, v in st.items()},
           "launches": counts, "k4_held": held, "k4_calls_seen": rec.seen,
           "k4_hold_s": t_hold, "rungs": res.rungs,
           "rejected": len(res.rejected), "evaluated": len(res.evaluated),
           "promoted": [p.name for p in res.promoted], "frontier": points,
           "served_rows": SEARCH_ROWS, "block": SEARCH_BLOCK}
    print(f"nid search (default budget cut to {SEARCH_NID_CUT}, 2 "
          f"slices) on the card: "
          f"{wall:.1f} s; rungs {[round(s, 2) for s in st['rungs']]} s, "
          f"promotions {sum(st.get('promotions', [])):.1f} s "
          f"({budget.promote} + {len(res.promoted) - budget.promote} "
          f"top-up), calibration "
          f"{sum(st.get('calibration', [])):.2f} s; K4 launches "
          f"{ {k: v for k, v in counts.items() if k.startswith('unit')} }; "
          f"every K4 layout launched ({held}) equal to the plain version "
          f"and the reference kernel ({t_hold:.1f} s); frontier [{smi}]:",
          flush=True)
    for pt in points:
        print(f"  {pt['name']}: accuracy {pt['accuracy']:.4f}, LUTs "
              f"{pt['luts']}, ADP {pt['adp']:.1f}, calibration "
              f"{pt['calibration']:.4f}; take/fused/pallas == CPU, "
              f"{pt['fused_kernel']} {blocks} and K3 "
              f"{pt['launches']['pallas']['lut_lookup']} launches for "
              f"{blocks} blocks", flush=True)
    return out


def _warm_engine(net, backend: str):
    """A ``LUTEngine`` serving ``net`` at ``SEARCH_BLOCK`` rows a block,
    warmed up (not counted)."""
    from repro_torch.serve.lut_engine import LUTEngine
    import numpy as np
    eng = LUTEngine(net, block=SEARCH_BLOCK, depth=2, backend=backend)
    eng.run(np.zeros((SEARCH_BLOCK, net.cfg.in_features), np.float32))
    return LUTEngine(net, block=SEARCH_BLOCK, depth=2, backend=backend)


def search_mesh(dev, smi: str, seed: int) -> dict:
    """Phase 10, part 3: ``nid_reduced`` with the smoke budget over 2 slots
    on one card (a worker thread and a stream a slot) against the sliced
    sequential run: identical rung survivors and scores; then a slot
    delayed past the straggler deadline (its slices partial, every other
    score unchanged) and a slot lost on its first job (remeshed, the clean
    survivors)."""
    import dataclasses
    import torch
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.search import (DistributedSearchBudget, SearchBudget,
                                    driver, run_search)

    budget = DistributedSearchBudget.from_budget(
        dataclasses.replace(SearchBudget.smoke(), seed=seed),
        population_slices=2, straggler_grace_s=30.0)
    # the sequential reference and the hook runs stop at the survivors
    # (fixed before any promotion); the meshed run also promotes, two
    # slots at a time
    fast = DistributedSearchBudget.from_budget(
        budget, promote=0, min_frontier=0, max_promote_extra=0)
    tight = DistributedSearchBudget.from_budget(
        fast, straggler_factor=1.0, straggler_grace_s=2.0)
    mesh = make_serving_mesh(slots=2, device=dev)
    t0 = time.perf_counter()
    sliced = run_search("nid_reduced", fast, device=dev)
    t1 = time.perf_counter()
    meshed = run_search("nid_reduced", budget, mesh=mesh)
    t2 = time.perf_counter()
    surv = [r["survivors"] for r in sliced.rungs]
    if [r["survivors"] for r in meshed.rungs] != surv or \
            meshed.evaluated != sliced.evaluated or meshed.dist["partial"] \
            or not meshed.frontier:
        fail(f"meshed rungs differ from the sliced run: "
             f"{meshed.rungs} vs {sliced.rungs}")
    out = {"slots": 2, "physical_devices": 1, "survivors": surv,
           "sliced_rungs_s": t1 - t0, "meshed_s": t2 - t1,
           "meshed_promoted": [p.name for p in meshed.promoted],
           "frontier_meshed": [p.name for p in meshed.frontier]}
    for name, hooks, b in (("delay", {"delay": {1: 9999.0}}, tight),
                           ("fail_once", {"fail_once": {1}}, fast)):
        driver._TEST_HOOKS.clear()
        driver._TEST_HOOKS.update(hooks)
        try:
            r = run_search("nid_reduced", b, mesh=mesh)
        finally:
            driver._TEST_HOOKS.clear()
        part = set(r.dist["partial"])
        if name == "delay":
            ok = bool(part) and r.rungs[0]["survivors"] and all(
                e["rungs"] == c["rungs"] for e, c in zip(
                    r.evaluated, sliced.evaluated) if e["name"] not in part)
        else:
            ev = r.dist["remesh_events"]
            ok = (ev and ev[0]["ok"] and ev[0]["new_devices"] == 1
                  and not part
                  and [x["survivors"] for x in r.rungs] == surv)
        if not ok:
            fail(f"meshed search, {name} hook: {r.dist}, {r.rungs}")
        out[name] = {"partial": sorted(part),
                     "straggler_events": len(r.dist["straggler_events"]),
                     "remesh_events": r.dist["remesh_events"],
                     "survivors": [x["survivors"] for x in r.rungs]}
    print(f"nid_reduced search over 2 slots on one card: survivors equal "
          f"the sliced run's ({t1 - t0:.1f} s sliced rungs, {t2 - t1:.1f} s "
          f"meshed with {len(meshed.promoted)} promotions); delayed slot: {len(out['delay']['partial'])} "
          f"candidates partial; lost slot: remeshed to 1, survivors equal "
          f"[{smi}]", flush=True)
    return out


def search_phase(dev, smi: str, seed: int, art_dir: Path) -> dict:
    """Slice 10's main path: the assembly search on the card."""
    t0 = time.perf_counter()
    out = {"population": k4_population(dev, smi, seed)}
    out["rung_idle"] = rung_idle_share(dev, smi, seed)
    out["nid"] = search_nid(dev, smi, seed, art_dir)
    out["mesh"] = search_mesh(dev, smi, seed)
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 10 (the assembly search): {out['seconds']:.1f} s",
          flush=True)
    return out


FAMILY_SLOTS = 4             # decode rows of every family's ServeEngine
FAMILY_CONTEXT = 2048        # ring positions (hymba's window caps its ring)
FAMILY_NEW_TOKENS = 8        # tokens each served request generates
HYMBA_PROMPTS = (1100, 700, 300, 33)   # the first passes the 1024 window
MOE_PROMPTS = (600, 130, 33, 7)
RWKV_PROMPTS = (700, 300, 64, 5)
MIXTRAL_LAYERS = 2           # of 56: the experts are 4.8 GB a layer in bf16
DBRX_LAYERS = 1              # of 40: 6.3 GB of experts a layer in bf16
WHISPER_BATCH = 3            # rows decoded in lock step
WHISPER_PROMPT = 32
WHISPER_NEW_TOKENS = 16
WHISPER_CONTEXT = 64
LUT_TM_STREAMS = 1024        # streams of the LUT time mix
LUT_TM_STEPS = 49
LUT_TM_STATE = 8             # state positions of the cell
FAMILY_F32_PROMPT = 48       # tokens of each family's f32 cut
FAMILY_F32_TOL = 2e-4        # tests/test_archs.py:123, rtol = atol
# rwkv_mix_reduced's trunk, card vs CPU: its per-head group norm (E[x^2] -
# mu^2 over 8 channels) cancels at early steps, so f32 rounding grows: the
# CPU's own f32 features are up to 4.1e-4 from f64 (mean 1.8e-7) on these
# 2,048 train streams; atol 1e-3, rtol 1e-5
TASK_DATA_ATOL = 1e-3
TASK_DATA_RTOL = 1e-5


class K5Recorder:
    """While on, counts K5's launches on the card by operand layout and
    keeps the operands of the first launch of each layout.  It wraps
    ``flash_attention._launch_wgmma`` and ``_launch_tf32``, which every K5
    call goes through; the wrapped calls launch and count as before, the
    recorder itself launches nothing."""

    def __init__(self):
        self.calls: dict = {}
        self.counts: dict = {}

    def __enter__(self):
        from repro_torch.kernels import flash_attention as fa
        self._orig = wgmma, tf32 = fa._launch_wgmma, fa._launch_tf32

        def rec_wgmma(q, k, v, causal, window, q_offset, split_p):
            o = wgmma(q, k, v, causal, window, q_offset, split_p)
            self._keep(fa.WGMMA, q, k, v, causal, window, q_offset)
            return o

        def rec_tf32(q, k, v, causal, window, q_offset):
            o = tf32(q, k, v, causal, window, q_offset)
            self._keep(fa.TF32, q, k, v, causal, window, q_offset)
            return o

        fa._launch_wgmma, fa._launch_tf32 = rec_wgmma, rec_tf32
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as fa
        fa._launch_wgmma, fa._launch_tf32 = self._orig

    def _keep(self, kernel, q, k, v, causal, window, q_offset) -> None:
        key = (kernel, tuple(q.shape), int(k.shape[1]), int(k.shape[2]),
               bool(causal), window, int(q_offset))
        self.counts[key] = self.counts.get(key, 0) + 1
        if key not in self.calls:
            self.calls[key] = (_snapshot(q), _snapshot(k), _snapshot(v),
                               dict(causal=causal, window=window,
                                    q_offset=q_offset))

    def launches(self) -> int:
        """Launches recorded."""
        return sum(self.counts.values())


def _k5_label(key) -> str:
    kernel, (b, hq, sq, d), hkv, skv, causal, window, q_offset = key
    return (f"{'wgmma' if kernel.endswith('wgmma') else 'TF32'} [{b}, {hq}, "
            f"{sq}, {d}] on [{hkv}, {skv}] {'causal' if causal else 'full'}"
            + (f" window {window}" if window else "")
            + (f" q_offset {q_offset}" if q_offset else ""))


def hold_k5_record(rec: K5Recorder, label: str) -> dict:
    """Every layout ``rec`` kept, launched again on its recorded operands
    and held against the plain version: bf16 (the wgmma kernel) within one
    bf16 ulp, f32 (the TF32 kernel) at the reference's 2e-5.  Returns
    {kernel: max |diff|} and the layouts with their launch counts."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    errs = {fa.WGMMA: 0.0, fa.TF32: 0.0}
    for key, (q, k, v, kw) in rec.calls.items():
        got = fa.flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = float((got.float() - want.float()).abs().max())
        if key[0] == fa.WGMMA:
            ok = torch.allclose(got.float(), want.float(), rtol=K5_BF16_RTOL,
                                atol=K5_BF16_ATOL)
        else:
            ok = torch.allclose(got, want, rtol=K5_F32_TOL, atol=K5_F32_TOL)
        if not ok:
            fail(f"K5 at {label}'s layout {_k5_label(key)}: max |diff| {err}")
        errs[key[0]] = max(errs[key[0]], err)
    return {"max_abs_err": errs,
            "layouts": {_k5_label(key): n for key, n in rec.counts.items()}}


def _k5_pairs(sq: int, skv: int, causal: bool, window, q_offset: int) -> int:
    """(q, k) pairs K5's masks leave for these positions."""
    total = 0
    for i in range(sq):
        p = q_offset + i
        hi = min(p, skv - 1) if causal else skv - 1
        lo = max(0, p - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def k5_layout_row(name: str, path: str, rec: K5Recorder, key, smi: str
                  ) -> dict:
    """K5's wgmma kernel alone at one layout the path launched (its
    recorded operands): ms by CUDA events, device ms from the profiler,
    the plain version, one SDPA call on the same inputs (a boolean mask
    for a window) and the bound (operations: 4 D flops a head for every
    (q, k) pair the masks leave, at the bf16 tensor-core rate; bytes: q,
    k, v read once, o written once)."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = rec.calls[key]
    b, hq, sq, d = q.shape
    skv = k.shape[2]
    fn = lambda: fa.flash_attention_wgmma_cuda(q, k, v, **kw)  # noqa: E731
    plain = lambda: fa.flash_attention_plain(q, k, v, **kw)  # noqa: E731
    err = float((fn().float() - plain().float()).abs().max())
    if kw["window"]:
        qpos = torch.arange(sq, device=q.device)[:, None] + kw["q_offset"]
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = (kpos > qpos - kw["window"]) & (
            (kpos <= qpos) if kw["causal"] else True)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=kw["causal"] and sq > 1, enable_gqa=True)
    pairs = _k5_pairs(sq, skv, kw["causal"], kw["window"], kw["q_offset"])
    ops = 4 * d * hq * b * pairs
    byts = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    row = {"name": fa.WGMMA, "path": path, "task": name,
           "layout": _k5_label(key), "batch": sq,
           "launches": rec.counts[key], "max_abs_err": err,
           "ms": per_call_ms(fn),
           "device_ms": traced_ms(fn, "flash_attention_wgmma_kernel"),
           "plain_ms": per_call_ms(plain), "library_ms": per_call_ms(sdpa),
           "library_device_ms": traced_all_ms(sdpa)[0]}
    row["bound_ms"], row["bound_by"] = bound(byts, ops, BF16_FLOPS_PER_S)
    print(f"time {fa.WGMMA} ({name}, {row['layout']}): kernel "
          f"{row['ms']:.4f} ms (device {row['device_ms']} ms), plain "
          f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms (device "
          f"{row['library_device_ms']} ms), bound {row['bound_ms']:.5f} ms "
          f"({row['bound_by']}), {row['launches']} launches on {path}, max "
          f"|diff| {err:.3e} [{smi}]", flush=True)
    return row


def _largest(rec: K5Recorder, causal: bool, sq_max=None):
    """The recorded wgmma layout with the most q rows (at most ``sq_max``)
    among causal or non-causal ones."""
    keys = [k for k in rec.calls if k[0] == "flash_attention_wgmma"
            and k[4] == causal and (sq_max is None or k[1][2] <= sq_max)]
    return max(keys, key=lambda k: (k[1][2], k[1][0]))


def serve_family(cfg, params, prompts, seed: int, smi: str, label: str,
                 k5_per_prefill: int) -> dict:
    """``prompts`` served on ``FAMILY_SLOTS`` slots through ``ServeEngine``
    (``FAMILY_NEW_TOKENS`` each) with the launch counts set to 0 just
    before; fails unless K5's wgmma kernel launched ``k5_per_prefill``
    times a prefill and never in decode, its TF32 kernel never, every
    request got its tokens in range and every logit was finite.  Returns
    the serving numbers and the K5 recorder of the run."""
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.serve.engine import Request, ServeEngine

    dev = params.embed.device
    ServeEngine(cfg, params, slots=FAMILY_SLOTS, context=FAMILY_CONTEXT,
                device=dev).run([Request(rid=-1, prompt=np.arange(
                    40, dtype=np.int32), max_tokens=3)])   # warm-up
    rs = np.random.RandomState(seed)
    reqs = [Request(rid=i, prompt=rs.randint(0, cfg.vocab, n).astype(np.int32),
                    max_tokens=FAMILY_NEW_TOKENS)
            for i, n in enumerate(prompts)]
    eng = ServeEngine(cfg, params, slots=FAMILY_SLOTS, context=FAMILY_CONTEXT,
                      device=dev, rng_seed=seed)
    finite = []
    sample = eng._sample

    def checked_sample(logits, req):
        finite.append(bool(np.isfinite(logits).all()))
        return sample(logits, req)

    eng._sample = checked_sample
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    with K5Recorder() as rec:
        done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    k5 = counts.get("flash_attention_wgmma", 0)
    want = k5_per_prefill * len(prompts)
    if k5 != want or counts.get("flash_attention", 0) or \
            rec.launches() != k5:
        fail(f"{label} serve: K5's wgmma kernel launched {k5} times, not "
             f"{want} ({k5_per_prefill} a prefill, none in decode), its TF32 "
             f"kernel {counts.get('flash_attention', 0)} times, not 0")
    if len(done) != len(reqs) or any(
            len(r.out_tokens) != FAMILY_NEW_TOKENS
            or not all(0 <= t < cfg.vocab for t in r.out_tokens)
            for r in done):
        fail(f"{label} serve: a request did not finish with "
             f"{FAMILY_NEW_TOKENS} tokens in range")
    if not all(finite) or len(finite) != eng.stats.tokens_out + len(reqs):
        fail(f"{label} serve: non-finite logits")
    st = eng.stats
    out = {"arch": cfg.name, "layers": cfg.n_layers, "slots": FAMILY_SLOTS,
           "context": FAMILY_CONTEXT, "prompts": list(prompts),
           "new_tokens": FAMILY_NEW_TOKENS, "launches": counts,
           "k5_launches": k5, "wall_s": wall,
           "prefill_ms": dict(zip(prompts, st.prefill_ms)),
           "decode_ticks": st.decode_steps,
           "decode_ms_median": statistics.median(st.decode_ms),
           "tokens_per_s": (st.tokens_out + len(reqs)) / wall,
           "tokens": {r.rid: r.out_tokens for r in done}}
    print(f"{label} serve: {len(prompts)} requests on {FAMILY_SLOTS} slots "
          f"in {wall:.3f} s, K5 (wgmma) launches {k5}, prefill ms by prompt "
          f"length { {n: round(ms, 2) for n, ms in out['prefill_ms'].items()} },"
          f" {st.decode_steps} decode ticks, median "
          f"{out['decode_ms_median']:.2f} ms/tick, {out['tokens_per_s']:.1f} "
          f"tokens/s [{smi}]", flush=True)
    return out, rec


def decode_vs_prefill_bf16(fns, cfg, prompt, n: int, label: str) -> dict:
    """Decode of token n after a prefill of n against a prefill of n + 1,
    in bf16 on the card: a sanity bound (``DECODE_VS_PREFILL_REL`` of the
    largest logit; the two paths accumulate in other orders) and the same
    argmax in every row, or, where a row's two argmaxes differ, a tie at
    the precision the two paths share: the prefill's logits of both tokens
    within the max |diff| of each other (whisper's 51,865 random logits
    have such near ties).  ``fns = (prefill(tokens), decode(cache,
    token))``."""
    import torch
    prefill, decode = fns
    full, _ = prefill(prompt[:, :n + 1])
    _, cache = prefill(prompt[:, :n])
    dec, _ = decode(cache, prompt[:, n:n + 1])
    full, dec = full[:, :cfg.vocab], dec[:, :cfg.vocab]
    err = float((dec - full).abs().max())
    scale = float(full.abs().max())
    top_full, top_dec = full.argmax(-1), dec.argmax(-1)
    argmax = bool(torch.equal(top_dec, top_full))
    gap = float((full.max(-1).values
                 - full.gather(-1, top_dec[:, None])[:, 0]).max())
    print(f"{label} decode vs prefill (bf16, n = {n}): max |diff| {err:.4f} "
          f"of max |logit| {scale:.4f} (limit {DECODE_VS_PREFILL_REL} of "
          f"it), argmax equal {argmax} (the prefill's logit gap between "
          f"the two argmaxes {gap:.4f})", flush=True)
    if not err <= DECODE_VS_PREFILL_REL * scale or not gap <= err:
        fail(f"{label} decode vs prefill: max |diff| {err} of {scale}, "
             f"argmax equal {argmax}, logit gap {gap}")
    return {"n": n, "max_abs_diff": err, "max_abs_logit": scale,
            "argmax_equal": argmax, "argmax_logit_gap": gap}


def family_f32_cut(cfg, dev, seed: int, label: str,
                   k5_per_prefill: int) -> dict:
    """``cfg`` at full width cut to 2 layers in f32 (MoE at capacity factor
    64 for decode vs prefill, where a prefill would otherwise drop tokens
    that decode keeps): the prefill logits on the card against the CPU,
    decode against prefill on the card, both at the reference's 2e-4, and
    K5's TF32 kernel ``k5_per_prefill`` times a prefill."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import lm, whisper

    torch.backends.cuda.matmul.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    enc = cfg.is_enc_dec
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               encoder_layers=2 if enc else 0)
    mod = whisper if enc else lm
    gen = torch.Generator(dev).manual_seed(seed)
    card = mod.init_params(cfg2, gen, dev)
    cpu = mod.compute_copy(card, cfg2, "cpu")
    rs = np.random.RandomState(seed + 11)
    toks = torch.from_numpy(rs.randint(0, cfg.vocab, (1, FAMILY_F32_PROMPT))
                            .astype(np.int32))
    if enc:
        audio = torch.from_numpy(rs.standard_normal(
            (1, cfg.enc_context, cfg.d_model)).astype(np.float32))

        def prefill(m, c, t):
            return whisper.prefill(m, c, audio.to(t.device), t,
                                   WHISPER_CONTEXT)

        def decode(m, c, cache, t):
            return whisper.decode_step(m, c, cache, t)
    else:
        def prefill(m, c, t):
            return lm.prefill(m, c, t, FAMILY_CONTEXT)

        def decode(m, c, cache, t):
            return lm.decode_step(m, c, cache, t)
    build.reset_counters()
    got, _ = prefill(card, cfg2, toks.to(dev))
    torch.cuda.synchronize()
    tf32 = build.launch_counts().get("flash_attention", 0)
    if tf32 != k5_per_prefill:
        fail(f"{label} f32 cut: K5's TF32 kernel launched {tf32} times, not "
             f"{k5_per_prefill}")
    want, _ = prefill(cpu, cfg2, toks)
    err = float((got.cpu() - want).abs().max())
    if not torch.allclose(got.cpu(), want, rtol=FAMILY_F32_TOL,
                          atol=FAMILY_F32_TOL):
        fail(f"{label} (2 layers, f32) card vs CPU: max |diff| {err}")
    cfg3 = dataclasses.replace(cfg2, capacity_factor=64.0) \
        if cfg.family == "moe" else cfg2
    n = FAMILY_F32_PROMPT - 1
    full, _ = prefill(card, cfg3, toks.to(dev))
    _, cache = prefill(card, cfg3, toks[:, :n].to(dev))
    dec, _ = decode(card, cfg3, cache, toks[:, n:].to(dev))
    dec_err = float((dec - full).abs().max())
    if not torch.allclose(dec, full, rtol=FAMILY_F32_TOL,
                          atol=FAMILY_F32_TOL):
        fail(f"{label} (2 layers, f32) decode vs prefill: max |diff| "
             f"{dec_err}")
    out = {"layers": 2, "prompt": FAMILY_F32_PROMPT, "k5_tf32_launches": tf32,
           "card_vs_cpu_max_abs_diff": err,
           "decode_vs_prefill_max_abs_diff": dec_err,
           "max_abs_logit": float(want[:, :cfg.vocab].abs().max())}
    print(f"{label} (2 layers, f32): card vs CPU prefill logits max |diff| "
          f"{err:.3e}, decode vs prefill on the card {dec_err:.3e} "
          f"(tolerance rtol = atol = {FAMILY_F32_TOL}), K5 TF32 launches "
          f"{tf32}", flush=True)
    del card, cpu
    torch.cuda.empty_cache()
    return out


def _bf16_model(cfg, dev, seed: int):
    """Random weights drawn on the card in f32 a layer at a time and kept
    in bf16 (``lm.init_params(dtype=...)``); peak memory reset before."""
    import gc
    import torch
    from repro_torch.models import lm
    gc.collect()                 # the engines' sampler closures are cycles
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev,
                           dtype=torch.bfloat16)
    torch.cuda.synchronize()
    return model, time.perf_counter() - t0


def serve_lm_family(arch: str, dev, seed: int, smi: str, *, layers=None,
                    prompts, dvp_n: int) -> tuple:
    """One decoder-only family at full width (depth ``layers`` if cut):
    served through ``ServeEngine``, decode against prefill in bf16, peak
    memory; returns (report, K5 recorder)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.models import lm

    cfg = lm_archs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    model, init_s = _bf16_model(cfg, dev, seed)
    k5 = 0 if cfg.family == "ssm" else cfg.n_layers
    out, rec = serve_family(cfg, model, prompts, seed, smi, arch, k5)
    out["init_s"] = init_s
    out["reduced"] = None if layers is None else \
        f"{layers} of {lm_archs.get(arch).n_layers} layers"
    dvp_cfg = dataclasses.replace(cfg, capacity_factor=64.0) \
        if cfg.family == "moe" else cfg
    prompt = torch.from_numpy(np.random.RandomState(seed + 3).randint(
        0, cfg.vocab, (1, dvp_n + 1)).astype(np.int32)).to(model.embed.device)
    out["decode_vs_prefill"] = decode_vs_prefill_bf16(
        (lambda t: lm.prefill(model, dvp_cfg, t, FAMILY_CONTEXT),
         lambda c, t: lm.decode_step(model, dvp_cfg, c, t)),
        cfg, prompt, dvp_n, arch)
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"{arch}: {cfg.n_layers} layers at full width, bf16, init "
          f"{init_s:.1f} s, peak memory {out['peak_bytes'] / 2**30:.2f} GiB",
          flush=True)
    return out, rec, model, cfg


def lut_time_mix(model, cfg, seed: int, smi: str) -> dict:
    """The LUT time mix at rwkv6-7b's width: a folded stream cell from
    random tables (``random_network``) with n_in = n_out = d_model and
    ``LUT_TM_STATE`` state positions takes the WKV slot of layer 0 for
    ``LUT_TM_STREAMS`` streams x ``LUT_TM_STEPS`` steps through
    ``rwkv_block_lut_tm``, the cell stepping through
    ``CompiledStreamCell.step`` on ``fused`` (K1, once a step) and
    ``pallas`` (K3, once a layer a step), launch counts set to 0 just
    before each; every stream's codes and final state equal the offline
    ``predict_sequence`` of the same pre-LN features on the card and the
    CPU.  Returns the numbers, with K1/K3 rows at the cell's shape."""
    import numpy as np
    import torch
    from repro_torch import pipeline
    from repro_torch.core.assemble import AssembleConfig, LayerSpec
    from repro_torch.kernels import build
    from repro_torch.models import layers, lm, rwkv
    from repro_torch.stream.cell import CompiledStreamCell

    dev = model.embed.device
    d, s = cfg.d_model, LUT_TM_STATE
    # one mapping layer of 2-input LUTs over [features | state], then a
    # per-unit assemble layer: K1 holds it (229,920 B at 4 rows a tile)
    ccfg = AssembleConfig(in_features=d + s, input_bits=1, input_signed=True,
                          layers=(LayerSpec(d + s, 2, 1, False),
                                  LayerSpec(d + s, 1, 2, True)),
                          subnet_width=8, subnet_depth=2, skip_step=2)
    arrays = random_network(ccfg, seed)
    card = CompiledStreamCell(pipeline.CompiledLUTNetwork(ccfg, *arrays,
                                                          device=dev), d, s)
    cpu = CompiledStreamCell(pipeline.CompiledLUTNetwork(ccfg, *arrays,
                                                         device="cpu"), d, s)
    blk, spec = model.blocks[0], lm.rwkv_spec(cfg)
    gen = torch.Generator(dev).manual_seed(seed)
    n, t = LUT_TM_STREAMS, LUT_TM_STEPS
    x = torch.randn((n, t, d), generator=gen, device=dev).to(torch.bfloat16)
    shift = torch.zeros((n, d), dtype=torch.bfloat16, device=dev)
    with torch.inference_mode():
        h1 = layers.layer_norm(x, blk.ln1, blk.ln1_b)
    want, _, want_s = card.predict_sequence(h1, backend="take")
    cpu_codes, _, cpu_s = cpu.predict_sequence(h1.cpu(), backend="take")
    if not (torch.equal(want.cpu(), cpu_codes)
            and torch.equal(want_s.cpu(), cpu_s)):
        fail("LUT time mix: the card's offline take scan differs from the "
             "CPU's")
    out = {"d_model": d, "n_state": s, "streams": n, "steps": t,
           "cell_layers": [(l.units, l.fan_in, l.bits, l.assemble)
                           for l in ccfg.layers]}
    for backend, kname, per_step in (("fused", "lut_cascade_resident", 1),
                                     ("pallas", "lut_lookup", 2)):
        codes = []

        def step(x_t, st, backend=backend):
            c, y, s_next = card.step(x_t, st, backend=backend)
            codes.append(c)
            return y, s_next

        # warm-up at the full batch (its plan, first launch), not counted
        card.step(h1[:, 0], card.init_state_codes(n), backend=backend)
        torch.cuda.synchronize()
        build.reset_counters()
        t0 = time.perf_counter()
        with torch.inference_mode():
            y, s_fin, new_cm = rwkv.rwkv_block_lut_tm(
                blk, spec, x, shift, step, card.init_state_codes(n))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = build.launch_counts()
        other = {k: v for k, v in counts.items() if k.startswith("lut_")
                 and k != kname}
        if counts.get(kname, 0) != per_step * t or any(other.values()):
            fail(f"LUT time mix/{backend}: launches {counts}, expected "
                 f"{kname} {per_step} x {t} steps and no other LUT kernel")
        got = torch.stack(codes, dim=1)
        if not (torch.equal(got, want) and torch.equal(s_fin, want_s)):
            fail(f"LUT time mix/{backend}: a stream's codes differ from the "
                 "offline scan of its pre-LN features")
        if y.shape != x.shape or not bool(torch.isfinite(y).all()) or \
                new_cm.shape != (n, d):
            fail(f"LUT time mix/{backend}: block output {tuple(y.shape)} "
                 "not finite or misshaped")
        out[backend] = {"launches": counts, "wall_s": wall,
                        "stream_steps_per_s": n * t / wall}
        print(f"LUT time mix/{backend} (rwkv6-7b layer 0, d_model {d}): "
              f"{n} streams x {t} steps in {wall:.3f} s "
              f"({n * t / wall:,.0f} stream steps/s), launches {counts}, "
              f"every stream == the offline scan on the card and the CPU "
              f"[{smi}]", flush=True)
    out["kernels"] = stream_kernels(card, np.random.RandomState(seed + 11),
                                    dev, smi, b=n, path="rwkv6-7b/lut-tm",
                                    task="rwkv6-7b LUT time-mix cell")
    for k in out["kernels"]:
        k["launches"] = out["fused" if k["name"] == "lut_cascade_resident"
                            else "pallas"]["launches"][k["name"]]
    return out


def rwkv_task_data(dev, smi: str) -> dict:
    """``stream_task_data("rwkv_mix_reduced")`` with its trunk on the card
    against the same on the CPU (f32, ``TASK_DATA_TOL``)."""
    import numpy as np
    import torch
    from repro_torch.configs import paper_tasks

    t0 = time.perf_counter()
    card = paper_tasks.stream_task_data("rwkv_mix_reduced", device=dev)
    t1 = time.perf_counter()
    cpu = paper_tasks.stream_task_data("rwkv_mix_reduced", device="cpu")
    diff = np.concatenate([np.abs(card.x_train - cpu.x_train).ravel(),
                           np.abs(card.x_test - cpu.x_test).ravel()])
    err, mean = float(diff.max()), float(diff.mean())
    if card.name != cpu.name or card.x_train.shape != cpu.x_train.shape or \
            not (np.allclose(card.x_train, cpu.x_train, rtol=TASK_DATA_RTOL,
                             atol=TASK_DATA_ATOL)
                 and np.allclose(card.x_test, cpu.x_test,
                                 rtol=TASK_DATA_RTOL, atol=TASK_DATA_ATOL)):
        fail(f"rwkv_mix_reduced: the card's trunk features differ from the "
             f"CPU's by {err}")
    print(f"rwkv_mix_reduced task data: {card.x_train.shape} train streams, "
          f"trunk on the card {t1 - t0:.2f} s, card vs CPU max |diff| "
          f"{err:.3e}, mean {mean:.3e} (atol {TASK_DATA_ATOL}, rtol "
          f"{TASK_DATA_RTOL}) [{smi}]", flush=True)
    return {"shape": list(card.x_train.shape), "max_abs_diff": err,
            "mean_abs_diff": mean, "card_s": t1 - t0}


def serve_whisper(dev, seed: int, smi: str) -> tuple:
    """whisper-small at full width and depth (12 + 12 layers, bf16):
    ``WHISPER_BATCH`` rows of random frame embeddings (1,536 frames)
    encoded, ``WHISPER_PROMPT``-token prompts prefilled and
    ``WHISPER_NEW_TOKENS`` tokens decoded greedily in lock step, the
    launch counts set to 0 just before; fails unless K5's wgmma kernel
    launched 12 non-causal (encoder) + 12 causal + 12 cross a prefill and
    12 cross a decode tick, the TF32 kernel never, and every logit is
    finite; then decode against prefill."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.kernels import build
    from repro_torch.models import whisper

    cfg = lm_archs.get("whisper-small")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = whisper.compute_copy(whisper.init_params(
        cfg, torch.Generator(dev).manual_seed(seed), dev), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator(dev).manual_seed(seed + 1)
    b, p = WHISPER_BATCH, WHISPER_PROMPT
    audio = torch.randn((b, cfg.enc_context, cfg.d_model), generator=gen,
                        device=dev)
    toks = torch.from_numpy(np.random.RandomState(seed).randint(
        0, cfg.vocab, (b, p + 1)).astype(np.int32)).to(dev)
    whisper.prefill(params, cfg, audio[:1], toks[:1, :4], WHISPER_CONTEXT)
    torch.cuda.synchronize()                      # warm-up, not counted
    build.reset_counters()
    t0 = time.perf_counter()
    with K5Recorder() as rec:
        logits, cache = whisper.prefill(params, cfg, audio, toks[:, :p],
                                        WHISPER_CONTEXT)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        after_prefill = build.launch_counts().get("flash_attention_wgmma", 0)
        out_tokens, finite = [], [bool(torch.isfinite(logits).all())]
        tok = logits[:, :cfg.vocab].argmax(-1)
        for _ in range(WHISPER_NEW_TOKENS):
            out_tokens.append(tok)
            logits, cache = whisper.decode_step(params, cfg, cache,
                                                tok[:, None].int())
            finite.append(bool(torch.isfinite(logits).all()))
            tok = logits[:, :cfg.vocab].argmax(-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    L, Le = cfg.n_layers, cfg.encoder_layers
    want = Le + 2 * L + WHISPER_NEW_TOKENS * L
    k5 = counts.get("flash_attention_wgmma", 0)
    if after_prefill != Le + 2 * L or k5 != want or \
            counts.get("flash_attention", 0) or rec.launches() != k5:
        fail(f"whisper-small: K5's wgmma kernel launched {after_prefill} "
             f"times in the prefill (want {Le + 2 * L}) and {k5} in all "
             f"(want {want}), its TF32 kernel "
             f"{counts.get('flash_attention', 0)} times")
    tokens = torch.stack(out_tokens, 1).cpu().numpy()
    if not all(finite) or not ((tokens >= 0) & (tokens < cfg.vocab)).all():
        fail("whisper-small: non-finite logits or tokens out of range")
    by_layout = {(key[4], key[1][2]): n for key, n in rec.counts.items()}
    if by_layout != {(False, cfg.enc_context): Le, (True, p): L,
                     (False, p): L, (False, 1): WHISPER_NEW_TOKENS * L}:
        fail(f"whisper-small: K5 launches by layout {rec.counts}")
    out = {"arch": cfg.name, "batch": b, "frames": cfg.enc_context,
           "prompt": p, "new_tokens": WHISPER_NEW_TOKENS, "init_s": init_s,
           "launches": counts, "k5_launches": k5,
           "k5_by_layout": {_k5_label(k): n for k, n in rec.counts.items()},
           "prefill_s": t_prefill, "wall_s": wall,
           "decode_ms_per_tick": (wall - t_prefill) / WHISPER_NEW_TOKENS
           * 1e3, "tokens": tokens.tolist()}
    print(f"whisper-small: {b} x {cfg.enc_context} frames encoded and "
          f"{p}-token prompts prefilled in {t_prefill * 1e3:.1f} ms, "
          f"{WHISPER_NEW_TOKENS} greedy tokens at "
          f"{out['decode_ms_per_tick']:.2f} ms a tick, K5 (wgmma) launches "
          f"{k5} ({Le} non-causal + {L} causal + {L} cross a prefill, {L} "
          f"cross a tick) [{smi}]", flush=True)
    out["decode_vs_prefill"] = decode_vs_prefill_bf16(
        (lambda t: whisper.prefill(params, cfg, audio, t, WHISPER_CONTEXT),
         lambda c, t: whisper.decode_step(params, cfg, c, t)),
        cfg, toks, p, "whisper-small")
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    print(f"whisper-small: peak memory {out['peak_bytes'] / 2**30:.2f} GiB",
          flush=True)
    return out, rec


def families_phase(dev, smi: str, seed: int) -> dict:
    """Slice 11's main paths: the remaining LM families on the card.
    hymba-1.5b (32 layers) and rwkv6-7b (32 layers) at full width and
    depth, mixtral-8x22b at full width cut to 2 of 56 layers and dbrx-132b
    to 1 of 40 (memory), each served through ``ServeEngine`` with decode
    against prefill; the LUT time mix and the rwkv task's trunk; whisper-
    small encoded, prefilled and decoded; a 2-layer f32 cut of each family
    on the card against the CPU (K5's TF32 kernel); every K5 layout the
    paths launched held against the plain version, and K5 alone at one
    layout of each."""
    import torch
    from repro_torch.configs import lm_archs

    t0 = time.perf_counter()
    out, recs, rows = {}, {}, []
    for arch, kw in (("hymba-1.5b", dict(prompts=HYMBA_PROMPTS, dvp_n=1100)),
                     ("mixtral-8x22b", dict(prompts=MOE_PROMPTS, dvp_n=129,
                                            layers=MIXTRAL_LAYERS)),
                     ("dbrx-132b", dict(prompts=MOE_PROMPTS, dvp_n=129,
                                        layers=DBRX_LAYERS)),
                     ("rwkv6-7b", dict(prompts=RWKV_PROMPTS, dvp_n=129))):
        out[arch], recs[arch], model, cfg = serve_lm_family(
            arch, dev, seed, smi, **kw)
        if arch == "rwkv6-7b":
            out["lut_time_mix"] = lut_time_mix(model, cfg, seed, smi)
            rows += out["lut_time_mix"].pop("kernels")
        del model
        torch.cuda.empty_cache()
    out["rwkv_task_data"] = rwkv_task_data(dev, smi)
    out["whisper-small"], recs["whisper-small"] = serve_whisper(dev, seed,
                                                                smi)
    out["k5_held"] = {a: hold_k5_record(r, a) for a, r in recs.items()}
    for name, arch, causal, sq_max in (
            ("hymba-1.5b prefill layer", "hymba-1.5b", True, None),
            ("mixtral-8x22b prefill layer", "mixtral-8x22b", True, None),
            ("dbrx-132b prefill layer", "dbrx-132b", True, None),
            ("whisper-small encoder layer", "whisper-small", False, None),
            ("whisper-small cross-attention, prefill", "whisper-small",
             False, WHISPER_PROMPT),
            ("whisper-small cross-attention, decode", "whisper-small",
             False, 1)):
        key = _largest(recs[arch], causal, sq_max)
        rows.append(k5_layout_row(name, f"{arch} serve", recs[arch], key,
                                  smi))
    out["f32_cut"] = {}
    for arch, k5 in (("hymba-1.5b", 2), ("mixtral-8x22b", 2),
                     ("dbrx-132b", 2), ("rwkv6-7b", 0),
                     ("whisper-small", 6)):
        out["f32_cut"][arch] = family_f32_cut(lm_archs.get(arch), dev, seed,
                                              arch, k5)
    out["kernels"] = rows
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 11 (the remaining LM families): {out['seconds']:.1f} s",
          flush=True)
    return out


TRAIN_BATCH = 4              # rows of a full-width gemma-2b training step
TRAIN_SEQ = 1024             # tokens a row
TRAIN_STEPS = 5              # loop steps at full width
TRAIN_LR = 1e-4              # constant (no schedule: a 10-step warm-up, as
                             # the CLI's cosine_schedule has, would keep all
                             # 5 steps near lr 0), weight decay 0.1, clip 1;
                             # at 1e-3 the 4th step's loss spiked
TRAIN_K5_PER_STEP = 36       # 18 layers x (the forward + remat's recompute);
                             # the backward is plain PyTorch, no launch
WHISPER_TRAIN = ("--steps", "2", "--batch", "4", "--seq", "512")
WHISPER_K5_PER_STEP = 72     # (12 encoder + 12 self + 12 cross) x 2 (remat)
TRAIN_SMOKE_ARCHS = ("gemma-2b", "mixtral-8x22b", "rwkv6-7b", "hymba-1.5b",
                     "whisper-small")
TRAIN_SMOKE_BATCH = (2, 24)  # rows, tokens of the card-vs-CPU smoke steps
TRAIN_LOSS_RTOL = 1e-5
# each gradient leaf within this share of its largest entry (a leaf whose
# exact gradient is 0, a key bias, against 1e-3 of the model's largest);
# RWKV's f32 gradient at the smoke config is 1.1e-3 from an f64 run of the
# same code (the JAX package's 2.3e-3; ROADMAP C.6, pinned by
# tests/test_torch_train_lm.py::test_rwkv_gradient_f32_floor), so 3e-3
TRAIN_GRAD_TOL = {"rwkv6-7b": 3e-3}
TRAIN_GRAD_TOL_DEFAULT = 1e-4
TRAIN_ZERO_GRAD_FLOOR = 1e-3
REPLAY_STEPS, REPLAY_FAIL_AT, REPLAY_CKPT_EVERY = 6, 5, 2
REPLAY_TOL = 1e-6            # final parameters, replayed vs uninterrupted
ROUTER_MIN_AGREEMENT = 0.9   # the reference example reaches 0.992 (CPU)


def _idle_step(fn, label: str) -> dict:
    """Wall, device busy and idle share of one profiled call of ``fn``
    from a trace that holds every launch (taken again with a longer lead
    otherwise; None after ``TRACE_LEADS`` tries)."""
    for lead in TRACE_LEADS:
        wall, prof, lost = profile(fn, calls=1, lead=lead)
        if prof and not lost:
            busy = sum(sec for _, sec in prof.values())
            top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]
            return {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
                    "device_idle_share": 1.0 - busy / wall,
                    "trace_lead": lead,
                    "top_kernels": {k[:60]: (c, sec * 1e3)
                                    for k, (c, sec) in top}}
        RETRACED.append({"kernel": label, "lead": lead, "lost": lost,
                         "lead_lost": LEAD_LOST[-1]})
    _untraced(label, f"{lost} launch calls without device work")
    return {"wall_ms": wall * 1e3, "device_busy_ms": None,
            "device_idle_share": None}


def train_gemma(dev, smi: str, seed: int) -> tuple:
    """Full-width, full-depth gemma-2b trained ``TRAIN_STEPS`` steps
    through ``train/loop.run``: f32 masters drawn on the card, bf16
    compute, remat, the chunked loss (chunk 512), batches of ``TRAIN_BATCH
    x TRAIN_SEQ`` from ``tokens.SyntheticCorpus`` at its 256,000-token
    vocabulary.  Fails unless every loss is finite, the last is below the
    first, and K5's wgmma kernel launched ``TRAIN_K5_PER_STEP`` times a
    step (TF32 never).  Reports step ms (median of steps 2-5), the
    batches' host seconds on their own, tokens/s, peak memory and the idle
    share of one profiled step.  Returns (report, K5 recorder)."""
    import gc
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.data import tokens
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.train import loop, optim

    cfg = lm_archs.GEMMA_2B
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = steps.init_fn(cfg)(torch.Generator(dev).manual_seed(seed), dev)
    opt = steps.opt_init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in steps.train_leaves(params))
    corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed))
    batch_s, last = [], {}

    def batch_fn(step):
        t = time.perf_counter()
        toks = corpus.sample_batch(step, TRAIN_BATCH)
        last["batch"] = steps.batch_on({"tokens": toks[:, :-1],
                                        "labels": toks[:, 1:]}, dev)
        batch_s.append(time.perf_counter() - t)
        return last["batch"]

    step_fn = steps.make_train_step(cfg, opt_cfg=optim.AdamWConfig(
        lr=TRAIN_LR, weight_decay=0.1))
    state = loop.LoopState(params=params, opt_state=opt)
    torch.cuda.synchronize()
    build.reset_counters()
    t0 = time.perf_counter()
    with K5Recorder() as rec:
        state = loop.run(loop.LoopConfig(total_steps=TRAIN_STEPS), state,
                         step_fn, batch_fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = state.metrics_history
    losses_ = [m["loss"] for m in hist]
    k5 = counts.get("flash_attention_wgmma", 0)
    step_ms = statistics.median(m["step_time_s"] for m in hist[1:]) * 1e3
    idle = _idle_step(lambda: step_fn(state.params, state.opt_state,
                                      last["batch"]), "a gemma-2b train step")
    out = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "lr": TRAIN_LR, "schedule": None, "weight_decay": 0.1,
           "loss_chunk": cfg.loss_chunk, "remat": cfg.remat,
           "init_s": init_s, "losses": losses_,
           "grad_norms": [m["grad_norm"] for m in hist],
           "step_ms": [m["step_time_s"] * 1e3 for m in hist],
           "step_ms_median_2_5": step_ms, "batch_fn_s": batch_s,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3),
           "loop_wall_s": wall, "peak_bytes": peak,
           "k5_launches": k5, "k5_launches_per_step": k5 / TRAIN_STEPS,
           "launches": counts, "profiled_step": idle}
    print(f"gemma-2b train ({n_params / 1e9:.3f} B parameters, f32 masters, "
          f"bf16 compute, remat, batch {TRAIN_BATCH} x {TRAIN_SEQ}): losses "
          f"{[round(x, 4) for x in losses_]}, step ms "
          f"{[round(x, 1) for x in out['step_ms']]} (median of 2-5 "
          f"{step_ms:.1f}), batch_fn s {[round(x, 3) for x in batch_s]}, "
          f"{out['tokens_per_s']:.0f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB, K5 wgmma {k5 / TRAIN_STEPS:g} a step; "
          f"profiled step wall {idle['wall_ms']:.1f} ms, device busy "
          f"{idle['device_busy_ms']} ms, idle share "
          f"{idle['device_idle_share']} [{smi}]", flush=True)
    if not all(math.isfinite(x) for x in losses_) or \
            not losses_[-1] < losses_[0]:
        fail(f"gemma-2b train: losses {losses_} (finite, last below first)")
    if k5 != TRAIN_K5_PER_STEP * TRAIN_STEPS or \
            counts.get("flash_attention", 0) or rec.launches() != k5:
        fail(f"gemma-2b train: K5 wgmma launched {k5} times in "
             f"{TRAIN_STEPS} steps, not {TRAIN_K5_PER_STEP} a step; TF32 "
             f"{counts.get('flash_attention', 0)}")
    del state, params, opt, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return out, rec


def train_whisper(dev, smi: str) -> tuple:
    """whisper-small at full width and depth trained through the CLI
    (``launch.train.main``; its batches and cosine schedule) for a few
    steps: K5 non-causal in the encoder, causal in the decoder, cross
    attention, ``WHISPER_K5_PER_STEP`` wgmma launches a step."""
    import gc
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch import train

    build.reset_counters()
    with K5Recorder() as rec:
        state = train.main(["--arch", "whisper-small", *WHISPER_TRAIN])
    torch.cuda.synchronize()
    counts = build.launch_counts()
    k5 = counts.get("flash_attention_wgmma", 0)
    losses_ = [m["loss"] for m in state.metrics_history]
    n = len(losses_)
    if not all(math.isfinite(x) for x in losses_) or \
            k5 != WHISPER_K5_PER_STEP * n or counts.get("flash_attention", 0):
        fail(f"whisper-small train: losses {losses_}, K5 wgmma {k5} (not "
             f"{WHISPER_K5_PER_STEP} a step), TF32 "
             f"{counts.get('flash_attention', 0)}")
    out = {"steps": n, "losses": losses_, "k5_launches": k5,
           "k5_launches_per_step": k5 / n, "cli": list(WHISPER_TRAIN),
           "step_ms": [m["step_time_s"] * 1e3 for m in state.metrics_history]}
    print(f"whisper-small train (CLI, {' '.join(WHISPER_TRAIN)}): losses "
          f"{[round(x, 4) for x in losses_]}, step ms "
          f"{[round(x, 1) for x in out['step_ms']]}, K5 wgmma {k5 / n:g} a "
          f"step [{smi}]", flush=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return out, rec


def k5_train_grads(rec: K5Recorder, key, seed: int, label: str) -> dict:
    """K5 with a gradient at one recorded training layout: the forward
    through ``FlashAttentionFn`` on the card (one launch), the backward
    with no launch, and q/k/v grads against ``mha_ref``'s autograd on f32
    copies of the same inputs and output gradient, rounded to the inputs'
    type (the gradient sums a KV head's group in f32), within one bf16
    ulp."""
    import torch
    from repro_torch.kernels import build, flash_attention as fa
    from repro_torch.kernels.ref import mha_ref

    q, k, v, kw = rec.calls[key]
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    build.reset_counters()
    o = fa.flash_attention_cuda(*leaves, **kw)
    torch.cuda.synchronize()
    fwd = sum(build.launch_counts().get(n, 0) for n in (fa.WGMMA, fa.TF32))
    g = torch.randn(o.shape, device=o.device, generator=torch.Generator(
        o.device).manual_seed(seed)).to(o.dtype)
    build.reset_counters()
    o.backward(g)
    torch.cuda.synchronize()
    bwd = sum(build.launch_counts().get(n, 0) for n in (fa.WGMMA, fa.TF32))
    ref = [t.detach().float().requires_grad_() for t in (q, k, v)]
    mha_ref(*ref, **kw).backward(g.float())
    errs = {}
    for name, a, b in zip("qkv", leaves, ref):
        want = b.grad.to(a.dtype).float()
        errs[name] = float((a.grad.float() - want).abs().max())
        if not torch.allclose(a.grad.float(), want, rtol=K5_BF16_RTOL,
                              atol=K5_BF16_ATOL):
            fail(f"K5 gradient at {label}: d{name} max |diff| {errs[name]}")
    if fwd != 1 or bwd:
        fail(f"K5 at {label}: {fwd} forward launches (not 1), {bwd} in the "
             "backward (not 0)")
    print(f"K5 gradient at {label} ({_k5_label(key)}): one forward launch, "
          f"none in the backward; dq/dk/dv max |diff| against mha_ref's "
          f"autograd {errs}", flush=True)
    return {"layout": _k5_label(key), "forward_launches": fwd,
            "backward_launches": bwd, "max_abs_err": errs}


def k5_backward_times(rec: K5Recorder, key, smi: str) -> dict:
    """At one recorded training layout: ms of the plain backward
    (``attention_grads``, what training runs) and of SDPA's forward plus
    backward on the same inputs, by CUDA events."""
    import torch
    from repro_torch.kernels import flash_attention as fa

    q, k, v, kw = rec.calls[key]
    g = torch.ones(q.shape, dtype=q.dtype, device=q.device)
    plain = per_call_ms(lambda: fa.attention_grads(q, k, v, g, **kw),
                        calls=10, reps=3)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa():
        o = torch.nn.functional.scaled_dot_product_attention(
            *leaves, is_causal=kw["causal"], enable_gqa=True)
        o.backward(g)
    lib = per_call_ms(sdpa, calls=10, reps=3)
    print(f"K5 backward at {_k5_label(key)}: plain (mha_ref autograd, f32) "
          f"{plain:.4f} ms; SDPA forward + backward {lib:.4f} ms [{smi}]",
          flush=True)
    return {"plain_backward_ms": plain, "sdpa_fwd_bwd_ms": lib}


def _grads_of(cfg, model, batch):
    """(total, loss, gradients as the reference's tree, numpy)."""
    import numpy as np
    from repro_torch.launch import steps
    from repro_torch.models import lm
    (total, loss, _), grads = steps.value_and_grad(
        steps.make_loss_fn(cfg), model, batch)
    meta = [(p, l) for p, l, _ in lm.leaves(model)]
    return float(total), float(loss), lm.nest(
        meta, [g.detach().float().cpu().numpy() for g in grads], np.stack)


def _hold_train_grads(got: dict, want: dict, tol: float, label: str) -> float:
    """Every gradient leaf within ``tol`` of its largest entry (floor:
    ``TRAIN_ZERO_GRAD_FLOOR`` of the model's largest); the worst ratio of
    |diff| to that bound's scale."""
    from repro_torch.ckpt.checkpoint import _flatten
    flat_w, flat_g = _flatten(want), dict(_flatten(got))
    top = max(float(abs(w).max()) for _, w in flat_w)
    worst = 0.0
    for key, w in flat_w:
        scale = max(float(abs(w).max()), TRAIN_ZERO_GRAD_FLOOR * top)
        err = float(abs(flat_g[key] - w).max())
        if err > tol * scale:
            fail(f"{label}: gradient {key} max |diff| {err} > {tol} x "
                 f"{scale}")
        worst = max(worst, err / scale)
    return worst


def train_step_card_vs_cpu(arch: str, dev, seed: int) -> dict:
    """One f32 train step's loss and gradients of ``arch``'s smoke config
    (remat on) on the card against the CPU, from the same weights and
    batch: loss at rtol ``TRAIN_LOSS_RTOL``, every gradient leaf within
    ``TRAIN_GRAD_TOL`` of its largest entry.  K5 runs its TF32 kernel (f32)
    on the card."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.kernels import build
    from repro_torch.launch import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(lm_archs.smoke(arch), dtype="float32")
    cpu = steps.init_fn(cfg)(torch.Generator().manual_seed(seed), "cpu")
    card = copy.deepcopy(cpu).to(dev)
    b, s = TRAIN_SMOKE_BATCH
    rs = np.random.RandomState(seed + 5)
    toks = rs.randint(0, cfg.vocab, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_enc_dec:
        batch["audio_embed"] = rs.standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)
    build.reset_counters()
    got = _grads_of(cfg, card, steps.batch_on(batch, dev))
    torch.cuda.synchronize()
    tf32 = build.launch_counts().get("flash_attention", 0)
    want = _grads_of(cfg, cpu, steps.batch_on(batch, "cpu"))
    if not math.isclose(got[1], want[1], rel_tol=TRAIN_LOSS_RTOL) or \
            not math.isclose(got[0], want[0], rel_tol=TRAIN_LOSS_RTOL):
        fail(f"{arch} smoke train step card vs CPU: loss {got[:2]} against "
             f"{want[:2]}")
    tol = TRAIN_GRAD_TOL.get(arch, TRAIN_GRAD_TOL_DEFAULT)
    worst = _hold_train_grads(got[2], want[2], tol,
                              f"{arch} smoke train step card vs CPU")
    # one a self-attention layer (whisper: encoder, decoder and cross) a
    # forward, twice with remat
    want_k5 = 0 if cfg.family == "ssm" else (
        cfg.encoder_layers + cfg.n_layers * (2 if cfg.is_enc_dec else 1)
    ) * (2 if cfg.remat else 1)
    print(f"{arch} smoke train step (f32, remat) card vs CPU: loss "
          f"{got[1]:.7f} / {want[1]:.7f}, worst gradient |diff| "
          f"{worst:.2e} of its leaf's largest (tolerance {tol}), K5 TF32 "
          f"launches {tf32}", flush=True)
    if tf32 != want_k5:
        fail(f"{arch} smoke train step: K5 TF32 launched {tf32} times, not "
             f"{want_k5}")
    return {"loss_card": got[1], "loss_cpu": want[1], "total_card": got[0],
            "total_cpu": want[0], "worst_grad_rel": worst, "tolerance": tol,
            "k5_tf32_launches": tf32}


def train_ckpt_replay(dev, seed: int, tmp: Path) -> dict:
    """mixtral-8x22b's smoke config (f32) trained ``REPLAY_STEPS`` steps
    through the loop on the card with async checkpoints every
    ``REPLAY_CKPT_EVERY``, once uninterrupted and once with a failure
    injected at step ``REPLAY_FAIL_AT`` (restore + replay): the final
    parameters and moments agree within ``REPLAY_TOL`` (the report says
    whether bit for bit, and names the ops PyTorch reports as
    non-deterministic in one such step); the card's last checkpoint
    restores on the CPU to the card's exact values."""
    import dataclasses
    import shutil
    import warnings
    import numpy as np
    import torch
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import lm_archs
    from repro_torch.launch import steps
    from repro_torch.train import loop, optim

    cfg = dataclasses.replace(lm_archs.smoke("mixtral-8x22b"),
                              dtype="float32")
    shutil.rmtree(tmp, ignore_errors=True)

    def run(name, fail_at=None, device=dev):
        params = steps.init_fn(cfg)(torch.Generator().manual_seed(seed),
                                    "cpu").to(device)
        step = steps.make_train_step(cfg, opt_cfg=optim.AdamWConfig(
            lr=3e-3, weight_decay=0.1))
        pending = {fail_at}

        def step_fn(p, o, batch):
            if batch["step"] in pending:
                pending.discard(batch["step"])
                # the failure lands after the writes in flight: the replay
                # resumes from the newest step and saves only later ones
                # (a re-save onto a written step fails in wait_pending)
                checkpoint.wait_pending()
                raise RuntimeError("injected failure")
            return step(p, o, batch)

        def batch_fn(s):
            toks = np.random.RandomState(seed + s).randint(
                0, cfg.vocab, (2, 33))
            return dict(steps.batch_on({"tokens": toks[:, :-1],
                                        "labels": toks[:, 1:]}, device),
                        step=s)
        state = loop.LoopState(params=params, opt_state=steps.opt_init(
            params), codec=steps.StateCodec())
        return loop.run(loop.LoopConfig(
            total_steps=REPLAY_STEPS, ckpt_dir=str(tmp / name),
            ckpt_every=REPLAY_CKPT_EVERY), state, step_fn, batch_fn), step

    clean, step = run("clean")
    replayed, _ = run("replayed", fail_at=REPLAY_FAIL_AT)
    if replayed.failures != 1 or replayed.step != REPLAY_STEPS:
        fail(f"checkpoint replay: {replayed.failures} failures, step "
             f"{replayed.step}")
    pairs = list(zip(
        steps.train_leaves(clean.params) + clean.opt_state.m
        + clean.opt_state.v, steps.train_leaves(replayed.params)
        + replayed.opt_state.m + replayed.opt_state.v))
    diff = max(float((a - b).detach().abs().max()) for a, b in pairs)
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            toks = torch.randint(0, cfg.vocab, (2, 33), device=dev)
            step(clean.params, clean.opt_state,
                 {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    nondet = sorted({str(w.message).split(" does not have")[0]
                     for w in caught if "deterministic" in str(w.message)})
    if diff > REPLAY_TOL:
        fail(f"checkpoint replay: final state max |diff| {diff} > "
             f"{REPLAY_TOL} (non-deterministic ops: {nondet})")
    # the card's last checkpoint on the CPU
    cpu = steps.init_fn(cfg)(torch.Generator().manual_seed(seed + 1), "cpu")
    copt = steps.opt_init(cpu)
    codec = steps.StateCodec()
    tree, rstep = checkpoint.restore(str(tmp / "replayed"),
                                     codec.to_tree(cpu, copt))
    cpu, copt = codec.from_tree(tree, cpu, copt)
    restored = all(torch.equal(a.cpu(), b) for a, b in zip(
        steps.train_leaves(replayed.params) + replayed.opt_state.m
        + replayed.opt_state.v, steps.train_leaves(cpu) + copt.m + copt.v))
    if rstep != REPLAY_STEPS or copt.step != replayed.opt_state.step or \
            not restored:
        fail(f"the card's checkpoint of step {rstep} does not restore on the "
             "CPU to the card's values")
    print(f"checkpoint replay on the card (mixtral-8x22b smoke, f32, "
          f"{REPLAY_STEPS} steps, failure at {REPLAY_FAIL_AT}): final state "
          f"max |diff| {diff:.3e} against the uninterrupted run (bit for "
          f"bit: {bitwise}); ops PyTorch names non-deterministic in a step: "
          f"{nondet or 'none'}; the card's step-{rstep} checkpoint restores "
          "on the CPU exactly", flush=True)
    return {"steps": REPLAY_STEPS, "fail_at": REPLAY_FAIL_AT,
            "max_abs_diff": diff, "bitwise": bitwise,
            "nondeterministic_ops": nondet, "card_to_cpu_exact": restored,
            "restored_step": rstep}


def router_example(dev, seed: int) -> dict:
    """``examples/torch_lut_router_moe.py`` at its own size on the card:
    the MoE LM trained, its router distilled into a folded LUT tree and
    plugged into ``moe.apply_moe``; fails below ``ROUTER_MIN_AGREEMENT``
    top-1 agreement or on a non-finite MoE error."""
    import importlib.util
    path = ROOT / "examples" / "torch_lut_router_moe.py"
    spec = importlib.util.spec_from_file_location("torch_lut_router_moe",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    out = mod.run(dev, seed=seed,
                  log=lambda msg: print(f"router example: {msg.strip()}",
                                        flush=True))
    out["seconds"] = time.perf_counter() - t0
    if not out["routing_agreement"] >= ROUTER_MIN_AGREEMENT or \
            not math.isfinite(out["moe_rel_diff"]) or \
            not out["lm_loss_last"] < out["lm_loss_first"]:
        fail(f"router example: {out}")
    return out


def train_phase(dev, smi: str, seed: int, art_dir: Path) -> dict:
    """Slice 12's main path: LM training.  Full-width gemma-2b through the
    loop and whisper-small through the CLI (K5's wgmma kernel in every
    training forward, held against the plain version, its gradient against
    ``mha_ref``'s, and timed beside SDPA and the plain backward); one f32
    smoke train step of five families on the card against the CPU; the
    checkpoint replay and card-to-CPU restore; the router example."""
    t0 = time.perf_counter()
    out, rows = {}, []
    out["gemma-2b"], grec = train_gemma(dev, smi, seed)
    out["whisper-small"], wrec = train_whisper(dev, smi)
    out["k5_held"] = {"gemma-2b train": hold_k5_record(grec, "gemma-2b train"),
                      "whisper-small train": hold_k5_record(
                          wrec, "whisper-small train")}
    gkey = _largest(grec, True)
    out["k5_grad"] = {"gemma-2b train": k5_train_grads(
        grec, gkey, seed, "gemma-2b train")}
    row = k5_layout_row("gemma-2b train layer", "gemma-2b train", grec, gkey,
                        smi)
    row.update(k5_backward_times(grec, gkey, smi))
    rows.append(row)
    for name, causal, sq_max in (
            # the encoder's layout is also the cross attention's (Sq = S_enc
            # here; a non-causal launch takes q_offset 0)
            ("whisper-small train, encoder and cross-attention layer", False,
             None),
            ("whisper-small train, decoder layer", True, None)):
        key = _largest(wrec, causal, sq_max)
        out["k5_grad"][name] = k5_train_grads(wrec, key, seed, name)
        rows.append(k5_layout_row(name, "whisper-small train", wrec, key,
                                  smi))
    out["card_vs_cpu"] = {a: train_step_card_vs_cpu(a, dev, seed)
                          for a in TRAIN_SMOKE_ARCHS}
    out["replay"] = train_ckpt_replay(dev, seed, art_dir / "train_ckpt")
    out["router"] = router_example(dev, seed)
    out["kernels"] = rows
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 12 (LM training): {out['seconds']:.1f} s", flush=True)
    return out


MESH_STEPS = 2               # meshed gemma-2b steps (phase 12's first two)
# meshed vs unmeshed losses and grad norms: the (1, 1) step computes the
# same sums; 1e-4 is far below a step's change of the loss (3.7e-3 from
# step 1 to 2), so a dropped or mis-scaled update fails
MESH_LOSS_RTOL = 1e-4
DRYRUN_CELLS = (("gemma-2b", "train_4k", "single"),
                ("mixtral-8x22b", "decode_32k", "multi"))
DRYRUN_TIMEOUT = 600
COMPRESS_LEAF = "blocks.0.ffn.w_up"   # a [2,048, 16,384] gradient leaf
COMPRESS_KEY = (("blocks", "ffn", "w_up"), 0)   # its lm.leaves entry


def _one_rank_group(dev):
    """A one-rank NCCL group on ``dev`` over an in-process store (the
    loopback of a meshed run on one card)."""
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(torch.cuda.current_device() if dev.index is None
                          else dev.index)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)


def mesh_train_gemma(dev, smi: str, seed: int, phase12: dict) -> tuple:
    """Full-width gemma-2b trained ``MESH_STEPS`` steps through
    ``build_cell``'s train step on a one-rank NCCL (1, 1) mesh (parameters
    and AdamW moments ``DTensor``s placed by the sharding rules, batches
    split over ``data``), from phase 12's seed, lr and batches: K5's wgmma
    kernel 36 times a step, losses and grad norms within
    ``MESH_LOSS_RTOL`` of phase 12's unmeshed steps, peak memory and step
    ms beside phase 12's.  Keeps the ``COMPRESS_LEAF`` gradient of the
    last step for the compression check.  Returns (report, K5 recorder, that gradient)."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.configs import lm_archs
    from repro_torch.data import tokens
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.models import lm
    from repro_torch.train import optim

    cfg = lm_archs.GEMMA_2B
    _one_rank_group(dev)
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device=dev)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = steps.init_fn(cfg)(torch.Generator(dev).manual_seed(seed),
                                    dev)
        params = shd.distribute_params(params, mesh)
        opt = steps.opt_init(params)
        shape = steps.ShapeSpec("phase13", TRAIN_SEQ, TRAIN_BATCH, "train")
        fn, _ = steps.build_cell(cfg, shape, mesh, opt_cfg=optim.AdamWConfig(
            lr=TRAIN_LR, weight_decay=0.1))
        corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
            seed=seed))
        # the COMPRESS_LEAF gradient, as AdamW receives it
        idx = [i for i, (p, l, _) in enumerate(lm.leaves(params))
               if (p, l) == COMPRESS_KEY][0]
        kept = {}
        orig_update = optim.adamw_update

        def keeping_update(ocfg, ps, grads, state, **kw):
            kept["grad"] = shd.local(grads[idx]).detach().clone()
            return orig_update(ocfg, ps, grads, state, **kw)

        losses_, norms, step_ms = [], [], []
        build.reset_counters()
        optim.adamw_update = keeping_update
        try:
            with K5Recorder() as rec:
                for s in range(MESH_STEPS):
                    toks = corpus.sample_batch(s, TRAIN_BATCH)
                    batch = steps.shard_batch(steps.batch_on(
                        {"tokens": toks[:, :-1], "labels": toks[:, 1:]},
                        dev), mesh)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    params, opt, m = fn(params, opt, batch)
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t) * 1e3)
                    losses_.append(float(m["loss"]))
                    norms.append(float(m["grad_norm"]))
        finally:
            optim.adamw_update = orig_update
        counts = build.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        k5 = counts.get("flash_attention_wgmma", 0)
        want = phase12["losses"][:MESH_STEPS]
        want_norms = phase12["grad_norms"][:MESH_STEPS]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses_, want)]
        rel_norms = [abs(a - b) / abs(b) for a, b in zip(norms, want_norms)]
        placements = {str(p.placements) for p in params.parameters()}
        out = {"arch": cfg.name, "mesh": [1, 1], "backend": "nccl",
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "lr": TRAIN_LR,
               "losses": losses_, "unmeshed_losses": want,
               "loss_rel_diff": rel, "grad_norms": norms,
               "unmeshed_grad_norms": want_norms,
               "grad_norm_rel_diff": rel_norms, "step_ms": step_ms,
               "unmeshed_step_ms_median_2_5": phase12["step_ms_median_2_5"],
               "peak_bytes": peak, "unmeshed_peak_bytes": phase12[
                   "peak_bytes"], "k5_launches": k5,
               "k5_launches_per_step": k5 / MESH_STEPS,
               "param_placements": sorted(placements), "launches": counts}
        print(f"gemma-2b meshed train ((1, 1) NCCL mesh, build_cell's step, "
              f"DTensor parameters {sorted(placements)}): losses "
              f"{[round(x, 5) for x in losses_]} vs unmeshed "
              f"{[round(x, 5) for x in want]} (rel {rel}), grad norms "
              f"{norms} vs {want_norms} (rel {rel_norms}), step ms "
              f"{[round(x, 1) for x in step_ms]} vs unmeshed median "
              f"{phase12['step_ms_median_2_5']:.1f}, peak "
              f"{peak / 2**30:.2f} GiB vs {phase12['peak_bytes'] / 2**30:.2f}"
              f" GiB, K5 wgmma {k5 / MESH_STEPS:g} a step [{smi}]",
              flush=True)
        if not all(math.isfinite(x) for x in losses_ + norms) or \
                len(rel) != MESH_STEPS or len(rel_norms) != MESH_STEPS or \
                max(rel + rel_norms) > MESH_LOSS_RTOL:
            fail(f"gemma-2b meshed train: losses {losses_} vs unmeshed "
                 f"{want}, grad norms {norms} vs {want_norms} (rtol "
                 f"{MESH_LOSS_RTOL})")
        if k5 != TRAIN_K5_PER_STEP * MESH_STEPS or \
                counts.get("flash_attention", 0) or rec.launches() != k5:
            fail(f"gemma-2b meshed train: K5 wgmma {k5} in {MESH_STEPS} "
                 f"steps, not {TRAIN_K5_PER_STEP} a step; TF32 "
                 f"{counts.get('flash_attention', 0)}")
        del params, opt, fn, batch
        gc.collect()
        torch.cuda.empty_cache()
        return out, rec, kept["grad"]
    finally:
        dist.destroy_process_group()


def mesh_train_whisper(dev, smi: str) -> tuple:
    """whisper-small through ``launch.train --mesh 1,1`` (the DTensor path
    on one rank; the CLI starts and ends its own group), 4 x 512, 2 steps:
    K5 ``WHISPER_K5_PER_STEP`` times a step."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import build
    from repro_torch.launch import train

    argv = ["--arch", "whisper-small", *WHISPER_TRAIN, "--mesh", "1,1"]
    build.reset_counters()
    with K5Recorder() as rec:
        state = train.main(argv)
    torch.cuda.synchronize()
    if dist.is_initialized():
        fail("launch.train --mesh 1,1 left its process group initialised")
    counts = build.launch_counts()
    k5 = counts.get("flash_attention_wgmma", 0)
    losses_ = [m["loss"] for m in state.metrics_history]
    n = len(losses_)
    out = {"cli": argv, "losses": losses_, "k5_launches": k5,
           "k5_launches_per_step": k5 / max(n, 1),
           "step_ms": [m["step_time_s"] * 1e3 for m in state.metrics_history]}
    print(f"whisper-small meshed train (CLI {' '.join(argv)}): losses "
          f"{[round(x, 4) for x in losses_]}, step ms "
          f"{[round(x, 1) for x in out['step_ms']]}, K5 wgmma "
          f"{k5 / max(n, 1):g} a step [{smi}]", flush=True)
    if n != 2 or not all(math.isfinite(x) for x in losses_) or \
            k5 != WHISPER_K5_PER_STEP * n or counts.get("flash_attention", 0):
        fail(f"whisper-small --mesh 1,1: losses {losses_}, K5 wgmma {k5}")
    del state
    torch.cuda.empty_cache()
    return out, rec


def compress_on_card(grad, dev, smi: str) -> dict:
    """``compress`` of a gemma-2b gradient leaf on the card equals the
    CPU's bit for bit (q, scale, error), and ``compressed_psum`` on a
    one-rank group equals ``decompress``."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import compress

    g = grad.float()
    err = torch.zeros_like(g)
    c, ne = compress.compress(g, err)
    torch.cuda.synchronize()
    t = per_call_ms(lambda: compress.compress(g, err), calls=10, reps=3)
    cc, cne = compress.compress(g.cpu(), err.cpu())
    same = (torch.equal(c.q.cpu(), cc.q) and torch.equal(c.scale.cpu(),
                                                         cc.scale)
            and torch.equal(ne.cpu(), cne))
    _one_rank_group(dev)
    try:
        mean, perr = compress.compressed_psum({"g": g}, {"g": err})
        torch.cuda.synchronize()
        psum_same = torch.equal(mean["g"], compress.decompress(c)) and \
            torch.equal(perr["g"], ne)
    finally:
        dist.destroy_process_group()
    out = {"leaf": COMPRESS_LEAF, "shape": list(g.shape),
           "scale": float(c.scale), "max_abs_err": float(ne.abs().max()),
           "card_equals_cpu": same, "psum_equals_decompress": psum_same,
           "compress_ms": t}
    print(f"compress on the card ({COMPRESS_LEAF} gradient {list(g.shape)}):"
          f" equals the CPU bit for bit {same}; compressed_psum on one rank "
          f"equals decompress {psum_same}; {t:.3f} ms [{smi}]", flush=True)
    if not (same and psum_same):
        fail(f"compress on the card: card == CPU {same}, psum == decompress "
             f"{psum_same}")
    return out


def dryrun_cells(smi: str, art_dir: Path) -> dict:
    """The dry run of ``DRYRUN_CELLS`` at the production meshes (16 x 16,
    2 x 16 x 16), in a subprocess with the fake group of 512 ranks: each
    record's per-rank bytes beside the card's memory, its collectives and
    flops."""
    import os
    import torch
    out_dir = art_dir / "dryrun"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_") and k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    card = torch.cuda.get_device_properties(0).total_memory
    out = {"card_bytes": card}
    for arch, shape, mesh in DRYRUN_CELLS:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--force",
             "--results-dir", str(out_dir)], env=env, cwd=str(ROOT),
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT)
        wall = time.perf_counter() - t
        path = out_dir / f"{arch}__{shape}__{mesh}.json"
        if proc.returncode or not path.exists():
            fail(f"dry run {arch} {shape} {mesh}: exit {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        rec = json.loads(path.read_text())
        if rec["status"] != "ok":
            fail(f"dry run {arch} {shape} {mesh}: {rec.get('error')}")
        ma, coll = rec["memory_analysis"], rec["collectives"]
        row = {"design": rec["design"], "mesh_shape": rec["mesh_shape"],
               "devices": rec["devices"],
               "param_bytes_per_rank": ma["param_bytes_per_rank"],
               "argument_bytes_per_rank": ma["argument_size_in_bytes"],
               "peak_bytes_per_rank": ma["peak_bytes_per_rank"],
               "peak_over_card": ma["peak_bytes_per_rank"] / card,
               "flops_per_rank": rec["cost_analysis"]["flops"],
               "collectives": {k: v for k, v in coll.items()
                               if k == "total_bytes" or v["count"]},
               "tp_collectives": rec["tp_collectives"],
               "run_s": rec["run_s"], "wall_s": wall}
        out[f"{arch} {shape} {mesh}"] = row
        print(f"dry run {arch} {shape} on {rec['mesh_shape']} (fake group, "
              f"meta DTensors, design {rec['design']}): per rank parameters "
              f"{row['param_bytes_per_rank'] / 2**30:.3f} GiB, arguments "
              f"{row['argument_bytes_per_rank'] / 2**30:.3f} GiB, peak "
              f"{row['peak_bytes_per_rank'] / 2**30:.3f} GiB = "
              f"{row['peak_over_card']:.3f} of the card's "
              f"{card / 2**30:.1f} GiB; flops {row['flops_per_rank']:.4g}; "
              f"collectives {row['collectives']}; {wall:.1f} s [{smi}]",
              flush=True)
    return out


TP_MESH = (1, 2)             # (data, model) of the tensor-parallel step
TP_RANKS = 2                 # processes, both on cuda:0
TP_TIMEOUT = 900             # s, both rank processes together
TP_PREFILL = 1024            # prompt tokens of the tensor-parallel prefill
TP_DESIGN = "tp"             # gemma-2b's 8 heads split 4 a rank at model 2
TP_PREFILL_K5 = 18           # one launch a layer of the prefill, each rank
# TP vs phase 12's unmeshed steps, (step 1, step 2), relative.  Step 1's
# loss is a forward of the same weights.  Its grad norm and step 2 sit on
# bf16's reordering floor, which :func:`bf16_order_floor` measures in the
# same call (the unmeshed step, each gradient summed over 4 row slices;
# PERF.md §6 gives its readings): AdamW's first step is lr x sign(g), so
# every gradient entry within rounding of 0 moves its parameter by up to
# 2 lr.  A dropped or mis-scaled update moves step 2's loss by about a
# step's change (3.7e-3), a missing partial sum the grad norms by far
# more than these bounds.
TP_LOSS_RTOL = (1e-4, 2e-3)
TP_GRAD_NORM_RTOL = (1e-3, 2e-2)
TP_FLOOR_SLICES = 4


def _tp_gather_cols(t):
    """This rank's last-dim piece of a tensor gathered whole on every rank
    through the host (gloo's list all-gather on CPU tensors)."""
    import torch
    import torch.distributed as dist
    parts = [torch.empty_like(t.cpu()) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.cpu().contiguous())
    return torch.cat(parts, dim=-1)


def tp_rank(rank: int, dev, seed: int, smi: str) -> dict:
    """One rank of the two-rank tensor-parallel check, on ``dev`` in a
    process of its own (the default group is gloo over the host): full-width
    gemma-2b trained ``MESH_STEPS`` steps through ``build_cell``'s train
    step on the ``TP_MESH`` mesh (each block on its weight shards, 4 of the
    8 q heads a rank, the residual on 1,024 of the 2,048 columns, the tied
    head on 128,000 vocabulary rows) from phase 12's seed, lr and batches,
    K5 counted and recorded; rank 0 holds K5 at its layout against the
    plain version and times it beside SDPA.  Then a ``TP_PREFILL``-token
    bf16 prefill through ``build_cell``'s prefill step, its logits gathered
    (rank 0 also runs the unmeshed prefill of the same weights first).
    Returns this rank's report."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.configs import lm_archs
    from repro_torch.data import tokens
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch import mesh as mesh_mod, steps
    from repro_torch.models import lm
    from repro_torch.train import optim

    cfg = lm_archs.GEMMA_2B
    mesh = mesh_mod.make_mesh(TP_MESH, ("data", "model"), device=dev)
    torch.cuda.reset_peak_memory_stats()
    params = shd.distribute_params(steps.init_fn(cfg)(
        torch.Generator(dev).manual_seed(seed), dev), mesh)
    opt = steps.opt_init(params)
    shape = steps.ShapeSpec("phase13 tp", TRAIN_SEQ, TRAIN_BATCH, "train")
    fn, _ = steps.build_cell(cfg, shape, mesh, opt_cfg=optim.AdamWConfig(
        lr=TRAIN_LR, weight_decay=0.1))
    corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=seed))
    losses_, norms, step_ms = [], [], []
    torch.cuda.synchronize()
    build.reset_counters()
    with K5Recorder() as rec:
        for s in range(MESH_STEPS):
            toks = corpus.sample_batch(s, TRAIN_BATCH)
            batch = steps.shard_batch(steps.batch_on(
                {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, dev), mesh)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = fn(params, opt, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses_.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    local = {n: list(shd.local(p).shape) for n, p in
             params.named_parameters() if n in ("embed", "blocks.0.attn.wq",
                                                "blocks.0.ffn.w_down")}
    out = {"rank": rank, "mesh": list(TP_MESH), "backend": "gloo",
           "design": steps.design(cfg, mesh), "losses": losses_,
           "grad_norms": norms, "step_ms": step_ms, "peak_bytes": peak,
           "launches": counts, "k5_layouts": {_k5_label(k): n for k, n in
                                               rec.counts.items()},
           "local_shapes": local}
    del params, opt, fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        out["k5_held"] = hold_k5_record(rec, "gemma-2b TP train")
        out["kernel_row"] = k5_layout_row(
            "K5 wgmma, gemma-2b TP training", "gemma-2b TP train", rec,
            _largest(rec, True), smi)
    dist.barrier()
    # the prefill: the same bf16 weights unmeshed (rank 0), then split
    prompt = torch.randint(0, cfg.vocab, (1, TP_PREFILL), device=dev,
                           generator=torch.Generator(dev).manual_seed(seed))
    model = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev,
                           dtype=torch.bfloat16)
    if rank == 0:
        out["unmeshed_logits"] = lm.prefill(model, cfg, prompt,
                                            TP_PREFILL)[0].float().cpu()
    model = shd.distribute_params(model, mesh)
    pre, _ = steps.build_cell(cfg, steps.ShapeSpec(
        "phase13 tp prefill", TP_PREFILL, 1, "prefill"), mesh)
    build.reset_counters()
    logits, _ = pre(model, shd.distribute(prompt, mesh, shd.Spec(
        shd.dp_axes(mesh), None)))
    torch.cuda.synchronize()
    out["prefill_launches"] = build.launch_counts()
    out["prefill_logits_local"] = list(shd.local(logits).shape)
    whole = _tp_gather_cols(shd.local(logits).float())
    if rank == 0:
        out["logits"] = whole
    del model, logits
    gc.collect()
    torch.cuda.empty_cache()
    out["families"] = tp_families_rank(rank, dev, mesh, seed, smi)
    return out


def tp_rank_main(rank: int, tp_dir: Path, seed: int) -> None:
    """``chip_smoke.py --tp-rank R``: join the gloo group of
    ``TP_RANKS`` processes through a file store in ``tp_dir``, run
    :func:`tp_rank` on ``cuda:0`` and save its report to
    ``tp_dir/rank<R>.pt``."""
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tp_dir / "store"), TP_RANKS), rank=rank, world_size=TP_RANKS)
    try:
        out = tp_rank(rank, dev, seed, smi_line())
        torch.save(out, tp_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


# The other families tensor-parallel on the same two ranks (slice 16), at
# full width; depth cut only for the MoE models, as phase 11 cuts them
TP_MOE_ARCHS = (("mixtral-8x22b", MIXTRAL_LAYERS), ("dbrx-132b", DBRX_LAYERS))
TP_MOE_PROMPT = 600          # tokens of each MoE prefill (phase 11's longest)
TP_DECODE_TICKS = 4          # decode ticks after each LM prefill
TP_HYMBA_TRAIN = (4, 512)    # rows, tokens of hymba's two training steps
TP_HYMBA_PREFILL = 1100      # past hymba's 1,024 window: the ring rolls
TP_RWKV_PREFILL = 700
# hymba's and rwkv6-7b's bf16 logits and states lie further from an f32
# run of the same weights than DECODE_VS_PREFILL_REL and the 1e-3 of RWKV's
# states (ROADMAP C.6; PERF.md §6), so a bf16 TP run cannot be held to
# them.  Both models are also run in f32 on the same bf16 values, unmeshed
# and on the TP mesh, and that pair is held at TP_F32_TOL of the largest
# entry (the logits, with the argmax, and every recurrent state): f32
# leaves only the reordering's rounding between them (hymba's attention
# in TF32 on both sides).  The bf16 TP run is held no farther
# from the f32 run than this factor times the unmeshed bf16 run's largest
# distance from it (logits, over the prefill and the ticks)
TP_BF16_VS_F32_FACTOR = 1.25
TP_F32_TOL = 1e-3
TP_WHISPER_TICKS = 8
TP_FAMILY_DESIGN = {"mixtral-8x22b": "tp", "dbrx-132b": "tp",
                    "hymba-1.5b": "tp (q whole)", "rwkv6-7b": "tp",
                    "whisper-small": "tp"}


class DispatchLog:
    """Inside the context, every MoE routing's router logits, dispatch
    table and token slots (``moe._group_dispatch``'s input and first and
    third outputs), copied to the host."""

    def __enter__(self):
        from repro_torch.models import moe
        self.orig, self.log = moe._group_dispatch, []

        def logged(spec, cap, logits):
            out = self.orig(spec, cap, logits)
            self.log.append((logits.detach().float().cpu(), out[0].cpu(),
                             out[2].cpu()))
            return out
        moe._group_dispatch = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._group_dispatch = self.orig


def _fresh_memory() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _tp_serve(cfg, model, mesh, prompt, ticks, audio=None) -> dict:
    """``prompt`` prefilled and ``ticks [n, B, 1]`` decoded by ``model``:
    unmeshed when ``mesh`` is None, else through ``build_cell``'s serving
    steps on ``mesh`` (logits gathered whole through the host).  Returns
    every step's logits and the recurrent states of the last cache on the
    host, and the prefill's and the decode ticks' ms."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm, whisper
    ctx = WHISPER_CONTEXT if cfg.is_enc_dec else FAMILY_CONTEXT
    mod = whisper if cfg.is_enc_dec else lm
    if mesh is None:
        def pre(t):
            if cfg.is_enc_dec:
                return whisper.prefill(model, cfg, audio, t, ctx)
            return lm.prefill(model, cfg, t, ctx)

        def dec(c, t):
            return mod.decode_step(model, cfg, c, t)

        def whole(t):
            return t.float().cpu()
    else:
        dp = shd.dp_axes(mesh)
        b = prompt.shape[0]
        pre_fn, _ = steps.build_cell(cfg, steps.ShapeSpec(
            "phase13 tp prefill", ctx, b, "prefill"), mesh)
        dec_fn, _ = steps.build_cell(cfg, steps.ShapeSpec(
            "phase13 tp decode", ctx, b, "decode"), mesh)
        extra = () if audio is None else (
            shd.distribute(audio, mesh, shd.Spec(dp, None, None)),)

        def pre(t):
            return pre_fn(model, shd.distribute(t, mesh, shd.Spec(dp, None)),
                          *extra)

        def dec(c, t):
            return dec_fn(model, c, shd.distribute(t, mesh,
                                                   shd.Spec(dp, None)))

        def whole(t):
            return _tp_gather_cols(shd.local(t).float())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = pre(prompt)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = [whole(logits)]
    for t in ticks:
        logits, cache = dec(cache, t)
        out.append(whole(logits))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    states = {k: shd.local(v).float().cpu() for k, v in cache.items()
              if k.startswith(("rwkv_", "ssm_"))}
    return {"logits": out, "states": states, "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_tick": (t2 - t1) * 1e3 / max(len(ticks), 1)}


def _cast_params(model, dtypes) -> dict:
    """Every parameter of ``model`` (whole or a ``DTensor``) cast in place
    to ``dtypes`` (one dtype, or a dtype by name); returns the dtypes they
    had."""
    import torch
    had = {}
    for name, p in list(model.named_parameters()):
        had[name] = p.dtype
        dt = dtypes if isinstance(dtypes, torch.dtype) else dtypes[name]
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            p.data.to(dt), requires_grad=p.requires_grad)
    return had


def _tp_serve_family(arch: str, rank: int, dev, mesh, seed: int, *,
                     layers=None, prompt_len: int, ticks: int,
                     batch: int = 1, f32: bool = False) -> tuple:
    """One family served on the TP mesh, at full width (depth ``layers``
    where cut), bf16: rank 0 first runs the same weights unmeshed; then
    both ranks the prefill and ``ticks`` decode ticks through
    ``build_cell``, the launch counts set to 0 just before and K5
    recorded.  With ``f32``, the same bf16 values are also run in f32,
    unmeshed by rank 0 (``f32``) and on the TP mesh (``tp_f32``), after
    the counted run.  Returns (this rank's report, K5 recorder)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.models import lm, whisper

    cfg = lm_archs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    _fresh_memory()
    gen = torch.Generator(dev).manual_seed(seed)
    if cfg.is_enc_dec:
        model = whisper.compute_copy(whisper.init_params(cfg, gen, dev), cfg)
        audio = torch.randn((batch, cfg.enc_context, cfg.d_model),
                            generator=torch.Generator(dev).manual_seed(
                                seed + 1), device=dev)
    else:
        model = lm.init_params(cfg, gen, dev, dtype=torch.bfloat16)
        audio = None
    rng = np.random.RandomState(seed + 3)
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (
        batch, prompt_len))).to(dev)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab, (
        ticks, batch, 1))).to(dev)
    out = {"arch": arch, "layers": cfg.n_layers, "prompt": prompt_len,
           "batch": batch, "ticks": ticks, "design": steps.design(cfg, mesh)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    if rank == 0:
        with DispatchLog() as dlog:
            out["unmeshed"] = _tp_serve(cfg, model, None, prompt, toks, audio)
        out["unmeshed_dispatch"] = dlog.log
        if f32:     # the same values in f32, and back (exact)
            had = _cast_params(model, torch.float32)
            out["f32"] = _tp_serve(cfg32, model, None, prompt, toks)
            _cast_params(model, had)
    model = shd.distribute_params(model, mesh)
    _fresh_memory()
    names = ("blocks.0.attn.wq", "blocks.0.moe.w_up", "blocks.0.moe.w_down",
             "blocks.0.ssm.in_proj", "blocks.0.wr", "dec.0.self_attn.wq",
             "dec.0.ffn.w_up")
    out["local_shapes"] = {n: list(shd.local(p).shape) for n, p in
                           model.named_parameters() if n in names}
    build.reset_counters()
    with K5Recorder() as rec, DispatchLog() as dlog:
        out["tp"] = _tp_serve(cfg, model, mesh, prompt, toks, audio)
    out["launches"] = build.launch_counts()
    out["dispatch"] = dlog.log
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["k5_layouts"] = {_k5_label(k): n for k, n in rec.counts.items()}
    if f32:
        _cast_params(model, torch.float32)
        _fresh_memory()
        build.reset_counters()
        with K5Recorder() as rec32:
            out["tp_f32"] = _tp_serve(cfg32, model, mesh, prompt, toks)
        out["launches_f32"] = build.launch_counts()
        if rank == 0:       # hymba's attention: K5's TF32 kernel
            out["k5_held_f32"] = hold_k5_record(rec32, f"{arch} f32 TP")
        del rec32
    del model
    _fresh_memory()
    return out, rec


def _tp_train_hymba(rank: int, dev, mesh, seed: int) -> tuple:
    """hymba-1.5b at full width and depth trained ``MESH_STEPS`` steps
    through ``build_cell``'s train step on the TP mesh from ``seed``'s
    weights at phase 12's lr, ``TP_HYMBA_TRAIN`` batches of
    ``tokens.SyntheticCorpus(seed)``, the launch counts set to 0 just
    before and K5 recorded.  Returns (report, K5 recorder)."""
    import torch
    from repro_torch.configs import lm_archs
    from repro_torch.data import tokens
    from repro_torch.dist import sharding as shd
    from repro_torch.kernels import build
    from repro_torch.launch import steps
    from repro_torch.train import optim

    cfg = lm_archs.get("hymba-1.5b")
    rows, seq = TP_HYMBA_TRAIN
    _fresh_memory()
    params = shd.distribute_params(steps.init_fn(cfg)(
        torch.Generator(dev).manual_seed(seed), dev), mesh)
    opt = steps.opt_init(params)
    fn, _ = steps.build_cell(cfg, steps.ShapeSpec(
        "phase13 tp hymba", seq, rows, "train"), mesh,
        opt_cfg=optim.AdamWConfig(lr=TRAIN_LR, weight_decay=0.1))
    corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=rows, seed=seed))
    losses_, norms, step_ms = [], [], []
    build.reset_counters()
    with K5Recorder() as rec:
        for s in range(MESH_STEPS):
            toks = corpus.sample_batch(s, rows)
            batch = steps.shard_batch(steps.batch_on(
                {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, dev), mesh)
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = fn(params, opt, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            losses_.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out = {"arch": cfg.name, "rows": rows, "seq": seq,
           "design": steps.design(cfg, mesh), "losses": losses_,
           "grad_norms": norms, "step_ms": step_ms,
           "launches": build.launch_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "k5_layouts": {_k5_label(k): n for k, n in rec.counts.items()}}
    del params, opt, fn, batch
    _fresh_memory()
    return out, rec


def tp_families_rank(rank: int, dev, mesh, seed: int, smi: str) -> dict:
    """This rank's part of the other families on the TP mesh (slice 16):
    mixtral-8x22b and dbrx-132b (phase 11's depth cuts) a 600-token
    prefill and 4 ticks; hymba-1.5b 2 training steps and a 1,100-token
    prefill and 4 ticks; rwkv6-7b a 700-token prefill and 4 ticks (both
    served again in f32 on the same bf16 values); whisper-small 3 rows of
    1,536 frames, a 32-token prompt and 8 ticks.  Rank 0 holds every K5 layout against the plain version and times it
    beside SDPA (kernel-line rows).  Returns the report."""
    out, recs = {}, {}
    for arch, layers in TP_MOE_ARCHS:
        out[arch], recs[arch] = _tp_serve_family(
            arch, rank, dev, mesh, seed, layers=layers,
            prompt_len=TP_MOE_PROMPT, ticks=TP_DECODE_TICKS)
    out["hymba-1.5b train"], recs["hymba-1.5b train"] = _tp_train_hymba(
        rank, dev, mesh, seed)
    out["hymba-1.5b"], recs["hymba-1.5b"] = _tp_serve_family(
        "hymba-1.5b", rank, dev, mesh, seed, prompt_len=TP_HYMBA_PREFILL,
        ticks=TP_DECODE_TICKS, f32=True)
    out["rwkv6-7b"], _ = _tp_serve_family(
        "rwkv6-7b", rank, dev, mesh, seed, prompt_len=TP_RWKV_PREFILL,
        ticks=TP_DECODE_TICKS, f32=True)
    out["whisper-small"], recs["whisper-small"] = _tp_serve_family(
        "whisper-small", rank, dev, mesh, seed, prompt_len=WHISPER_PROMPT,
        ticks=TP_WHISPER_TICKS, batch=WHISPER_BATCH)
    if rank == 0:
        out["k5_held"], out["kernel_rows"] = {}, []
        for label, rec in recs.items():
            out["k5_held"][label] = hold_k5_record(rec, f"{label} TP")
            for key in sorted(rec.calls, key=str):
                out["kernel_rows"].append(k5_layout_row(
                    f"K5 wgmma, {label} TP", f"{label} TP", rec, key, smi))
        _fresh_memory()
    return out


def _rel_steps(got: list, want: list, vocab: int) -> list:
    """Each step's max |got - want| over the vocabulary, relative to the
    largest entry of ``want``."""
    return [float((g[..., :vocab] - w[..., :vocab]).abs().max())
            / float(w[..., :vocab].abs().max()) for g, w in zip(got, want)]


def _logits_held(label: str, got: list, want: list, vocab: int,
                 limit: float = DECODE_VS_PREFILL_REL) -> dict:
    """Each step's TP logits against the unmeshed run's: finite, within
    ``limit`` of the largest logit, and the same argmax in
    every row or, where a row's argmaxes differ, a tie at the precision
    the two runs share (the unmeshed logits of both tokens within the max
    |diff|)."""
    import torch
    if len(got) != len(want):
        fail(f"{label} TP: {len(got)} steps of logits, unmeshed {len(want)}")
    errs = _rel_steps(got, want, vocab)
    gaps, same = [], True
    for g, w in zip(got, want):
        g, w = g[..., :vocab], w[..., :vocab]
        top = g.argmax(-1)
        gaps.append(float((w.max(-1).values
                           - w.gather(-1, top[:, None])[:, 0]).max()))
        same = same and bool(torch.equal(top, w.argmax(-1)))
    print(f"{label} TP logits a step (prefill, then each tick): max |diff| "
          f"/ largest {[round(e, 7) for e in errs]}; argmax logit gaps "
          f"{gaps}", flush=True)
    for i, g in enumerate(got):
        scale = float(want[i][..., :vocab].abs().max())
        if not (torch.isfinite(g[..., :vocab]).all()
                and errs[i] <= limit and gaps[i] <= errs[i] * scale):
            fail(f"{label} TP: step {i} logits max |diff| {errs[i]} of the "
                 f"largest (limit {limit}), argmax logit gap {gaps[i]}")
    return {"max_rel_diff": max(errs), "rel_diff": errs,
            "argmax_same": same, "argmax_gaps": gaps}


def _states_rel(got: dict, want: dict) -> dict:
    """Each recurrent state's max |got - want| relative to the largest
    entry of ``want``."""
    if set(got) != set(want):
        fail(f"TP states {sorted(got)}, unmeshed {sorted(want)}")
    return {k: float((got[k] - v).abs().max()) / float(v.abs().max())
            for k, v in want.items()}


def _f32_held(arch: str, ref: dict, vocab: int) -> dict:
    """hymba's or rwkv6-7b's f32 pair (the same bf16 values unmeshed and
    on the TP mesh): logits as :func:`_logits_held` and every state, each
    within ``TP_F32_TOL`` of its largest entry.  Then the bf16 pair: the TP
    run's logits no farther from the unmeshed f32 run than
    ``TP_BF16_VS_F32_FACTOR`` times the unmeshed bf16 run's largest
    distance from it.  Returns the readings."""
    import torch
    rep = {"f32": _logits_held(f"{arch} f32", ref["tp_f32"]["logits"],
                               ref["f32"]["logits"], vocab, TP_F32_TOL)}
    states = _states_rel(ref["tp_f32"]["states"], ref["f32"]["states"])
    rep["f32"]["state_rel_diff"] = states
    if not states or not all(torch.isfinite(v).all() for v in
                             ref["tp_f32"]["states"].values()) \
            or any(not e <= TP_F32_TOL for e in states.values()):
        fail(f"{arch} f32 TP: states {states} of their largest entries "
             f"(limit {TP_F32_TOL})")
    floor = _rel_steps(ref["unmeshed"]["logits"], ref["f32"]["logits"],
                       vocab)
    tp = _rel_steps(ref["tp"]["logits"], ref["f32"]["logits"], vocab)
    rep["bf16_floor_rel"], rep["bf16_tp_vs_f32_rel"] = floor, tp
    rep["bf16_state_floor_rel"] = _states_rel(ref["unmeshed"]["states"],
                                              ref["f32"]["states"])
    rep["bf16_tp_state_vs_f32_rel"] = _states_rel(ref["tp"]["states"],
                                                  ref["f32"]["states"])
    print(f"{arch} bf16 logits' distance from the unmeshed f32 run, a step: "
          f"unmeshed {[round(x, 5) for x in floor]}, TP "
          f"{[round(x, 5) for x in tp]} (limit {TP_BF16_VS_F32_FACTOR} x "
          f"the unmeshed's largest); states: unmeshed "
          f"{rep['bf16_state_floor_rel']}, TP "
          f"{rep['bf16_tp_state_vs_f32_rel']}", flush=True)
    if not max(tp) <= TP_BF16_VS_F32_FACTOR * max(floor):
        fail(f"{arch} bf16 TP: logits {max(tp)} of the largest from the f32 "
             f"run, the unmeshed bf16 run {max(floor)}")
    return rep


def _dispatch_held(label: str, k: int, want: list, got: list) -> dict:
    """The TP run's MoE routings against the unmeshed run's: equal, or,
    where a token's top-k experts differ, a tie: the unmeshed logits' gap
    at the k-th boundary within the two runs' logit difference (a bf16
    rounding on either side flips it).  Counts such tokens."""
    import torch
    from repro_torch.models import moe
    if len(want) != len(got):
        fail(f"{label} TP: {len(got)} routings, unmeshed {len(want)}")
    flips, equal, worst = 0, 0, 0.0
    for (la, da, sa), (lb, db, sb) in zip(want, got):
        if torch.equal(da, db) and torch.equal(sa, sb):
            equal += 1
            continue
        ia = moe.top_k(la, k)[1].sort(-1).values
        ib = moe.top_k(lb, k)[1].sort(-1).values
        moved = (ia != ib).any(-1)
        if not moved.any():
            fail(f"{label} TP: a dispatch differs with the same experts "
                 "chosen")
        vals = la.sort(-1, descending=True).values
        gap = (vals[..., k - 1] - vals[..., k])[moved]
        diff = (la - lb).abs().amax(-1)[moved]
        if (gap > 2 * diff).any():
            fail(f"{label} TP: a token's experts moved across a logit gap "
                 f"{float(gap.max())} wider than the runs' difference")
        flips += int(moved.sum())
        worst = max(worst, float(gap.max()))
    return {"routings": len(want), "equal": equal, "tokens_flipped": flips,
            "largest_flipped_gap": worst}


def check_tp_families(ranks: list, hymba: dict, smi: str) -> tuple:
    """The families part of both TP ranks' reports (``tp_families_rank``)
    against rank 0's unmeshed runs (``hymba``: the unmeshed training
    steps and bf16's floor, run here first): designs, K5 launches a rank,
    logits, MoE routings, hymba's and RWKV's logits and states in f32 (the
    bf16 pair's distance from f32 beside them), hymba's losses and grad
    norms.  Fails on any miss.  Returns (report, rank 0's kernel-line
    rows)."""
    import torch
    from repro_torch.configs import lm_archs
    r0 = ranks[0]["families"]
    out = {}
    for arch in ("mixtral-8x22b", "dbrx-132b", "hymba-1.5b", "rwkv6-7b",
                 "whisper-small"):
        cfg = lm_archs.get(arch)
        ref = r0[arch]
        rep = {"layers": ref["layers"], "prompt": ref["prompt"],
               "batch": ref["batch"], "ticks": ref["ticks"]}
        layers, L = ref["layers"], cfg.n_layers
        want_k5 = {"mixtral-8x22b": layers, "dbrx-132b": layers,
                   "hymba-1.5b": L, "rwkv6-7b": 0,
                   "whisper-small": cfg.encoder_layers + 2 * L
                   + TP_WHISPER_TICKS * L}[arch]
        for r in ranks:
            f = r["families"][arch]
            k5 = f["launches"].get("flash_attention_wgmma", 0)
            if f["design"] != TP_FAMILY_DESIGN[arch] or k5 != want_k5 or \
                    f["launches"].get("flash_attention", 0):
                fail(f"{arch} TP rank {r['rank']}: design {f['design']}, K5 "
                     f"wgmma {k5} (want {want_k5}), TF32 "
                     f"{f['launches'].get('flash_attention', 0)}")
            if "launches_f32" in f and (
                    f["launches_f32"].get("flash_attention", 0) != want_k5
                    or f["launches_f32"].get("flash_attention_wgmma", 0)):
                fail(f"{arch} f32 TP rank {r['rank']}: K5 launches "
                     f"{f['launches_f32']} (want TF32 {want_k5})")
            if r is not ranks[0] and not all(
                    (a == b).all() for a, b in zip(f["tp"]["logits"],
                                                   ref["tp"]["logits"])):
                fail(f"{arch} TP: the two ranks' gathered logits differ")
        if "tp_f32" in ref:     # hymba, rwkv6-7b: held in f32
            rep["logits"] = {"max_rel_diff": max(_rel_steps(
                ref["tp"]["logits"], ref["unmeshed"]["logits"],
                cfg.vocab))} | _f32_held(arch, ref, cfg.vocab)
            if not all(bool(torch.isfinite(x).all()) for x in
                       ref["tp"]["logits"]):
                fail(f"{arch} bf16 TP: logits not finite")
        else:
            rep["logits"] = _logits_held(arch, ref["tp"]["logits"],
                                         ref["unmeshed"]["logits"],
                                         cfg.vocab)
        if cfg.family == "moe":
            rep["dispatch"] = _dispatch_held(arch, cfg.top_k,
                                             ref["unmeshed_dispatch"],
                                             ref["dispatch"])
            r1 = ranks[1]["families"][arch]["dispatch"]
            if not all((a[1] == b[1]).all() and (a[2] == b[2]).all()
                       for a, b in zip(r1, ref["dispatch"])):
                fail(f"{arch} TP: the two ranks route differently")
        states = _states_rel(ref["tp"]["states"], ref["unmeshed"]["states"])
        rep["state_rel_diff"] = states
        rep["per_rank"] = [{
            "design": r["families"][arch]["design"],
            "peak_bytes": r["families"][arch]["peak_bytes"],
            "prefill_ms": r["families"][arch]["tp"]["prefill_ms"],
            "decode_ms_per_tick": r["families"][arch]["tp"][
                "decode_ms_per_tick"],
            "k5_layouts": r["families"][arch]["k5_layouts"],
            "local_shapes": r["families"][arch]["local_shapes"]}
            for r in ranks]
        rep["unmeshed_prefill_ms"] = ref["unmeshed"]["prefill_ms"]
        out[arch] = rep
        print(f"{arch} TP serve ({TP_MESH} mesh, {ref['layers']} layers, "
              f"prompt {ref['prompt']} x {ref['batch']}, {ref['ticks']} "
              f"ticks; gloo between two processes on one card, so no figure "
              f"of TP speed): design {rep['per_rank'][0]['design']}, logits "
              f"max rel diff {rep['logits']['max_rel_diff']:.4g} (argmax "
              f"same {rep['logits'].get('argmax_same', 'not held in bf16')})"
              f", states {states}, f32 pair "
              f"{rep['logits'].get('f32', 'not run')}, "
              f"routings {rep.get('dispatch')}, prefill ms "
              f"{[round(x['prefill_ms'], 1) for x in rep['per_rank']]} "
              f"(unmeshed {rep['unmeshed_prefill_ms']:.1f}), decode ms a "
              f"tick {[round(x['decode_ms_per_tick'], 1) for x in rep['per_rank']]}, "
              f"peak GiB a rank "
              f"{[round(x['peak_bytes'] / 2**30, 2) for x in rep['per_rank']]}, "
              f"K5 a rank {want_k5} at {rep['per_rank'][0]['k5_layouts']}, "
              f"local shapes {rep['per_rank'][0]['local_shapes']} [{smi}]",
              flush=True)
    # hymba's training steps against the unmeshed ones, above bf16's floor
    cfg = lm_archs.get("hymba-1.5b")
    want_k5 = MESH_STEPS * cfg.n_layers * (2 if cfg.remat else 1)
    plain_l, plain_n = hymba["losses"], hymba["grad_norms"]
    floor_l = [abs(a - b) / abs(b) for a, b in zip(hymba["floor_losses"],
                                                   plain_l)]
    floor_n = [abs(a - b) / abs(b) for a, b in zip(
        hymba["floor_grad_norms"], plain_n)]
    loss_tol = [max(t, 3 * f) for t, f in zip(TP_LOSS_RTOL, floor_l)]
    norm_tol = [max(t, 3 * f) for t, f in zip(TP_GRAD_NORM_RTOL, floor_n)]
    train = {"rows": TP_HYMBA_TRAIN[0], "seq": TP_HYMBA_TRAIN[1],
             "unmeshed_losses": plain_l, "unmeshed_grad_norms": plain_n,
             "floor_loss_rel": floor_l, "floor_grad_norm_rel": floor_n,
             "loss_rtol": loss_tol, "grad_norm_rtol": norm_tol,
             "per_rank": []}
    for r in ranks:
        f = r["families"]["hymba-1.5b train"]
        rel = [abs(a - b) / abs(b) for a, b in zip(f["losses"], plain_l)]
        rel_n = [abs(a - b) / abs(b) for a, b in zip(f["grad_norms"],
                                                      plain_n)]
        k5 = f["launches"].get("flash_attention_wgmma", 0)
        train["per_rank"].append({k: f[k] for k in (
            "design", "losses", "grad_norms", "step_ms", "peak_bytes",
            "k5_layouts")} | {"loss_rel": rel, "grad_norm_rel": rel_n})
        print(f"hymba-1.5b TP train rank {r['rank']} ({TP_MESH}, "
              f"{TP_HYMBA_TRAIN[0]} x {TP_HYMBA_TRAIN[1]}, design "
              f"{f['design']}): losses {f['losses']} vs unmeshed {plain_l} "
              f"(rel {rel}, bounds {loss_tol}), grad norms "
              f"{f['grad_norms']} vs {plain_n} (rel {rel_n}, bounds "
              f"{norm_tol}); bf16's floor (the unmeshed step, each gradient "
              f"over {TP_FLOOR_SLICES} row slices) {floor_l} / {floor_n}; "
              f"step ms {[round(x, 1) for x in f['step_ms']]} (gloo through "
              f"the host), peak {f['peak_bytes'] / 2**30:.2f} GiB, K5 wgmma "
              f"{k5} at {f['k5_layouts']} [{smi}]", flush=True)
        if f["design"] != TP_FAMILY_DESIGN["hymba-1.5b"] or \
                len(rel) != MESH_STEPS or not all(
                    math.isfinite(x) for x in f["losses"] + f["grad_norms"]) \
                or any(a > b for a, b in zip(rel, loss_tol)) \
                or any(a > b for a, b in zip(rel_n, norm_tol)) \
                or k5 != want_k5 or f["launches"].get("flash_attention", 0):
            fail(f"hymba-1.5b TP train rank {r['rank']}: design "
                 f"{f['design']}, losses {f['losses']} vs {plain_l} "
                 f"(rtol {loss_tol}), grad norms {f['grad_norms']} vs "
                 f"{plain_n} (rtol {norm_tol}), K5 {k5} (want {want_k5})")
    out["hymba-1.5b train"] = train
    out["k5_held"] = r0["k5_held"] | {
        f"{arch} f32": r0[arch]["k5_held_f32"] for arch in (
            "hymba-1.5b", "rwkv6-7b")}
    return out, r0["kernel_rows"]


def _sliced_steps(cfg, dev, seed: int, rows: int, seq: int,
                  slices: int) -> tuple:
    """``MESH_STEPS`` unmeshed steps of ``cfg`` from ``seed``'s weights at
    phase 12's lr on ``tokens.SyntheticCorpus(seed)`` batches of ``rows``
    x ``seq``, each batch's gradient summed over ``slices`` slices of its
    rows (1: the plain step): (losses, grad norms)."""
    import gc
    import torch
    from repro_torch.data import tokens
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.train import optim

    params = steps.init_fn(cfg)(torch.Generator(dev).manual_seed(seed), dev)
    opt = steps.opt_init(params)
    leaves = steps.train_leaves(lm.trainable(params))
    ocfg = optim.AdamWConfig(lr=TRAIN_LR, weight_decay=0.1)
    parts = steps.make_loss_parts(cfg)
    corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=rows, seed=seed))
    losses_, norms = [], []
    for s in range(MESH_STEPS):
        toks = corpus.sample_batch(s, rows)
        batch = steps.batch_on({"tokens": toks[:, :-1],
                                "labels": toks[:, 1:]}, dev)
        grads, loss_sum = None, 0.0
        for i in range(slices):
            part = {k: v[i::slices] for k, v in batch.items()}
            with torch.enable_grad():
                loss, _, _ = parts(params, part)
                g = torch.autograd.grad(loss / slices, leaves)
            loss_sum += float(loss) / slices
            grads = list(g) if grads is None else [
                a + b for a, b in zip(grads, g)]
            del g
        opt, om = optim.adamw_update(ocfg, leaves, grads, opt)
        losses_.append(loss_sum)
        norms.append(float(om["grad_norm"]))
        del grads
    del params, opt, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return losses_, norms


def bf16_order_floor(dev, seed: int, phase12: dict) -> dict:
    """Phase 12's first ``MESH_STEPS`` unmeshed gemma-2b steps (seed, lr,
    batches) with each batch's gradient summed over ``TP_FLOOR_SLICES``
    slices of its rows: the same sums in another order, so their losses
    and grad norms against phase 12's are bf16's floor for any reordering
    (the tensor-parallel step's among them)."""
    from repro_torch.configs import lm_archs
    losses_, norms = _sliced_steps(lm_archs.GEMMA_2B, dev, seed, TRAIN_BATCH,
                                   TRAIN_SEQ, TP_FLOOR_SLICES)
    out = {"slices": TP_FLOOR_SLICES, "losses": losses_, "grad_norms": norms,
           "loss_rel_diff": [abs(a - b) / abs(b) for a, b in
                             zip(losses_, phase12["losses"])],
           "grad_norm_rel_diff": [abs(a - b) / abs(b) for a, b in
                                  zip(norms, phase12["grad_norms"])]}
    return out


def tp_train_gemma(dev, smi: str, seed: int, art_dir: Path, phase12: dict,
                   mesh11: dict) -> tuple:
    """Full-width gemma-2b tensor-parallel at ``(data, model) = (1, 2)``:
    two processes of this script (``--tp-rank``) on one card, a gloo group
    between them (NCCL refuses two ranks on one device), each running
    :func:`tp_rank`.  Fails unless both exit 0, the design is ``tp``, each
    rank's losses and grad norms are within ``MESH_LOSS_RTOL`` of phase
    12's unmeshed steps (``TP_LOSS_RTOL`` and ``TP_GRAD_NORM_RTOL`` a
    step, beside bf16's floor measured first), the second loss below the
    first, K5's wgmma kernel launched ``TRAIN_K5_PER_STEP``
    times a step on each rank (TF32 never) and ``TP_PREFILL_K5`` times in
    each rank's prefill, and the prefill's logits are within
    ``DECODE_VS_PREFILL_REL`` of the unmeshed prefill's largest with the
    same argmax; then the other families on the same ranks
    (:func:`tp_families_rank`, held by :func:`check_tp_families`, hymba's
    unmeshed training steps and their floor run here first).  Returns (the
    report, rank 0's K5 kernel-line rows, the families' report)."""
    import gc
    import shutil
    import torch

    floor = bf16_order_floor(dev, seed, phase12)
    from repro_torch.configs import lm_archs
    hcfg = lm_archs.get("hymba-1.5b")
    hymba = dict(zip(("losses", "grad_norms"), _sliced_steps(
        hcfg, dev, seed, *TP_HYMBA_TRAIN, 1)))
    hymba["floor_losses"], hymba["floor_grad_norms"] = _sliced_steps(
        hcfg, dev, seed, *TP_HYMBA_TRAIN, TP_FLOOR_SLICES)
    print(f"bf16 order floor (phase 12's steps, each gradient summed over "
          f"{TP_FLOOR_SLICES} row slices): losses {floor['losses']} (rel "
          f"{floor['loss_rel_diff']}), grad norms {floor['grad_norms']} "
          f"(rel {floor['grad_norm_rel_diff']}) [{smi}]", flush=True)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tp_dir = art_dir / "tp"
    shutil.rmtree(tp_dir, ignore_errors=True)
    tp_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = []
    for r in range(TP_RANKS):
        with open(tp_dir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank",
                 str(r), "--tp-dir", str(tp_dir), "--seed", str(seed)],
                cwd=str(ROOT), stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=max(TP_TIMEOUT - (time.perf_counter() - t0), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        logs = "\n".join((tp_dir / f"rank{r}.log").read_text()[-3000:]
                         for r, _ in bad)
        fail(f"gemma-2b TP ranks {bad} (exit codes) after {wall:.0f} s:\n"
             f"{logs}")
    ranks = [torch.load(tp_dir / f"rank{r}.pt", weights_only=False)
             for r in range(TP_RANKS)]
    want = phase12["losses"][:MESH_STEPS]
    want_norms = phase12["grad_norms"][:MESH_STEPS]
    from repro_torch.configs import lm_archs
    vocab = lm_archs.GEMMA_2B.vocab      # the padded columns are -1e30
    ref = ranks[0]["unmeshed_logits"][..., :vocab]
    got = ranks[0]["logits"][..., :vocab]
    logit_diff = float((got - ref).abs().max())
    logit_scale = float(ref.abs().max())
    argmax_same = bool((got.argmax(-1) == ref.argmax(-1)).all())
    out = {"arch": "gemma-2b", "mesh": list(TP_MESH), "ranks": TP_RANKS,
           "backend": "gloo (two processes on cuda:0; collectives cross the "
                      "host)", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
           "unmeshed_losses": want, "unmeshed_grad_norms": want_norms,
           "one_rank_mesh_peak_bytes": mesh11["peak_bytes"],
           "prefill_tokens": TP_PREFILL, "prefill_max_abs_diff": logit_diff,
           "prefill_largest_logit": logit_scale,
           "prefill_argmax_same": argmax_same, "wall_s": wall,
           "bf16_order_floor": floor, "loss_rtol": list(TP_LOSS_RTOL),
           "grad_norm_rtol": list(TP_GRAD_NORM_RTOL),
           "per_rank": [{k: v for k, v in r.items() if k not in (
               "logits", "unmeshed_logits", "kernel_row")} for r in ranks]}
    for r in ranks:
        rel = [abs(a - b) / abs(b) for a, b in zip(r["losses"], want)]
        rel_n = [abs(a - b) / abs(b) for a, b in zip(r["grad_norms"],
                                                      want_norms)]
        k5 = r["launches"].get("flash_attention_wgmma", 0)
        pk5 = r["prefill_launches"].get("flash_attention_wgmma", 0)
        print(f"gemma-2b TP train rank {r['rank']} ({TP_MESH} mesh, design "
              f"{r['design']}, gloo between two processes on one card: the "
              f"collectives cross the host, so these times are no figure of "
              f"TP speed): losses {[round(x, 5) for x in r['losses']]} vs "
              f"unmeshed {[round(x, 5) for x in want]} (rel {rel}), grad "
              f"norms {r['grad_norms']} vs {want_norms} (rel {rel_n}), step "
              f"ms {[round(x, 1) for x in r['step_ms']]}, peak "
              f"{r['peak_bytes'] / 2**30:.2f} GiB a rank vs the one-rank "
              f"mesh's {mesh11['peak_bytes'] / 2**30:.2f} GiB, K5 wgmma "
              f"{k5 / MESH_STEPS:g} a step at {r['k5_layouts']}, prefill K5 "
              f"{pk5}, local shapes {r['local_shapes']} [{smi}]", flush=True)
        if r["design"] != TP_DESIGN or not all(
                math.isfinite(x) for x in r["losses"] + r["grad_norms"]) \
                or len(rel) != MESH_STEPS or len(rel_n) != MESH_STEPS \
                or not r["losses"][1] < r["losses"][0] \
                or any(a > b for a, b in zip(rel, TP_LOSS_RTOL)) \
                or any(a > b for a, b in zip(rel_n, TP_GRAD_NORM_RTOL)):
            fail(f"gemma-2b TP rank {r['rank']}: design {r['design']}, "
                 f"losses {r['losses']} vs {want} (rtol {TP_LOSS_RTOL}), "
                 f"grad norms {r['grad_norms']} vs {want_norms} (rtol "
                 f"{TP_GRAD_NORM_RTOL})")
        if k5 != TRAIN_K5_PER_STEP * MESH_STEPS or pk5 != TP_PREFILL_K5 or \
                r["launches"].get("flash_attention", 0):
            fail(f"gemma-2b TP rank {r['rank']}: K5 wgmma {k5} in "
                 f"{MESH_STEPS} steps (not {TRAIN_K5_PER_STEP} a step), "
                 f"{pk5} in the prefill (not {TP_PREFILL_K5}); TF32 "
                 f"{r['launches'].get('flash_attention', 0)}")
    print(f"gemma-2b TP prefill ({TP_PREFILL} tokens, bf16, {TP_MESH}): "
          f"logits [{list(got.shape)}] gathered from "
          f"{ranks[0]['prefill_logits_local']} a rank, max |diff| "
          f"{logit_diff:.4f} vs the unmeshed prefill's (largest "
          f"{logit_scale:.3f}), argmax same {argmax_same}; two ranks "
          f"{wall:.1f} s wall [{smi}]", flush=True)
    if not argmax_same or not logit_diff <= DECODE_VS_PREFILL_REL \
            * logit_scale:
        fail(f"gemma-2b TP prefill: max |diff| {logit_diff} vs "
             f"{DECODE_VS_PREFILL_REL} x {logit_scale}, argmax same "
             f"{argmax_same}")
    fam, rows = check_tp_families(ranks, hymba, smi)
    for r in out["per_rank"]:
        r.pop("families", None)
    return out, [ranks[0]["kernel_row"]] + rows, fam


def dist_phase(dev, smi: str, seed: int, art_dir: Path,
               phase12: dict) -> dict:
    """Slices 13, 15 and 16's main path: distribution.  Full-width
    gemma-2b through ``build_cell``'s meshed train step on a one-rank NCCL
    mesh (K5 held at its layouts) and whisper-small through ``launch.train
    --mesh 1,1``; ``compress`` on the card; gemma-2b, then mixtral-8x22b,
    dbrx-132b, hymba-1.5b, rwkv6-7b and whisper-small tensor-parallel on
    two ranks of one card (:func:`tp_train_gemma`); the dry run of a
    production cell a mesh kind.  Every process group is ended before the
    next part."""
    t0 = time.perf_counter()
    out, rows = {}, []
    out["gemma-2b"], grec, grad = mesh_train_gemma(dev, smi, seed, phase12)
    out["k5_held"] = {"gemma-2b meshed train": hold_k5_record(
        grec, "gemma-2b meshed train")}
    rows.append(k5_layout_row("gemma-2b meshed train layer",
                              "gemma-2b meshed train", grec,
                              _largest(grec, True), smi))
    out["compress"] = compress_on_card(grad, dev, smi)
    del grad
    out["whisper-small"], wrec = mesh_train_whisper(dev, smi)
    out["k5_held"]["whisper-small meshed train"] = hold_k5_record(
        wrec, "whisper-small meshed train")
    out["gemma-2b tp"], tp_rows, out["tp families"] = tp_train_gemma(
        dev, smi, seed, art_dir, phase12, out["gemma-2b"])
    out["k5_held"]["gemma-2b TP train"] = out["gemma-2b tp"]["per_rank"][0][
        "k5_held"]
    out["k5_held"].update({f"{k} TP": v for k, v in
                           out["tp families"].pop("k5_held").items()})
    rows += tp_rows
    out["dryrun"] = dryrun_cells(smi, art_dir)
    out["kernels"] = rows
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 13 (distribution and the dry run): {out['seconds']:.1f} s",
          flush=True)
    return out


AUTOTUNE_ROWS = 2048          # codes each autotuned launch runs
AUTOTUNE_REPS = 3             # timed reps a launch (after one warm-up)
AUTOTUNE_HELD_OUT = 4096      # rows the measured plans serve afterwards


def _launch_label(key) -> str:
    """``resident`` (K1) or ``streamed/c<cluster>/r<rows>/ring<units>``
    (K2's cluster plan) for a card launch of ``autotune.hopper_launch``."""
    if key[0] == "resident":
        return "resident"
    return "streamed/c{}/r{}/ring{}".format(*key[1:])


def autotune_task(task: str, kname: str, dev, smi: str, seed: int,
                  art_dir: Path) -> tuple:
    """``autotune_plan`` on the fused plan of ``task``'s phase-4 artifact:
    its launches counted (each distinct launch timed once), the measured
    plan saved, reloaded and served against ``take`` on a held-out batch,
    and ``kname`` at ``AUTOTUNE_ROWS`` rows timed beside its plain version.
    Returns (the task's report, its kernel-line row)."""
    import numpy as np
    import torch
    from repro_torch import backends, pipeline
    from repro_torch.kernels import autotune, build, lut_cascade

    fused = backends.get("fused")
    net = pipeline.CompiledLUTNetwork.load(
        str(art_dir / f"{task}_fused.npz"), device=dev)
    plan = net.compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    isz = plan.buffers["tables"].dtype.itemsize
    grid = autotune.measurement_grid(
        layers, table_itemsize=isz, table_dtype=plan.meta["table_dtype"],
        device=dev)
    keys = [autotune.hopper_launch(t, layers, isz) for t in grid]
    distinct = list(dict.fromkeys(keys))
    runs = AUTOTUNE_REPS + 1
    expect = {"lut_cascade_resident": runs * distinct.count(("resident",)),
              "lut_cascade_streamed": runs * sum(k[0] == "streamed"
                                                 for k in distinct),
              "lut_lookup": 0}
    build.reset_counters()
    t0 = time.perf_counter()
    tuned = fused.autotune_plan(plan, rows=AUTOTUNE_ROWS, reps=AUTOTUNE_REPS,
                                seed=seed, device=dev)
    tune_s = time.perf_counter() - t0
    launches = lut_launches()
    if launches != expect or not launches[kname]:
        fail(f"autotune {task}: launches {launches}, expected {expect} "
             f"({len(distinct)} distinct launches of {len(grid)} candidates)")
    report = tuned.meta["tuning_report"]
    won = autotune.KernelTuning.from_meta(tuned.meta["tuning"])
    best = {}
    for row, key in zip(report, keys):
        if best.setdefault(_launch_label(key), row["best_s"]) != row["best_s"]:
            fail(f"autotune {task}: candidates of launch {key} report "
                 "different times")
    won_label = _launch_label(autotune.hopper_launch(won, layers, isz))
    if (won.source != "measured" or len(report) != len(grid)
            or best[won_label] != min(best.values())):
        fail(f"autotune {task}: winner {won} is not the fastest launch of "
             f"{best} ({len(report)} report rows, {len(grid)} candidates)")
    print(f"autotune {task}: best_s per launch {best}, winner {won_label} "
          f"({won.to_meta()}), {len(grid)} candidates, tuned in "
          f"{tune_s:.2f} s [{smi}]", flush=True)

    # the measured plan through save and load, served against take
    net._plans["fused"] = tuned
    path = net.save(str(art_dir / f"{task}_autotuned.npz"))
    loaded = pipeline.CompiledLUTNetwork.load(path, device=dev)
    lmeta = loaded._plans["fused"].meta
    if (lmeta["tuning"] != tuned.meta["tuning"]
            or lmeta["tuning_report"] != report
            or lmeta["tuning"]["source"] != "measured"):
        fail(f"autotune {task}: the measured tuning did not survive "
             f"save/load: {lmeta.get('tuning')}")
    rs = np.random.RandomState(seed + 14)
    xs = rs.uniform(-1.0, 1.0, (AUTOTUNE_HELD_OUT, loaded.cfg.in_features)
                    ).astype(np.float32)
    build.reset_counters()
    got = loaded.predict_codes(xs, backend="fused")
    torch.cuda.synchronize()
    served = lut_launches()
    want = loaded.predict_codes(xs, backend="take")
    mismatched = int((got != want).any(dim=1).sum())
    won_kernel = ("lut_cascade_resident" if won_label == "resident"
                  else "lut_cascade_streamed")
    if mismatched or not served[won_kernel]:
        fail(f"autotune {task}: the measured plan disagrees with take on "
             f"{mismatched} of {AUTOTUNE_HELD_OUT} rows (launches {served})")

    # kname at the tuner's codes, against its plain version
    tables = plan.tensor("tables", dev)
    maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    ops = lut_cascade.prepare(tables, layers, maps)
    codes = torch.from_numpy(np.random.RandomState(seed).randint(
        0, int(plan.meta["input_span"]),
        size=(AUTOTUNE_ROWS, layers[0][0])).astype(np.int32)).to(dev)
    if kname == "lut_cascade_resident":
        kern = lambda: lut_cascade.lut_cascade_resident(  # noqa: E731
            codes, ops)
        sub = "cascade_resident_kernel"
    else:
        ut = won.unit_tile
        kern = lambda: lut_cascade.lut_cascade_streamed(  # noqa: E731
            codes, ops, unit_tile=ut)
        sub = "cascade_streamed_kernel"
    plain = lambda: lut_cascade.lut_cascade_plain(  # noqa: E731
        codes, tables, maps, layers)
    k_out = kern()
    torch.cuda.synchronize()
    err = int((k_out - plain()).abs().max())
    if err:
        fail(f"autotune {task}: {kname} disagrees with its plain version "
             f"by {err}")
    byts, n_ops = cascade_work(layers, AUTOTUNE_ROWS,
                               tables.numel() * tables.element_size(),
                               ops.map_words * 4)
    bound_ms, bound_by = bound(byts, n_ops)
    ms, plain_ms = per_call_ms(kern), per_call_ms(plain)
    device_ms = traced_ms(kern, sub)
    row = {"name": kname, "path": f"{task} autotune", "task": task,
           "batch": AUTOTUNE_ROWS, "launches": launches[kname],
           "max_abs_err": err, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "route": "cuda", "source": SOURCES[kname],
           "replaces": REPLACES[kname]}
    print(f"time {kname} ({task} autotune, batch {AUTOTUNE_ROWS}): kernel "
          f"{ms:.4f} ms (device {device_ms} ms), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.5f} ms ({bound_by}) [{smi}]", flush=True)
    return {"candidates": len(grid), "distinct_launches": len(distinct),
            "launches": launches, "best_s": best, "winner": won.to_meta(),
            "tune_s": tune_s, "held_out_rows": AUTOTUNE_HELD_OUT,
            "served_launches": served, "artifact": path}, row


def autotune_phase(dev, smi: str, seed: int, art_dir: Path) -> dict:
    """Slice 14's main path: ``FusedCascadeBackend.autotune_plan`` on the
    ``nid`` (K1) and ``mnist`` (K2) fused plans of phase 4's artifacts at
    ``AUTOTUNE_ROWS`` rows, with the launches of each run counted."""
    t0 = time.perf_counter()
    out, rows = {}, []
    for task, kname in (("nid", "lut_cascade_resident"),
                        ("mnist", "lut_cascade_streamed")):
        out[task], row = autotune_task(task, kname, dev, smi, seed, art_dir)
        rows.append(row)
    out["kernels"] = rows
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 14 (autotune): {out['seconds']:.1f} s", flush=True)
    return out


PAPER_REFERENCE = ROOT / "experiments" / "TORCH_paper_tables_reference.json"
PAPER_SEED = 0               # the seed the reference trains Table IV at


def _k4_work(kind, args) -> tuple:
    """(route, shape, plain fn, kernel fn, library fn, bytes, flops,
    launches a call) of one recorded K4 call: the forward routes against
    one ``torch.baddbmm`` (shared rows broadcast over the units), the
    dense gradient against one ``einsum``."""
    import torch
    from repro_torch.kernels import subnet_mlp
    if kind[0] == "affine":
        x, w, b = args
        act = kind[1]
        route = f"unit_affine_{subnet_mlp.route(x)}"
        bsz, (u, din, dout) = x.shape[0], w.shape
        xb = x if x.dim() == 3 else x[:, None, :].expand(bsz, u, din)
        bias = b if b is not None else torch.zeros(
            (u, dout), dtype=w.dtype, device=w.device)
        x_elems = bsz * din if route == "unit_affine_dense" else xb.numel()
        byts = (x_elems + w.numel() + (0 if b is None else b.numel())
                + bsz * u * dout) * x.element_size()
        return (route, [bsz, u, din, dout],
                lambda: subnet_mlp.unit_affine_plain(x, w, b, activate=act),
                lambda: subnet_mlp.unit_affine_cuda(x, w, b, activate=act),
                lambda: torch.baddbmm(bias[:, None, :], xb.transpose(0, 1),
                                      w),
                byts, 2 * bsz * u * din * dout, 1)
    dy, w = args
    bsz, u, dout = dy.shape
    din = w.shape[1]
    return ("unit_affine_dx", [bsz, u, din, dout],
            lambda: subnet_mlp.unit_affine_dx_plain(dy, w),
            lambda: subnet_mlp.unit_affine_dx_cuda(dy, w),
            lambda: torch.einsum("bun,ukn->bk", dy, w),
            (dy.numel() + w.numel() + bsz * din) * dy.element_size(),
            2 * bsz * u * din * dout, 2)


def paper_k4_rows(models: list, smi: str) -> list:
    """Kernel-line rows of Table IV's K4 layouts: for each model its
    largest per-unit layout at the training batch, and for
    ``neuralut_assemble`` its largest dense and dense-gradient layouts,
    each timed beside its plain version,
    its bound and its library call; ``launches`` is the model's count of
    that route over its training and fold."""
    import torch
    picks = []
    for m in models:
        by_route: dict = {}
        for kind, args, _ in m["calls"].values():
            work = _k4_work(kind, args)
            if work[0] != "unit_affine_units" and \
                    m["model"] != "neuralut_assemble":
                continue
            # a training step's layout (the batch of 256) before the
            # evaluations' larger ones
            rank = (work[1][0] == 256, work[6])
            if work[0] not in by_route or rank > by_route[work[0]][0]:
                by_route[work[0]] = (rank, work)
        picks += [(m, by_route[r][1]) for r in K4_ROUTES[1:]
                  if r in by_route]
    rows = []
    for m, (route, shape, plain, kern, lib, byts, flops, per) in picks:
        torch.cuda.synchronize()
        err = float((kern() - plain()).abs().max())
        bound_ms, bound_by = bound(byts, flops, F32_FLOPS_PER_S)
        lib_dev, lib_kernels = traced_all_ms(lib)
        row = {"name": route, "path": "paper tables/table4",
               "task": f"{m['model']} {route[12:]} {shape}",
               "batch": shape[0], "shape": shape,
               "launches": m["k4"].get(route, 0), "max_abs_err": err,
               "ms": per_call_ms(kern, calls=20),
               "device_ms": traced_ms(kern, K4_KERNELS[route], 10, per),
               "plain_ms": per_call_ms(plain, calls=10),
               "library_ms": per_call_ms(lib, calls=20),
               "library_device_ms": lib_dev, "library_kernels": lib_kernels,
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        print(f"time {route} (table4 {row['task']}): kernel {row['ms']:.4f}"
              f" ms (device {row['device_ms']} ms), plain "
              f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
              f"ms (device {lib_dev} ms), bound {bound_ms:.6f} ms "
              f"({bound_by}), {row['launches']} launches, max |diff| {err}"
              f" [{smi}]", flush=True)
    return rows


def paper_tables_phase(dev, smi: str, seed: int) -> dict:
    """Slice 17's main path: the paper's Table IV through
    ``benchmarks/torch_paper_tables.py`` on the card at the reference's
    budget (four trainings on ``nid``: NeuraLUT-Assemble's full flow and
    the LogicNets-, NeuraLUT- and PolyLUT-style baselines on random
    mappings, K4's dense, per-unit and dense-gradient routes, the PolyLUT
    monomials feeding K4).  Every folded artifact is served through
    ``LUTEngine`` on ``fused`` (K1 once a block) and ``pallas`` (K3 once a
    layer a block) against ``take`` and a CPU load, its served accuracy
    equal to the folded one, every fold exact.  The ``hwcost`` columns of
    Table IV, Table III and Fig. 2 must equal the reference's record
    (``experiments/TORCH_paper_tables_reference.json``, read as JSON).
    Every K4 layout the trainings launched is kept by a
    :class:`K4Recorder` and held by :func:`hold_k4_record`."""
    import types
    import numpy as np
    import torch
    from repro_torch.kernels import build

    sys.path.insert(0, str(ROOT))
    from benchmarks import torch_paper_tables as pt

    if not PAPER_REFERENCE.exists():
        fail(f"paper tables: no reference record at {PAPER_REFERENCE}")
    ref = json.loads(PAPER_REFERENCE.read_text())
    t0 = time.perf_counter()
    for table, rows in (("table3", pt.table3()),
                        ("fig2", pt.fig2_assembly_scaling())):
        if rows != ref[table]["rows"]:
            fail(f"paper {table}: {rows} != the reference's "
                 f"{ref[table]['rows']}")
    models, served_nets = [], []
    torch.cuda.synchronize()
    build.reset_counters()
    with K4Recorder() as rec:
        def serve(net, data, folded_acc):
            # this model's training and fold launched everything counted
            # since the last reset; serving counts its own launches
            torch.cuda.synchronize()
            models.append({"k4": {k: v for k, v in
                                  build.launch_counts().items()
                                  if k.startswith("unit_affine")},
                           "calls": rec.calls})
            rec.calls = {}
            out = pt.serve_folded(net, data, folded_acc)
            served_nets.append(net)
            build.reset_counters()
            return out

        t_train = time.perf_counter()
        rows = pt.table4(PAPER_SEED, device=dev, serve=serve)
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t_train
    want = {r["model"]: r for r in ref["table4"]["per_seed"][
        str(PAPER_SEED)]}
    k4 = {k: sum(m["k4"].get(k, 0) for m in models) for k in K4_ROUTES}
    lut = {k: sum(r["served"][b]["launches"][k] for r in rows
                  for b in ("fused", "pallas")) for k in LUT_KERNELS}
    for r, m in zip(rows, models):
        m["model"] = r["model"]
        s = r["served"]
        if not (r["fold_exact"] and s["ok"]):
            fail(f"paper table4 {r['model']}: fold exact {r['fold_exact']}"
                 f", served {s}")
        for c in pt.HWCOST_COLS["table4"]:
            if r[c] != want[r["model"]][c]:
                fail(f"paper table4 {r['model']}: {c} {r[c]} != the "
                     f"reference's {want[r['model']][c]}")
        if m["k4"].get("unit_affine_reference", 0) or \
                not m["k4"].get("unit_affine_units", 0):
            fail(f"paper table4 {r['model']}: K4 launches {m['k4']}")
    if not all(k4[k] for k in K4_ROUTES[1:]):
        fail(f"paper table4: K4 launches by route {k4}")
    t_hold = time.perf_counter()
    held = {}
    for m in models:
        held[m["model"]] = hold_k4_record(
            types.SimpleNamespace(calls=m["calls"]),
            f"paper table4 {m['model']}")
    t_hold = time.perf_counter() - t_hold
    if sorted(held["neuralut_assemble"]) != sorted(K4_ROUTES[1:]):
        fail(f"paper table4: recorded K4 routes {held}")
    # K1 and K3 at a block of the Assemble artifact (its fused plan is K1)
    ours = next(r for r in rows if r["model"] == "neuralut_assemble")
    if ours["served"]["fused"]["kernel"] != "lut_cascade_resident":
        fail(f"paper table4: the Assemble artifact's fused kernel is "
             f"{ours['served']['fused']['kernel']}")
    lut_rows = stream_kernels(
        types.SimpleNamespace(net=served_nets[rows.index(ours)]),
        np.random.RandomState(seed + 15), dev, smi, b=pt.SERVE_BLOCK,
        path="paper tables/table4", task="nid Assemble artifact (table4)")
    for k in lut_rows:
        k["launches"] = lut[k["name"]]
    k4_rows = paper_k4_rows(models, smi)
    for m in models:
        del m["calls"]
    out = {"seed": PAPER_SEED, "train_s": t_train, "k4_hold_s": t_hold,
           "k4_launches": k4, "lut_launches": lut, "k4_held": held,
           "per_model_k4": {m["model"]: m["k4"] for m in models},
           "rows": [{k: v for k, v in r.items() if k != "served"}
                    for r in rows],
           "served": {r["model"]: r["served"] for r in rows},
           "kernels": [dict(k, route="cuda", source=SOURCES[k["name"]],
                            replaces=REPLACES[k["name"]])
                       for k in lut_rows + k4_rows]}
    out["seconds"] = time.perf_counter() - t0
    print(f"paper table4 on the card (seed {PAPER_SEED}, {pt.STEPS} steps):"
          f" {t_train:.1f} s; K4 launches {k4}; every layout held "
          f"({t_hold:.1f} s); served K1/K2/K3 {lut} [{smi}]", flush=True)
    for r in out["rows"]:
        print(f"  {r['model']}: acc {r['acc']}, folded {r['folded_acc']}, "
              f"LUTs {r['luts']}, ADP {r['area_delay']} "
              f"(x{r['area_delay_vs_ours']}); hwcost == reference, "
              f"fused/pallas == take == CPU load", flush=True)
    print(f"phase 15 (the paper's tables): {out['seconds']:.1f} s",
          flush=True)
    return out


# the gate's suites over the records phase 16 writes; the kernel suite's
# one violation (fused not fastest) is a timing contract, reported and not
# failed on (host clocks move between calls)
BENCH_SUITES = ("throughput", "kernel", "stream")
TIMING_SUITES = ("kernel",)


def _bench_launch_rule(bk_res: dict, tp_res: dict, st_res: dict) -> list:
    """Launches off the rule: ``fused`` one K1 launch a call on a reduced
    task (its tables are resident) and one a slot on a mesh, ``pallas``
    one K3 launch a layer, the other backends none; a stream block one K1
    launch (``fused``) or one K3 launch a cell layer (``pallas``)."""
    k1, k3 = "lut_cascade_resident", "lut_lookup"
    bad = []
    for task, t in bk_res["tasks"].items():
        n_layers = len(t["config"]["layers"])
        want = {"fused": {k1: 1.0}, "pallas": {k3: float(n_layers)}}
        for c in t["cells"]:
            for name, got in c["launches_per_call"].items():
                if got != want.get(name, {}):
                    bad.append(f"backends {task} batch {c['batch']} {name}:"
                               f" {got} a call")
    for c in tp_res["kernel"]:
        if c["launches_per_chunk"] != ({k1: 1.0} if c["backend"] == "fused"
                                       else {}):
            bad.append(f"kernel sweep {c['backend']} block {c['block']}: "
                       f"{c['launches_per_chunk']} a chunk")
    for c in tp_res["mesh"]:
        if c["launches_per_call"] != ({k1: c["slots"]}
                                      if c["backend"] == "fused" else {}):
            bad.append(f"mesh {c['backend']} x{c['slots']}: "
                       f"{c['launches_per_call']} a call")
    for p in st_res["scaling"]:
        want = 1.0 if p["backend"] == "fused" else float(st_res["cell"][
            "layers"])
        if p["kernel_launches_per_block"] != want:
            bad.append(f"stream scale {p['streams']} {p['backend']}: "
                       f"{p['kernel_launches_per_block']} a block")
    return bad


def _roofline_gpu_rows(rl, out: Path, dev, seed: int) -> dict:
    """``torch_roofline --lut``'s ``gpu`` rows against ``hopper_mode`` and
    against the mode the card's own plan of each task stamps."""
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.kernels import autotune
    doc = json.loads(Path(rl.write_lut_choices(str(out))).read_text())
    modes = {}
    for c in doc["choices"]:
        if c["device"] != "gpu":
            continue
        task = c["task"]
        hopper = autotune.hopper_mode(rl.task_layers(task),
                                      c["table_itemsize"])
        cfg = paper_tasks.task_config(task)
        net = pipeline.CompiledLUTNetwork(cfg, *random_network(cfg, seed),
                                          device=dev)
        planned = net.compile_backend("fused").plan.meta["tuning"]["mode"]
        if not c["tuning"]["mode"] == hopper == planned:
            fail(f"roofline --lut {task}: gpu row {c['tuning']['mode']}, "
                 f"hopper_mode {hopper}, the card's plan {planned}")
        modes[task] = planned
    return modes


def benches_phase(dev, smi: str, seed: int, art_dir: Path) -> dict:
    """Slice 18's main path: the serving benches at their smoke sizes on
    the card, through their own functions (``benchmarks/torch_lut_backends
    .py``, ``torch_lut_throughput.py`` with its 1, 2 and 4 slot cells,
    ``torch_stream_serving.py`` with both stateful hot swaps), the records
    written as the benches write them and read back through the gate's
    extractors (``torch_check_regression.py``): any contract violation,
    bit mismatch or launch count off the rule fails; the drift against the
    committed baselines and the timing contracts are reported.  Then
    ``torch_roofline --lut``'s ``gpu`` rows against the card's plans, and
    K1 and K3 at the throughput bench's layout (``nid_reduced``, a block
    of 256) against their plain versions."""
    import types
    import numpy as np
    import torch
    from repro_torch.kernels import build

    sys.path.insert(0, str(ROOT / "benchmarks"))
    import torch_check_regression as cr
    import torch_lut_backends as bk
    import torch_lut_throughput as tp
    import torch_roofline as rl
    import torch_stream_serving as st

    out_dir = art_dir / "benches"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    params, cell = st.make_cell(seed, dev)
    torch.cuda.synchronize()
    build.reset_counters()
    bk_res = bk.sweep(**bk.FAST_KW, seed=seed, device=dev)
    tp_res = tp.sweep(**tp.FAST_KW, seed=seed, device=dev)
    st_res = st.sweep(cell, params, dev, seed=seed, **st.FAST_KW)
    torch.cuda.synchronize()
    counts = {k: v for k, v in build.launch_counts().items() if v}
    for kname in ("lut_cascade_resident", "lut_lookup"):
        if not counts.get(kname):
            fail(f"benches: {kname} was not launched ({counts})")
    bk.write_results(bk_res, str(out_dir / cr.BACKENDS))
    tp.write_results(tp_res, str(out_dir / cr.THROUGHPUT))
    (out_dir / cr.STREAM).write_text(json.dumps(st_res, indent=1))
    bad = bk.violations(bk_res) + [
        e for e in tp.exits(tp_res, fast=True) if "bit-identical" in e]
    bad += _bench_launch_rule(bk_res, tp_res, st_res)
    gate = {}
    for name in BENCH_SUITES:
        suite = cr.SUITES[name]
        metrics, violations = suite.extract(str(out_dir))
        if name not in TIMING_SUITES:
            bad += violations
        base = (json.loads(Path(suite.baseline).read_text())
                if Path(suite.baseline).exists() else {"metrics": {}})
        reg, missing, improved = cr.compare(base, metrics, suite.tolerance,
                                            suite.mode)
        gate[name] = {"metrics": len(metrics), "violations": violations,
                      "regressions": reg, "improved": improved,
                      "compared": len(base["metrics"]) - len(missing)}
        print(f"gate {name} on this run's smoke records: {len(metrics)} "
              f"metrics, violations {violations}; against "
              f"{Path(suite.baseline).name} ({gate[name]['compared']} shared"
              f" metrics, tol {suite.tolerance}): regressions {reg}, "
              f"improved {improved} (reported only)", flush=True)
    if bad:
        fail("benches: " + "; ".join(map(str, bad)))
    timing = {"fused_fastest": {c["block"]: c["fused_fastest"]
                                for c in tp_res["kernel"]
                                if c["backend"] == "fused"},
              "fused_margin": {c["block"]: c["fused_margin"]
                               for c in tp_res["kernel"]
                               if c["backend"] == "fused"},
              "async_speedup": {f"{c['backend']}@{c['block']}":
                                c["async_speedup"] for c in tp_res["engine"]}}
    print(f"benches timing contracts (reported only): {timing} [{smi}]",
          flush=True)
    modes = _roofline_gpu_rows(rl, out_dir / "TORCH_AUTOTUNE_choices.json",
                               dev, seed)
    net = bk.make_network("nid", seed, dev)
    rows = stream_kernels(
        types.SimpleNamespace(net=net), np.random.RandomState(seed + 16),
        dev, smi, b=256, path="benches/lut_throughput",
        task="nid_reduced (torch_lut_throughput)")
    for k in rows:
        k["launches"] = counts.get(k["name"], 0)
    out = {"launches": counts, "gate": gate, "timing": timing,
           "roofline_gpu_modes": modes,
           "hot_swap": st_res["hot_swap"],
           "slots": [{key: c[key] for key in (
               "backend", "slots", "physical_devices", "rows_per_s",
               "bit_identical")} for c in tp_res["mesh"]],
           "backends_us": {t: v["cells"][0]["us"]
                           for t, v in bk_res["tasks"].items()},
           "kernels": [dict(k, route="cuda", source=SOURCES[k["name"]],
                            replaces=REPLACES[k["name"]]) for k in rows]}
    out["seconds"] = time.perf_counter() - t0
    swaps = [(m, h["state_migration"], h["wrong"], h["dropped"])
             for m, h in st_res["hot_swap"].items()]
    print(f"benches: backends, throughput (slots 1, 2, 4 of {dev}) and "
          f"stream hot swaps (mode, migration, wrong, dropped) {swaps} "
          f"bit-identical and on the launch rule, launches {counts}; "
          f"roofline gpu modes == the card's plans {modes} [{smi}]",
          flush=True)
    print(f"phase 16 (the serving benches): {out['seconds']:.1f} s",
          flush=True)
    return out


def main(seed: int) -> dict:
    """Run every phase; return the report (exits on the first failure)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a GPU")
    try:
        from repro_torch import pipeline
        from repro_torch.configs import paper_tasks
        from repro_torch.kernels import (build, flash_attention, lut_cascade,
                                         lut_gather, subnet_mlp)
        from repro_torch.serve.lut_engine import LUTEngine
    except ImportError as e:
        fail(f"the port's package is not importable next to this script: {e}")

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    print(f"device: {name}", flush=True)
    print(smi, flush=True)
    report = {"device": name, "nvidia_smi": smi, "seed": seed}

    # -- phase 2: build ------------------------------------------------------
    try:
        built = build.build()
        for src in built:
            build.library(src)
    except RuntimeError as e:
        fail(f"kernel build: {e}")
    report["build_s"] = {}
    for src, (lib_path, build_s, ptxas) in built.items():
        print(f"build: {build_s:.1f} s -> {lib_path.name}", flush=True)
        for line in ptxas.splitlines():
            if "Used" in line or "Compiling entry" in line:
                print("  ptxas " + line.split("ptxas info    :")[-1].strip())
        report["build_s"][src] = build_s

    # networks from the paper's Table II, random weights
    nets = {}
    for task in ("mnist", "jsc_cernbox", "jsc_openml", "nid"):
        cfg = paper_tasks.task_config(task)
        tables, maps, ils, ols = random_network(cfg, seed)
        net = pipeline.CompiledLUTNetwork(cfg, tables, maps, ils, ols,
                                          device=dev)
        nets[task] = net
    rs = np.random.RandomState(seed + 1)

    # -- phase 3: each kernel against its plain version ----------------------
    errs = {k: 0 for k in REPLACES if k.startswith("lut_")}
    t3 = time.perf_counter()
    # K3 on mnist's and nid's layers; a few addresses outside [0, T), which
    # the kernel clamps (as a JAX gather does)
    for task in ("mnist", "nid"):
        lplan = nets[task].compile_backend("pallas").plan
        for l in range(len(lplan.meta["layers"])):
            table = lplan.tensor(f"table_{l}", dev)
            t = table.shape[1]
            for b in (1, 257, 1023, 4096):
                addr = torch.from_numpy(rs.randint(
                    -2, t + 2, size=(b, table.shape[0])).astype(np.int32)
                ).to(dev)
                got = lut_gather.lut_lookup_cuda(table, addr)
                torch.cuda.synchronize()
                want = lut_gather.lut_lookup_plain(table, addr.clamp(0, t - 1))
                errs["lut_lookup"] = max(errs["lut_lookup"], int(
                    (got - want).abs().max()))
    checks = [("lut_cascade_resident", t, None) for t in ("nid", "jsc_openml")]
    checks += [("lut_cascade_streamed", t, ut)
               for t in ("mnist", "jsc_cernbox") for ut in (8, 16, 32)]
    for kname, task, ut in checks:
        plan = nets[task].compile_backend("fused").plan
        layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
        tables = plan.tensor("tables", dev)
        maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
                else None for l in range(len(layers))]
        ops = lut_cascade.prepare(tables, layers, maps)
        span = 2 ** layers[0][5]
        # K1 also at 3 and 1023 rows: ragged last tiles of its plan
        for b in ((1, 3, 33, 257, 1023, 4096) if ut is None
                  else (1, 33, 257, 4096)):
            codes = torch.from_numpy(rs.randint(
                0, span, size=(b, layers[0][0])).astype(np.int32)).to(dev)
            if ut is None:
                got = lut_cascade.lut_cascade_resident(codes, ops)
            else:
                got = lut_cascade.lut_cascade_streamed(codes, ops,
                                                       unit_tile=ut)
            torch.cuda.synchronize()
            want = lut_cascade.lut_cascade_plain(codes, tables, maps, layers)
            errs[kname] = max(errs[kname], int((got - want).abs().max()))
    print(f"kernels vs plain versions: max |diff| {errs} "
          f"({time.perf_counter() - t3:.1f} s)", flush=True)
    if any(errs.values()):
        fail(f"a kernel disagrees with its plain version: {errs}")
    errs.update(check_unit_affine(dev))
    k5_errs = check_flash_attention(dev)
    errs["flash_attention"] = k5_errs["flash_attention"]
    errs["flash_attention_wgmma"] = k5_errs["flash_attention_wgmma"]
    report["k5_single_p"] = k5_errs["single_p"]

    # -- phase 4: serve from a reloaded artifact through LUTEngine ----------
    art_dir = ROOT / "build" / "chip_smoke"
    art_dir.mkdir(parents=True, exist_ok=True)
    serving = {}
    runs = (("mnist", "fused", "lut_cascade_streamed"),
            ("nid", "fused", "lut_cascade_resident"),
            ("nid", "pallas", "lut_lookup"))
    for task, backend, kname in runs:
        src = nets[task]
        src.compile_backend(backend)
        path = src.save(str(art_dir / f"{task}_{backend}.npz"))
        xs = rs.uniform(-1.0, 1.0, (8192, src.cfg.in_features)
                        ).astype(np.float32)
        serving[f"{task}/{backend}"] = serve_artifact(
            path, backend, kname, xs, dev, smi, f"{task}/{backend}")
    report["serving"] = serving

    # -- phase 6: the toolflow (slice 2) -------------------------------------
    report["toolflow_mnist"] = train_mnist(dev, smi, art_dir)
    report["step_card_vs_cpu"] = step_card_vs_cpu(dev)
    report["nid_reduced"] = train_nid(dev, smi)

    # -- phase 7: LM serving (slice 3) ---------------------------------------
    report["serve_gemma"] = serve_gemma(dev, smi, seed)

    # -- phase 5: kernel times at the main path's shapes (block 1024) -------
    # Each kernel's numbers count one launch at the main path's shapes: K1
    # and K2 one launch a block of 1024 rows; K3 one layer's launch (nid's
    # block runs 5, one a layer), as the mean of the 5 layers, with each
    # layer's time and the block's totals beside it.  "ms" is CUDA events
    # around 40 back-to-back calls, which is host time when the Python
    # wrapper takes longer than the kernel; device_ms is the kernels' own
    # time in the profiler's CUDA trace, library_device_ms that of every
    # kernel the library call launches.  K1 on jsc_openml (int16 tables,
    # 81 KB a CTA) is timed too and reported beside nid's row.
    kernels = []
    b = 1024
    substr = {"lut_cascade_streamed": "cascade_streamed_kernel",
              "lut_cascade_resident": "cascade_resident_kernel",
              "lut_lookup": "lut_lookup_kernel"}
    for kname, task in (("lut_cascade_streamed", "mnist"),
                        ("lut_cascade_resident", "nid"),
                        ("lut_cascade_resident", "jsc_openml")):
        plan = nets[task].compile_backend("fused").plan
        layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
        tables = plan.tensor("tables", dev)
        maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
                else None for l in range(len(layers))]
        ops = lut_cascade.prepare(tables, layers, maps)
        codes = torch.from_numpy(rs.randint(
            0, 2 ** layers[0][5], size=(b, layers[0][0])).astype(np.int32)
        ).to(dev)
        # each lambda binds this iteration's operands (a late-bound
        # closure would time K2 on nid's operands, the loop's last)
        if kname == "lut_cascade_streamed":
            ut = plan.meta["tuning"]["unit_tile"]
            kern = lambda c=codes, o=ops, u=ut: (  # noqa: E731
                lut_cascade.lut_cascade_streamed(c, o, unit_tile=u))
            report["k2_plan"] = k2_plan(ops, ut, b)
        else:
            kern = lambda c=codes, o=ops: (  # noqa: E731
                lut_cascade.lut_cascade_resident(c, o))
            report[f"k1_plan_{task}"] = k1_plan(ops, b)
        plain = lambda c=codes, t=tables, m=maps, l=layers: (  # noqa: E731
            lut_cascade.lut_cascade_plain(c, t, m, l))
        byts, n_ops = cascade_work(layers, b, tables.numel()
                                   * tables.element_size(),
                                   ops.map_words * 4)
        kernels.append({"name": kname, "task": task, "batch": b,
                        "kernel": kern, "plain": plain, "library": None,
                        "bytes": byts, "ops": n_ops,
                        "side": task == "jsc_openml"})
    plan = nets["nid"].compile_backend("pallas").plan
    shapes = []
    for l in range(len(plan.meta["layers"])):
        table = plan.tensor(f"table_{l}", dev)
        addr = torch.from_numpy(rs.randint(
            0, table.shape[1], size=(b, table.shape[0])).astype(np.int32)
        ).to(dev)
        shapes.append((table, addr))
    kernels.append({
        "name": "lut_lookup", "task": "nid, mean of its 5 layers", "batch": b,
        "per_launch": len(shapes),
        "kernel": lambda: [lut_gather.lut_lookup_cuda(t, a)
                           for t, a in shapes],
        "plain": lambda: [lut_gather.lut_lookup_plain(t, a)
                          for t, a in shapes],
        "library": lambda: [torch.gather(t, 1, a.t().long()).t()
                            for t, a in shapes],
        "bytes": sum(a.numel() * 8 + t.numel() * 4 for t, a in shapes),
        "ops": 0})
    # K4 at the toolflow's shapes, TF32 off.  Bytes: every input read once,
    # the output written once; operations: one FMA (2 flops) per product at
    # the non-tensor f32 rate, the only unit that keeps the kernels' numbers.
    # The dense route on dense layer 0 of mnist: shared rows x [256, 784]
    # for 2160 units, w [2160, 784, 64]; yardstick one baddbmm on [U, B, din]
    # (x broadcast); K4's first kernel (the reference) timed beside it.
    torch.backends.cuda.matmul.allow_tf32 = False
    kb, ku, kdin, kdout = 256, 2160, 784, 64
    gen4 = torch.Generator().manual_seed(seed)
    x4, w4, b4 = k4_inputs(kb, ku, kdin, kdout, True, gen4, dev)
    r4 = x4[:, 0, :]
    substr.update(K4_KERNELS)
    substr["reference"] = "unit_affine_reference_kernel"
    kernels.append({
        "name": "unit_affine_dense", "task": "mnist dense layer 0",
        "batch": kb, "calls": 10,
        "kernel": lambda: subnet_mlp.unit_affine_cuda(r4, w4, b4),
        "plain": lambda: subnet_mlp.unit_affine_plain(r4, w4, b4),
        "library": lambda: torch.baddbmm(b4[:, None, :], x4.transpose(0, 1),
                                         w4),
        "reference": lambda: subnet_mlp.unit_affine_reference_cuda(
            r4, w4, b4),
        "bytes": (kb * kdin + ku * kdin * kdout + ku * kdout
                  + kb * ku * kdout) * 4,
        "ops": 2 * kb * ku * kdin * kdout, "ops_per_s": F32_FLOPS_PER_S})
    # The dense gradient on the same layer: dy [256, 2160, 64] -> dx
    # [256, 784]; yardstick one einsum "bun,ukn->bk" (also the plain
    # version).  The f32 scratch of partials is not in the bound.  A call
    # launches two kernels (partials, then their sum), both in its time.
    dy4 = torch.randn((kb, ku, kdout), generator=gen4).to(dev)
    kernels.append({
        "name": "unit_affine_dx", "task": "mnist dense layer 0, dx",
        "batch": kb, "calls": 10, "traced_per_call": 2,
        "kernel": lambda: subnet_mlp.unit_affine_dx_cuda(dy4, w4),
        "plain": lambda: subnet_mlp.unit_affine_dx_plain(dy4, w4),
        "library": lambda: torch.einsum("bun,ukn->bk", dy4, w4),
        "bytes": (kb * ku * kdout + ku * kdin * kdout + kb * kdin) * 4,
        "ops": 2 * kb * ku * kdin * kdout, "ops_per_s": F32_FLOPS_PER_S})
    # The per-unit route on the sparse first affine: x [256, 2160, 6] ->
    # [256, 2160, 64] with the fused ReLU; yardstick one baddbmm (no ReLU).
    # Bound by writing y (141.6 MB).
    sdin = 6
    xs4, ws4, bs4 = k4_inputs(kb, ku, sdin, kdout, False, gen4, dev)
    kernels.append({
        "name": "unit_affine_units", "task": "mnist sparse first affine",
        "batch": kb,
        "kernel": lambda: subnet_mlp.unit_affine_cuda(xs4, ws4, bs4,
                                                      activate=True),
        "plain": lambda: subnet_mlp.unit_affine_plain(xs4, ws4, bs4,
                                                      activate=True),
        "library": lambda: torch.baddbmm(bs4[:, None, :],
                                         xs4.transpose(0, 1), ws4),
        "reference": lambda: subnet_mlp.unit_affine_reference_cuda(
            xs4, ws4, bs4, activate=True),
        "bytes": (kb * ku * sdin + ku * sdin * kdout + ku * kdout
                  + kb * ku * kdout) * 4,
        "ops": 2 * kb * ku * sdin * kdout, "ops_per_s": F32_FLOPS_PER_S})
    # K5 on one layer of gemma-2b's 1024-token prefill, causal, q in the
    # layout _project_qkv passes ([B, Hq, S, D] with row stride Hq*D); the
    # yardstick is one scaled_dot_product_attention call on the same inputs
    # (timed here only, no module of the port calls it).  Bytes: q, k, v
    # read once, o written once; operations: 4 * Hq * D per unmasked (q, k)
    # pair, S(S+1)/2 of them.  The wgmma route on bf16 at the bf16
    # tensor-core rate (its split p does 1.5x that work; the bound counts
    # the function's).  The TF32 route on what route() sends it, f32, at the
    # TF32 tensor-core rate (its split operands do 3x that work); its row
    # also gives the f32 FMA bound and the byte floor.
    fs, fhq, fd = 1024, 8, 256
    qf, kf, vf = k5_inputs(1, fhq, 1, fs, fs, fd, seed, dev, torch.bfloat16)
    qf = qf.transpose(1, 2).contiguous().transpose(1, 2)
    q32, k32, v32 = (t.float() for t in (qf, kf, vf))
    q32 = q32.transpose(1, 2).contiguous().transpose(1, 2)
    k5_ops = 4 * fhq * fd * fs * (fs + 1) // 2

    def k5_work(q, k, v, ops_per_s):
        return {"bytes": (2 * q.numel() + k.numel() + v.numel())
                * q.element_size(), "ops": k5_ops, "ops_per_s": ops_per_s,
                "plain": lambda: flash_attention.flash_attention_plain(
                    q, k, v),
                "library": lambda: torch.nn.functional.
                scaled_dot_product_attention(q, k, v, is_causal=True,
                                             enable_gqa=True)}
    substr["flash_attention"] = "flash_attention_tf32_kernel"
    substr["flash_attention_wgmma"] = "flash_attention_wgmma_kernel"
    kernels.append({
        "name": "flash_attention", "task": "gemma-2b prefill layer, f32",
        "batch": fs,
        "kernel": lambda: flash_attention.flash_attention_tf32_cuda(
            q32, k32, v32), **k5_work(q32, k32, v32, TF32_FLOPS_PER_S),
        "bound_fma_ms": k5_ops / F32_FLOPS_PER_S * 1e3,
        "byte_floor_ms": (2 * q32.numel() + k32.numel() + v32.numel()) * 4
        / HBM_BYTES_PER_S * 1e3})
    kernels.append({
        "name": "flash_attention_wgmma",
        "task": "gemma-2b prefill layer, bf16", "batch": fs,
        "kernel": lambda: flash_attention.flash_attention_wgmma_cuda(
            qf, kf, vf), **k5_work(qf, kf, vf, BF16_FLOPS_PER_S)})
    for k in kernels:
        calls = k.pop("calls", 40)
        k["ms"] = per_call_ms(k["kernel"], calls=calls)
        k["plain_ms"] = per_call_ms(k["plain"], calls=calls)
        k["library_ms"] = (None if k["library"] is None
                           else per_call_ms(k["library"], calls=calls))
        k["device_ms"] = traced_ms(
            k["kernel"], substr[k["name"]], 10,
            k.pop("traced_per_call", k.get("per_launch", 1)))
        # the library call's own device time: every kernel it launches
        k["library_device_ms"], k["library_kernels"] = (
            (None, []) if k["library"] is None
            else traced_all_ms(k["library"]))
        k["bound_ms"], k["bound_by"] = bound(
            k["bytes"], k["ops"], k.pop("ops_per_s", INT_OPS_PER_S))
        ref = k.pop("reference", None)
        if ref is not None:
            # K4's first kernel on the same inputs (report only)
            k["reference_ms"] = per_call_ms(ref, calls=calls)
            k["reference_device_ms"] = traced_ms(ref, substr["reference"])
        for fn in ("kernel", "plain", "library"):
            del k[fn]
        n_per = k.pop("per_launch", 1)
        if n_per > 1:
            # the lambda launched n_per kernels: keep the block's totals and
            # report the mean launch, in the unit `launches` counts
            keys = ("ms", "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms")
            k["per_block"] = {"launches": n_per,
                              **{key: k[key] for key in keys}}
            for key in keys:
                k[key] = None if k[key] is None else k[key] / n_per
    # K3 layer by layer: each launch's device time beside its bound
    k3 = next(k for k in kernels if k["name"] == "lut_lookup")
    k3["per_layer"] = []
    for t, a in shapes:
        k3["per_layer"].append({
            "units": t.shape[0], "entries": t.shape[1],
            "device_ms": traced_ms(
                lambda t=t, a=a: lut_gather.lut_lookup_cuda(t, a),
                substr["lut_lookup"]),
            "bound_ms": bound(a.numel() * 8 + t.numel() * 4, 0)[0]})
    side = [k for k in kernels if k.pop("side", False)]
    kernels = [k for k in kernels if all(k is not x for x in side)]
    for k in side:
        report[f"k1_{k['task']}"] = k
        print(f"time {k['name']} ({k['task']}, batch {k['batch']}): kernel "
              f"{k['ms']:.4f} ms (device {k['device_ms']} ms), plain "
              f"{k['plain_ms']:.4f} ms, bound {k['bound_ms']:.5f} ms "
              f"({k['bound_by']}), plan {report['k1_plan_' + k['task']]} "
              f"[{smi}]", flush=True)
    del x4, r4, w4, b4, dy4, xs4, ws4, bs4, qf, kf, vf, q32, k32, v32
    report["k5_by_prompt"] = k5_by_prompt(dev, seed, smi)
    report["k5_tf32_d16"] = k5_tf32_d16(dev, seed, smi)

    # the engine under the profiler: device busy share of a serving pass
    for key, (task, backend) in (("mnist/fused", ("mnist", "fused")),
                                 ("nid/fused", ("nid", "fused")),
                                 ("nid/pallas", ("nid", "pallas"))):
        net = nets[task]
        xs = rs.uniform(-1.0, 1.0, (8192, net.cfg.in_features)
                        ).astype(np.float32)
        eng = LUTEngine(net, block=1024, depth=2, backend=backend)
        wall, prof, _ = profile(lambda: eng.run(xs), calls=1)
        busy = sum(s for _, s in prof.values())
        serving[key]["profiled_wall_s"] = wall
        serving[key]["device_busy_s"] = busy
        serving[key]["device_idle_share"] = 1.0 - busy / wall
        print(f"profile {key}: wall {wall * 1e3:.2f} ms, device busy "
              f"{busy * 1e3:.3f} ms, idle share {1.0 - busy / wall:.3f} "
              f"[{smi}]", flush=True)
    # -- phase 8: stream serving and hardware surfaces (slice 8) -------------
    # (after phase 5, whose kernel times are compared across slices)
    report["stream"] = stream_phase(dev, smi, seed, art_dir)
    report["hw_surfaces"] = hw_surfaces(
        report["toolflow_mnist"]["artifact"], dev, smi)

    # -- phase 9: the serving tier (slice 9) ----------------------------------
    report["fleet"] = fleet_phase(nets, dev, smi, seed, art_dir,
                                  report["toolflow_mnist"]["artifact"],
                                  report["stream"]["artifact"])

    # -- phase 10: the assembly search (slice 10) -----------------------------
    report["search"] = search_phase(dev, smi, seed, art_dir)

    # -- phase 11: the remaining LM families (slice 11) ------------------------
    report["families"] = families_phase(dev, smi, seed)

    # -- phase 12: LM training (slice 12) --------------------------------------
    report["train"] = train_phase(dev, smi, seed, art_dir)

    # -- phase 13: distribution and the dry run (slice 13) ---------------------
    report["dist"] = dist_phase(dev, smi, seed, art_dir,
                                report["train"]["gemma-2b"])

    # -- phase 14: the autotuner's measurement path (slice 14) ----------------
    report["autotune"] = autotune_phase(dev, smi, seed, art_dir)

    # -- phase 15: the paper's tables (slice 17) --------------------------------
    report["paper_tables"] = paper_tables_phase(dev, smi, seed)

    # -- phase 16: the serving benches and their gate (slice 18) ---------------
    report["benches"] = benches_phase(dev, smi, seed, art_dir)

    for k in kernels:
        if k["name"] == "flash_attention_wgmma":
            # the LM serving path: one launch per layer per prefill
            k["launches"] = report["serve_gemma"]["k5_launches"]
        elif k["name"] == "flash_attention":
            # the f32 2-layer cut of the serving path
            k["launches"] = report["serve_gemma"]["k5_tf32_launches_f32_cut"]
        elif k["name"].startswith("unit_affine"):
            # the toolflow's main path: pretrain + retrain + compile
            k["launches"] = report["toolflow_mnist"]["k4_launches"][k["name"]]
            k["launches_per_step"] = {
                m: v["k4_launches"][k["name"]]
                for m, v in report["toolflow_mnist"]["step"].items()}
        else:
            k["launches"] = serving[PATHS[k["name"]]]["launches"][k["name"]]
        k["path"] = PATHS[k["name"]]
        k["max_abs_err"] = errs[k["name"]]
        k["route"] = "cuda"
        k["source"] = SOURCES[k["name"]]
        k["replaces"] = REPLACES[k["name"]]
        ref = ("" if "reference_ms" not in k else
               f", reference kernel {k['reference_ms']:.4f} ms (device "
               f"{k['reference_device_ms']} ms)")
        extra = {key: k[key] for key in ("bound_fma_ms", "byte_floor_ms",
                                         "library_kernels") if key in k}
        if k["name"] == "lut_cascade_streamed":
            extra["plan"] = report["k2_plan"]
        if k["name"] == "lut_cascade_resident":
            extra["plan"] = report["k1_plan_nid"]
        if k["name"] == "lut_lookup":
            extra["per_layer"] = k["per_layer"]
            extra["per_block"] = k["per_block"]
        print(f"time {k['name']} ({k['task']}, batch {k['batch']}): kernel "
              f"{k['ms']:.4f} ms (device {k['device_ms']} ms), plain "
              f"{k['plain_ms']:.4f} ms, library {k['library_ms']} ms (device "
              f"{k['library_device_ms']} ms), bound "
              f"{k['bound_ms']:.5f} ms ({k['bound_by']}){ref} {extra} "
              f"[{smi}]",
              flush=True)
    # the stream path's kernels at the cell's block: launches of its run
    for k in report["stream"]["kernels"]:
        backend = "fused" if k["name"] == "lut_cascade_resident" else "pallas"
        kernels.append(dict(
            k, route="cuda", source=SOURCES[k["name"]],
            replaces=REPLACES[k["name"]],
            launches=report["stream"]["serve"][backend]["launches"][
                k["name"]]))
    # the fleet's new call shapes: launches of the placed lanes' runs
    placed = report["fleet"]["placements"]
    for k in report["fleet"]["kernels"]:
        run = placed["batch" if k["name"] == "lut_cascade_resident"
                     else "units"]
        kernels.append(dict(
            k, route="cuda", source=SOURCES[k["name"]],
            replaces=REPLACES[k["name"]],
            launches=run["launches"][k["name"]]))
    # the search's new call shape: K4 per-unit at a stacked population,
    # launches of the population step at that shape
    for k in report["search"]["population"]["kernels"]:
        kernels.append(dict(k, route="cuda", source=SOURCES[k["name"]],
                            replaces=REPLACES[k["name"]]))
    # the remaining LM families' new call shapes: K5 at each new layout, K1
    # and K3 at the LUT time-mix cell, launches of their main paths' runs
    for k in report["families"]["kernels"]:
        kernels.append(dict(k, route="cuda", source=SOURCES[k["name"]],
                            replaces=REPLACES[k["name"]]))
    # LM training's K5 layouts: launches of the training runs (forward and
    # remat's recompute; the backward launches none)
    for k in report["train"]["kernels"]:
        kernels.append(dict(k, route="cuda", source=SOURCES[k["name"]],
                            replaces=REPLACES[k["name"]]))
    # the meshed train step's K5 layout: launches of its run
    for k in report["dist"]["kernels"]:
        kernels.append(dict(k, route="cuda", source=SOURCES[k["name"]],
                            replaces=REPLACES[k["name"]]))
    # the autotuner's K1 and K2 at its codes: launches of its runs
    kernels.extend(report["autotune"]["kernels"])
    # Table IV's K4 layouts and K1 / K3 at its Assemble artifact: launches
    # of its trainings, folds and serving
    kernels.extend(report["paper_tables"]["kernels"])
    # K1 and K3 at the throughput bench's layout: launches of phase 16's run
    kernels.extend(report["benches"]["kernels"])
    report["kernels"] = kernels
    report["profiler_lead_lost"] = {str(n): LEAD_LOST.count(n)
                                    for n in sorted(set(LEAD_LOST))}
    report["profiler_retraced"] = RETRACED
    print(f"profiler sessions by spin launches lost: "
          f"{report['profiler_lead_lost']}; incomplete traces: "
          f"{len(RETRACED)} {RETRACED}", flush=True)
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tp-rank", type=int, default=None,
                    help="(internal) one rank of phase 13's TP check")
    ap.add_argument("--tp-dir", default=None)
    args = ap.parse_args()
    if args.tp_rank is not None:
        tp_rank_main(args.tp_rank, Path(args.tp_dir), args.seed)
        sys.exit(0)
    rep = main(args.seed)
    import torch
    out_dir = ROOT / "build" / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "report.json").write_text(json.dumps(rep, indent=1))
    fl = rep["fleet"]
    print(json.dumps({"fleet": {
        "tenants": {m: {key: t[key] for key in (
            "task", "backend", "rows_per_s", "p50_request_us",
            "p99_request_us")} for m, t in fl["replay"]["tenants"].items()},
        "idle_share_10_ticks": fl["idle"]["device_idle_share"],
        "launches": fl["replay"]["launches"],
        "blocks": fl["replay"]["blocks"],
        "placements": {
            "slots": fl["placements"]["slots"],
            "physical_devices": fl["placements"]["physical_devices"],
            **{k: {key: fl["placements"][k][key] for key in (
                "backend", "rows_per_s", "unplaced_rows_per_s",
                "launches")} for k in ("batch", "units")}},
        "degrades": {"uninjected": sum(fl["degrades"].values()),
                     "injected": {n: f["degrades"]
                                  for n, f in fl["faults"].items()}},
        "swaps": fl["hot_swap"]["swap_history"],
        "failover": {key: fl["failover"][key] for key in (
            "streams", "steps", "mismatched_streams", "lost_steps")}}}))
    se = rep["search"]
    print(json.dumps({"search": {
        "population": {key: se["population"][key] for key in (
            "p", "units", "stages_per_forward", "step_s", "peak_bytes")},
        "rung_idle_share": se["rung_idle"]["device_idle_share"],
        "nid": {"wall_s": se["nid"]["wall_s"],
                "stage_seconds": {k: v["total"] for k, v in
                                  se["nid"]["stage_seconds"].items()},
                "frontier": [{key: pt[key] for key in (
                    "name", "accuracy", "luts", "adp", "calibration")}
                    for pt in se["nid"]["frontier"]]},
        "mesh_survivors_equal": True, "seconds": se["seconds"]}}))
    fa = rep["families"]
    print(json.dumps({"lm_families": {
        **{a: {key: fa[a][key] for key in (
            "layers", "k5_launches", "tokens_per_s", "decode_ms_median",
            "peak_bytes", "reduced", "decode_vs_prefill")}
           for a in ("hymba-1.5b", "mixtral-8x22b", "dbrx-132b",
                     "rwkv6-7b")},
        "whisper-small": {key: fa["whisper-small"][key] for key in (
            "k5_launches", "prefill_s", "decode_ms_per_tick", "peak_bytes",
            "decode_vs_prefill")},
        "lut_time_mix": {be: fa["lut_time_mix"][be]["stream_steps_per_s"]
                         for be in ("fused", "pallas")},
        "f32_card_vs_cpu": {a: v["card_vs_cpu_max_abs_diff"]
                            for a, v in fa["f32_cut"].items()},
        "seconds": fa["seconds"]}}))
    tr = rep["train"]
    print(json.dumps({"lm_train": {
        "gemma-2b": {key: tr["gemma-2b"][key] for key in (
            "params", "batch", "seq", "losses", "step_ms_median_2_5",
            "batch_fn_s", "tokens_per_s", "peak_bytes",
            "k5_launches_per_step")},
        "gemma-2b_idle_share": tr["gemma-2b"]["profiled_step"][
            "device_idle_share"],
        "whisper-small": {key: tr["whisper-small"][key] for key in (
            "losses", "k5_launches_per_step")},
        "card_vs_cpu_worst_grad": {a: v["worst_grad_rel"]
                                   for a, v in tr["card_vs_cpu"].items()},
        "replay": {key: tr["replay"][key] for key in (
            "max_abs_diff", "bitwise", "nondeterministic_ops",
            "card_to_cpu_exact")},
        "router": {key: tr["router"][key] for key in (
            "routing_agreement", "moe_rel_diff")},
        "seconds": tr["seconds"]}}))
    di = rep["dist"]
    print(json.dumps({"lm_dist": {
        "gemma-2b_mesh_1_1": {key: di["gemma-2b"][key] for key in (
            "losses", "unmeshed_losses", "loss_rel_diff", "grad_norms",
            "unmeshed_grad_norms", "grad_norm_rel_diff", "step_ms",
            "unmeshed_step_ms_median_2_5", "peak_bytes",
            "unmeshed_peak_bytes", "k5_launches_per_step")},
        "whisper-small_mesh_1_1": {key: di["whisper-small"][key] for key in (
            "losses", "k5_launches_per_step", "step_ms")},
        "gemma-2b_tp_1_2": {
            **{key: di["gemma-2b tp"][key] for key in (
                "backend", "unmeshed_losses", "unmeshed_grad_norms",
                "one_rank_mesh_peak_bytes", "prefill_max_abs_diff",
                "prefill_argmax_same", "wall_s")},
            "ranks": [{key: r[key] for key in (
                "losses", "grad_norms", "step_ms", "peak_bytes", "design",
                "k5_layouts")} for r in di["gemma-2b tp"]["per_rank"]]},
        "tp_families_1_2": {arch: {
            "design": f["per_rank"][0]["design"],
            "peak_bytes_per_rank": [r["peak_bytes"] for r in f["per_rank"]],
            **({"step_ms": [r["step_ms"] for r in f["per_rank"]],
                "losses": [r["losses"] for r in f["per_rank"]],
                "unmeshed_losses": f["unmeshed_losses"]}
               if "step_ms" in f["per_rank"][0] else
               {"prefill_ms": [r["prefill_ms"] for r in f["per_rank"]],
                "logits_max_rel_diff": f["logits"]["max_rel_diff"],
                "state_rel_diff": f["state_rel_diff"],
                **({"f32_logits_max_rel_diff": f["logits"]["f32"][
                    "max_rel_diff"], "f32_state_rel_diff": f["logits"][
                    "f32"]["state_rel_diff"]} if "f32" in f["logits"]
                   else {}),
                "dispatch": f.get("dispatch")}),
            "k5_layouts": f["per_rank"][0]["k5_layouts"]}
            for arch, f in di["tp families"].items()},
        "compress": {key: di["compress"][key] for key in (
            "card_equals_cpu", "psum_equals_decompress", "compress_ms")},
        "dryrun": {k: v for k, v in di["dryrun"].items()},
        "seconds": di["seconds"]}}))
    au = rep["autotune"]
    print(json.dumps({"autotune": {
        **{t: {key: au[t][key] for key in (
            "candidates", "distinct_launches", "launches", "best_s",
            "winner", "tune_s")} for t in ("nid", "mnist")},
        "seconds": au["seconds"]}}))
    pa = rep["paper_tables"]
    print(json.dumps({"paper_tables": {
        "table4": [{key: r[key] for key in (
            "model", "acc", "folded_acc", "luts", "area_delay",
            "area_delay_vs_ours")} for r in pa["rows"]],
        "k4_launches": pa["k4_launches"], "lut_launches": pa["lut_launches"],
        "train_s": pa["train_s"], "seconds": pa["seconds"]}}))
    be = rep["benches"]
    print(json.dumps({"benches": {
        "launches": be["launches"], "slots": be["slots"],
        "hot_swap": be["hot_swap"], "timing": be["timing"],
        "gate": {n: {key: g[key] for key in ("metrics", "violations",
                                             "compared", "regressions")}
                 for n, g in be["gate"].items()},
        "roofline_gpu_modes": be["roofline_gpu_modes"],
        "seconds": be["seconds"]}}))
    keys = ("name", "path", "route", "source", "replaces", "launches",
            "max_abs_err",
            "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys}
                                  for kr in rep["kernels"]]}))
    print(rep["nvidia_smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
