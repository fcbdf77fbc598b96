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
  SDPA.

Served codes are checked against the ``take`` backend on the card and the
plain CPU path, folded codes against the quantized model, and every kernel
is timed.  Any failed phase exits nonzero.  The last three lines of
standard output are a JSON object with every kernel's launches, error and
times, the card's ``name, power.limit``, then ``{"ok": true, "device":
{...}}``; a ``{"fleet": ...}``, a ``{"search": ...}`` and an
``{"lm_families": ...}`` line come before them.  A full report goes
to ``build/chip_smoke/report.json``.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
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
        bound_ms, bound_by = bound(nbytes // per, n_ops if per == 1 else 0)
        rows.append({"name": name, "path": path, "task": task, "batch": b,
                     "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err": err})
        print(f"time {name} ({task}, batch {b}, per launch): kernel "
              f"{ms:.4f} ms (device {device_ms} ms), plain {plain_ms:.4f} "
              f"ms, library {lib_ms} ms, bound {bound_ms:.6f} ms "
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
    ``nid`` with the default budget on the card (sliced in 2, run
    sequentially).  The frontier must be
    non-empty, ranked and non-dominated; every frontier artifact, saved and
    loaded, must answer bit-identically on ``take``, ``fused`` and
    ``pallas`` on the card and from a CPU load, with the fused kernel
    launched once a block and K3 once a layer a block.  The best frontier
    accuracy must pass ``SEARCH_NID_ACCURACY``.  Every K4 operand layout
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
                                 population_slices=2)
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
    print(f"nid search (default budget, 2 slices) on the card: "
          f"{wall:.1f} s; rungs {[round(s, 2) for s in st['rungs']]} s, "
          f"promotions {sum(st.get('promotions', [])):.1f} s "
          f"({len(res.promoted)}), calibration "
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
    args = ap.parse_args()
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
