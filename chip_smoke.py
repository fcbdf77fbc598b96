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
  card-folded ``mnist`` artifact, its Verilog against a CPU load's.

Served codes are checked against the ``take`` backend on the card and the
plain CPU path, folded codes against the quantized model, and every kernel
is timed.  Any failed phase exits nonzero.  The last three lines of
standard output are a JSON object with every kernel's launches, error and
times, the card's ``name, power.limit``, then ``{"ok": true, "device":
{...}}``.  A full report goes to ``build/chip_smoke/report.json``.
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


def stream_kernels(card, rs, dev, smi: str) -> list:
    """K1 on one block of the cell (256 rows) and K3 per launch (the mean
    of the cell's 4 layers at 256 rows), each held against its plain
    version at the block and at ragged batches; returns their rows for the
    kernel table (launches filled in by the caller)."""
    import torch
    from repro_torch.kernels import lut_cascade, lut_gather

    b = STREAM_BLOCK
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
        rows.append({"name": name, "path": "seqmnist/stream",
                     "task": "seqmnist_reduced cell", "batch": b,
                     "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "max_abs_err": err1 if per == 1 else err3})
        print(f"time {name} (seqmnist_reduced cell, batch {b}, per launch): "
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
