"""Tile shapes of K4's dense routes on the card.

    python benchmarks/torch_k4_tiles.py [--variants NAME,...]

Builds ``src/repro_torch/kernels/csrc/subnet_mlp.cu`` once per variant with
some of its tile constants rewritten in a copy of the source (the dense
forward's big tile ``DENSE_BM``, ``DENSE_BN``, ``DENSE_TM``, ``DENSE_TN``,
its k-slice ``DENSE_KT`` and the CTAs an SM its registers are cut for
``DENSE_MINB``; the units a partial of the dense dx sums ``CHUNK``), all
variants' ``nvcc`` at once.  Each
variant's dense forward on dense layer 0 of ``mnist`` (shared rows
[256, 784], w [2160, 784, 64], f32) is held bit for bit against the
reference kernel, and its dense dx ([256, 2160, 64] -> [256, 784]) bit for
bit against the committed build's (at the committed chunk; another chunk
sums in another order and is held to the plain version at rtol 1e-4, atol
1e-5 x the largest |dx|).  Both are then timed: CUDA events around 10 calls
(median of 5 runs) and the kernels' own time in the profiler's trace, beside
``torch.baddbmm`` with TF32 off; the forward with x k-major, as
``unit_affine_cuda`` passes it, and as given (row-major).  Prints one JSON
line per variant and the card's ``name, power.limit``.  The ``ablate_*`` variants are the committed
source with one kind of work taken out of the loop (their results are
wrong on purpose and only timed), to show what bounds it.  Imports nothing
of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# name -> new values of the source's tile constants (none: the committed
# build).  The forward's CTA has (DENSE_BM / DENSE_TM) * (DENSE_BN /
# DENSE_TN) threads.
T8X8 = {"DENSE_TM": 8, "DENSE_TN": 8, "DENSE_MINB": 2}
VARIANTS = {
    "committed": {},
    "t8x8_kt16": T8X8,
    "t8x8_kt8": {**T8X8, "DENSE_KT": 8},
    "t16x8_kt8": {"DENSE_KT": 8},
    "t8x16_kt16": {"DENSE_TM": 8, "DENSE_TN": 16},
    "256x128_t16x8_kt8_b1": {"DENSE_BM": 256, "DENSE_KT": 8,
                             "DENSE_MINB": 1},
    "128x64_t16x8_b6": {"DENSE_BN": 64, "DENSE_MINB": 6},
    "dx_chunk64": {"CHUNK": 64},
    "dx_chunk8": {"CHUNK": 8},
}
# Ablations of the committed source (timing only; their results are wrong
# on purpose): name -> [(text, replacement)], every occurrence.  Each
# removes one kind of work from the loops and keeps the FMAs.
ABLATIONS = {
    # stage only the first two k-slices; later slices reuse stale tiles
    "ablate_no_staging": [("    if (s + 1 < nslices) {\n",
                           "    if (s + 1 < 2) {\n")],
    # read the x fragment once a slice instead of once a k
    "ablate_x_reads_once": [("Frag<TM, BM>::load(xs + kk * LDX, ty, a);",
                             "Frag<TM, BM>::load(xs, ty, a);")],
    # read the w fragment once a slice instead of once a k
    "ablate_w_reads_once": [("Frag<TN, BN>::load(ws + kk * LDW, tx, b);",
                             "Frag<TN, BN>::load(ws, tx, b);")],
}


def _constant(text: str, name: str) -> str:
    """The pattern of the source's ``constexpr int name = value;`` line."""
    pat = rf"constexpr int {name} = \d+;"
    if len(re.findall(pat, text)) != 1:
        raise RuntimeError(f"constant {name} not found once in the source")
    return pat


def _variant_source(name: str, text: str) -> str:
    """The committed source with ``name``'s constants or ablation."""
    for old, new in ABLATIONS.get(name, ()):
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} not found")
        text = text.replace(old, new)
    for const, value in VARIANTS.get(name, {}).items():
        text = re.sub(_constant(text, const),
                      f"constexpr int {const} = {value};", text)
    return text


def _build(names, out_dir: Path):
    """{variant: library path}, one nvcc per variant, started together."""
    from repro_torch.kernels import build
    text = build.SOURCES["subnet_mlp"].read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for name in names:
        if VARIANTS.get(name) == {}:
            libs[name] = build.build()["subnet_mlp"][0]
            continue
        lib = out_dir / f"libsubnet_mlp_{name}.so"
        src = out_dir / f"{name}.cu"
        src.write_text(_variant_source(name, text))
        procs[name] = subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        libs[name] = lib
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{err}")
        regs = [ln.split(":")[-1].strip() for ln in err.splitlines()
                if "Used" in ln]
        print(f"built {name}: ptxas {regs[-6:]}", flush=True)
    return libs


def _load(path):
    from repro_torch.kernels import build
    lib = ctypes.CDLL(str(path))
    for fname, argtypes in build._SIGNATURES["subnet_mlp"].items():
        fn = getattr(lib, fname)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _ms(fn, calls: int = 10, reps: int = 5) -> float:
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def _device_ms(fn, calls: int = 10) -> float:
    """The kernels' own time per call in the profiler's CUDA trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()) * 1e-3 / calls


def main(names) -> None:
    """Build, check and time every variant in ``names``."""
    import torch
    from repro_torch.kernels import build, subnet_mlp

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    libs = _build(names, ROOT / "build" / "k4_tiles")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    b, u, din, dout = 256, 2160, 784, 64
    x = torch.rand((b, din), generator=gen).to(dev)
    w = (torch.randn((u, din, dout), generator=gen) * (2.0 / din) ** 0.5
         ).to(dev)
    bias = (torch.randn((u, dout), generator=gen) * 0.1).to(dev)
    dy = torch.randn((b, u, dout), generator=gen).to(dev)
    xt = x.t().contiguous().t()     # k-major, as unit_affine_cuda passes it
    want = subnet_mlp.unit_affine_reference_cuda(x, w, bias)
    want_dx = subnet_mlp.unit_affine_dx_cuda(dy, w)
    plain_dx = subnet_mlp.unit_affine_dx_plain(dy, w)
    scale = float(plain_dx.abs().max())
    xb = x[:, None, :].expand(b, u, din).transpose(0, 1)
    baddbmm = lambda: torch.baddbmm(bias[:, None, :], xb, w)  # noqa: E731
    baddbmm_ms, baddbmm_dev = _ms(baddbmm), _device_ms(baddbmm)
    stream = torch.cuda.current_stream().cuda_stream
    y = torch.empty((b, u, dout), device=dev)
    dx = torch.empty((b, din), device=dev)
    for name in names:
        lib = _load(libs[name])
        part = torch.empty((lib.unit_affine_dx_chunks(u), b, din), device=dev)

        def fwd(xx=xt):
            build.check(lib.unit_affine_launch(
                xx.data_ptr(), w.data_ptr(), bias.data_ptr(), y.data_ptr(), b,
                u, din, dout, xx.stride(0), 0, xx.stride(1), *w.stride(), 0,
                0, stream), name)

        def bwd():
            build.check(lib.unit_affine_dx_launch(
                dy.data_ptr(), w.data_ptr(), part.data_ptr(), dx.data_ptr(),
                b, u, din, dout, *dy.stride(), *w.stride(), 0, stream), name)

        for xx in (x, xt):
            fwd(xx)
            torch.cuda.synchronize()
            if name not in ABLATIONS and not torch.equal(y, want):
                sys.exit(f"{name}: forward differs from the reference kernel")
        bwd()
        torch.cuda.synchronize()
        same_chunk = "CHUNK" not in VARIANTS.get(name, {})
        if name not in ABLATIONS and (
                same_chunk and not torch.equal(dx, want_dx)
                or not torch.allclose(dx, plain_dx, rtol=1e-4,
                                      atol=1e-5 * scale)):
            sys.exit(f"{name}: dx differs from the committed build's or "
                     "the plain version")
        print(json.dumps({"variant": name, "config": VARIANTS.get(name),
                          "timing_only": name in ABLATIONS,
                          "dense_fwd_ms": _ms(fwd),
                          "dense_fwd_device_ms": _device_ms(fwd),
                          "dense_fwd_row_major_x_device_ms": _device_ms(
                              lambda: fwd(x)),
                          "dense_dx_ms": _ms(bwd),
                          "dense_dx_device_ms": _device_ms(bwd),
                          "baddbmm_ms": baddbmm_ms,
                          "baddbmm_device_ms": baddbmm_dev, "card": smi}),
              flush=True)
    print(smi)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join([*VARIANTS, *ABLATIONS]))
    main(ap.parse_args().variants.split(","))
