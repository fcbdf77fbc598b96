#!/usr/bin/env python3
"""Where one KV tile's time goes inside K5's wgmma kernel, on one GPU.

    python3 benchmarks/torch_k5_phases.py

Builds a copy of ``src/repro_torch/kernels/csrc/flash_attention_wgmma.cu``
with ``clock64()`` stamps added around the consumer warpgroup's phases
(into ``build/k5_phases/``; the kernel in the package is not touched), runs
it on one gemma-2b prefill layer (q ``[1, 8, 1024, 256]`` as the model's
strided view on one KV head, bf16, causal), and prints the median SM cycles
a KV tile spends in each phase, for thread 0 of the CTA that takes the most
KV tiles (the last q tile of head 0), with p split and with p rounded once:

* ``wait``: the tile's "full" barrier (TMA still loading);
* ``qk``: issuing Q K^T and the previous tile's PV, then waiting for Q K^T;
* ``softmax``: mask, row max, exp2 and row sums (the previous PV runs);
* ``pv_wait``: what is left of the previous tile's PV;
* ``rescale_split``: O *= alpha, and p into the bf16 A-fragments;
* ``tile``: from one tile's barrier wait to the next.

Tile 0 runs before the loop (no PV to overlap), so the stamps cover tiles 1
to n-1.

The stamps are stores from one thread, so the instrumented kernel is a
little slower than the real one.  Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("wait", "qk", "softmax", "pv_wait", "rescale_split", "tile")
# (marker in the source, stamp index, stamp before the marker); the loop
# runs tiles 1 .. n-1 (tile 0 is its prologue)
STAMPS = (("      mbar_wait(full_bar + 8 * (i % STAGES), (i / STAGES) & 1);\n",
           0, True),
          ("      mbar_wait(full_bar + 8 * (i % STAGES), (i / STAGES) & 1);\n",
           1, False),
          ("      wgmma_wait<1>();                   // S_i is done, the PV may "
           "still run\n      pin(sc);\n", 2, False),
          ("      wgmma_wait<0>();                   // the previous tile's PV "
           "is done\n", 3, True),
          ("      mbar_arrive(empty_bar + 8 * ((i - 1) % STAGES));\n", 4,
           False))
MAX_TILES = 64


def instrumented_source(src: str) -> str:
    """The kernel source with a stamp buffer, the stamps and a reader."""
    src = src.replace("namespace {\n", "__device__ long long k5_stamps[%d];\n"
                      "namespace {\n" % (MAX_TILES * 5), 1)
    first = "    mbar_wait(q_bar, 0);\n"
    if src.count(first) != 1:
        raise RuntimeError("the kernel source changed: no unique q wait")
    src = src.replace(first, first + "    const bool stamp = threadIdx.x == 0"
                      " && blockIdx.x == 0 && blockIdx.y == 0 && "
                      "blockIdx.z == 0;\n")
    for marker, idx, before in STAMPS:
        if src.count(marker) != 1:
            raise RuntimeError(f"the kernel source changed: {marker!r}")
        line = (f"      if (stamp && i < {MAX_TILES}) k5_stamps[i * 5 + "
                f"{idx}] = clock64();\n")
        src = src.replace(marker, line + marker if before else marker + line)
    return src + ('\nextern "C" int k5_stamps_read(void* host) {\n  return '
                  'static_cast<int>(cudaMemcpyFromSymbol(host, k5_stamps, '
                  'sizeof(k5_stamps)));\n}\n')


def main() -> None:
    """Build the instrumented copy, run it, print the phases."""
    import torch
    from repro_torch.kernels import build, flash_attention as fa

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a GPU")
    out = ROOT / "build" / "k5_phases"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_attention_wgmma_phases.cu"
    src.write_text(instrumented_source(
        build.SOURCES["flash_attention_wgmma"].read_text()))
    lib_path = out / "libk5_phases.so"
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.flash_attention_wgmma_launch.argtypes = list(
        build._SIGNATURES["flash_attention_wgmma"][
            "flash_attention_wgmma_launch"])
    lib.k5_stamps_read.argtypes = [ctypes.c_void_p]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    hq, s, d = 8, 1024, 256
    gen = torch.Generator(device="cuda").manual_seed(0)
    dev = torch.device("cuda")
    q = torch.randn((1, s, hq, d), generator=gen, device=dev).bfloat16()
    q = q.transpose(1, 2)                  # the model's strided view
    k = torch.randn((1, 1, s, d), generator=gen, device=dev).bfloat16()
    v = torch.randn((1, 1, s, d), generator=gen, device=dev).bfloat16()
    o = torch.empty((1, hq, s, d), dtype=torch.bfloat16, device=dev)
    st = [x for t in (q, k, v) for x in fa._tma_strides(t)]
    n_tiles = s // 64                      # the last q tile sees every key
    for split in (1, 0):
        for _ in range(5):
            err = lib.flash_attention_wgmma_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                hq, 1, s, s, d, *st, 1, 0, 0, d ** -0.5, split,
                torch.cuda.current_stream().cuda_stream)
            build.check(err, "flash_attention_wgmma (instrumented)")
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (MAX_TILES * 5))()
        build.check(lib.k5_stamps_read(buf), "k5_stamps_read")
        rows = [buf[i * 5:(i + 1) * 5] for i in range(1, n_tiles)]
        per = {name: [] for name in PHASES}
        for r, nxt in zip(rows, rows[1:]):
            per["wait"].append(r[1] - r[0])
            per["qk"].append(r[2] - r[1])
            per["softmax"].append(r[3] - r[2])
            per["pv_wait"].append(r[4] - r[3])
            per["rescale_split"].append(nxt[0] - r[4])
            per["tile"].append(nxt[0] - r[0])
        med = {name: statistics.median(x) for name, x in per.items()}
        print(f"K5 wgmma phases, gemma-2b layer S {s}, split_p={split}, "
              f"{n_tiles} KV tiles, median SM cycles per tile: "
              + ", ".join(f"{name} {med[name]:.0f}" for name in PHASES)
              + f"; tiles 1 to {n_tiles - 1}: {rows[-1][4] - rows[0][0]} "
              f"cycles [{smi}]",
              flush=True)


if __name__ == "__main__":
    main()
