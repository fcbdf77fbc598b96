"""K1 (the resident cascade) and K3 (the per-layer lookup) of one source
tree, timed on the card.

    python benchmarks/torch_lut_resident.py [--src DIR] [--label NAME]
                                            [--sweep]

Imports ``repro_torch`` from ``DIR`` (default: this tree's ``src``), so
that two trees -- a commit and its parent unpacked beside it -- are timed
by the same code in one call, in turns.  Each time is CUDA events around
40 calls (median of 5 runs, "ms") and the device time of the kernel in the
profiler's trace ("device_ms", per call):

* K1 (``lut_cascade_resident``) on one block of 1024 rows at ``nid`` (int8
  tables ``[93, 64]``) and ``jsc_openml`` (int16 ``[635, 64]``), random
  tables from ``chip_smoke.random_network``, checked bit for bit against the
  plain cascade;
* K3 (``lut_lookup_cuda``) launch by launch at ``nid``'s five layers (U =
  60, 20, 9, 3, 1; T = 64; B = 1024), and at U = 60, B = 1024 with T = 4096
  and 32768; on a tree whose K3 still has a staged route (the parent), that
  route is also forced at T = 32768 (one table row staged a CTA);
* an empty kernel with K3's arguments, launched as K3 launches nid's layer
  0 (240 CTAs of 64 threads) and as one CTA of 32 threads: K3's floor.  Its
  source is written by this script into ``build/bench/`` and compiled with
  ``nvcc``; it is no part of the package;
* with ``--sweep`` (a tree with ``plan_resident``): K1's plans over rows a
  tile {4, 8, 16, 32} x CTAs an SM {1, 2, 4, all that fit}, at ``nid`` and
  ``jsc_openml``, batches 1024 and 4096, each checked bit for bit.

Prints one JSON line and the card's ``name, power.limit``.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
EMPTY_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void empty_lookup_kernel(const int32_t* table, const int32_t* addr,
                                    int32_t* out, long long n, int U, int T) {}
extern "C" int empty_launch(const void* table, const void* addr, void* out,
                            long long n, int U, int T, int grid, int threads,
                            void* stream) {
  empty_lookup_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)table, (const int32_t*)addr, (int32_t*)out, n, U, T);
  return (int)cudaGetLastError();
}
"""


def empty_library(nvcc: str):
    """Build (once) and load the empty kernel."""
    out = ROOT / "build" / "bench"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "empty_lookup.cu", out / "libempty_lookup.so"
    src.write_text(EMPTY_SRC)
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    so = ctypes.CDLL(str(lib))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.empty_launch.argtypes = [P, P, P, L, I, I, I, I, P]
    so.empty_launch.restype = I
    return so


def main(src: Path, label: str, sweep: bool) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                     # timing helpers of this tree
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.kernels import build
    from repro_torch.kernels import lut_cascade as lc
    from repro_torch.kernels import lut_gather as lg

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a GPU")
    if not str(Path(lc.__file__).resolve()).startswith(str(src.resolve())):
        sys.exit(f"repro_torch came from {lc.__file__}, not {src}")
    dev = torch.device("cuda")
    out = {"label": label, "src": str(src)}

    def timed(fn, name):
        _, prof = cs.profile(fn)
        hits = [s for key, (_, s) in prof.items() if name in key]
        return {"ms": cs.per_call_ms(fn),
                "device_ms": sum(hits) * 1e3 / 10 if hits else None}

    # K1 at its two paper tasks
    fused = {}
    for task in ("nid", "jsc_openml"):
        cfg = paper_tasks.task_config(task)
        plan = pipeline.CompiledLUTNetwork(
            cfg, *cs.random_network(cfg, 0), device=dev
        ).compile_backend("fused").plan
        layers = tuple(tuple(int(x) for x in l) for l in plan.meta["layers"])
        tables = plan.tensor("tables", dev)
        maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
                else None for l in range(len(layers))]
        ops = lc.prepare(tables, layers, maps)
        fused[task] = (layers, tables, maps, ops)
        codes = torch.from_numpy(np.random.RandomState(1).randint(
            0, 2 ** layers[0][5], (1024, layers[0][0])).astype(np.int32)
        ).to(dev)
        fn = lambda c=codes, o=ops: lc.lut_cascade_resident(c, o)  # noqa: E731
        if not torch.equal(fn(), lc.lut_cascade_plain(codes, tables, maps,
                                                      layers)):
            sys.exit(f"K1 differs from the plain cascade on {task}")
        out[f"k1_{task}_1024"] = {**timed(fn, "cascade_resident_kernel"),
                                  "table_dtype": str(tables.dtype)}

    # K3 launch by launch, and its floor
    rs = np.random.RandomState(2)
    nid = pipeline.CompiledLUTNetwork(
        paper_tasks.task_config("nid"),
        *cs.random_network(paper_tasks.task_config("nid"), 0), device=dev
    ).compile_backend("pallas").plan
    shapes = [(nid.tensor(f"table_{l}", dev).shape[0], 64, 1024)
              for l in range(len(nid.meta["layers"]))]
    shapes += [(60, 4096, 1024), (60, 32768, 1024)]
    k3 = []
    for units, entries, b in shapes:
        table = torch.from_numpy(rs.randint(0, 64, (units, entries)).astype(
            np.int32)).to(dev)
        addr = torch.from_numpy(rs.randint(0, entries, (b, units)).astype(
            np.int32)).to(dev)
        fn = lambda t=table, a=addr: lg.lut_lookup_cuda(t, a)  # noqa: E731
        if not torch.equal(fn(), lg.lut_lookup_plain(table, addr)):
            sys.exit(f"K3 differs from the plain lookup at U {units}")
        row = {"units": units, "entries": entries, "batch": b,
               **timed(fn, "lut_lookup_kernel")}
        if hasattr(lg, "SMEM_STAGE_BUDGET") and entries == 32768:
            lib = build.library("lut_kernels")
            res = torch.empty_like(addr)

            def staged(t=table, a=addr, o=res):
                err = lib.lut_lookup_launch(
                    t.data_ptr(), a.data_ptr(), o.data_ptr(), b, units,
                    entries, 1, 256, 1,
                    torch.cuda.current_stream().cuda_stream)
                build.check(err, "staged lookup")
                return o
            if not torch.equal(staged(), lg.lut_lookup_plain(table, addr)):
                sys.exit("the forced staged route differs from plain")
            row["staged_forced"] = timed(staged, "lut_lookup_kernel")
        k3.append(row)
    out["k3"] = k3
    out["k3_nid_block_device_ms"] = sum(r["device_ms"] or 0.0
                                        for r in k3[:5])
    empty = empty_library(build.nvcc())
    t0 = torch.zeros((60, 64), dtype=torch.int32, device=dev)
    a0 = torch.zeros((1024, 60), dtype=torch.int32, device=dev)
    floor = {}
    for grid, threads in ((240, 64), (1, 32)):
        def launch(grid=grid, threads=threads):
            build.check(empty.empty_launch(
                t0.data_ptr(), a0.data_ptr(), a0.data_ptr(), a0.numel(), 60,
                64, grid, threads, torch.cuda.current_stream().cuda_stream),
                "empty kernel")
        floor[f"{grid}x{threads}"] = timed(launch, "empty_lookup_kernel")
    out["empty_kernel"] = floor

    if sweep and hasattr(lc, "plan_resident"):
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows_out = []
        for task, (layers, tables, maps, ops) in fused.items():
            isz = tables.element_size()
            for b in (1024, 4096):
                codes = torch.from_numpy(rs.randint(
                    0, 2 ** layers[0][5], (b, layers[0][0])).astype(np.int32)
                ).to(dev)
                want = lc.lut_cascade_plain(codes, tables, maps, layers)
                default = lc.plan_resident(layers, isz, b, sms,
                                           max_entries=tables.shape[1])
                for r in (4, 8, 16, 32):
                    try:
                        fit = lc.plan_resident(layers, isz, b, sms, rows=r,
                                               max_entries=tables.shape[1])
                    except ValueError:
                        continue
                    for c in sorted({1, 2, 4, fit.ctas_per_sm}):
                        if c > fit.ctas_per_sm:
                            continue
                        p = lc.plan_resident(layers, isz, b, sms, rows=r,
                                             ctas_per_sm=c,
                                             max_entries=tables.shape[1])
                        fn = lambda c_=codes, p_=p, o=ops: (  # noqa: E731
                            lc.launch_resident(c_, o, p_))
                        if not torch.equal(fn(), want):
                            sys.exit(f"K1 plan {p} differs from plain")
                        rows_out.append({
                            "task": task, "batch": b, "rows": r,
                            "ctas_per_sm": c, "grid": p.grid,
                            "smem_bytes": p.smem_bytes,
                            "default": (r, c) == (default.rows,
                                                  default.ctas_per_sm),
                            **timed(fn, "cascade_resident_kernel")})
        out["k1_sweep"] = rows_out
    print(json.dumps(out), flush=True)
    print(cs.smi_line())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    main(args.src, args.label, args.sweep)
