"""Cluster plans of K2, the streamed cascade, on the card.

    python benchmarks/torch_k2_cluster.py [--threads 128,256,512]

K2 (``src/repro_torch/kernels/csrc/lut_kernels.cu`` ``cascade_streamed_
kernel``) splits the cascade over a thread-block cluster: C CTAs share a
batch tile of R rows, each owning 1/C of every layer's units
(``kernels/lut_cascade.py`` ``plan_cluster``).  C and R are launch
arguments, so one build serves every plan; the CTA's thread count is a
constant of the source, so each ``--threads`` value builds a copy of the
source with ``kClusterThreads`` rewritten (all ``nvcc`` at once).

At ``mnist`` (Table II widths, random int8 tables [5110, 64], one main-path
block of 1024 rows, the plan's unit_tile) every variant -- C in {1, 2, 4,
8}, R in {4, 8, 16, 32, 64}, resident where the CTA's share fits and the
ring where it does not, and the ring forced at C 8 -- is held bit for bit
against ``lut_cascade_plain`` and timed: CUDA events around 40 calls
(median of 5 runs) and the kernel's own time in the profiler's trace.
Prints one JSON line per variant (plan, bytes a CTA, clusters resident at
once, ms, device ms), then the card's ``name, power.limit``.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CLUSTERS = (1, 2, 4, 8)
ROWS = (4, 8, 16, 32, 64)


PAT = r"constexpr int kClusterThreads = (\d+);"


def _committed_threads() -> int:
    """``kClusterThreads`` of the committed source."""
    from repro_torch.kernels import build
    found = re.findall(PAT, build.SOURCES["lut_kernels"].read_text())
    if len(found) != 1:
        raise RuntimeError("kClusterThreads not found once in the source")
    return int(found[0])


def _libraries(threads):
    """{threads: ctypes library} built from copies of the source with
    ``kClusterThreads`` rewritten, compiled at once."""
    from repro_torch.kernels import build
    src = build.SOURCES["lut_kernels"].read_text()

    out_dir = build.BUILD_DIR / "k2_cluster"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for t in threads:
        cu = out_dir / f"lut_kernels_t{t}.cu"
        cu.write_text(re.sub(PAT, f"constexpr int kClusterThreads = {t};",
                             src))
        so = out_dir / f"liblut_kernels_t{t}.so"
        procs[t] = (so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for t, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {t} threads:\n{err}")
        lib = ctypes.CDLL(str(so))
        for name, sig in build._SIGNATURES["lut_kernels"].items():
            fn = getattr(lib, name)
            fn.argtypes = list(sig)
            fn.restype = ctypes.c_int
        libs[t] = lib
    return libs


def main(threads) -> None:
    import numpy as np
    import torch
    from chip_smoke import per_call_ms, profile, random_network, smi_line
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.kernels import build, lut_cascade as lc

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this sweep needs a GPU")
    dev = torch.device("cuda")
    smi = smi_line()
    libs = _libraries(threads)
    committed = _committed_threads()
    cfg = paper_tasks.task_config("mnist")
    net = pipeline.CompiledLUTNetwork(cfg, *random_network(cfg, 0),
                                      device=dev)
    plan = net.compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    tables = plan.tensor("tables", dev)
    maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    ops = lc.prepare(tables, layers, maps)
    ut = plan.meta["tuning"]["unit_tile"]
    isz, asz = tables.element_size(), lc.act_itemsize(layers)
    codes = torch.from_numpy(np.random.RandomState(1).randint(
        0, 2, (1024, layers[0][0])).astype(np.int32)).to(dev)
    want = lc.lut_cascade_plain(codes, tables, maps, layers)
    default = lc.plan_cluster(layers, isz, unit_tile=ut,
                              max_entries=tables.shape[1])

    plans = []
    for c in CLUSTERS:
        for r in ROWS:
            try:
                plans.append(lc.plan_cluster(layers, isz, unit_tile=ut,
                                             max_entries=tables.shape[1],
                                             cluster=c, rows=r))
            except ValueError:
                continue
    for r in (8, 32):                     # the ring where the share fits
        g = -(-ut // lc.GROUP) * lc.GROUP
        p = lc.plan_cluster(layers, isz, unit_tile=ut, cluster=8, rows=r)
        plans.append(lc.ClusterPlan(
            8, r, g, p.a_pad, lc.cluster_smem_bytes(
                layers, isz, 8, r, g, tables.shape[1]), p.ranges,
            p.input_ranges))

    for t, lib in libs.items():
        for p in plans:
            n = ctypes.c_int(0)
            build.check(lib.lut_cascade_streamed_max_clusters(
                isz, asz, int(bool(p.ring_units)), p.cluster, p.smem_bytes,
                ctypes.byref(n)), "max clusters")
            row = {"threads": t, "cluster": p.cluster, "rows": p.rows,
                   "route": p.route, "ring_units": p.ring_units,
                   "smem_bytes": p.smem_bytes, "max_active_clusters": n.value,
                   "default": p == default and t == committed}
            if n.value < 1:
                print(json.dumps({**row, "skipped": "does not fit"}))
                continue
            ncl = min(-(-1024 // p.rows), n.value)
            row["clusters_launched"] = ncl
            out = torch.empty_like(want)

            def call(p=p, ncl=ncl, lib=lib, out=out):
                stream = torch.cuda.current_stream().cuda_stream
                build.check(lib.lut_cascade_streamed_launch(
                    codes.data_ptr(), ops.tables.data_ptr(), isz,
                    ops.maps.data_ptr(), ops.desc.data_ptr(), len(layers),
                    1024, layers[0][0], tables.shape[1], p.a_pad, asz,
                    ops.max_fan, p.cluster, p.rows, p.ring_units, ncl,
                    p.smem_bytes, out.data_ptr(), stream), "K2")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                sys.exit(f"K2 variant {row} differs from the plain cascade")
            row["ms"] = per_call_ms(call)
            _, prof = profile(call)
            row["device_ms"] = sum(sec for key, (_, sec) in prof.items()
                                   if "cascade_streamed_kernel" in key
                                   ) * 1e3 / 10
            print(json.dumps(row), flush=True)
    print(smi)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", default="256,512",
                    help="comma-separated CTA sizes to build and time")
    args = ap.parse_args()
    main(tuple(int(t) for t in args.threads.split(",")))
