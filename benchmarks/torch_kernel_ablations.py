"""What bounds K5's TF32 kernel, K2's cluster kernel and K1's persistent
kernel: ablations on the card.

    python benchmarks/torch_kernel_ablations.py [--only k5,k2,k1]

Each variant is a copy of a committed source (``csrc/flash_attention.cu``
or ``csrc/lut_kernels.cu``) with one kind of work taken out or one
constant changed by a text replacement; all variants are compiled at once
(one ``nvcc`` each) and loaded with ``ctypes``.  The results of an
ablation are wrong on purpose and only timed; the ``committed`` variant is
also held against the plain version.  Shapes:

* K5: one gemma-2b prefill layer in f32 (q ``[1, 8, 1024, 256]`` strided,
  k/v ``[1, 1, 1024, 256]``, causal), and bf16 at head dim 16 on the same
  heads and length;
* K2: ``mnist`` (random int8 tables [5110, 64]), one block of 1024 rows,
  on the default cluster plan;
* K1: ``nid`` (random int8 tables [93, 64]), one block of 1024 rows, on
  the default plan (8 rows a tile, 128 CTAs).

Each time is the kernel's own device time in the profiler's trace (10
calls), beside CUDA events around 40 calls.  Prints one JSON line per
variant and the card's ``name, power.limit``.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

QK_MMA = "mma_split<kF32, kF32>(s[n], s2[n], ah, al, bh0, bh1, bl0, bl1);"
PV_MMA = ("mma_split<true, kF32>(acc[n], acc[n], ph, pl, bh0, bh1, bl0,\n"
          "                                  bl1);")
NEXT_K = "load_rows<T, BK>(ks + nxt, kb, sks, k0 + BK, Skv, D, ld, vec_kv);"
NEXT_V = "load_rows<T, BK>(vs + nxt, vb, svs, k0 + BK, Skv, D, ld, vec_kv);"
# name -> (source, [(text, replacement), ...]); every occurrence replaced
VARIANTS = {
    "k5 committed": ("flash_attention", []),
    # QK^T's mmas out (the fragments are still loaded and split)
    "k5 no_qk_mma": ("flash_attention", [(QK_MMA, "s[n][0] += __uint_as_float("
                                         "ah[0] ^ al[1] ^ bh0 ^ bl1);")]),
    # PV's mmas out (V fragments still loaded and split)
    "k5 no_pv_mma": ("flash_attention", [(PV_MMA, "acc[n][0] += __uint_as_float("
                                         "ph[0] ^ pl[1] ^ bh0 ^ bl1);")]),
    # one product per mma instead of three (operands rounded once)
    "k5 one_product": ("flash_attention", [
        (QK_MMA, "mma_split<false, false>(s[n], s2[n], ah, al, bh0, bh1, bl0, "
                 "bl1);"),
        (PV_MMA, "mma_split<false, false>(acc[n], acc[n], ph, pl, bh0, bh1, "
                 "bl0, bl1);")]),
    # the next K/V tile never copied (every tile reads the first one)
    "k5 no_kv_copy": ("flash_attention", [(NEXT_K, ""), (NEXT_V, "")]),
    # the exponentials as __expf
    "k5 fast_exp": ("flash_attention", [("expf(", "__expf(")]),
    # the QK^T loop over D unrolled by 4
    "k5 unroll_qk": ("flash_attention", [(
        "for (int kk = 0; kk < nd; ++kk) {",
        "_Pragma(\"unroll 4\") for (int kk = 0; kk < nd; ++kk) {")]),
    # no split: f32 operands go in whole (hi = x, lo = 0; 3 mmas still)
    "k5 no_split": ("flash_attention", [(
        "  hi = __float_as_uint(x) & 0xffffe000u;\n"
        "  lo = __float_as_uint(x - __uint_as_float(hi));",
        "  hi = __float_as_uint(x);\n  lo = 0u;")]),
    # every lane of a group reads one K row (broadcast: no bank conflicts)
    "k5 broadcast_k": ("flash_attention", [(
        "const T* kr = kt + (n * 8 + g) * ld + c;",
        "const T* kr = kt + n * 8 * ld + c;")]),
    # the mma asm not volatile (free for the compiler to schedule)
    "k5 mma_not_volatile": ("flash_attention", [(
        "  asm volatile(\n      \"mma.sync", "  asm(\n      \"mma.sync")]),
    # no compute at all: copies, waits and barriers only
    "k5 copies_only": ("flash_attention", [(
        "if (w_rows && kw < w_hi && kw + BKW > w_lo) {",
        "if (w_rows && kw < 0) {")]),
    # 64 q rows a CTA, each tile's keys over 2 warps (128 CTAs at gemma)
    "k5 bq64_ksplit2": ("flash_attention", [
        ("constexpr int QWARPS = 2;", "constexpr int QWARPS = 4;"),
        ("constexpr int KSPLIT = 4;", "constexpr int KSPLIT = 2;")]),
    # 64 q rows a CTA, one warp a row block (4 warps)
    "k5 bq64_ksplit1": ("flash_attention", [
        ("constexpr int QWARPS = 2;", "constexpr int QWARPS = 4;"),
        ("constexpr int KSPLIT = 4;", "constexpr int KSPLIT = 1;")]),
    "k2 committed": ("lut_kernels", []),
    # each CTA stores its codes into its own tile only (no remote stores)
    "k2 local_stores": ("lut_kernels", [(
        "for (int r = 0; r < C; ++r)\n",
        "for (int r = cluster.block_rank(); r <= static_cast<int>("
        "cluster.block_rank()); ++r)\n")]),
    # the resident tables and maps never copied in (lookups read garbage)
    "k2 no_table_copy": ("lut_kernels", [(
        "  if (!kRing) {                // the share of every layer, copied once",
        "  if (false) {")]),
    # no lookups at all: tables, input codes and cluster barriers only
    "k2 no_lookups": ("lut_kernels", [(
        "const int items = rows * groups;", "const int items = 0 * groups;")]),
    # no input codes broadcast (the layers read stale tiles)
    "k2 no_input": ("lut_kernels", [(
        "for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {",
        "for (int i = threadIdx.x; i < 0 * groups; i += blockDim.x) {")]),
    # mapping layers read their fan-in indices but gather no codes
    "k2 no_gather": ("lut_kernels", [(
        "a[j] = (a[j] << bits) + static_cast<int>(hr[src[j]]);",
        "a[j] = (a[j] << bits) + (src[j] & 1);")]),
    "k1 committed": ("lut_kernels", []),
    # no layers: tables, codes and the barriers only
    "k1 no_layers": ("lut_kernels", [(
        "const int items = rows * groups;\n  for (int i = threadIdx.x; "
        "i < items; i += blockDim.x) {\n    int r, grp;",
        "const int items = 0 * groups;\n  for (int i = threadIdx.x; "
        "i < items; i += blockDim.x) {\n    int r, grp;")]),
    # codes never copied in (the narrowing pass reads a stale stage)
    "k1 no_code_copy": ("lut_kernels", [
        ("  fetch(tile, 0);\n", ""),
        ("      fetch(tile + gridDim.x, (k + 1) & 1);\n", "")]),
    # tables and maps never copied in (lookups read garbage)
    "k1 no_table_copy": ("lut_kernels", [(
        "  async_copy(smem, tables, static_cast<size_t>(tables_elems) * "
        "sizeof(TabT));\n  async_copy(smem + tab_bytes, maps, "
        "static_cast<size_t>(maps_words) * 4);\n", "")]),
    # the fan-in loop of a mapping layer unrolled by 3 (its map and code
    # reads of 3 inputs issued together; K2 shares the loop)
    "k1 unroll_fan": ("lut_kernels", [(
        "    for (int f = 0; f < fan_in; ++f) {\n      int src[kGroup];",
        "    _Pragma(\"unroll 3\") for (int f = 0; f < fan_in; ++f) {\n"
        "      int src[kGroup];")]),
    # CTAs of 128 threads (nid's widest layer has 120 work items a tile)
    "k1 threads_128": ("lut_kernels", [(
        "constexpr int kResidentThreads = 256;",
        "constexpr int kResidentThreads = 128;")]),
    # the kernel returns at once: a launch of its shape and shared memory
    "k1 empty": ("lut_kernels", [(
        "  int tile = blockIdx.x;\n  if (tile >= n_tiles) return;",
        "  int tile = blockIdx.x;\n  if (tile >= 0) return;")]),
}


def _build(names):
    """{variant: ctypes library}, every copy compiled at once."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "ablations"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, name in enumerate(names):
        source, edits = VARIANTS[name]
        text = build.SOURCES[source].read_text()
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {source}")
            text = text.replace(old, new)
        cu = out_dir / f"v{i}_{source}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (source, so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (source, so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        for fn, sig in build._SIGNATURES[source].items():
            getattr(lib, fn).argtypes = list(sig)
            getattr(lib, fn).restype = ctypes.c_int
        stack = [ln.strip() for ln in err.splitlines() if "stack frame" in ln]
        libs[name] = (lib, sorted(set(stack)))
    return libs


def main(only) -> None:
    import numpy as np
    import torch
    import chip_smoke as cs
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lut_cascade as lc

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a GPU")
    dev = torch.device("cuda")
    names = [n for n in VARIANTS if n.split()[0] in only]
    libs = _build(names)

    def timed(fn, substr):
        fn()
        torch.cuda.synchronize()
        _, prof = cs.profile(fn)
        return {"ms": cs.per_call_ms(fn), "device_ms": sum(
            s for k, (_, s) in prof.items() if substr in k) * 1e3 / 10}

    k5_inputs = []
    for d, dt in ((256, torch.float32), (16, torch.bfloat16)):
        q, k, v = cs.k5_inputs(1, 8, 1, 1024, 1024, d, d, dev, dt)
        k5_inputs.append((f"{'f32' if d == 256 else 'bf16'} D {d}",
                          q.transpose(1, 2).contiguous().transpose(1, 2),
                          k, v))

    cfg = paper_tasks.task_config("mnist")
    plan = pipeline.CompiledLUTNetwork(
        cfg, *cs.random_network(cfg, 0), device=dev
    ).compile_backend("fused").plan
    layers = tuple(tuple(int(x) for x in l) for l in plan.meta["layers"])
    tables = plan.tensor("tables", dev)
    maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    ops = lc.prepare(tables, layers, maps)
    cp = lc.plan_cluster(layers, 1, unit_tile=plan.meta["tuning"]["unit_tile"],
                         max_entries=tables.shape[1])
    codes = torch.from_numpy(np.random.RandomState(1).randint(
        0, 2, (1024, layers[0][0])).astype(np.int32)).to(dev)
    want_k2 = lc.lut_cascade_plain(codes, tables, maps, layers)

    cfg1 = paper_tasks.task_config("nid")
    plan1 = pipeline.CompiledLUTNetwork(
        cfg1, *cs.random_network(cfg1, 0), device=dev
    ).compile_backend("fused").plan
    layers1 = tuple(tuple(int(x) for x in l) for l in plan1.meta["layers"])
    tables1 = plan1.tensor("tables", dev)
    maps1 = [plan1.tensor(f"map_{l}", dev) if f"map_{l}" in plan1.buffers
             else None for l in range(len(layers1))]
    ops1 = lc.prepare(tables1, layers1, maps1)
    codes1 = torch.from_numpy(np.random.RandomState(1).randint(
        0, 2, (1024, layers1[0][0])).astype(np.int32)).to(dev)
    want_k1 = lc.lut_cascade_plain(codes1, tables1, maps1, layers1)
    rp = lc.plan_resident(layers1, 1, 1024,
                          torch.cuda.get_device_properties(0)
                          .multi_processor_count,
                          max_entries=tables1.shape[1])

    for name in names:
        lib, stack = libs[name]
        row = {"variant": name, "ptxas_stack": stack}
        if name.startswith("k5"):
            for label, q, k, v in k5_inputs:
                o = torch.empty(q.shape, dtype=q.dtype, device=dev)

                def call(q=q, k=k, v=v, o=o):
                    build.check(lib.flash_attention_launch(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), 1, 8, 1, 1024, 1024, q.shape[3],
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        1, 0, 0, q.shape[3] ** -0.5,
                        0 if q.dtype == torch.float32 else 1,
                        fa.copy_width(q), fa.copy_width(k, v),
                        torch.cuda.current_stream().cuda_stream), name)
                row[label] = timed(call, "flash_attention_tf32_kernel")
                if name == "k5 committed":
                    row[label]["max_abs_err"] = float(
                        (o.float() - fa.flash_attention_plain(q, k, v)
                         .float()).abs().max())
        elif name.startswith("k1"):
            out = torch.empty_like(want_k1)

            def call(out=out):
                # the launcher's CTA size is kResidentThreads of the variant
                build.check(lib.lut_cascade_resident_launch(
                    codes1.data_ptr(), ops1.tables.data_ptr(), 1,
                    ops1.maps.data_ptr(), ops1.desc.data_ptr(), len(layers1),
                    1024, layers1[0][0], tables1.shape[1], rp.a_pad, 1,
                    ops1.tables.numel(), ops1.map_words, rp.rows, rp.grid,
                    rp.smem_bytes, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream), name)
            row["nid block 1024"] = timed(call, "cascade_resident_kernel")
            row["plan"] = [rp.rows, rp.ctas_per_sm, rp.grid, rp.smem_bytes]
            if name == "k1 committed":
                row["equal_to_plain"] = bool(torch.equal(out, want_k1))
        else:
            fit = ctypes.c_int(0)
            build.check(lib.lut_cascade_streamed_max_clusters(
                1, 1, int(bool(cp.ring_units)), cp.cluster, cp.smem_bytes,
                ctypes.byref(fit)), name)
            out = torch.empty_like(want_k2)

            def call(out=out, n=min(-(-1024 // cp.rows), fit.value)):
                build.check(lib.lut_cascade_streamed_launch(
                    codes.data_ptr(), ops.tables.data_ptr(), 1,
                    ops.maps.data_ptr(), ops.desc.data_ptr(), len(layers),
                    1024, layers[0][0], tables.shape[1], cp.a_pad, 1,
                    ops.max_fan, cp.cluster, cp.rows, cp.ring_units, n,
                    cp.smem_bytes, out.data_ptr(),
                    torch.cuda.current_stream().cuda_stream), name)
            row["mnist block 1024"] = timed(call, "cascade_streamed_kernel")
            row["plan"] = [cp.cluster, cp.rows, cp.route, cp.smem_bytes]
            if name == "k2 committed":
                row["equal_to_plain"] = bool(torch.equal(out, want_k2))
        print(json.dumps(row), flush=True)
    print(cs.smi_line())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default="k5,k2,k1")
    args = ap.parse_args()
    main(set(args.only.split(",")))
