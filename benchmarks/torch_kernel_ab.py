"""K5's TF32 route and K2 of one source tree, timed on the card.

    python benchmarks/torch_kernel_ab.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this tree's ``src``), so
that two trees -- a commit and its parent unpacked beside it -- are timed
by the same code in one call, in turns.  It times, each as CUDA events
around 40 calls (median of 5 runs) and as the device time of every kernel
the call launches in the profiler's trace:

* K5's non-wgmma route (``flash_attention_tf32_cuda``, or the parent's
  ``flash_attention_simt_cuda``) on what ``route()`` sends it at one
  gemma-2b prefill layer: f32 q ``[1, 8, 1024, 256]`` (the model's strided
  view), k/v ``[1, 1, 1024, 256]``, causal; and bf16 at head dim 16 (the
  smoke configs') on the same heads and length;
* f32 ``scaled_dot_product_attention`` on the same inputs, with the names
  of the kernels it launches (a yardstick; the port never calls it);
* K2 (``lut_cascade_streamed``) at ``mnist`` (random int8 tables, one
  block of 1024 rows, the plan's unit_tile), checked bit for bit against
  the plain cascade.

Prints one JSON line and the card's ``name, power.limit``.  Imports
nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(src: Path, label: str) -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                     # timing helpers of this tree
    sys.path.insert(0, str(src))
    import numpy as np
    import torch
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lut_cascade as lc

    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this needs a GPU")
    if not str(Path(fa.__file__).resolve()).startswith(str(src.resolve())):
        sys.exit(f"repro_torch came from {fa.__file__}, not {src}")
    dev = torch.device("cuda")
    out = {"label": label, "src": str(src)}

    def timed(fn):
        _, prof = cs.profile(fn)
        return {"ms": cs.per_call_ms(fn),
                "device_ms": sum(s for _, s in prof.values()) * 1e3 / 10,
                "kernels": sorted(k[:100] for k in prof)}

    k5 = getattr(fa, "flash_attention_tf32_cuda", None) or \
        fa.flash_attention_simt_cuda
    q, k, v = cs.k5_inputs(1, 8, 1, 1024, 1024, 256, 0, dev)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    got = k5(q, k, v)
    err = float((got - fa.flash_attention_plain(q, k, v)).abs().max())
    out["k5_f32"] = {**timed(lambda: k5(q, k, v)), "max_abs_err": err}
    out["sdpa_f32"] = timed(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True))
    q, k, v = cs.k5_inputs(1, 8, 1, 1024, 1024, 16, 16, dev, torch.bfloat16)
    q = q.transpose(1, 2).contiguous().transpose(1, 2)
    out["k5_bf16_d16"] = timed(lambda: k5(q, k, v))
    del q, k, v, got

    cfg = paper_tasks.task_config("mnist")
    plan = pipeline.CompiledLUTNetwork(
        cfg, *cs.random_network(cfg, 0), device=dev
    ).compile_backend("fused").plan
    layers = tuple(tuple(int(x) for x in l) for l in plan.meta["layers"])
    tables = plan.tensor("tables", dev)
    maps = [plan.tensor(f"map_{l}", dev) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    ops = lc.prepare(tables, layers, maps)
    ut = plan.meta["tuning"]["unit_tile"]
    codes = torch.from_numpy(np.random.RandomState(1).randint(
        0, 2, (1024, layers[0][0])).astype(np.int32)).to(dev)
    fn = lambda: lc.lut_cascade_streamed(codes, ops, unit_tile=ut)  # noqa: E731
    if not torch.equal(fn(), lc.lut_cascade_plain(codes, tables, maps,
                                                  layers)):
        sys.exit("K2 differs from the plain cascade")
    out["k2_mnist_1024"] = {**timed(fn), "unit_tile": ut}
    print(json.dumps(out), flush=True)
    print(cs.smi_line())


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    main(args.src, args.label)
