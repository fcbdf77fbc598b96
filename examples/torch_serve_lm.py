"""Batched serving demo on the port (the counterpart of
``examples/serve_lm.py``): continuous batching over the decode cells' code
path (prefill -> slot splice -> batched decode ticks) through
``repro_torch.serve.engine.ServeEngine``.

    PYTHONPATH=src python examples/torch_serve_lm.py --requests 6 --slots 2
        [--device cpu]

Serves the architecture's smoke config on random weights drawn by a
``torch.Generator`` on the chosen device (seed 0); runs on CUDA unless
``--device`` says else.  Even requests decode greedily, odd ones sample at
temperature 0.8.
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import lm_archs
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=list(lm_archs.ARCHS))
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-tokens", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain path (default: the card)")
    args = ap.parse_args()

    cfg = dataclasses.replace(lm_archs.smoke(args.arch), remat=False)
    if cfg.is_enc_dec:
        raise SystemExit("serve demo targets decoder-only archs")
    dev = _device.resolve(args.device)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    print(f"== serving {args.arch} (smoke config, "
          f"{cfg.n_params() / 1e6:.1f}M params), {args.slots} slots, "
          f"continuous batching on {dev}")

    eng = ServeEngine(cfg, params, slots=args.slots, context=64, device=dev)
    g = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=g.integers(0, cfg.vocab,
                                      args.prompt_len).astype(np.int32),
                    max_tokens=args.max_tokens,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    for r in sorted(done, key=lambda r: r.rid):
        mode = "greedy" if r.temperature == 0 else f"T={r.temperature}"
        print(f"  req {r.rid} [{mode}]: {r.out_tokens}")
    s = eng.stats
    print(f"== {len(done)} requests, {s.prefills} prefills, "
          f"{s.decode_steps} batched decode ticks, {s.tokens_out} tokens "
          f"in {dt:.2f}s ({s.tokens_out / dt:.1f} tok/s on {dev})")


if __name__ == "__main__":
    main()
