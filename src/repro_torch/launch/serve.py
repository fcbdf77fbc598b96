"""Serving entry point (``repro.launch.serve``): the continuous-batching
engine on random weights.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
        --requests 8

Serves the architecture's smoke config, as the reference does; runs on
CUDA unless ``--device cpu``.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import lm_archs
from repro_torch.models import lm
from repro_torch.serve.engine import Request, ServeEngine


def main() -> None:
    """Parse the arguments, serve the requests, print their tokens."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(lm_archs.ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--context", type=int, default=128)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    cfg = dataclasses.replace(lm_archs.smoke(args.arch), remat=False)
    if cfg.is_enc_dec:
        raise SystemExit("serve targets decoder-only archs")
    dev = _device.resolve(args.device)
    params = lm.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, params, slots=args.slots, context=args.context,
                      device=dev)
    g = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=g.integers(0, cfg.vocab, 8).astype(
        np.int32), max_tokens=args.max_tokens)
        for i in range(args.requests)]
    done = eng.run(reqs)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"req {r.rid}: {r.out_tokens}")
    print(f"{eng.stats.tokens_out} tokens, {eng.stats.decode_steps} ticks on "
          f"{dev}")


if __name__ == "__main__":
    main()
