"""Training entry point (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --steps 50 [--ckpt-dir DIR] [--device cpu]

The reference's flags, on the port's loop (``train/loop.py``): AdamW with
a cosine schedule, the synthetic token corpus, atomic async checkpoints,
straggler flags and replay.  ``--smoke`` trains the family's reduced
config; without it the full config (a card's worth of memory).  Runs on
CUDA unless ``--device`` says else.  ``--mesh`` takes only ``1,1``: the
(data, model) meshes come with the distribution slice (ROADMAP A.14d).
"""
import argparse
import dataclasses
from typing import List, Optional

import torch

from repro_torch import device as _device
from repro_torch.configs import lm_archs
from repro_torch.data import jax_prng, tokens
from repro_torch.launch import steps
from repro_torch.train import loop as train_loop, optim


def main(argv: Optional[List[str]] = None) -> train_loop.LoopState:
    """Parse ``argv``, train, print a line every 10 steps; returns the
    loop's final state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(lm_archs.ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default=None,
                    help="data,model (only 1,1: one device)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--remat-group", type=int, default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    if args.mesh and tuple(int(x) for x in args.mesh.split(",")) != (1, 1):
        raise SystemExit(f"--mesh {args.mesh}: the port trains on one device "
                         "(1,1); meshes come with ROADMAP A.14d")
    cfg = lm_archs.smoke(args.arch) if args.smoke else lm_archs.get(args.arch)
    cfg = dataclasses.replace(cfg, remat_group=args.remat_group,
                              loss_chunk=min(cfg.loss_chunk, args.seq))
    dev = _device.resolve(args.device)
    params = steps.init_fn(cfg)(torch.Generator(dev).manual_seed(0), dev)
    opt_state = steps.opt_init(params)
    ocfg = optim.AdamWConfig(lr=args.lr, weight_decay=0.1,
                             schedule=optim.cosine_schedule(args.steps,
                                                            warmup=10))
    step_fn = steps.make_train_step(cfg, opt_cfg=ocfg)
    corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))

    def batch_fn(step):
        toks = corpus.sample_batch(step, args.batch)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_enc_dec:          # jax.random.normal(PRNGKey(step), ...)
            b["audio_embed"] = jax_prng.normal(
                jax_prng.prng_key(step), (args.batch, args.seq, cfg.d_model))
        return steps.batch_on(b, dev)

    def log(step, m):
        print(f"step {step:5d} loss {m['loss']:.4f} "
              f"({m['step_time_s'] * 1e3:.0f} ms)")

    state = train_loop.LoopState(params=params, opt_state=opt_state,
                                 codec=steps.StateCodec())
    lcfg = train_loop.LoopConfig(total_steps=args.steps,
                                 ckpt_dir=args.ckpt_dir, log_every=10)
    state = train_loop.run(lcfg, state, step_fn, batch_fn, log)
    print(f"{args.arch}: {state.step} steps on {dev}, loss "
          f"{state.metrics_history[0]['loss']:.4f} -> "
          f"{state.metrics_history[-1]['loss']:.4f}"
          if state.metrics_history else f"{args.arch}: resumed at step "
          f"{state.step} of {args.steps}")
    return state


if __name__ == "__main__":
    main()
