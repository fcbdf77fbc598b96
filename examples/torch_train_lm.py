"""End-to-end LM training on the port's production loop (the counterpart
of ``examples/train_lm.py``).

Trains a small member of an architecture family on the synthetic token
corpus through the port's substrate: the train step of
``launch/steps.py`` (K5 in every attention forward on the card, the
chunked loss, AdamW with a cosine schedule), atomic async checkpoints in
the reference's format, straggler flags and replay of a failed step.

    PYTHONPATH=src python examples/torch_train_lm.py --arch gemma-2b \\
        --steps 200 [--device cpu]
    PYTHONPATH=src python examples/torch_train_lm.py --arch mixtral-8x22b \\
        --steps 300 --d-model 512 --layers 8      # ~100M-parameter MoE

Runs on CUDA unless ``--device`` says else.
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch import device as _device
from repro_torch.configs import lm_archs
from repro_torch.data import jax_prng, tokens
from repro_torch.launch import steps
from repro_torch.train import loop as train_loop, optim


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b", choices=list(lm_archs.ARCHS))
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    base = lm_archs.smoke(args.arch)
    n_heads = max(4, args.d_model // 32)
    cfg = dataclasses.replace(
        base, d_model=args.d_model, n_layers=args.layers,
        n_heads=n_heads, n_kv_heads=max(1, n_heads // 2), head_dim=None,
        d_ff=args.d_model * 4, vocab=args.vocab,
        loss_chunk=min(64, args.seq))
    dev = _device.resolve(args.device)
    print(f"== {args.arch} family, ~{cfg.n_params() / 1e6:.1f}M params, "
          f"on {dev}")

    params = steps.init_fn(cfg)(torch.Generator(dev).manual_seed(0), dev)
    ocfg = optim.AdamWConfig(
        lr=args.lr, weight_decay=0.1,
        schedule=optim.cosine_schedule(args.steps, warmup=20))
    step_fn = steps.make_train_step(cfg, opt_cfg=ocfg)
    corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))

    def batch_fn(step):
        toks = corpus.sample_batch(step, args.batch)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_enc_dec:
            batch["audio_embed"] = jax_prng.normal(
                jax_prng.prng_key(step), (args.batch, args.seq, cfg.d_model))
        return steps.batch_on(batch, dev)

    def log(step, m):
        print(f"step {step:5d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.2f}  {m['step_time_s'] * 1e3:.0f} ms"
              + ("  [STRAGGLER]" if m.get("straggler") else ""))

    state = train_loop.LoopState(params=params,
                                 opt_state=steps.opt_init(params),
                                 codec=steps.StateCodec())
    lcfg = train_loop.LoopConfig(total_steps=args.steps,
                                 ckpt_dir=args.ckpt_dir, ckpt_every=50,
                                 log_every=10)
    state = train_loop.run(lcfg, state, step_fn, batch_fn, log)
    if not state.metrics_history:
        print(f"== nothing to do: {args.ckpt_dir} holds step {state.step}")
        return
    first = state.metrics_history[0]["loss"]
    last = state.metrics_history[-1]["loss"]
    print(f"== done: loss {first:.3f} -> {last:.3f} over {state.step} steps "
          f"({state.failures} recovered failures, "
          f"{len(state.straggler.events)} straggler flags)")
    if last >= first:
        raise SystemExit("training did not reduce the loss")


if __name__ == "__main__":
    main()
