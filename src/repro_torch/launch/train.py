"""Training entry point (``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
        --smoke --steps 50 [--ckpt-dir DIR] [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch gemma-2b --smoke --mesh 2,2 [--device cpu]

The reference's flags, on the port's loop (``train/loop.py``): AdamW with
a cosine schedule, the synthetic token corpus, atomic async checkpoints,
straggler flags and replay.  ``--smoke`` trains the family's reduced
config; without it the full config (a card's worth of memory).  Runs on
CUDA unless ``--device`` says else.

``--mesh d,m`` trains on a (data, model) ``DeviceMesh`` of ``d * m`` ranks:
the rank and world size come from the environment (``torchrun``'s
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``; a
process without them is one rank on an in-process store), NCCL on CUDA,
gloo on the CPU.  Parameters and AdamW moments are placed by
``dist.sharding``, each batch split over ``data``
(``launch.steps.make_mesh_train_step``); every family computes each
block on its weight shards over ``model`` (tensor parallel,
``launch.steps.design``).  ``--mesh 1,1`` takes the same
path on one rank; without ``--mesh`` the unmeshed step runs.  Checkpoints
hold whole tensors in the reference's format, written by rank 0, so any
mesh restores any other's.
"""
import argparse
import dataclasses
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from repro_torch import device as _device
from repro_torch.configs import lm_archs
from repro_torch.data import jax_prng, tokens
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as mesh_mod, steps
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
                    help="data,model: train on a DeviceMesh of d*m ranks")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--remat-group", type=int, default=1)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cfg = lm_archs.smoke(args.arch) if args.smoke else lm_archs.get(args.arch)
    cfg = dataclasses.replace(cfg, remat_group=args.remat_group,
                              loss_chunk=min(cfg.loss_chunk, args.seq))
    dev = _device.resolve(args.device)
    mesh, owned = None, False
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        world = dist.get_world_size() if dist.is_initialized() else \
            int(os.environ.get("WORLD_SIZE", 1))
        if len(shape) != 2 or shape[0] * shape[1] != world:
            raise SystemExit(f"--mesh {args.mesh}: needs d*m == WORLD_SIZE "
                             f"({world})")
        dev, owned = _join(dev)
    try:
        if args.mesh:
            mesh = mesh_mod.make_mesh(shape, ("data", "model"), device=dev)
        return _train(args, cfg, dev, mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _join(dev: torch.device):
    """Join (or start) the default process group for a meshed run: the
    rank's device (``cuda:LOCAL_RANK``) and whether this call started the
    group (and so ends it)."""
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend,
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev, True


def _train(args, cfg, dev: torch.device, mesh) -> train_loop.LoopState:
    """The run itself, unmeshed (``mesh`` None) or on ``mesh``."""
    params = steps.init_fn(cfg)(torch.Generator(dev).manual_seed(0), dev)
    if mesh is not None:
        params = shd.distribute_params(params, mesh)
    opt_state = steps.opt_init(params)
    ocfg = optim.AdamWConfig(lr=args.lr, weight_decay=0.1,
                             schedule=optim.cosine_schedule(args.steps,
                                                            warmup=10))
    step_fn = steps.make_train_step(cfg, opt_cfg=ocfg) if mesh is None \
        else steps.make_mesh_train_step(cfg, mesh, opt_cfg=ocfg)
    corpus = tokens.SyntheticCorpus(tokens.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))

    def batch_fn(step):
        toks = corpus.sample_batch(step, args.batch)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if cfg.is_enc_dec:          # jax.random.normal(PRNGKey(step), ...)
            b["audio_embed"] = jax_prng.normal(
                jax_prng.prng_key(step), (args.batch, args.seq, cfg.d_model))
        b = steps.batch_on(b, dev)
        return b if mesh is None else steps.shard_batch(b, mesh)

    def log(step, m):
        print(f"step {step:5d} loss {m['loss']:.4f} "
              f"({m['step_time_s'] * 1e3:.0f} ms)")

    state = train_loop.LoopState(params=params, opt_state=opt_state,
                                 codec=steps.StateCodec())
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    lcfg = train_loop.LoopConfig(total_steps=args.steps,
                                 ckpt_dir=args.ckpt_dir, log_every=10,
                                 ckpt_write=rank0)
    state = train_loop.run(lcfg, state, step_fn, batch_fn,
                           log if rank0 else None)
    if not rank0:
        return state
    where = dev if mesh is None else f"{dev} mesh {tuple(mesh.shape)}"
    print(f"{args.arch}: {state.step} steps on {where}, loss "
          f"{state.metrics_history[0]['loss']:.4f} -> "
          f"{state.metrics_history[-1]['loss']:.4f}"
          if state.metrics_history else f"{args.arch}: resumed at step "
          f"{state.step} of {args.steps}")
    return state


if __name__ == "__main__":
    main()
