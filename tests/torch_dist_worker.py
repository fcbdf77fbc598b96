"""Multi-rank checks of the port's distribution layer, one process a rank.

``spawn(job, world, tmp_path)`` starts ``world`` fresh interpreters
running this file, each joining a gloo group through a ``FileStore`` under
``tmp_path`` (no TCP port), on one torch thread; each runs ``job`` and
saves what it returns as ``tmp_path/rank<r>.pt``.  A rank that fails or
outlives ``timeout`` fails the spawn (every rank is killed).  Nothing here
imports JAX: the reference's numbers are computed by the test itself.
"""
import contextlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def spawn(job: str, world: int, tmp_path, timeout: float = 120.0, args=()):
    """Run ``job`` on ``world`` ranks; returns each rank's result."""
    return collect(start(job, world, tmp_path, args), timeout)


def start(job: str, world: int, tmp_path, args=()):
    """Start ``job`` on ``world`` ranks (the caller works meanwhile);
    :func:`collect` waits for them."""
    tmp = Path(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    for k in [k for k in env if k.startswith("REPRO_")]:
        del env[k]
    procs = []
    for r in range(world):      # output to a file: no pipe to fill meanwhile
        with open(tmp / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, job, str(r), str(world), str(tmp),
                 *map(str, args)], env=env, cwd=str(ROOT), stdout=log,
                stderr=subprocess.STDOUT))
    return procs, tmp


def collect(started, timeout: float = 120.0):
    """Each rank's result of a :func:`start`; a rank that fails or
    outlives ``timeout`` (counted from this call) fails it, every rank
    killed."""
    procs, tmp = started
    world = len(procs)
    end = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(r, p.returncode, (tmp / f"rank{r}.log").read_text()[-3000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, bad
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# ---------------------------------------------------------------------------
# inputs both sides build from numpy seeds
# ---------------------------------------------------------------------------

def compress_inputs(rank: int):
    """Rank ``rank``'s gradient and error trees (f32 numpy)."""
    rng = np.random.default_rng(700 + rank)
    g = {"a": rng.normal(size=(64,)).astype(np.float32) * 3.0,
         "b": {"w": rng.normal(size=(8, 16)).astype(np.float32)}}
    e = {"a": rng.normal(size=(64,)).astype(np.float32) * 0.01,
         "b": {"w": np.zeros((8, 16), np.float32)}}
    return g, e


def gpipe_inputs():
    """(ws [8, 16, 16], xs [6, 2, 8, 16]) of the GPipe check."""
    rng = np.random.default_rng(11)
    ws = (rng.normal(size=(8, 16, 16)) * 0.5).astype(np.float32)
    xs = rng.normal(size=(6, 2, 8, 16)).astype(np.float32)
    return ws, xs


def train_batches(cfg, steps: int, batch: int, seq: int):
    """Fixed token batches (numpy seeded) of a smoke config."""
    rng = np.random.default_rng(5)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab, size=(batch, seq + 1))
        out.append({"tokens": torch.from_numpy(toks[:, :-1]),
                    "labels": torch.from_numpy(toks[:, 1:])})
    return out


# ---------------------------------------------------------------------------
# jobs (run inside a rank)
# ---------------------------------------------------------------------------

def job_compress(rank, world, tmp):
    import torch.distributed as dist
    from repro_torch.dist import compress
    g, e = compress_inputs(rank)
    tg = {"a": torch.from_numpy(g["a"]), "b": {"w": torch.from_numpy(
        g["b"]["w"])}}
    te = {"a": torch.from_numpy(e["a"]), "b": {"w": torch.from_numpy(
        e["b"]["w"])}}
    mean, new_err = compress.compressed_psum(tg, te, dist.group.WORLD)
    return {"mean": mean, "err": new_err}


def job_gpipe(rank, world, tmp):
    from repro_torch.dist import pipeline
    from repro_torch.launch import mesh as mesh_mod
    mesh = mesh_mod.make_mesh((world,), ("pipe",), device="cpu")
    ws, xs = gpipe_inputs()
    lps = ws.shape[0] // world
    fn = pipeline.make_pipelined_fn(
        lambda w, x: torch.tanh(x @ w), mesh, axis_name="pipe",
        n_stages=world, layers_per_stage=lps)
    out = fn(torch.from_numpy(ws[rank * lps:(rank + 1) * lps]),
             torch.from_numpy(xs))
    return {"out": out, "ticks": fn.ticks}


def _submesh(world: int, shape):
    """This rank's (data, model) mesh of ``shape``: the world split into
    ``world / (d * m)`` replicas of it."""
    from torch.distributed.device_mesh import init_device_mesh
    reps = world // (shape[0] * shape[1])
    mesh = init_device_mesh("cpu", (reps, *shape),
                            mesh_dim_names=("rep", "data", "model"))
    return mesh["data", "model"]


# The meshed-training check's configs: each family's f32 smoke config
# widened so that the sharding rules split leaves (a trailing dim of 512 or
# more): d_model 520 (embeddings, norms, output projections, the MoE
# router), d_ff 517 (the FFN; uneven on 2 and on 4 ranks of ``model``) and
# a vocabulary padded to 768 (the untied head).  head_dim stays 16.
WIDE = dict(d_model=520, head_dim=16, d_ff=517, vocab=600, loss_chunk=8,
            dtype="float32")
# AdamW of the check (eps 1e-3: see tests/test_torch_mesh_train.py)
MESH_OPT = dict(lr=1e-3, weight_decay=0.1, eps=1e-3)
MESH_STEPS, MESH_BATCH, MESH_SEQ = 2, 8, 16


def _mesh_run(cfg, mesh, batches, ckpt=None):
    """``MESH_STEPS`` steps of ``cfg`` from seed 0 through the training
    loop (unmeshed when ``mesh`` is None; a checkpoint in ``ckpt``, written
    by rank 0): losses, grad norms, whole parameters and AdamW moments in
    ``lm.leaves`` order, and each sharded parameter's (name, placements,
    local shape, whole shape) on this rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.train import loop, optim
    ocfg = optim.AdamWConfig(**MESH_OPT)
    params = steps.init_fn(cfg)(torch.Generator().manual_seed(0), "cpu")
    if mesh is None:
        step = steps.make_train_step(cfg, opt_cfg=ocfg)
    else:
        params = shd.distribute_params(params, mesh)
        step = steps.make_mesh_train_step(cfg, mesh, opt_cfg=ocfg)
    state = loop.LoopState(params=params, opt_state=steps.opt_init(params),
                           codec=steps.StateCodec())
    state = loop.run(
        loop.LoopConfig(total_steps=len(batches), ckpt_dir=ckpt,
                        ckpt_write=mesh is None or dist.get_rank() == 0),
        state, step, lambda i: batches[i] if mesh is None
        else steps.shard_batch(batches[i], mesh))
    hist = state.metrics_history
    sharded = [(n, str(p.placements), tuple(p.to_local().shape),
                tuple(p.shape)) for n, p in state.params.named_parameters()
               if isinstance(p, DTensor)
               and any(isinstance(q, Shard) for q in p.placements)]
    return {"losses": [m["loss"] for m in hist],
            "grad_norms": [m["grad_norm"] for m in hist],
            "params": [shd.full(p.detach()).clone()
                       for p in steps.train_leaves(state.params)],
            "m": [shd.full(t).clone() for t in state.opt_state.m],
            "v": [shd.full(t).clone() for t in state.opt_state.v],
            "sharded": sharded}


def job_mesh_train(rank, world, tmp):
    import dataclasses
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt import checkpoint
    from repro_torch.configs import lm_archs
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps, train
    out = {}
    ckpt = str(Path(tmp) / "ckpt")
    for arch in ("gemma-2b", "mixtral-8x22b"):
        cfg = dataclasses.replace(lm_archs.smoke(arch), **WIDE)
        batches = train_batches(cfg, MESH_STEPS, MESH_BATCH, MESH_SEQ)
        for shape in ((2, 2), (2, 1), (1, 2)):
            out[(arch, shape)] = _mesh_run(
                cfg, _submesh(world, shape), batches,
                ckpt if (arch, shape) == ("gemma-2b", (2, 2)) else None)
        if rank == 0:
            out[(arch, None)] = _mesh_run(cfg, None, batches)
    checkpoint.wait_pending()
    dist.barrier()
    # the (2, 2) checkpoint restored at (1, 1) and (1, 4)
    cfg = dataclasses.replace(lm_archs.smoke("gemma-2b"), **WIDE)
    for shape in ((1, 1), (1, 4)):
        mesh = _submesh(world, shape)
        params = shd.distribute_params(steps.init_fn(cfg)(
            torch.Generator().manual_seed(1), "cpu"), mesh)
        opt = steps.opt_init(params)
        codec = steps.StateCodec()
        tree, step = checkpoint.restore(ckpt, codec.to_tree(params, opt))
        params, opt = codec.from_tree(tree, params, opt)
        out[("restore", shape)] = {
            "step": step, "opt_step": opt.step,
            "params": [shd.full(p.detach()).clone()
                       for p in steps.train_leaves(params)],
            "m": [shd.full(t).clone() for t in opt.m],
            "v": [shd.full(t).clone() for t in opt.v],
            "local_shapes": [tuple(p.to_local().shape)
                             for p in steps.train_leaves(params)
                             if isinstance(p, DTensor)]}
    # the CLI at 2,2 (bf16 smoke; rank 0 writes its checkpoint)
    cli_ckpt = str(Path(tmp) / "cli_ckpt")
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "2", "--batch", "8",
            "--seq", "16", "--device", "cpu", "--ckpt-dir", cli_ckpt]
    state = train.main(argv + ["--mesh", "2,2"])
    out["cli"] = [m["loss"] for m in state.metrics_history]
    checkpoint.wait_pending()
    dist.barrier()
    out["cli_ckpt_step"] = checkpoint.latest_step(cli_ckpt)
    if rank == 0:
        plain = train.main(argv[:-2])
        out["cli_plain"] = [m["loss"] for m in plain.metrics_history]
    # constrain: identity outside the rules, a redistribute inside
    from repro_torch.dist import act_sharding
    mesh = _submesh(world, (2, 2))
    x = shd.distribute(torch.arange(32.0).reshape(4, 8), mesh, shd.Spec())
    with act_sharding.activation_rules(mesh):
        y = act_sharding.constrain(x, "batch", "heads")
        plain = torch.ones(3)
        same_plain = act_sharding.constrain(plain, "batch") is plain
    out["constrain"] = (act_sharding.constrain(x, "batch") is x, same_plain,
                        [(type(p).__name__, getattr(p, "dim", None))
                         for p in y.placements],
                        tuple(y.to_local().shape),
                        torch.equal(y.full_tensor(), x.full_tensor()))
    return out


# The tensor-parallel check's configs (f32, ``WIDE`` widths): attention
# wide enough that the rules split it.  "gemma": MQA, wq 512 wide (32 heads
# of 16), tied head, local heads on 2 and 4 ranks; "qwen": qkv biases, wk
# and wv 512 wide (sharded, gathered whole), untied head; "chameleon" (the
# vlm family, qk-norm): 33 heads, so no mesh splits them (q whole).
TP_CONFIGS = {
    "gemma": ("gemma-2b", dict(n_heads=32, n_kv_heads=1)),
    "qwen": ("qwen2-72b", dict(n_heads=64, n_kv_heads=32)),
    "chameleon": ("chameleon-34b", dict(n_heads=33, n_kv_heads=3)),
}
TP_MESHES = ((1, 2), (2, 2), (1, 4))
TP_SERVE_MESHES = ((1, 2), (1, 4))
TP_PROMPT, TP_CONTEXT, TP_DECODE = 12, 24, 4


def tp_config(name: str):
    """The port's config of ``TP_CONFIGS[name]``."""
    import dataclasses
    from repro_torch.configs import lm_archs
    arch, extra = TP_CONFIGS[name]
    return dataclasses.replace(lm_archs.smoke(arch), **WIDE, **extra)


def tp_prompts(cfg):
    """(prompt [MESH_BATCH, TP_PROMPT], decode tokens [TP_DECODE,
    MESH_BATCH, 1]) of the serving check (numpy seeded)."""
    rng = np.random.default_rng(9)
    return (torch.from_numpy(rng.integers(0, cfg.vocab,
                                          (MESH_BATCH, TP_PROMPT))),
            torch.from_numpy(rng.integers(0, cfg.vocab,
                                          (TP_DECODE, MESH_BATCH, 1))))


def _tp_serve(cfg, model, mesh):
    """Prefill (last-token logits and cache) and ``TP_DECODE`` decode
    steps' logits through ``build_cell``'s serving steps on ``mesh``
    (``model`` unmeshed when ``mesh`` is None), whole tensors."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm
    prompt, toks = tp_prompts(cfg)
    if mesh is None:
        logits, cache = lm.prefill(model, cfg, prompt, TP_CONTEXT)
        out = {"prefill": logits, "cache": dict(cache), "decode": []}
        for t in toks:
            logits, cache = lm.decode_step(model, cfg, cache, t)
            out["decode"].append(logits)
        return out
    dp = shd.dp_axes(mesh)
    pre, _ = steps.build_cell(cfg, steps.ShapeSpec(
        "tp_prefill", TP_CONTEXT, MESH_BATCH, "prefill"), mesh)
    dec, _ = steps.build_cell(cfg, steps.ShapeSpec(
        "tp_decode", TP_CONTEXT, MESH_BATCH, "decode"), mesh)
    logits, cache = pre(model, shd.distribute(prompt, mesh,
                                              shd.Spec(dp, None)))
    out = {"prefill": shd.full(logits),
           "cache": {k: shd.full(v) for k, v in cache.items()},
           "decode": [], "logits_placements": str(logits.placements)}
    for t in toks:
        logits, cache = dec(model, cache, shd.distribute(
            t, mesh, shd.Spec(dp, None)))
        out["decode"].append(shd.full(logits))
    return out


class _GatherLog:
    """A dispatch mode that keeps the output shape of every all-gather."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        log = self.shapes = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                if "all_gather" in str(func):
                    log.append(tuple(out.shape))
                return out
        self.mode = Mode()


def _tp_block(cfg, model, mesh):
    """Block 0's training forward and backward on this rank (``mesh``
    None: the whole model): (flops, the all-gathers' output shapes), on
    the tensor-parallel view, and on the gather view for contrast."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.dist import act_sharding
    from repro_torch.models import lm
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(MESH_BATCH, MESH_SEQ, cfg.d_model)).astype(np.float32))
    freqs = lm._freqs(cfg, "cpu")
    out = {}
    views = [("whole", lambda m: m)] if mesh is None else \
        [("tp", lm.tp_view), ("gather", lm.local_view)]
    for name, view in views:
        blk = lm.cast_view(view(lm.trainable(model)).blocks[0],
                           torch.float32)
        log = _GatherLog()
        flops = FlopCounterMode(display=False)
        rules = act_sharding.activation_rules(mesh) if mesh is not None \
            else contextlib.nullcontext()
        with rules:     # the tensor-parallel residual: this rank's columns
            xs = act_sharding.model_slice(x, -1) if name == "tp" else x
            xs = xs.clone().requires_grad_(True)
            with flops, log.mode, torch.enable_grad():
                y, _ = lm._block_train(cfg, blk, xs, range(MESH_SEQ), freqs)
                y.sum().backward()
        out[name] = {"flops": flops.get_total_flops(),
                     "gathers": log.shapes}
    return out


def job_tensor_parallel(rank, world, tmp):
    import torch.distributed as dist
    from repro_torch.launch import steps
    out = {}
    for name in TP_CONFIGS:
        cfg = tp_config(name)
        batches = train_batches(cfg, MESH_STEPS, MESH_BATCH, MESH_SEQ)
        for shape in TP_MESHES:
            mesh = _submesh(world, shape)
            out[(name, shape)] = _mesh_run(cfg, mesh, batches)

            out[(name, shape, "design")] = steps.design(cfg, mesh)
        model = steps.init_fn(cfg)(torch.Generator().manual_seed(0), "cpu")
        if rank == 0:
            out[(name, None)] = _mesh_run(cfg, None, batches)
            out[(name, None, "serve")] = _tp_serve(cfg, model, None)
            out[(name, None, "block")] = _tp_block(cfg, model, None)
        from repro_torch.dist import sharding as shd
        for shape in TP_SERVE_MESHES:
            mesh = _submesh(world, shape)
            model = steps.init_fn(cfg)(torch.Generator().manual_seed(0),
                                       "cpu")
            model = shd.distribute_params(model, mesh)
            out[(name, shape, "serve")] = _tp_serve(cfg, model, mesh)
            if shape == (1, 4):
                out[(name, shape, "block")] = _tp_block(cfg, model, mesh)
    out["eager_gather"] = _eager_gather_check(world)
    dist.barrier()
    return out


def _eager_gather_check(world):
    """(the eager all-gather's result and gradient equal the functional
    one's, 6 tied-table rows over 4 ranks of ``model`` raise)."""
    from repro_torch.dist import act_sharding
    mesh = _submesh(world, (1, 4))
    x = torch.randn(3, 2, 517, generator=torch.Generator().manual_seed(4))
    got = []
    orig = act_sharding._eager_gather
    try:
        for eager in (False, True):
            act_sharding._eager_gather = lambda group, t, e=eager: e
            with act_sharding.activation_rules(mesh):
                xs = act_sharding.model_slice(x, -1).requires_grad_(True)
                y = act_sharding.gather_model(xs, 517, "x")
                (y * torch.arange(517.0)).sum().backward()
            got.append((y.detach(), xs.grad))
    finally:
        act_sharding._eager_gather = orig
    same = torch.equal(got[0][0], got[1][0]) and torch.equal(
        got[0][1], got[1][1]) and torch.equal(got[0][0], x)
    try:
        with act_sharding.activation_rules(mesh):
            act_sharding.rows_from_columns(torch.zeros(6, 130), 520)
        raised = False
    except ValueError:
        raised = True
    return same, raised


def main():
    job, rank, world, tmp = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(str(Path(tmp) / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        res = globals()["job_" + job](rank, world, tmp)
        torch.save(res, Path(tmp) / f"rank{rank}.pt")

    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
