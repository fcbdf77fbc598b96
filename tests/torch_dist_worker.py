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


def _widened(arch: str, extra: dict):
    """``arch``'s smoke config at ``WIDE`` widths, then ``extra``."""
    import dataclasses
    from repro_torch.configs import lm_archs
    return dataclasses.replace(lm_archs.smoke(arch), **{**WIDE, **extra})


def tp_config(name: str):
    """The port's config of ``TP_CONFIGS[name]``."""
    return _widened(*TP_CONFIGS[name])


def tp_prompts(cfg):
    """(prompt [MESH_BATCH, TP_PROMPT], decode tokens [TP_DECODE,
    MESH_BATCH, 1]) of the serving check (numpy seeded)."""
    rng = np.random.default_rng(9)
    return (torch.from_numpy(rng.integers(0, cfg.vocab,
                                          (MESH_BATCH, TP_PROMPT))),
            torch.from_numpy(rng.integers(0, cfg.vocab,
                                          (TP_DECODE, MESH_BATCH, 1))))


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
    """Block 0's training forward and backward on this rank at
    ``MESH_BATCH x MESH_SEQ`` (:func:`_block_run`), keyed by the view:
    ``whole`` (``mesh`` None) or ``tp``."""
    return {"whole" if mesh is None else "tp":
            _block_run(cfg, model, mesh, MESH_BATCH, MESH_SEQ)}


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


# The tensor-parallel check of the other families (f32, ``WIDE`` widths,
# each split by the rules): "mixtral" (4 experts, top 2; 32 heads of 16 on
# 8 KV heads; at 16 tokens a group every expert holds every token), "dbrx"
# (6 experts, top 4, capacity factor 0.5: 8 slots an expert, so tokens are
# dropped), "hymba" (the hybrid: d_model 521,
# so d_inner 1,042, whose chunks of xs | z on 4 ranks cut a rank's
# channels; 33 heads, so q whole), "rwkv6" (10 heads of 52: local at 2
# ranks, whole at 4, where the heads do not split) and "whisper" (32 heads
# of 16, encoder and decoder).
TP_FAMILY_CONFIGS = {
    "mixtral": ("mixtral-8x22b", dict(n_heads=32, n_kv_heads=8)),
    "dbrx": ("dbrx-132b", dict(n_heads=32, n_kv_heads=8, n_experts=6,
                               top_k=4, capacity_factor=0.5)),
    "hymba": ("hymba-1.5b", dict(d_model=521, n_heads=33, n_kv_heads=3)),
    "rwkv6": ("rwkv6-7b", dict(n_heads=10)),
    "whisper": ("whisper-small", dict(n_heads=32, n_kv_heads=32)),
}
# block 0's check runs on fewer tokens, so that no activation it gathers is
# as large as a block weight
TP_BLOCK_BATCH, TP_BLOCK_SEQ = 2, 8


def family_config(name: str):
    """The port's config of ``TP_FAMILY_CONFIGS[name]``."""
    return _widened(*TP_FAMILY_CONFIGS[name])


def audio_embed(cfg, batch: int, frames: int, seed: int) -> torch.Tensor:
    """Whisper's stub frontend output ``[batch, frames, d_model]``."""
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, frames, cfg.d_model)).astype(np.float32))


def family_batches(cfg):
    """The training batches of a family config (whisper's with audio)."""
    out = train_batches(cfg, MESH_STEPS, MESH_BATCH, MESH_SEQ)
    if cfg.is_enc_dec:
        for i, b in enumerate(out):
            b["audio_embed"] = audio_embed(cfg, MESH_BATCH, MESH_SEQ, 20 + i)
    return out


class DispatchLog:
    """Inside the context, every MoE routing's dispatch table and token
    slots (``moe._group_dispatch``'s first and third outputs)."""

    def __enter__(self):
        from repro_torch.models import moe
        self.orig, self.log = moe._group_dispatch, []

        def logged(*args):
            out = self.orig(*args)
            self.log.append((out[0].detach().clone(),
                             out[2].detach().clone()))
            return out
        moe._group_dispatch = logged
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._group_dispatch = self.orig


def _tp_serve(cfg, model, mesh):
    """Prefill (last-token logits and cache) and ``TP_DECODE`` decode
    steps' logits through ``build_cell``'s serving steps on ``mesh``
    (``model`` unmeshed when ``mesh`` is None), whole tensors; whisper
    encodes ``enc_context`` frames first."""
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import lm, whisper
    prompt, toks = tp_prompts(cfg)
    audio = (audio_embed(cfg, MESH_BATCH, cfg.enc_context, 31),) \
        if cfg.is_enc_dec else ()
    mod = whisper if cfg.is_enc_dec else lm
    if mesh is None:
        if cfg.is_enc_dec:
            logits, cache = whisper.prefill(model, cfg, audio[0], prompt,
                                            TP_CONTEXT)
        else:
            logits, cache = lm.prefill(model, cfg, prompt, TP_CONTEXT)
        out = {"prefill": logits, "cache": dict(cache), "decode": []}
        for t in toks:
            logits, cache = mod.decode_step(model, cfg, cache, t)
            out["decode"].append(logits)
        return out
    dp = shd.dp_axes(mesh)
    pre, _ = steps.build_cell(cfg, steps.ShapeSpec(
        "tp_prefill", TP_CONTEXT, MESH_BATCH, "prefill"), mesh)
    dec, _ = steps.build_cell(cfg, steps.ShapeSpec(
        "tp_decode", TP_CONTEXT, MESH_BATCH, "decode"), mesh)
    args = [shd.distribute(prompt, mesh, shd.Spec(dp, None))]
    args += [shd.distribute(a, mesh, shd.Spec(dp, None, None))
             for a in audio]
    logits, cache = pre(model, *args)
    out = {"prefill": shd.full(logits),
           "cache": {k: shd.full(v) for k, v in cache.items()},
           "decode": [], "logits_placements": str(logits.placements)}
    for t in toks:
        logits, cache = dec(model, cache, shd.distribute(
            t, mesh, shd.Spec(dp, None)))
        out["decode"].append(shd.full(logits))
    return out


def _family_layer(cfg, blk, b: int, s: int):
    """Block 0's training forward as ``fn(x) -> y`` with any extra inputs
    it takes (whisper's decoder block: the cross k and v, leaves that take
    a gradient as the encoder's output would)."""
    from repro_torch.models import attention, ffn, lm, rwkv, whisper
    if cfg.family == "ssm":
        spec = lm.rwkv_spec(cfg)
        state = rwkv.init_state(spec, b, torch.float32, "cpu")
        return lambda x: rwkv.rwkv_block(blk, spec, x, state)[0], ()
    if cfg.is_enc_dec:
        g = torch.Generator().manual_seed(6)
        shape = (b, cfg.n_kv_heads, cfg.enc_context, cfg.head_dim_)
        ck, cv = (torch.randn(shape, generator=g).requires_grad_(True)
                  for _ in range(2))
        spec = whisper.attn_spec(cfg, causal=True)
        cross = whisper.attn_spec(cfg, causal=False)

        def fn(x):
            x = x + attention.attention_train(
                blk.self_attn, spec, whisper._ln(cfg, x, blk, "ln1"),
                range(s), None)
            x = x + attention.cross_attention(
                blk.cross_attn, cross, whisper._ln(cfg, x, blk, "ln2"),
                ck, cv)
            return x + ffn.apply_ffn(blk.ffn, whisper.ffn_spec(cfg),
                                     whisper._ln(cfg, x, blk, "ln3"))
        return fn, (ck, cv)
    freqs = lm._freqs(cfg, "cpu")
    return lambda x: lm._block_train(cfg, blk, x, range(s), freqs)[0], ()


def _block_run(cfg, model, mesh, b: int, s: int):
    """Block 0's training forward and backward on this rank on ``b x s``
    tokens (``mesh`` None: the whole model, else its tensor-parallel
    view): flops, the all-gathers' output shapes and the tensor-parallel
    traffic by purpose."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.dist import act_sharding
    from repro_torch.models import lm
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(b, s, cfg.d_model)).astype(np.float32))
    view = lm.tp_view(lm.trainable(model)) if mesh is not None else \
        lm.trainable(model)
    blocks = view.dec if cfg.is_enc_dec else view.blocks
    blk = lm.cast_view(blocks[0], torch.float32)
    fn, _ = _family_layer(cfg, blk, b, s)
    log = _GatherLog()
    flops = FlopCounterMode(display=False)
    rules = act_sharding.activation_rules(mesh) if mesh is not None \
        else contextlib.nullcontext()
    with rules, act_sharding.traffic() as traffic:
        xs = act_sharding.model_slice(x, -1) if mesh is not None else x
        xs = xs.clone().requires_grad_(True)
        with flops, log.mode, torch.enable_grad():
            fn(xs).sum().backward()
    return {"flops": flops.get_total_flops(), "gathers": log.shapes,
            "traffic": dict(traffic)}


def _family_block(cfg, model, mesh):
    """:func:`_block_run` at ``TP_BLOCK_BATCH x TP_BLOCK_SEQ``."""
    return _block_run(cfg, model, mesh, TP_BLOCK_BATCH, TP_BLOCK_SEQ)


def _updates(cfg, run):
    """Each parameter's largest change over ``run`` (from the seed-0
    weights), in ``lm.leaves`` order."""
    from repro_torch.launch import steps
    init = steps.train_leaves(steps.init_fn(cfg)(
        torch.Generator().manual_seed(0), "cpu"))
    return [float((p - q.detach()).abs().max())
            for p, q in zip(run["params"], init)]


def _against(run, ref):
    """A meshed run's losses, grad norms and sharded leaves, and each
    parameter's (max |diff| from the unmeshed run ``ref``'s, ``ref``'s
    largest entry, ``ref``'s largest change over its steps) in
    ``lm.leaves`` order (the parameters themselves stay on the rank:
    whisper's alone are 100 MB a run)."""
    return {"losses": run["losses"], "grad_norms": run["grad_norms"],
            "sharded": run["sharded"],
            "param_err": [(float((p - q).abs().max()), float(q.abs().max()),
                           u) for p, q, u in zip(run["params"],
                                                 ref["params"],
                                                 ref["updates"])]}


def _k5_layout_log():
    """Wrap ``ops.flash_attention`` so that every call's operand layout
    is kept when K5's card check (``flash_attention._check``: the head dim
    contiguous) would refuse it; returns the list."""
    from repro_torch.kernels import ops
    refused, orig = [], ops.flash_attention

    def checked(q, k, v, **kw):
        if any(t.stride(-1) != 1 for t in (q, k, v)):
            refused.append(tuple((tuple(t.shape), t.stride())
                                 for t in (q, k, v)))
        return orig(q, k, v, **kw)
    ops.flash_attention = checked
    return refused


def job_tensor_parallel_families(rank, world, tmp):
    import torch.distributed as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import steps
    out = {"k5_refused": _k5_layout_log()}
    for name in TP_FAMILY_CONFIGS:
        cfg = family_config(name)
        batches = family_batches(cfg)
        # every rank runs the unmeshed steps (while rank 0 would anyway)
        with DispatchLog() as dlog:
            ref = _mesh_run(cfg, None, batches)
        ref["updates"] = _updates(cfg, ref)
        out[(name, None, "dispatch")] = dlog.log
        for shape in TP_MESHES:
            mesh = _submesh(world, shape)
            with DispatchLog() as dlog:
                out[(name, shape)] = _against(_mesh_run(cfg, mesh, batches),
                                              ref)
            out[(name, shape, "design")] = steps.design(cfg, mesh)
            out[(name, shape, "dispatch")] = dlog.log
        if rank == 0:
            out[(name, None)] = {k: ref[k] for k in
                                 ("losses", "grad_norms", "params",
                                  "updates")}
            model = steps.init_fn(cfg)(torch.Generator().manual_seed(0),
                                       "cpu")
            with DispatchLog() as dlog:
                out[(name, None, "serve")] = _tp_serve(cfg, model, None)
            out[(name, None, "serve dispatch")] = dlog.log
            out[(name, None, "block")] = _family_block(cfg, model, None)
        del ref
        for shape in TP_SERVE_MESHES:
            mesh = _submesh(world, shape)
            model = shd.distribute_params(steps.init_fn(cfg)(
                torch.Generator().manual_seed(0), "cpu"), mesh)
            with DispatchLog() as dlog:
                out[(name, shape, "serve")] = _tp_serve(cfg, model, mesh)
            out[(name, shape, "serve dispatch")] = dlog.log
            if shape == (1, 4):
                out[(name, shape, "block")] = _family_block(cfg, model, mesh)
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
