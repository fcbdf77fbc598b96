"""The causal LM (``repro.models.lm``) for the ``dense``, ``vlm``, ``moe``,
``ssm`` (RWKV-6) and ``hybrid`` (hymba) families: prefill (attention
through the flash kernel K5), ring-cache decode with the recurrent states
of the ``ssm`` and ``hybrid`` families, and the training forward with its
gradient.  The ``audio`` family (whisper) is an encoder-decoder and lives
in ``models/whisper.py``, as in the reference.

Parameters live in f32 in an :class:`LM` module, one layer module per
layer (a :class:`Block` of attention and FFN, MoE or SSM branch, or an
``rwkv.RWKVLayer``); a Python loop over the layers takes the place of the
reference's ``lax.scan`` over stacked ``[L, ...]`` leaves.  The reference
casts the layers to the compute type on every call (``_cast_blocks``),
f32-only leaves such as RWKV's decay base and the SSM's ``log(-A)``
included.  Serving makes that copy once (:func:`compute_copy`, done when a
serving engine is built), and every serving entry point given the f32
module in a bf16 config makes it first, with the same numbers.  Training
casts inside the autograd graph on every call (:func:`cast_view`), so the
gradient reaches the f32 masters.

Parameters are created frozen (``requires_grad=False``), so serving
records no graph; :func:`trainable` turns them on for training.

On a mesh the model runs on each rank's local tensors through
:func:`tp_view` (every family, :data:`TP_FAMILIES`): each weight read as
its shard, the residual stream sharded on ``embed``, activations gathered
over ``model`` where a whole row is needed, the head and the loss split
over the vocabulary, the recurrent states (the hybrid's SSM, RWKV's WKV)
on this rank's channels or heads inside a step and whole in the cache.
The code below is the same for a view and for one device: it reads each
tensor's width against the whole one (``act_sharding.gather_model``).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.dist import act_sharding
from repro_torch.models import attention, ffn, layers, moe, rwkv, ssm
from repro_torch.models.attention import AttnSpec, KVCache
from repro_torch.models.config import ArchConfig

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")
# the families whose blocks compute on their weight shards on a mesh (the
# LM's and whisper's ``audio``): every one
TP_FAMILIES = PORTED_FAMILIES + ("audio",)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(
            f"{cfg.name}: models.lm runs the {', '.join(PORTED_FAMILIES)} "
            f"families; the {cfg.family!r} family is models.whisper")


# ---------------------------------------------------------------------------
# spec builders
# ---------------------------------------------------------------------------

def attn_spec(cfg: ArchConfig, *, causal: bool = True) -> AttnSpec:
    """The attention spec of ``cfg``."""
    return AttnSpec(
        d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim_, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm,
        causal=causal, window=cfg.window, rope_theta=cfg.rope_theta)


def ffn_spec(cfg: ArchConfig) -> ffn.FFNSpec:
    """The feed-forward spec of ``cfg``."""
    return ffn.FFNSpec(d_model=cfg.d_model, d_ff=cfg.d_ff, act=cfg.act,
                       gated=cfg.gated_ffn)


def moe_spec(cfg: ArchConfig) -> moe.MoESpec:
    """The MoE spec of ``cfg``."""
    return moe.MoESpec(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       n_experts=cfg.n_experts, top_k=cfg.top_k, act=cfg.act,
                       gated=cfg.gated_ffn,
                       capacity_factor=cfg.capacity_factor)


def rwkv_spec(cfg: ArchConfig) -> rwkv.RWKVSpec:
    """The RWKV-6 spec of ``cfg``."""
    return rwkv.RWKVSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                         d_ff=cfg.d_ff, chunk=cfg.rwkv_chunk)


def ssm_spec(cfg: ArchConfig) -> ssm.SSMSpec:
    """The hybrid's SSM-branch spec of ``cfg``."""
    return ssm.SSMSpec(d_model=cfg.d_model,
                       d_inner=cfg.ssm_expand * cfg.d_model,
                       d_state=cfg.ssm_state)


def compute_dtype(cfg: ArchConfig) -> torch.dtype:
    """The working type of ``cfg`` (bf16 or f32)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One transformer layer: ``ln1``, ``attn``, ``ln2`` and either ``ffn``
    or ``moe``; the hybrid family adds the parallel ``ssm`` branch."""

    def __init__(self, ln1: torch.Tensor, attn: attention.Attention,
                 ln2: torch.Tensor, ffn_: Optional[ffn.FFN] = None, *,
                 moe_: Optional[moe.MoE] = None,
                 ssm_: Optional[ssm.SSM] = None):
        """Hold the given norms and submodules."""
        super().__init__()
        self.ln1, self.ln2 = _param(ln1), _param(ln2)
        self.attn, self.ffn, self.moe, self.ssm = attn, ffn_, moe_, ssm_


class LM(nn.Module):
    """The model: ``embed [padded_vocab, d]``, the layers, ``final_norm``
    and, unless the embeddings are tied, ``lm_head [d, padded_vocab]``."""

    def __init__(self, embed: torch.Tensor, blocks: List[nn.Module],
                 final_norm: torch.Tensor,
                 lm_head: Optional[torch.Tensor] = None):
        """Hold the given tensors and layers."""
        super().__init__()
        self.embed = _param(embed)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = _param(final_norm)
        self.lm_head = None if lm_head is None else _param(lm_head)


def _layer(cfg: ArchConfig, device, dtype) -> nn.Module:
    """An uninitialised layer of ``cfg``'s family."""
    if cfg.family == "ssm":
        return rwkv.RWKVLayer(rwkv_spec(cfg), device=device, dtype=dtype)
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    return Block(
        torch.empty(d, **kw), attention.Attention(attn_spec(cfg), **kw),
        torch.empty(d, **kw),
        None if cfg.family == "moe" else ffn.FFN(ffn_spec(cfg), **kw),
        moe_=moe.MoE(moe_spec(cfg), **kw) if cfg.family == "moe" else None,
        ssm_=ssm.SSM(ssm_spec(cfg), **kw) if cfg.family == "hybrid" else None)


def _init_layer(cfg: ArchConfig, generator: torch.Generator,
                device) -> nn.Module:
    """One f32 layer by the reference's init rules."""
    if cfg.family == "ssm":
        return rwkv.init_rwkv_layer(generator, rwkv_spec(cfg), device=device)
    d = cfg.d_model
    att = attention.init_attention(generator, attn_spec(cfg), device=device)
    if cfg.family == "moe":
        mix = dict(moe_=moe.init_moe(generator, moe_spec(cfg), device=device))
    else:
        mix = dict(ffn_=ffn.init_ffn(generator, ffn_spec(cfg), device=device))
    if cfg.family == "hybrid":
        mix["ssm_"] = ssm.init_ssm(generator, ssm_spec(cfg), device=device)
    return Block(torch.ones(d, device=device), att,
                 torch.ones(d, device=device), **mix)


@torch.no_grad()
def init_params(cfg: ArchConfig, generator: torch.Generator,
                device=None, dtype: Optional[torch.dtype] = None) -> LM:
    """Random weights drawn from ``generator`` on ``device`` (CUDA by
    default; the generator must live there), in f32, or in ``dtype`` with
    each layer cast as soon as it is drawn (so a full-depth bf16 model
    never holds its f32 copy; ``final_norm`` stays f32).  The reference's
    init rules; its numbers differ (``jax.random`` is not
    ``torch.Generator``)."""
    _check_family(cfg)
    dev = _device.resolve(device)
    dt = torch.float32 if dtype is None else dtype
    vp, d = cfg.padded_vocab, cfg.d_model
    embed = torch.empty((vp, d), device=dev).normal_(generator=generator)
    embed = embed.mul_(0.02).to(dt)
    lm_head = None if cfg.tie_embeddings else layers.he_init(
        generator, (d, vp), device=dev).to(dt)
    blocks = [_init_layer(cfg, generator, dev).to(dt)
              for _ in range(cfg.n_layers)]
    return LM(embed, blocks, torch.ones(d, device=dev), lm_head)


def fill(module: nn.Module, get: Callable[[str], torch.Tensor]
         ) -> nn.Module:
    """Copy ``get(name)`` into every parameter ``name`` of ``module`` (each
    cast to the parameter's type and device); returns the module."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(get(name))
    return module


def _rebuild(cfg: ArchConfig, get: Callable[[str], torch.Tensor], device,
             dtype: torch.dtype) -> LM:
    """An :class:`LM` on ``device`` whose tensor at each parameter path
    (``"embed"``, ``"blocks.3.attn.wq"``, ...) is ``get(path)`` cast to
    ``dtype``; ``final_norm`` stays f32, as the reference never casts it."""
    return fill(empty_params(cfg, device, dtype), get)


def empty_params(cfg: ArchConfig, device, dtype: torch.dtype) -> LM:
    """An uninitialised :class:`LM` of ``cfg`` on ``device`` in ``dtype``
    (``final_norm`` in f32); on the meta device, shapes without storage."""
    _check_family(cfg)
    vp, d = cfg.padded_vocab, cfg.d_model
    kw = dict(device=device, dtype=dtype)
    return LM(torch.empty((vp, d), **kw),
              [_layer(cfg, device, dtype) for _ in range(cfg.n_layers)],
              torch.empty(d, device=device),
              None if cfg.tie_embeddings else torch.empty((d, vp), **kw))


def same_device(a: torch.device, b: torch.device) -> bool:
    """``a`` and ``b`` name one device (an unindexed CUDA device matches
    any index)."""
    return a.type == b.type and (a.index is None or b.index is None
                                 or a.index == b.index)


@torch.no_grad()
def compute_copy(model: LM, cfg: ArchConfig, device=None) -> LM:
    """``model`` with its layers, embeddings and head in the compute type
    on ``device`` (the model's own by default): the copy the reference
    makes on every call (``_cast_blocks`` and the head's cast), made once.
    The model itself when nothing changes."""
    dt = compute_dtype(cfg)
    embed = peek(model, "embed")
    dev = embed.device if device is None else torch.device(device)
    if embed.dtype == dt and same_device(dev, embed.device):
        return model
    return _rebuild(cfg, model.get_parameter, dev, dt)


def peek(model, name: str) -> torch.Tensor:
    """Parameter ``name`` of a model or of a view of one, as it is stored
    (for its type and device: no gather, no cast)."""
    if isinstance(model, _CastView):
        model = model._module
    return getattr(model, name)


def tree_getter(tree: dict) -> Callable[[str], torch.Tensor]:
    """``get(path)`` over a reference parameter pytree: ``"embed"`` is
    ``tree["embed"]``, ``"blocks.3.attn.wq"`` is
    ``tree["blocks"]["attn"]["wq"][3]`` (per-layer leaves stacked)."""
    def get(path: str) -> torch.Tensor:
        parts = path.split(".")
        if len(parts) == 1:
            return torch.from_numpy(np.array(tree[path], np.float32))
        node = tree[parts[0]]
        for key in parts[2:]:
            node = node[key]
        return torch.from_numpy(np.array(node[int(parts[1])], np.float32))
    return get


def trainable(model: nn.Module) -> nn.Module:
    """``model`` with every parameter taking a gradient (in place)."""
    return model.requires_grad_(True)


def leaves(model: nn.Module) -> List[Tuple[Tuple[str, ...], Optional[int],
                                           nn.Parameter]]:
    """Every parameter of an :class:`LM` or a ``whisper.Whisper`` as
    ``(reference path, layer, tensor)`` in the reference's tree order
    (``jax.tree`` sorts dict keys): a per-layer leaf (``blocks.3.attn.wq``)
    is the path ``("blocks", "attn", "wq")`` at layer 3, a leaf's layers
    one after another; a model-level leaf has layer None.  The order in
    which the optimizer walks the leaves, so that its global norm sums them
    as the reference's does."""
    out = []
    for name, p in model.named_parameters():
        parts = name.split(".")
        if len(parts) > 1 and parts[1].isdigit():
            out.append(((parts[0], *parts[2:]), int(parts[1]), p))
        else:
            out.append((tuple(parts), None, p))
    out.sort(key=lambda e: (e[0], -1 if e[1] is None else e[1]))
    return out


def nest(paths: List[Tuple[Tuple[str, ...], Optional[int]]],
         values: List, stack: Callable) -> Dict:
    """The reference's nested tree of ``values`` (one a :func:`leaves`
    entry): each per-layer leaf's values joined by ``stack`` (``np.stack``,
    ``torch.stack``) on a leading ``[L]`` axis."""
    tree: Dict = {}
    groups: Dict = {}
    for (path, layer), v in zip(paths, values):
        groups.setdefault(path, []).append((layer, v))
    for path, vals in groups.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = vals[0][1] if vals[0][0] is None else \
            stack([v for _, v in vals])
    return tree


def params_to_reference(model: nn.Module) -> dict:
    """The reference's parameter pytree of an :class:`LM` or a
    ``whisper.Whisper`` as numpy f32 arrays, per-layer leaves stacked on a
    leading ``[L]`` axis."""
    entries = leaves(model)
    return nest([(path, layer) for path, layer, _ in entries],
                [p.detach().float().cpu().numpy() for _, _, p in entries],
                np.stack)


@torch.no_grad()
def params_from_reference(tree: dict, cfg: ArchConfig, device=None) -> LM:
    """An f32 :class:`LM` on ``device`` (CUDA by default) from the
    reference's parameter pytree (nested dicts of arrays, per-layer leaves
    stacked ``[L, ...]``)."""
    _check_family(cfg)
    return _rebuild(cfg, tree_getter(tree), _device.resolve(device),
                    torch.float32)


# ---------------------------------------------------------------------------
# blocks, embeddings, head
# ---------------------------------------------------------------------------

def _norm(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # block norms are in the working type, as the reference's _cast_blocks
    # leaves them before its layer scan
    return layers.rms_norm(x, w.to(x.dtype), plus_one=cfg.norm_plus_one)


def _mix_out(attn_out: torch.Tensor,
             ssm_out: Optional[torch.Tensor]) -> torch.Tensor:
    if ssm_out is None:
        return attn_out
    return 0.5 * (attn_out + ssm_out)    # hymba's parallel heads, averaged


def _ffn_out(cfg: ArchConfig, blk: Block, h2: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's FFN or MoE output and its aux loss (0 for an FFN)."""
    if blk.moe is not None:
        return moe.apply_moe(blk.moe, moe_spec(cfg), h2)
    return (ffn.apply_ffn(blk.ffn, ffn_spec(cfg), h2),
            torch.zeros((), device=h2.device))


def _ssm_branch(cfg: ArchConfig, blk: Block, h: torch.Tensor,
                state: Optional[ssm.SSMState]):
    """The hybrid's SSM branch from ``state`` (zero when None), or
    (None, None) for a family without one."""
    if blk.ssm is None:
        return None, None
    sspec = ssm_spec(cfg)
    if state is None:
        state = ssm.init_state(sspec, h.shape[0], h.dtype, h.device)
    return ssm.apply_ssm(blk.ssm, sspec, h, state)


def _whole_ssm(cfg: ArchConfig, state: Optional[ssm.SSMState]
               ) -> Optional[ssm.SSMState]:
    """A hybrid layer's new SSM state on every channel (the cache's
    placement: whole over ``model``)."""
    return None if state is None else ssm.whole_state(ssm_spec(cfg), state)


def _rwkv_block(cfg: ArchConfig, blk, x: torch.Tensor,
                state: rwkv.RWKVState
                ) -> Tuple[torch.Tensor, rwkv.RWKVState]:
    """An RWKV layer of a prefill or decode step, its state whole over
    ``model`` (the cache's placement)."""
    x, st = rwkv.rwkv_block(blk, rwkv_spec(cfg), x, state)
    return x, rwkv.whole_state(rwkv_spec(cfg), st)


def _row_norm(cfg: ArchConfig, x: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """The block norm of the residual ``x`` as whole rows.  On a
    tensor-parallel view ``x`` and the norm's weight hold this rank's
    ``embed`` columns: both are gathered (the weight is ``d`` entries), so
    the row's statistics are the unsharded step's."""
    d = cfg.d_model
    return _norm(cfg, act_sharding.gather_model(x, d, "rows"),
                 act_sharding.gather_model(w, d, "norm"))


def _block_train(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                 positions: range, freqs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = _row_norm(cfg, x, blk.ln1)
    attn_out = attention.attention_train(blk.attn, attn_spec(cfg), h,
                                         positions, freqs)
    ssm_out, _ = _ssm_branch(cfg, blk, h, None)
    x = x + _mix_out(attn_out, ssm_out)
    out, aux = _ffn_out(cfg, blk, _row_norm(cfg, x, blk.ln2))
    return x + out, aux


def _block_prefill(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                   positions: range, freqs: torch.Tensor, context: int
                   ) -> Tuple[torch.Tensor, KVCache,
                              Optional[ssm.SSMState]]:
    h = _row_norm(cfg, x, blk.ln1)
    attn_out, kv = attention.attention_prefill(blk.attn, attn_spec(cfg), h,
                                               positions, freqs, context)
    ssm_out, ssm_state = _ssm_branch(cfg, blk, h, None)
    x = x + _mix_out(attn_out, ssm_out)
    out, _ = _ffn_out(cfg, blk, _row_norm(cfg, x, blk.ln2))
    return x + out, kv, _whole_ssm(cfg, ssm_state)


def _block_decode(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                  pos: torch.Tensor, freqs: torch.Tensor, kv: KVCache,
                  slot_pos: torch.Tensor,
                  ssm_state: Optional[ssm.SSMState]
                  ) -> Tuple[torch.Tensor, KVCache, Optional[ssm.SSMState]]:
    h = _row_norm(cfg, x, blk.ln1)
    attn_out, kv_new = attention.attention_decode(
        blk.attn, attn_spec(cfg), h, pos, freqs, kv, slot_pos)
    ssm_out, ssm_new = _ssm_branch(cfg, blk, h, ssm_state)
    x = x + _mix_out(attn_out, ssm_out)
    out, _ = _ffn_out(cfg, blk, _row_norm(cfg, x, blk.ln2))
    return x + out, kv_new, _whole_ssm(cfg, ssm_new)


def _embed(model: LM, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    # on a tensor-parallel view the table holds this rank's embed columns,
    # and so does the lookup: the residual stream starts sharded
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    return layers.embed_lookup(model.embed, tokens, dtype=compute_dtype(cfg),
                               scale=scale)


def final_hidden(model: LM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm of hidden states ``x`` (gathered whole over
    ``model`` on a tensor-parallel view)."""
    return layers.rms_norm(
        act_sharding.gather_model(x, cfg.d_model, "rows"), model.final_norm,
        plus_one=cfg.norm_plus_one)


def head_matrix(model: LM, cfg: ArchConfig) -> torch.Tensor:
    """The f32 output projection ``[D, padded_vocab]``: the transposed
    embeddings when they are tied, else ``lm_head``.  On a
    :func:`tp_view`, this rank's vocabulary columns ``[D, Vp / model]``:
    ``lm_head`` as it is placed (``Shard(1)``), the tied table's rows
    redistributed from its ``Shard(1)`` placement (one all-to-all, in the
    compute type), a replicated one's sliced."""
    if not isinstance(model, _TPView):
        return model.embed.T if cfg.tie_embeddings else model.lm_head
    if cfg.tie_embeddings:      # cast first: the all-to-all moves half
        table = model.embed.to(compute_dtype(cfg))
        return act_sharding.rows_from_columns(table, cfg.d_model).T
    head = model.lm_head
    if head.shape[1] == cfg.padded_vocab:
        head = act_sharding.model_slice(head, 1)
    return head


def logits_at(model: LM, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """h ``[..., D]`` -> ``[..., padded_vocab]`` f32 logits, the padded
    entries at -1e30 (on a :func:`tp_view`, this rank's vocabulary
    columns: the reference's ``(dp, model)`` out spec)."""
    head = head_matrix(model, cfg).to(compute_dtype(cfg))
    return mask_padded_vocab(cfg, (h @ head).float())


def mask_padded_vocab(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """``logits`` (the whole vocabulary, or this rank's columns of it)
    with the entries past the vocabulary at -1e30."""
    if cfg.padded_vocab != cfg.vocab:
        start = act_sharding.vocab_start(cfg.padded_vocab,
                                         logits.shape[-1]) or 0
        cols = torch.arange(start, start + logits.shape[-1],
                            device=logits.device)
        mask = torch.where(cols >= cfg.vocab, -1e30, 0.0)
        logits = logits + mask
    return logits


def _freqs(cfg: ArchConfig, device) -> torch.Tensor:
    return layers.rope_freqs(cfg.head_dim_, cfg.rope_theta, device=device)


def _rwkv_state(cfg: ArchConfig, batch: int, device) -> rwkv.RWKVState:
    return rwkv.init_state(rwkv_spec(cfg), batch, compute_dtype(cfg), device)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

class _CastView:
    """A module read through a cast: each tensor attribute reads whole
    (``act_sharding.gathered``: a sharded ``DTensor`` is all-gathered at
    its use) and, when a dtype is set, floating ones as ``.to(dtype)`` (a
    node of the autograd graph); each submodule as a view of its own, a
    module list as a list of views; anything else as it is."""

    __slots__ = ("_module", "_dtype")
    _read = staticmethod(act_sharding.gathered)

    def __init__(self, module: nn.Module, dtype: Optional[torch.dtype]):
        self._module, self._dtype = module, dtype

    def __getattr__(self, name: str):
        v = getattr(self._module, name)
        if isinstance(v, nn.ModuleList):
            return [type(self)(m, self._dtype) for m in v]
        if isinstance(v, nn.Module):
            return type(self)(v, self._dtype)
        if isinstance(v, torch.Tensor):
            v = self._read(v)
            if self._dtype is not None and v.is_floating_point():
                return v.to(self._dtype)
        return v


class _TPView(_CastView):
    """A :class:`_CastView` whose tensors read as this rank's shards
    (``act_sharding.tp_local``), not whole."""

    __slots__ = ()
    _read = staticmethod(act_sharding.tp_local)


def cast_view(module: nn.Module, dtype: torch.dtype):
    """``module`` with every floating parameter read in ``dtype`` on each
    use, inside the autograd graph: the reference's ``_cast_blocks``
    without a copy that would cut the gradient from the f32 masters.  A
    view of a view casts the module underneath, read as that view reads
    it (whole or by shards)."""
    if isinstance(module, _CastView):
        return type(module)(module._module, dtype)
    return _CastView(module, dtype)


def tp_view(model: nn.Module):
    """``model`` (an :class:`LM` or a ``whisper.Whisper``) with every
    parameter read as this rank's shard, in its own type: run under
    ``act_sharding.activation_rules(mesh)``, each block computes on its
    weight shards over ``model`` (the reference's placements: column
    shards of every weight 512 or more wide), its residual stream sharded
    on ``embed``, its q heads local where they split evenly
    (``attention.local_heads``), k and v whole, and the head and the loss
    on this rank's vocabulary columns; the experts on their hidden-unit
    and ``d`` columns (``moe``), the SSM branch on its ``d_inner``
    channels (``hybrid``), RWKV's time mix on its heads (``ssm``).  No
    weight matrix is gathered but RWKV's low-rank ``ddl_b`` (the block
    norms' and lerps' ``d``-entry weights are, with the rows they
    scale)."""
    return _TPView(model, None)


def _remat(cfg: ArchConfig, layers_: List[Callable], x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``layer(x) -> (x, aux)`` for each layer, summing the aux terms,
    with the reference's remat: with ``cfg.remat`` each layer's forward is
    recomputed in the backward (one checkpoint a layer); with
    ``cfg.remat_group = k > 1`` each group of k layers is checkpointed too,
    so only every k-th layer's input is kept (the reference's two-level
    remat).  Without a gradient the layers just run."""
    grad = torch.is_grad_enabled()

    def run(fns, x):
        aux = torch.zeros((), device=x.device)
        for fn in fns:
            x, a = checkpoint(fn, x, use_reentrant=False) \
                if grad and cfg.remat else fn(x)
            aux = aux + a
        return x, aux

    k = cfg.remat_group
    if k <= 1 or not grad:
        return run(layers_, x)
    if len(layers_) % k:
        raise ValueError(f"remat_group {k} does not divide the "
                         f"{len(layers_)} layers")
    aux = torch.zeros((), device=x.device)
    for i in range(0, len(layers_), k):
        x, a = checkpoint(run, layers_[i:i + k], x, use_reentrant=False)
        aux = aux + a
    return x, aux


def forward_train(model: LM, cfg: ArchConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (final hidden ``[B, S, D]``, aux loss: the sum
    of the MoE layers' load-balancing terms, else 0), differentiable with
    respect to the f32 parameters of ``model``.  Each layer reads its
    parameters cast to the compute type (:func:`cast_view`); the remat is
    ``cfg.remat`` / ``cfg.remat_group``'s.  Each attention layer's forward
    is one K5 launch on the card (two with remat: the backward recomputes
    it), its backward plain PyTorch."""
    _check_family(cfg)
    dt = compute_dtype(cfg)
    x = _embed(model, cfg, tokens)
    blocks = [cast_view(blk, dt) for blk in model.blocks]
    if cfg.family == "ssm":
        state0 = _rwkv_state(cfg, tokens.shape[0], tokens.device)

        def layer(blk):
            def fn(x):
                y, _ = rwkv.rwkv_block(blk, rwkv_spec(cfg), x, state0)
                return y, torch.zeros((), device=y.device)
            return fn
    else:
        positions = range(tokens.shape[1])
        freqs = _freqs(cfg, tokens.device)

        def layer(blk):
            return lambda x: _block_train(cfg, blk, x, positions, freqs)
    x, aux = _remat(cfg, [layer(blk) for blk in blocks], x)
    return final_hidden(model, cfg, x), aux



def init_decode_cache(model: LM, cfg: ArchConfig, batch: int,
                      context: int) -> Dict[str, torch.Tensor]:
    """A zeroed decode cache on the model's device: per-row ``pos [B]``;
    with attention, ``slot_pos [B, W]`` (-1: empty slot) and ``kv_k``/
    ``kv_v [L, B, Hkv, W, hd]`` in the compute type; the hybrid's
    ``ssm_h [L, B, di, n]`` (f32) and ``ssm_conv [L, B, k - 1, di]``; RWKV's
    ``rwkv_wkv [L, B, H, hd, hd]`` (f32) and token shifts ``rwkv_tm``/
    ``rwkv_cm [L, B, D]``."""
    _check_family(cfg)
    dev = model.embed.device
    L, dt = cfg.n_layers, compute_dtype(cfg)
    cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=dev)}
    if cfg.family != "ssm":
        w = attention.cache_length(attn_spec(cfg), context)
        shape = (L, batch, cfg.n_kv_heads, w, cfg.head_dim_)
        cache["kv_k"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["kv_v"] = torch.zeros(shape, dtype=dt, device=dev)
        cache["slot_pos"] = torch.full((batch, w), -1, dtype=torch.int32,
                                       device=dev)
    if cfg.family == "hybrid":
        sp = ssm_spec(cfg)
        cache["ssm_h"] = torch.zeros((L, batch, sp.d_inner, sp.d_state),
                                     device=dev)
        cache["ssm_conv"] = torch.zeros(
            (L, batch, sp.conv_kernel - 1, sp.d_inner), dtype=dt, device=dev)
    if cfg.family == "ssm":
        rp = rwkv_spec(cfg)
        cache["rwkv_wkv"] = torch.zeros(
            (L, batch, rp.n_heads, rp.head_dim, rp.head_dim), device=dev)
        cache["rwkv_tm"] = torch.zeros((L, batch, cfg.d_model), dtype=dt,
                                       device=dev)
        cache["rwkv_cm"] = torch.zeros((L, batch, cfg.d_model), dtype=dt,
                                       device=dev)
    return cache


@torch.inference_mode()
def prefill(model: LM, cfg: ArchConfig, tokens: torch.Tensor, context: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens ``[B, S]`` -> (last-token logits ``[B, padded_vocab]``, decode
    cache).  Each attention layer's prefill is one K5 launch on the card."""
    _check_family(cfg)
    model = compute_copy(model, cfg)
    b, s = tokens.shape
    x = _embed(model, cfg, tokens)
    cache = {"pos": torch.full((b,), s, dtype=torch.int32,
                               device=tokens.device)}
    if cfg.family == "ssm":
        state0 = _rwkv_state(cfg, b, tokens.device)
        states = []
        for blk in model.blocks:
            x, st = _rwkv_block(cfg, blk, x, state0)
            states.append(st)
        cache.update(rwkv_wkv=torch.stack([st.wkv for st in states]),
                     rwkv_tm=torch.stack([st.shift_tm for st in states]),
                     rwkv_cm=torch.stack([st.shift_cm for st in states]))
    else:
        positions = range(s)
        freqs = _freqs(cfg, tokens.device)
        kvs, ssts = [], []
        for blk in model.blocks:
            x, kv, sst = _block_prefill(cfg, blk, x, positions, freqs,
                                        context)
            kvs.append(kv)
            ssts.append(sst)
        w = attention.cache_length(attn_spec(cfg), context)
        cache.update(kv_k=torch.stack([kv.k for kv in kvs]),
                     kv_v=torch.stack([kv.v for kv in kvs]),
                     slot_pos=attention.cache_positions(
                         s, w, device=tokens.device).repeat(b, 1))
        if cfg.family == "hybrid":
            cache.update(ssm_h=torch.stack([st.h for st in ssts]),
                         ssm_conv=torch.stack([st.conv for st in ssts]))
    return logits_at(model, cfg, final_hidden(model, cfg, x[:, -1])), cache


@torch.inference_mode()
def decode_step(model: LM, cfg: ArchConfig, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens ``[B, 1]`` -> (logits ``[B, padded_vocab]``, a new cache).
    ``cache["pos"]`` is ``[B]``: every row decodes at its own position."""
    _check_family(cfg)
    model = compute_copy(model, cfg)
    pos = cache["pos"]
    x = _embed(model, cfg, tokens)
    new_cache = dict(cache, pos=pos + 1)
    if cfg.family == "ssm":
        states = []
        for l, blk in enumerate(model.blocks):
            st = rwkv.RWKVState(cache["rwkv_wkv"][l], cache["rwkv_tm"][l],
                                cache["rwkv_cm"][l])
            x, st = _rwkv_block(cfg, blk, x, st)
            states.append(st)
        new_cache.update(rwkv_wkv=torch.stack([st.wkv for st in states]),
                         rwkv_tm=torch.stack([st.shift_tm for st in states]),
                         rwkv_cm=torch.stack([st.shift_cm for st in states]))
        return logits_at(model, cfg, final_hidden(model, cfg, x[:, -1])), \
            new_cache
    freqs = _freqs(cfg, tokens.device)
    w = cache["kv_k"].shape[3]
    # per-row ring-slot update: row b stamps its own slot pos[b] % w
    hit = (torch.arange(w, dtype=torch.int32, device=pos.device)[None, :]
           == (pos % w)[:, None])
    slot_pos = torch.where(hit, pos[:, None], cache["slot_pos"])
    hybrid = cfg.family == "hybrid"
    kvs, ssts = [], []
    for l, blk in enumerate(model.blocks):
        sst = ssm.SSMState(cache["ssm_h"][l], cache["ssm_conv"][l]) \
            if hybrid else None
        x, kv, sst = _block_decode(cfg, blk, x, pos, freqs,
                                   KVCache(cache["kv_k"][l],
                                           cache["kv_v"][l]),
                                   slot_pos, sst)
        kvs.append(kv)
        ssts.append(sst)
    new_cache.update(kv_k=torch.stack([kv.k for kv in kvs]),
                     kv_v=torch.stack([kv.v for kv in kvs]),
                     slot_pos=slot_pos)
    if hybrid:
        new_cache.update(ssm_h=torch.stack([st.h for st in ssts]),
                         ssm_conv=torch.stack([st.conv for st in ssts]))
    return logits_at(model, cfg, final_hidden(model, cfg, x[:, -1])), \
        new_cache
