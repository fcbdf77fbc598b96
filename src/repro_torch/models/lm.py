"""The causal LM (``repro.models.lm``) for the ``dense``, ``vlm``, ``moe``,
``ssm`` (RWKV-6) and ``hybrid`` (hymba) families: prefill (attention
through the flash kernel K5), ring-cache decode with the recurrent states
of the ``ssm`` and ``hybrid`` families, and the training forward (forward
only).  The ``audio`` family (whisper) is an encoder-decoder and lives in
``models/whisper.py``, as in the reference.

Parameters live in f32 in an :class:`LM` module, one layer module per
layer (a :class:`Block` of attention and FFN, MoE or SSM branch, or an
``rwkv.RWKVLayer``); a Python loop over the layers takes the place of the
reference's ``lax.scan`` over stacked ``[L, ...]`` leaves.  The reference
casts the layers to the compute type on every call (``_cast_blocks``),
f32-only leaves such as RWKV's decay base and the SSM's ``log(-A)``
included; the port makes that copy once (:func:`compute_copy`, done when a
serving engine is built), and every entry point given the f32 module in a
bf16 config makes it first, with the same numbers.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import device as _device
from repro_torch.models import attention, ffn, layers, moe, rwkv, ssm
from repro_torch.models.attention import AttnSpec, KVCache
from repro_torch.models.config import ArchConfig

PORTED_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid")


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
    vp, d = cfg.padded_vocab, cfg.d_model
    kw = dict(device=device, dtype=dtype)
    model = LM(torch.empty((vp, d), **kw),
               [_layer(cfg, device, dtype) for _ in range(cfg.n_layers)],
               torch.empty(d, device=device),
               None if cfg.tie_embeddings else torch.empty((d, vp), **kw))
    return fill(model, get)


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
    dev = model.embed.device if device is None else torch.device(device)
    if model.embed.dtype == dt and same_device(dev, model.embed.device):
        return model
    return _rebuild(cfg, model.get_parameter, dev, dt)


def stack_layers(mods: nn.ModuleList) -> Dict:
    """The reference's layout of a layer stack: a nested dict of numpy f32
    arrays, each leaf the layers' tensors stacked on a leading ``[L]``."""
    out: Dict = {}
    for name, _ in mods[0].named_parameters():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = np.stack([m.get_parameter(name).detach().float().cpu()
                               .numpy() for m in mods])
    return out


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


def params_to_reference(model: LM) -> dict:
    """The reference's parameter pytree as numpy f32 arrays, per-layer
    leaves stacked on a leading ``[L]`` axis."""
    def np_(t):
        return t.detach().float().cpu().numpy()

    tree: Dict = {"embed": np_(model.embed),
                  "final_norm": np_(model.final_norm),
                  "blocks": stack_layers(model.blocks)}
    if model.lm_head is not None:
        tree["lm_head"] = np_(model.lm_head)
    return tree


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


def _block_train(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                 positions: range, freqs: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = _norm(cfg, x, blk.ln1)
    attn_out = attention.attention_train(blk.attn, attn_spec(cfg), h,
                                         positions, freqs)
    ssm_out, _ = _ssm_branch(cfg, blk, h, None)
    x = x + _mix_out(attn_out, ssm_out)
    out, aux = _ffn_out(cfg, blk, _norm(cfg, x, blk.ln2))
    return x + out, aux


def _block_prefill(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                   positions: range, freqs: torch.Tensor, context: int
                   ) -> Tuple[torch.Tensor, KVCache,
                              Optional[ssm.SSMState]]:
    h = _norm(cfg, x, blk.ln1)
    attn_out, kv = attention.attention_prefill(blk.attn, attn_spec(cfg), h,
                                               positions, freqs, context)
    ssm_out, ssm_state = _ssm_branch(cfg, blk, h, None)
    x = x + _mix_out(attn_out, ssm_out)
    out, _ = _ffn_out(cfg, blk, _norm(cfg, x, blk.ln2))
    return x + out, kv, ssm_state


def _block_decode(cfg: ArchConfig, blk: Block, x: torch.Tensor,
                  pos: torch.Tensor, freqs: torch.Tensor, kv: KVCache,
                  slot_pos: torch.Tensor,
                  ssm_state: Optional[ssm.SSMState]
                  ) -> Tuple[torch.Tensor, KVCache, Optional[ssm.SSMState]]:
    h = _norm(cfg, x, blk.ln1)
    attn_out, kv_new = attention.attention_decode(
        blk.attn, attn_spec(cfg), h, pos, freqs, kv, slot_pos)
    ssm_out, ssm_new = _ssm_branch(cfg, blk, h, ssm_state)
    x = x + _mix_out(attn_out, ssm_out)
    out, _ = _ffn_out(cfg, blk, _norm(cfg, x, blk.ln2))
    return x + out, kv_new, ssm_new


def _embed(model: LM, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    return layers.embed_lookup(model.embed, tokens, dtype=compute_dtype(cfg),
                               scale=scale)


def final_hidden(model: LM, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """The final norm of hidden states ``x``."""
    return layers.rms_norm(x, model.final_norm, plus_one=cfg.norm_plus_one)


def logits_at(model: LM, cfg: ArchConfig, h: torch.Tensor) -> torch.Tensor:
    """h ``[..., D]`` -> ``[..., padded_vocab]`` f32 logits, the padded
    entries at -1e30."""
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    return mask_padded_vocab(cfg, (h @ head.to(compute_dtype(cfg))).float())


def mask_padded_vocab(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """``logits`` with the entries past the vocabulary at -1e30."""
    if cfg.padded_vocab != cfg.vocab:
        mask = torch.zeros(cfg.padded_vocab, device=logits.device)
        mask[cfg.vocab:] = -1e30
        logits = logits + mask
    return logits


def _freqs(cfg: ArchConfig, device) -> torch.Tensor:
    return layers.rope_freqs(cfg.head_dim_, cfg.rope_theta, device=device)


def _rwkv_state(cfg: ArchConfig, batch: int, device) -> rwkv.RWKVState:
    return rwkv.init_state(rwkv_spec(cfg), batch, compute_dtype(cfg), device)


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

@torch.inference_mode()
def forward_train(model: LM, cfg: ArchConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens ``[B, S]`` -> (final hidden ``[B, S, D]``, aux loss: the sum
    of the MoE layers' load-balancing terms, else 0).  Forward only: K5
    has no backward in this port yet."""
    _check_family(cfg)
    model = compute_copy(model, cfg)
    x = _embed(model, cfg, tokens)
    aux = torch.zeros((), device=x.device)
    if cfg.family == "ssm":
        state0 = _rwkv_state(cfg, tokens.shape[0], tokens.device)
        for blk in model.blocks:
            x, _ = rwkv.rwkv_block(blk, rwkv_spec(cfg), x, state0)
        return final_hidden(model, cfg, x), aux
    positions = range(tokens.shape[1])
    freqs = _freqs(cfg, tokens.device)
    for blk in model.blocks:
        x, a = _block_train(cfg, blk, x, positions, freqs)
        aux = aux + a
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
            x, st = rwkv.rwkv_block(blk, rwkv_spec(cfg), x, state0)
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
            x, st = rwkv.rwkv_block(blk, rwkv_spec(cfg), x, st)
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
