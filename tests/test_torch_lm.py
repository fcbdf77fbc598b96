"""The LM substrate of the port (configs, layers, FFN, the causal LM) on
the CPU, held against the JAX package on the same inputs: weights drawn by
JAX and carried across as numpy, tokens from numpy seeds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.models import ffn as jffn
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro_torch.configs import gemma_2b, lm_archs
from repro_torch.models import ffn, layers, lm

# dense-like smoke configs: qkv bias, GeGLU + tied + (1+w) norm + embed
# scale, plain SwiGLU, squared-ReLU non-gated FFN, qk-norm (vlm family)
DENSE_LIKE = ["qwen2-72b", "gemma-2b", "internlm2-20b", "minitron-4b",
              "chameleon-34b"]
# f32: the packages sum in other orders (the port's attention normalizes
# once at the end, the JAX model's scan per KV block); observed <= 6e-6
F32_TOL = dict(rtol=1e-4, atol=1e-4)
# bf16: the JAX model's scan rounds p to bf16 before the PV product and
# XLA's CPU fuses bf16 chains in f32, where the port rounds every op;
# observed 2 ulps (0.016) on logits of magnitude 0.9 and 1 ulp on K/V
BF16_TOL = dict(rtol=3e-2, atol=3e-2)


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jarchs.smoke(arch), dtype=dtype, remat=False),
            dataclasses.replace(lm_archs.smoke(arch), dtype=dtype,
                                remat=False))


def _carried(arch, dtype="float32"):
    jcfg, cfg = _cfgs(arch, dtype)
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jp, lm.params_from_reference(
        jax.tree.map(np.asarray, jp), cfg, "cpu")


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("arch", list(jarchs.ARCHS))
def test_arch_configs_equal_reference(arch):
    for port, ref in ((lm_archs.get(arch), jarchs.get(arch)),
                      (lm_archs.smoke(arch), jarchs.smoke(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        for prop in ("head_dim_", "padded_vocab", "is_enc_dec", "attn_free",
                     "sub_quadratic"):
            assert getattr(port, prop) == getattr(ref, prop)
        assert port.n_params() == ref.n_params()
        assert port.n_active_params() == ref.n_active_params()
    assert gemma_2b.config() is lm_archs.GEMMA_2B
    assert gemma_2b.smoke_config() == lm_archs.smoke("gemma-2b")


@pytest.mark.parametrize("plus_one", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_and_activations(plus_one, dtype):
    """f32 at 1e-6; bf16 at one bf16 ulp (2^-7 relative): XLA's CPU may
    keep a bf16 chain in f32 where PyTorch rounds each op."""
    rs = np.random.RandomState(0)
    x = rs.normal(size=(2, 5, 16)).astype(np.float32)
    w = rs.normal(size=(16,)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -7)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(tdt)
    np.testing.assert_allclose(
        _np(layers.rms_norm(tx, torch.from_numpy(w), plus_one=plus_one)
            .float()),
        _np(jlayers.rms_norm(jx, jnp.asarray(w), plus_one=plus_one)), **tol)
    pos = np.arange(3, 8, dtype=np.int32)
    freqs = layers.rope_freqs(16, 10_000.0)
    np.testing.assert_allclose(freqs.numpy(),
                               _np(jlayers.rope_freqs(16, 10_000.0)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        _np(layers.apply_rope(tx, torch.from_numpy(pos), freqs).float()),
        _np(jlayers.apply_rope(jx, jnp.asarray(pos),
                               jlayers.rope_freqs(16, 10_000.0))), **tol)
    for name in ("silu", "gelu", "relu", "relu2"):
        np.testing.assert_allclose(
            _np(layers.activation(name)(tx).float()),
            _np(jlayers.activation(name)(jx)), **tol, err_msg=name)
    with pytest.raises(ValueError, match="unknown activation"):
        layers.activation("swish")


def test_embed_lookup_rounds_the_scale_to_the_working_type():
    """gemma's sqrt(2048) = 45.2548 is 45.25 in bf16; the products equal
    the reference's bit for bit."""
    table = np.random.RandomState(1).normal(size=(10, 2048)).astype(
        np.float32)
    ids = np.array([[3, 0, 9]], np.int32)
    scale = 2048 ** 0.5
    got = layers.embed_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                              dtype=torch.bfloat16, scale=scale)
    want = jlayers.embed_lookup(jnp.asarray(table), jnp.asarray(ids),
                                dtype=jnp.bfloat16, scale=scale)
    np.testing.assert_array_equal(_np(got.float()), _np(want))
    exact = torch.from_numpy(table[ids]).to(torch.bfloat16).float() * scale
    assert not torch.equal(got.float(), exact.to(torch.bfloat16).float())
    assert layers.pad_vocab(256000) == 256000 and layers.pad_vocab(129) == 256


@pytest.mark.parametrize("act,gated", [("gelu", True), ("silu", True),
                                       ("relu2", False)])
def test_apply_ffn_matches_reference(act, gated):
    spec, jspec = (ffn.FFNSpec(16, 32, act, gated),
                   jffn.FFNSpec(16, 32, act, gated))
    jp = jax.tree.map(lambda a: a[0], jffn.init_ffn(jax.random.PRNGKey(2),
                                                    jspec, 1))
    p = ffn.FFN(spec)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    x = np.random.RandomState(3).normal(size=(4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        ffn.apply_ffn(p, spec, torch.from_numpy(x)).numpy(),
        _np(jffn.apply_ffn(jp, jspec, jnp.asarray(x))), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-72b", "chameleon-34b",
                                  "minitron-4b"])
def test_params_round_trip(arch):
    jcfg, cfg, jp, model = _carried(arch)
    tree = lm.params_to_reference(model)
    flat_ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                jp))
    flat_port = jax.tree_util.tree_leaves_with_path(tree)
    assert [k for k, _ in flat_ref] == [k for k, _ in flat_port]
    for (k, a), (_, b) in zip(flat_ref, flat_port):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    again = lm.params_from_reference(tree, cfg, "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def _check_cache(jc, tc, tol):
    for key in ("kv_k", "kv_v"):
        np.testing.assert_allclose(_np(tc[key].float()), _np(jc[key]), **tol,
                                   err_msg=key)
    for key in ("slot_pos", "pos"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]),
                                      err_msg=key)


def _prefill_then_decode(arch, dtype, context, tol, n_prompt=20):
    """prefill logits and cache, then three decode steps, JAX vs port."""
    jcfg, cfg, jp, model = _carried(arch, dtype)
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, n_prompt + 3)
                                            ).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jlm.prefill(p, jcfg, t, context))(
        jp, jnp.asarray(toks[:, :n_prompt]))
    tl, tc = lm.prefill(model, cfg, torch.from_numpy(toks[:, :n_prompt]),
                        context)
    assert tl.shape == (2, cfg.padded_vocab) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
    _check_cache(jc, tc, tol)
    jdec = jax.jit(lambda p, c, t: jlm.decode_step(p, jcfg, c, t))
    for i in range(n_prompt, n_prompt + 3):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = lm.decode_step(model, cfg, tc,
                                torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
        _check_cache(jc, tc, tol)


@pytest.mark.parametrize("arch", DENSE_LIKE)
def test_prefill_and_decode_match_reference_f32(arch):
    _prefill_then_decode(arch, "float32", 32, F32_TOL)


def test_prompt_longer_than_context_rolls_the_ring():
    """20 prompt tokens into a 16-slot ring: the roll of prefill_to_cache,
    and decode writing over the oldest slots."""
    _prefill_then_decode("gemma-2b", "float32", 16, F32_TOL)


def test_gemma_smoke_bf16_within_looser_tolerance():
    _prefill_then_decode("gemma-2b", "bfloat16", 32, BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_prefill_in_the_port(dtype):
    """The reference's test_decode_matches_prefill, on the port alone:
    prefill of 17 tokens against prefill of 16 then one decode step, at the
    reference's 2e-4 (f32) and at one bf16 ulp of the largest logit."""
    cfg = dataclasses.replace(lm_archs.smoke("gemma-2b"), dtype=dtype)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    full, _ = lm.prefill(model, cfg, toks, 32)
    _, cache = lm.prefill(model, cfg, toks[:, :16], 32)
    dec, cache = lm.decode_step(model, cfg, cache, toks[:, 16:17])
    assert cache["pos"].tolist() == [17, 17]
    tol = 2e-4 if dtype == "float32" else 2 ** -7 * float(full.abs().max())
    torch.testing.assert_close(dec, full, rtol=tol, atol=tol)
    copy = lm.compute_copy(model, cfg)
    assert copy.embed.dtype == lm.compute_dtype(cfg)
    assert copy.final_norm.dtype == torch.float32
    torch.testing.assert_close(lm.prefill(copy, cfg, toks, 32)[0], full,
                               rtol=0, atol=0)


def test_forward_train_hidden_matches_reference():
    jcfg, cfg, jp, model = _carried("chameleon-34b")
    toks = np.random.RandomState(4).randint(0, cfg.vocab, (2, 16)).astype(
        np.int32)
    h, aux = lm.forward_train(model, cfg, torch.from_numpy(toks))
    jh, jaux = jlm.forward_train(jp, jcfg, jnp.asarray(toks))
    np.testing.assert_allclose(h.numpy(), _np(jh), **F32_TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "rwkv6-7b", "hymba-1.5b",
                                  "whisper-small"])
def test_new_family_smoke_forward_matches_reference(arch):
    """The four families the port once refused: each smoke forward (the
    decoder's teacher-forced hidden states; whisper's over its encoder)
    against the reference with carried weights, f32 at 1e-4; RWKV's
    per-head group norm divides by a small variance and amplifies the
    packages' f32 rounding, so its hidden states are held at 2e-4 of their
    largest magnitude."""
    toks = np.random.RandomState(4).randint(0, 128, (2, 16)).astype(np.int32)
    if arch == "whisper-small":
        from repro.models import whisper as jwhisper
        from repro_torch.models import whisper
        jcfg, cfg = _cfgs(arch)
        jp = jwhisper.init_params(jax.random.PRNGKey(0), jcfg)
        model = whisper.params_from_reference(jax.tree.map(np.asarray, jp),
                                              cfg, "cpu")
        audio = np.random.RandomState(5).normal(
            size=(2, cfg.enc_context, cfg.d_model)).astype(np.float32)
        h, aux = whisper.forward_train(model, cfg, torch.from_numpy(audio),
                                       torch.from_numpy(toks))
        jh, jaux = jwhisper.forward_train(jp, jcfg, jnp.asarray(audio),
                                          jnp.asarray(toks))
        tol = F32_TOL
    else:
        jcfg, cfg, jp, model = _carried(arch)
        h, aux = lm.forward_train(model, cfg, torch.from_numpy(toks))
        jh, jaux = jlm.forward_train(jp, jcfg, jnp.asarray(toks))
        tol = F32_TOL if arch != "rwkv6-7b" else dict(
            rtol=2e-4, atol=2e-4 * float(np.abs(_np(jh)).max()))
    assert h.shape == (2, 16, cfg.d_model)
    np.testing.assert_allclose(h.numpy(), _np(jh), **tol)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if cfg.family == "moe":
        assert float(aux) > 0.0
    with pytest.raises(ValueError, match="whisper"):
        lm.init_params(lm_archs.smoke("whisper-small"), torch.Generator(),
                       "cpu")


NEW_FAMILIES = ["mixtral-8x22b", "dbrx-132b", "rwkv6-7b", "hymba-1.5b"]
# bf16 for the new families: the MoE, SSM and WKV paths chain more bf16
# products than a dense block (router, expert gate, SSM projections, the
# RWKV token-shift LoRA), each rounding where XLA's CPU may keep f32;
# observed up to 4 ulps (0.06) on logits of magnitude 2.6
BF16_NEW_TOL = dict(rtol=6e-2, atol=6e-2)


def _check_states(jc, tc, rtol):
    """The recurrent states, at ``rtol`` of each tensor's largest entry (the
    WKV state sums k v products of magnitude ~30 that cancel)."""
    for key in ("ssm_h", "ssm_conv", "rwkv_wkv", "rwkv_tm", "rwkv_cm"):
        if key in jc:
            want = _np(jc[key])
            np.testing.assert_allclose(
                _np(tc[key].float()), want, rtol=rtol,
                atol=rtol * max(1.0, float(np.abs(want).max())), err_msg=key)
    assert set(tc) == set(jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_family_prefill_and_decode_match_reference(arch, dtype):
    """prefill, then three decode steps, JAX vs port: logits at the
    reference's 2e-4 in f32 (BF16_NEW_TOL in bf16), the ring caches as in
    the dense test, the SSM / RWKV states at 2e-4 of their scale."""
    f32 = dtype == "float32"
    jcfg, cfg, jp, model = _carried(arch, dtype)
    toks = np.random.RandomState(1).randint(0, cfg.vocab, (2, 23)).astype(
        np.int32)
    tol = dict(rtol=2e-4, atol=2e-4) if f32 else BF16_NEW_TOL
    srtol = 2e-4 if f32 else 6e-2
    jl, jc = jax.jit(lambda p, t: jlm.prefill(p, jcfg, t, 32))(
        jp, jnp.asarray(toks[:, :20]))
    tl, tc = lm.prefill(model, cfg, torch.from_numpy(toks[:, :20]), 32)
    np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
    _check_states(jc, tc, srtol)
    if "kv_k" in jc:
        _check_cache(jc, tc, tol)
    jdec = jax.jit(lambda p, c, t: jlm.decode_step(p, jcfg, c, t))
    for i in range(20, 23):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = lm.decode_step(model, cfg, tc,
                                torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
        _check_states(jc, tc, srtol)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("arch", ["qwen2-72b", "mixtral-8x22b", "rwkv6-7b",
                                  "hymba-1.5b", "gemma-2b"])
def test_decode_matches_prefill_like_the_reference(arch):
    """tests/test_archs.py::test_decode_matches_prefill on the port: prefill
    of 17 tokens against prefill of 16 and one decode step, f32 smoke
    configs, 2e-4.  MoE takes capacity_factor 64 as there: capacity
    depends on the group's length, so a 17-token prefill may drop tokens
    (capacity 16 of 34 routings on 4 experts) where a decode step (one
    token, capacity 8) never does."""
    cfg = dataclasses.replace(lm_archs.smoke(arch), dtype="float32",
                              remat=False)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=64.0)
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    full, _ = lm.prefill(model, cfg, toks, 32)
    _, cache = lm.prefill(model, cfg, toks[:, :16], 32)
    dec, _ = lm.decode_step(model, cfg, cache, toks[:, 16:17])
    np.testing.assert_allclose(full.numpy(), dec.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("arch", ["dbrx-132b", "rwkv6-7b", "hymba-1.5b"])
def test_new_family_params_round_trip(arch):
    """The new parameter trees (``blocks.moe.*``, RWKV's flat block tree,
    ``blocks.ssm.*``) carry across both ways, leaf for leaf; the bf16
    compute copy rounds every block leaf (f32-only ones included, as the
    reference's _cast_blocks does) and keeps final_norm f32."""
    jcfg, cfg, jp, model = _carried(arch)
    tree = lm.params_to_reference(model)
    flat_ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                jp))
    flat_port = jax.tree_util.tree_leaves_with_path(tree)
    assert [k for k, _ in flat_ref] == [k for k, _ in flat_port]
    for (k, a), (_, b) in zip(flat_ref, flat_port):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    copy = lm.compute_copy(model, bcfg)
    assert copy.final_norm.dtype == torch.float32
    assert all(p.dtype == torch.bfloat16 for p in copy.blocks.parameters())
    init = lm.init_params(bcfg, torch.Generator().manual_seed(0), "cpu",
                          dtype=torch.bfloat16)
    assert lm.compute_copy(init, bcfg) is init
    assert [n for n, _ in init.named_parameters()] == \
        [n for n, _ in model.named_parameters()]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "hymba-1.5b"])
def test_engine_splices_recurrent_states_into_their_slots(arch):
    """ServeEngine's cache splice writes a request's RWKV (``rwkv_wkv``,
    ``rwkv_tm``, ``rwkv_cm``) or SSM (``ssm_h``, ``ssm_conv``) state into
    its own slot and no other, so two requests of different lengths
    decode in one batch as they do alone."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = dataclasses.replace(lm_archs.smoke(arch), dtype="float32",
                              remat=False)
    model = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    p1 = np.arange(5, dtype=np.int32) + 2
    p2 = np.arange(11, dtype=np.int32) + 7
    eng = ServeEngine(cfg, model, slots=3, context=32, device="cpu")
    keys = [k for k in eng.cache if k.startswith(("rwkv_", "ssm_"))]
    assert len(keys) == (3 if cfg.family == "ssm" else 2)
    eng.submit(Request(rid=0, prompt=p1, max_tokens=4))
    _, solo = lm.prefill(model, cfg, torch.from_numpy(p1)[None], 32)
    slot = next(iter(eng.active))
    for key in keys:
        assert torch.equal(eng.cache[key][:, slot], solo[key][:, 0]), key
        others = [s for s in range(3) if s != slot]
        assert not eng.cache[key][:, others].any(), key
    want = {}
    for rid, prompt in ((0, p1), (1, p2)):
        one = ServeEngine(cfg, model, slots=1, context=32, device="cpu")
        want[rid] = one.run([Request(rid=rid, prompt=prompt,
                                     max_tokens=5)])[0].out_tokens
    eng = ServeEngine(cfg, model, slots=3, context=32, device="cpu")
    done = eng.run([Request(rid=0, prompt=p1, max_tokens=5),
                    Request(rid=1, prompt=p2, max_tokens=5)])
    assert {r.rid: r.out_tokens for r in done} == want


def test_attention_decode_scalar_position_and_init_cache():
    """The lock-step decode path (one scalar position for every row, as
    whisper decodes) against the reference's, f32, at 1e-5."""
    from repro.models import attention as jatt
    from repro_torch.models import attention
    spec = attention.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2,
                              head_dim=8, window=6)
    jspec = jatt.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                          window=6)
    jp = jax.tree.map(lambda a: a[0], jatt.init_attention(
        jax.random.PRNGKey(5), jspec, 1))
    p = attention.Attention(spec)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    cache = attention.init_cache(spec, 2, 16, dtype=torch.float32)
    assert cache.k.shape == (2, 2, 6, 8) and not cache.k.any()
    rs = np.random.RandomState(6)
    x = rs.normal(size=(2, 1, 32)).astype(np.float32)
    kc, vc = (rs.normal(size=(2, 2, 6, 8)).astype(np.float32)
              for _ in range(2))
    pos = 9
    slots = attention.cache_positions(pos, 6)
    slots = torch.where(torch.arange(6) == pos % 6, pos, slots)
    freqs = layers.rope_freqs(8)
    out, new = attention.attention_decode(
        p, spec, torch.from_numpy(x), torch.tensor(pos, dtype=torch.int32),
        freqs, attention.KVCache(torch.from_numpy(kc), torch.from_numpy(vc)),
        slots)
    jout, jnew = jatt.attention_decode(
        jp, jspec, jnp.asarray(x), jnp.asarray(pos, jnp.int32),
        jlayers.rope_freqs(8), jatt.KVCache(jnp.asarray(kc), jnp.asarray(vc)),
        jnp.asarray(slots.numpy()))
    np.testing.assert_allclose(out.numpy(), _np(jout), rtol=1e-5, atol=1e-5)
    for a, b in ((new.k, jnew.k), (new.v, jnew.v)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("module", [
    "chameleon_34b", "dbrx_132b", "gemma_2b", "hymba_1_5b", "internlm2_20b",
    "minitron_4b", "mixtral_8x22b", "qwen2_72b", "rwkv6_7b",
    "whisper_small"])
def test_arch_wrapper_modules_equal_reference(module):
    """Every ``--arch`` module of the reference has its counterpart, with
    equal full and smoke configs."""
    import importlib
    port = importlib.import_module(f"repro_torch.configs.{module}")
    ref = importlib.import_module(f"repro.configs.{module}")
    assert dataclasses.asdict(port.config()) == \
        dataclasses.asdict(ref.config())
    assert dataclasses.asdict(port.smoke_config()) == \
        dataclasses.asdict(ref.smoke_config())


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "dbrx-132b", "rwkv6-7b",
                                  "hymba-1.5b"])
def test_launch_serve_serves_the_new_families(arch, monkeypatch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --device cpu``
    serves the smoke config: every request gets its tokens (the first from
    its prefill, 3 decoded)."""
    import sys
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", arch, "--device", "cpu", "--requests", "3",
        "--max-tokens", "4"])
    serve.main()
    out = capsys.readouterr().out.splitlines()
    assert len([line for line in out if line.startswith("req ")]) == 3
    assert out[-1].startswith("9 tokens") and out[-1].endswith("on cpu")
