"""The port's whisper encoder-decoder (``repro_torch.models.whisper``) and
cross-attention on the CPU, held against ``repro.models.whisper`` and
``repro.models.attention`` with weights drawn by JAX and carried across,
frames and tokens from numpy seeds."""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.models import attention as jattention
from repro.models import whisper as jwhisper
from repro_torch.configs import lm_archs, whisper_small
from repro_torch.models import attention, whisper

F32_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_archs.py's
# bf16: every layer's norms, projections and GELU round in bf16 in the port
# where XLA's CPU may keep f32; observed 2 ulps (0.03) on logits of
# magnitude 1.5 and on encoder states of magnitude 3
BF16_TOL = dict(rtol=4e-2, atol=4e-2)


def _np(t):
    return np.array(t, np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def carried(request):
    dtype = request.param
    jcfg = dataclasses.replace(jarchs.smoke("whisper-small"), dtype=dtype,
                               remat=False)
    cfg = dataclasses.replace(lm_archs.smoke("whisper-small"), dtype=dtype,
                              remat=False)
    jp = jwhisper.init_params(jax.random.PRNGKey(0), jcfg)
    model = whisper.params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                          "cpu")
    rs = np.random.RandomState(1)
    audio = rs.normal(size=(2, cfg.enc_context, cfg.d_model)).astype(
        np.float32)
    toks = rs.randint(0, cfg.vocab, (2, 12)).astype(np.int32)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    return jcfg, cfg, jp, model, audio, toks, tol


def test_params_round_trip_and_config_wrapper(carried):
    jcfg, cfg, jp, model, _, _, _ = carried
    tree = whisper.params_to_reference(model)
    flat_ref = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray,
                                                                jp))
    flat_port = jax.tree_util.tree_leaves_with_path(tree)
    assert [k for k, _ in flat_ref] == [k for k, _ in flat_port]
    for (k, a), (_, b) in zip(flat_ref, flat_port):
        np.testing.assert_array_equal(a, b, err_msg=str(k))
    assert whisper_small.config() is lm_archs.WHISPER_SMALL
    assert whisper_small.smoke_config() == lm_archs.smoke("whisper-small")
    copy = whisper.compute_copy(model, cfg)
    want = torch.float32 if cfg.dtype == "float32" else torch.bfloat16
    assert all(p.dtype == want for p in copy.parameters())
    assert whisper.compute_copy(copy, cfg) is copy


def test_encode_matches_reference(carried):
    jcfg, cfg, jp, model, audio, _, tol = carried
    got = whisper.encode(model, cfg, torch.from_numpy(audio))
    want = jwhisper.encode(jp, jcfg, jnp.asarray(audio))
    assert got.shape == (2, cfg.enc_context, cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want.astype(jnp.float32)), **tol)


def test_prefill_and_decode_match_reference(carried):
    """Encode, prefill 9 tokens on a 16-slot ring, decode 3; logits and
    every cache entry (the lock-step scalar position, the ring positions,
    self and cross K/V) against the reference."""
    jcfg, cfg, jp, model, audio, toks, tol = carried
    jl, jc = jax.jit(lambda p, a, t: jwhisper.prefill(p, jcfg, a, t, 16))(
        jp, jnp.asarray(audio), jnp.asarray(toks[:, :9]))
    tl, tc = whisper.prefill(model, cfg, torch.from_numpy(audio),
                             torch.from_numpy(toks[:, :9]), 16)
    assert set(tc) == set(jc)

    def check(jl, jc, tl, tc):
        np.testing.assert_allclose(tl.numpy(), _np(jl), **tol)
        for key in jc:
            if key in ("pos", "slot_pos"):
                np.testing.assert_array_equal(tc[key].numpy(),
                                              np.asarray(jc[key]))
            else:
                np.testing.assert_allclose(
                    tc[key].float().numpy(),
                    _np(jc[key].astype(jnp.float32)), **tol, err_msg=key)

    check(jl, jc, tl, tc)
    jdec = jax.jit(lambda p, c, t: jwhisper.decode_step(p, jcfg, c, t))
    for i in range(9, 12):
        jl, jc = jdec(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = whisper.decode_step(model, cfg, tc,
                                     torch.from_numpy(toks[:, i:i + 1]))
        check(jl, jc, tl, tc)
    assert int(tc["pos"]) == 12 and tc["pos"].dim() == 0


def test_forward_train_and_decode_vs_prefill(carried):
    jcfg, cfg, jp, model, audio, toks, tol = carried
    h, aux = whisper.forward_train(model, cfg, torch.from_numpy(audio),
                                   torch.from_numpy(toks))
    jh, _ = jwhisper.forward_train(jp, jcfg, jnp.asarray(audio),
                                   jnp.asarray(toks))
    np.testing.assert_allclose(h.float().numpy(),
                               _np(jh.astype(jnp.float32)), **tol)
    assert float(aux) == 0.0
    if cfg.dtype == "float32":   # decode == prefill, the reference's 2e-4
        a, t = torch.from_numpy(audio), torch.from_numpy(toks)
        full, _ = whisper.prefill(model, cfg, a, t, 16)
        _, cache = whisper.prefill(model, cfg, a, t[:, :11], 16)
        dec, _ = whisper.decode_step(model, cfg, cache, t[:, 11:12])
        torch.testing.assert_close(dec, full, **F32_TOL)
        empty = whisper.init_decode_cache(model, cfg, 2, 16)
        assert {k: tuple(v.shape) for k, v in empty.items()} == \
            {k: tuple(v.shape) for k, v in cache.items()}


@pytest.mark.parametrize("sq", [1, 5])
def test_cross_attention_and_project_kv_match_reference(sq):
    """Cross attention at Sq = 1 (a decode tick) and Sq = 5 over 24
    encoder frames, GQA 4 q heads on 2 KV heads, with biases: the K5 call
    is non-causal with tensor-free positions."""
    spec = attention.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2,
                              head_dim=8, qkv_bias=True, causal=False,
                              rope=False)
    jspec = jattention.AttnSpec(d_model=32, n_heads=4, n_kv_heads=2,
                                head_dim=8, qkv_bias=True, causal=False,
                                rope=False)
    jp = dict(jax.tree.map(lambda a: a[0], jattention.init_attention(
        jax.random.PRNGKey(2), jspec, 1)))
    rs = np.random.RandomState(3)
    for name in ("bq", "bk", "bv"):
        jp[name] = jnp.asarray(rs.normal(size=jp[name].shape), jnp.float32)
    p = attention.Attention(spec)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    enc = rs.normal(size=(2, 24, 32)).astype(np.float32)
    x = rs.normal(size=(2, sq, 32)).astype(np.float32)
    k, v = attention.project_kv(p, spec, torch.from_numpy(enc))
    jk, jv = jattention.project_kv(jp, jspec, jnp.asarray(enc))
    assert k.shape == (2, 2, 24, 8)
    np.testing.assert_allclose(k.numpy(), _np(jk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), _np(jv), rtol=1e-5, atol=1e-5)
    got = attention.cross_attention(p, spec, torch.from_numpy(x), k, v)
    want = jattention.cross_attention(jp, jspec, jnp.asarray(x), jk, jv)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


def test_flash_scan_takes_tensor_positions_only_where_they_do_not_mask():
    """Non-causal, unwindowed: tensor positions (the reference's encoder
    arange and cross-attention full) give the unmasked result; causal or
    windowed calls still need ranges."""
    rs = np.random.RandomState(4)
    q = torch.from_numpy(rs.normal(size=(1, 2, 2, 3, 8)).astype(np.float32))
    k, v = (torch.from_numpy(rs.normal(size=(1, 2, 7, 8)).astype(np.float32))
            for _ in range(2))
    got = attention.flash_scan(q, k, v, causal=False, window=None,
                               q_positions=torch.full((3,), 7),
                               k_positions=torch.arange(7))
    want = jattention.flash_scan(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                 causal=False, window=None,
                                 q_positions=jnp.full((3,), 7),
                                 k_positions=jnp.arange(7), block_k=4)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="range"):
        attention.flash_scan(q, k, v, causal=False, window=4,
                             q_positions=torch.full((3,), 7),
                             k_positions=torch.arange(7))
    with pytest.raises(ValueError, match="positions"):
        attention.flash_scan(q, k, v, causal=False, window=None,
                             q_positions=range(2), k_positions=range(7))


def test_launch_serve_refuses_the_encoder_decoder(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "whisper-small",
                                      "--device", "cpu"])
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main()
