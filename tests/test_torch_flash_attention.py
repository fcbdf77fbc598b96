"""K5, blockwise flash attention: the port's plain version and its
``flash_scan`` on the CPU, held against the JAX package's Pallas kernel
(interpret mode), its ``ref.mha_ref`` and the model's scan, on the same
inputs made with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattention
from repro_torch.kernels import build, flash_attention, ops
from repro_torch.models import attention

# tests/test_kernels.py's cases: (hq, hkv) x (sq, skv, causal, window), D 32
CASES = [(hq, hkv, sq, skv, causal, window)
         for hq, hkv in ((4, 4), (4, 2), (8, 1))
         for sq, skv, causal, window in ((64, 64, True, None),
                                         (64, 64, False, None),
                                         (100, 100, True, 32),
                                         (1, 96, True, None),
                                         (1, 96, True, 24))]


def _qkv(b, hq, hkv, sq, skv, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(b, hq, sq, d)).astype(np.float32),
            rs.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rs.normal(size=(b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window", CASES)
def test_plain_matches_pallas_interpret_and_reference(hq, hkv, sq, skv,
                                                      causal, window):
    """The reference test's tolerance: rtol = atol = 2e-5 in f32."""
    q, k, v = _qkv(2, hq, hkv, sq, skv, 32, seed=hq + sq)
    kw = dict(causal=causal, window=window, q_offset=skv - sq)
    got = flash_attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                          **kw).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32,
                                        interpret=True, **kw),
                 jref.mha_ref(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mqa_head_dim_256(dtype):
    """gemma-2b's layout (8 q heads on one KV head, D 256), causal, ragged
    S = 70 against Pallas with blocks of 32.  f32 at 2e-5.  bf16: both
    compute in f32 from the same bf16 values and round the output once, so
    they differ by at most one bf16 ulp: rtol 2^-7, atol 1e-5."""
    q, k, v = _qkv(1, 8, 1, 70, 70, 256, seed=11)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  for a in (jq, jk, jv))
    got = flash_attention.flash_attention(tq, tk, tv)
    assert got.dtype == tdt and got.shape == (1, 8, 70, 256)
    want = flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32,
                                  interpret=True)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_scan_matches_model_scan_grouped_layout(window):
    """The port's flash_scan (through ops.flash_attention) against the JAX
    model's scan, grouped layout [B, Hkv, G, S, hd], f32, at 2e-5."""
    b, hkv, g, s, d = 2, 2, 2, 40, 16
    rs = np.random.RandomState(3)
    q = rs.normal(size=(b, hkv, g, s, d)).astype(np.float32)
    k = rs.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rs.normal(size=(b, hkv, s, d)).astype(np.float32)
    pos = jnp.arange(s, dtype=jnp.int32)
    want = jattention.flash_scan(*map(jnp.asarray, (q, k, v)), causal=True,
                                 window=window, q_positions=pos,
                                 k_positions=pos, block_k=16)
    got = attention.flash_scan(*map(torch.from_numpy, (q, k, v)),
                               causal=True, window=window,
                               q_positions=range(s), k_positions=range(s))
    assert got.shape == (b, hkv, g, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(NotImplementedError, match="range"):
        attention.flash_scan(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=None, q_positions=range(s),
                             k_positions=torch.arange(s))


def test_ops_dispatch_cpu_takes_the_plain_path():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 9, 9, 16, seed=5))
    build.reset_counters()
    want = ops.flash_attention(q, k, v, impl="ref")
    torch.testing.assert_close(ops.flash_attention(q, k, v), want, rtol=0,
                               atol=0)
    assert build.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="unknown"):
        ops.flash_attention(q, k, v, impl="mxu")
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)


def test_flash_attention_source_is_built_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    assert build.SOURCES["flash_attention"].is_file()
    assert "flash_attention_launch" in build._SIGNATURES["flash_attention"]
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {
        "flash_attention": build.SOURCES["flash_attention"]})
    monkeypatch.setattr(build, "nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    assert not list(tmp_path.glob("*.so"))


def test_port_follows_the_kernel_where_the_reference_forms_differ_in_bf16():
    """bf16 q/k/v [1, 8, 192, 256], causal (ROADMAP C.3): the JAX model's
    scan rounds p to bf16 and pre-scales q in bf16, the Pallas kernel does
    everything in f32.  The port's plain K5 stays within one bf16 ulp
    (rtol 2^-7) of the kernel, and the two reference forms differ by more
    than the port does from the kernel."""
    q, k, v = _qkv(1, 8, 1, 192, 192, 256, seed=7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, block_q=64, block_k=64, interpret=True), np.float32)
    pos = jnp.arange(192, dtype=jnp.int32)
    scan = np.asarray(jattention.flash_scan(
        jq.reshape(1, 1, 8, 192, 256), jk, jv, causal=True, window=None,
        q_positions=pos, k_positions=pos, block_k=64), np.float32)
    port = flash_attention.flash_attention(
        *(torch.from_numpy(np.array(a, np.float32)).bfloat16()
          for a in (jq, jk, jv))).float().numpy()
    np.testing.assert_allclose(port, pallas, rtol=2 ** -7, atol=1e-5)
    port_err = np.abs(port - pallas).max()
    scan_err = np.abs(scan.reshape(pallas.shape) - pallas).max()
    assert scan_err > port_err
