"""The port's selective SSM (``repro_torch.models.ssm``, hymba's second
branch) on the CPU against ``repro.models.ssm``, weights carried across and
inputs from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

# f32: the in-chunk scans associate differently (Hillis-Steele here, JAX's
# odd/even associative_scan there) and the carry enters after the scan;
# observed <= 1e-6
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16: the projections round in bf16 in both; the scan is f32 in both;
# observed 2 ulps (0.03) on outputs of magnitude 2
BF16_TOL = dict(rtol=4e-2, atol=4e-2)


def _np(t):
    return np.array(t, np.float32)


def _specs(d=16, di=32, n=8):
    return ssm.SSMSpec(d, di, n), jssm.SSMSpec(d, di, n)


def _layer(spec, jspec, seed=1):
    jp = jax.tree.map(lambda a: a[0], jssm.init_ssm(jax.random.PRNGKey(seed),
                                                    jspec, 1))
    p = ssm.SSM(spec)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    return jp, p


@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 16), (1, 16), (5, 64),
                                     (130, 64)])
def test_selective_scan_matches_reference(s, chunk):
    """S a multiple of the chunk, S not a multiple (a padded last chunk),
    S = 1 (a decode step) and S below the chunk; a random carried state;
    held also against the recurrence one token at a time in f64."""
    rs = np.random.RandomState(s)
    a = (-np.abs(rs.normal(size=(2, s, 6, 4))) * 0.3).astype(np.float32)
    b = rs.normal(size=(2, s, 6, 4)).astype(np.float32)
    h0 = rs.normal(size=(2, 6, 4)).astype(np.float32)
    jh, jfin = jssm.selective_scan(*map(jnp.asarray, (a, b, h0)),
                                   chunk=chunk)
    h, fin = ssm.selective_scan(*map(torch.from_numpy, (a, b, h0)),
                                chunk=chunk)
    assert h.shape == (2, s, 6, 4) and fin.shape == (2, 6, 4)
    np.testing.assert_allclose(h.numpy(), _np(jh), **F32_TOL)
    np.testing.assert_allclose(fin.numpy(), _np(jfin), **F32_TOL)
    state, outs = h0.astype(np.float64), []
    for t in range(s):
        state = np.exp(a[:, t].astype(np.float64)) * state + b[:, t]
        outs.append(state)
    np.testing.assert_allclose(h.numpy(), np.stack(outs, 1), rtol=1e-5,
                               atol=1e-5)


def test_selective_scan_never_overflows_over_long_decays():
    """8,192 steps of a strong decay (cumulative log-decay -8,192): a closed
    form in exp(-cumsum) would overflow; the chunked form stays finite."""
    a = torch.full((1, 8192, 2, 2), -1.0)
    b = torch.ones((1, 8192, 2, 2))
    h, fin = ssm.selective_scan(a, b, torch.zeros((1, 2, 2)))
    assert torch.isfinite(h).all()
    fixed = 1.0 / (1.0 - np.exp(-1.0))
    np.testing.assert_allclose(fin.numpy(), fixed, rtol=1e-6)


@pytest.mark.parametrize("s", [1, 3, 9])
def test_causal_conv_with_carried_state_matches_reference(s):
    spec, jspec = _specs()
    jp, p = _layer(spec, jspec)
    rs = np.random.RandomState(s + 20)
    x = rs.normal(size=(2, s, 32)).astype(np.float32)
    st = rs.normal(size=(2, 3, 32)).astype(np.float32)
    with torch.no_grad():
        p.conv_b.copy_(torch.from_numpy(rs.normal(size=32).astype(
            np.float32)))
    jp = dict(jp, conv_b=jnp.asarray(p.conv_b.numpy()))
    jy, jst = jssm._causal_conv(jp, jspec, jnp.asarray(x), jnp.asarray(st))
    y, new = ssm._causal_conv(p, spec, torch.from_numpy(x),
                              torch.from_numpy(st))
    np.testing.assert_allclose(y.numpy(), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(new.numpy(), _np(jst))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_ssm_matches_reference_and_continues_a_split_sequence(dtype):
    """The branch over 11 tokens against the reference (f32 at 2e-4, bf16
    at BF16_TOL); in f32 also 7 tokens then 4 from the carried state equal
    the 11 in one call."""
    spec, jspec = _specs()
    jp, p = _layer(spec, jspec)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    if dtype == "bfloat16":      # the reference casts its blocks first
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        p = p.to(torch.bfloat16)
    x = np.random.RandomState(3).normal(size=(2, 11, 16)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(_np(jx.astype(jnp.float32))).to(tdt)
    jy, jst = jssm.apply_ssm(jp, jspec, jx, jssm.init_state(jspec, 2, jdt))
    y, st = ssm.apply_ssm(p, spec, tx, ssm.init_state(spec, 2, tdt))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert y.dtype == tdt and st.h.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(),
                               _np(jy.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(st.h.numpy(), _np(jst.h), **tol)
    np.testing.assert_allclose(st.conv.float().numpy(),
                               _np(jst.conv.astype(jnp.float32)), **tol)
    if dtype == "float32":
        y1, st1 = ssm.apply_ssm(p, spec, tx[:, :7], ssm.init_state(spec, 2,
                                                                   tdt))
        y2, st2 = ssm.apply_ssm(p, spec, tx[:, 7:], st1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-5,
                                   atol=1e-5)
        torch.testing.assert_close(st2.h, st.h, rtol=1e-5, atol=1e-5)


def test_init_ssm_follows_the_reference_rules():
    spec, _ = _specs(d=32, di=64, n=16)
    p = ssm.init_ssm(torch.Generator().manual_seed(0), spec)
    np.testing.assert_allclose(p.log_a[5].numpy(),
                               np.log(np.arange(1, 17, dtype=np.float32)),
                               rtol=1e-6)
    assert bool((p.dt_bias == -4).all()) and bool((p.d_skip == 1).all())
    assert not p.conv_b.any()
    np.testing.assert_allclose(float(p.conv_w.std()), 4 ** -0.5, rtol=0.1)
    np.testing.assert_allclose(float(p.in_proj.std()), 32 ** -0.5, rtol=0.1)
    st = ssm.init_state(spec, 3)
    assert st.h.shape == (3, 64, 16) and st.conv.shape == (3, 3, 64)
    assert st.h.dtype == torch.float32 and st.conv.dtype == torch.bfloat16
