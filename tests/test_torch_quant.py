"""The port's integer-code quantization held against the JAX reference.

The reference serves through a jitted executor that closes over the
log-scale; XLA folds ``s = exp(log_scale)`` and turns ``x / s`` into
``x * (1/s)``.  The port reproduces that deployed form bit for bit, which is
what these tests pin, on random floats and on floats one ulp either side of
every rounding midpoint ``(k + 0.5) * s``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro_torch.core import quant as tquant

SPECS = [(1, False), (2, False), (3, True), (4, True), (6, True), (8, True)]


def _log_scales(n, seed):
    """``n`` log-scales, first those where XLA's eager ``exp`` and the
    correctly rounded one differ (the cases that could flip a code)."""
    pool = np.random.RandomState(seed).uniform(-4.0, 1.0, 400).astype(
        np.float32)
    eager = np.asarray(jnp.exp(jnp.asarray(pool)))
    exact = np.array([np.float32(math.exp(float(v))) for v in pool])
    order = np.argsort(eager == exact, kind="stable")
    return pool[order[:n]]


def _jax_deployed(ls, spec, x):
    """The reference's quantizer as its executor runs it: jitted, with the
    log-scale closed over as a constant."""
    params = {"log_scale": jnp.asarray(float(ls))}
    return np.asarray(jax.jit(
        lambda v: jquant.quantize_codes(params, spec, v))(jnp.asarray(x)))


def _midpoint_inputs(ls, spec):
    """Floats at and one ulp either side of every rounding midpoint, for the
    correctly rounded scale and for the reference's eager ``exp``."""
    k = np.arange(spec.qmin - 1, spec.qmax + 1, dtype=np.float32)
    scales = {np.float32(math.exp(float(ls))),
              np.float32(np.asarray(jnp.exp(jnp.asarray(ls))))}
    xs = []
    for s in scales:
        m = ((k + np.float32(0.5)) * s).astype(np.float32)
        xs += [np.nextafter(m, -np.inf, dtype=np.float32), m,
               np.nextafter(m, np.inf, dtype=np.float32)]
    return np.concatenate(xs).astype(np.float32)


@pytest.mark.parametrize("bits,signed", SPECS)
def test_quantize_codes_matches_reference_on_random_floats(bits, signed):
    spec_j, spec_t = jquant.QuantSpec(bits, signed), tquant.QuantSpec(bits, signed)
    rs = np.random.RandomState(bits)
    for ls in _log_scales(2, seed=bits):
        s = math.exp(float(ls))
        x = rs.uniform(spec_j.qmin * s * 1.5, spec_j.qmax * s * 1.5,
                       (64, 7)).astype(np.float32)
        want = _jax_deployed(ls, spec_j, x)
        got = tquant.quantize_codes({"log_scale": float(ls)}, spec_t,
                                    torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
        eager = np.asarray(jquant.quantize_codes(
            {"log_scale": jnp.asarray(ls)}, spec_j, jnp.asarray(x)))
        np.testing.assert_array_equal(got, eager)


@pytest.mark.parametrize("bits,signed", SPECS)
def test_quantize_codes_matches_reference_around_midpoints(bits, signed):
    """+-1 ulp around every (k+0.5)*s, 8 log-scales per spec."""
    spec_j, spec_t = jquant.QuantSpec(bits, signed), tquant.QuantSpec(bits, signed)
    for ls in _log_scales(8, seed=100 + bits):
        x = _midpoint_inputs(ls, spec_j)
        want = _jax_deployed(ls, spec_j, x)
        got = tquant.quantize_codes({"log_scale": float(ls)}, spec_t,
                                    torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"log_scale={ls!r}")


@pytest.mark.parametrize("bits,signed", SPECS)
def test_dequantize_codes_matches_reference(bits, signed):
    spec_j, spec_t = jquant.QuantSpec(bits, signed), tquant.QuantSpec(bits, signed)
    codes = np.arange(2 ** bits, dtype=np.int32)
    for ls in _log_scales(3, seed=200 + bits):
        params = {"log_scale": jnp.asarray(float(ls))}
        want = np.asarray(jax.jit(lambda c: jquant.dequantize_codes(
            params, spec_j, c))(jnp.asarray(codes)))
        got = tquant.dequantize_codes({"log_scale": float(ls)}, spec_t,
                                      torch.from_numpy(codes)).numpy()
        np.testing.assert_array_equal(got, want)


def test_scale_is_correctly_rounded_exp():
    for ls in _log_scales(50, seed=3):
        s, inv = tquant.scale({"log_scale": float(ls)})
        assert s == float(np.float32(math.exp(float(ls))))
        assert inv == float(np.float32(1.0) / np.float32(s))
    # tensor and numpy log-scales read the same value
    assert (tquant.scale({"log_scale": torch.tensor(-0.7)})
            == tquant.scale({"log_scale": np.float32(-0.7)}))


def test_recode_matches_reference():
    a_j, b_j = jquant.QuantSpec(4, True), jquant.QuantSpec(3, False)
    a_t, b_t = tquant.QuantSpec(4, True), tquant.QuantSpec(3, False)
    codes = np.arange(16, dtype=np.int32)
    pa, pb = {"log_scale": -0.3}, {"log_scale": -1.1}
    want = np.asarray(jax.jit(lambda c: jquant.recode(
        {"log_scale": jnp.asarray(pa["log_scale"])}, a_j,
        {"log_scale": jnp.asarray(pb["log_scale"])}, b_j, c))(
            jnp.asarray(codes)))
    got = tquant.recode(pa, a_t, pb, b_t, torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,fan_in", [(1, 6), (2, 3), (3, 2), (6, 1),
                                         (4, 3)])
def test_address_packing_matches_reference(bits, fan_in):
    rs = np.random.RandomState(bits * 10 + fan_in)
    codes = rs.randint(0, 2 ** bits, size=(17, 5, fan_in)).astype(np.int32)
    want = np.array(jquant.pack_address(jnp.asarray(codes), bits, fan_in))
    got = tquant.pack_address(torch.from_numpy(codes), bits, fan_in).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tquant.unpack_address(torch.from_numpy(want), bits, fan_in).numpy(),
        np.asarray(jquant.unpack_address(jnp.asarray(want), bits, fan_in)))
    np.testing.assert_array_equal(
        tquant.all_codes(bits, fan_in).numpy(),
        np.asarray(jquant.all_codes(bits, fan_in)))
    with pytest.raises(ValueError, match="fan_in"):
        tquant.pack_address(torch.from_numpy(codes), bits, fan_in + 1)


@pytest.mark.parametrize("bits,signed", SPECS)
def test_quant_spec_levels_match_reference(bits, signed):
    j, t = jquant.QuantSpec(bits, signed), tquant.QuantSpec(bits, signed)
    assert (t.levels, t.qmin, t.qmax) == (j.levels, j.qmin, j.qmax)


def test_fake_quant_dynamic_matches_reference_with_candidate_bounds():
    """Tensor clip bounds broadcast over a candidate axis ``[B, P, W]``
    (one log-scale and one bit-width a candidate): values, and gradients to
    x, the log-scales and the bounds, half at the clip ties as
    ``jnp.clip`` passes them; equal to ``fake_quant`` at a spec's bounds."""
    rs = np.random.RandomState(21)
    ls = np.log(np.array([0.5, 0.25, 1.0], np.float32)).astype(np.float32)
    lo = np.array([-4.0, 0.0, -2.0], np.float32)
    hi = np.array([3.0, 7.0, 1.0], np.float32)
    x = rs.uniform(-3, 3, (6, 3, 5)).astype(np.float32)
    x[0, :, 0] = lo * np.exp(ls)                 # exactly at the bounds
    x[0, :, 1] = hi * np.exp(ls)
    cot = rs.normal(size=x.shape).astype(np.float32)

    def f(xx, ll, qlo, qhi):
        y = jquant.fake_quant_dynamic({"log_scale": ll[:, None]},
                                      qlo[:, None], qhi[:, None], xx)
        return jnp.sum(y * cot), y

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3),
                                          has_aux=True)(x, ls, lo, hi)
    t = [torch.tensor(a, requires_grad=True) for a in (x, ls, lo, hi)]
    y = tquant.fake_quant_dynamic(t[1][:, None], t[2][:, None],
                                  t[3][:, None], t[0])
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-7)
    for g, w in zip(t, grads):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    spec = tquant.QuantSpec(3, signed=True)
    q = tquant.Quantizer(torch.tensor(float(ls[0])))
    xs = torch.from_numpy(x[:, 0])
    assert torch.equal(
        tquant.fake_quant_dynamic(q, torch.tensor(-4.0), torch.tensor(3.0),
                                  xs),
        tquant.fake_quant(q, spec, xs))


@pytest.mark.parametrize("signed", [False, True])
def test_beta_bounds_pass_their_gradient_through_the_clip(signed):
    """Bounds from a trainable bit-width: values, and the gradient reaching
    beta through the saturated entries, as the reference computes them;
    ``round_beta`` rounds half to even and clips to [1, 8]."""
    rs = np.random.RandomState(22)
    beta = np.array([2.3, 3.0, 4.7], np.float32)
    x = rs.uniform(-40, 40, (7, 3, 4)).astype(np.float32)
    cot = rs.normal(size=x.shape).astype(np.float32)

    def f(b):
        lo, hi = jquant.beta_bounds(b, signed)
        y = jquant.fake_quant_dynamic({"log_scale": jnp.float32(0.0)},
                                      lo[:, None], hi[:, None], x)
        return jnp.sum(y * cot), (lo, hi)

    (_, (wlo, whi)), wg = jax.value_and_grad(f, has_aux=True)(beta)
    tb = torch.tensor(beta, requires_grad=True)
    lo, hi = tquant.beta_bounds(tb, signed)
    y = tquant.fake_quant_dynamic(torch.tensor(0.0), lo[:, None],
                                  hi[:, None], torch.from_numpy(x))
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(lo.detach().numpy(), np.asarray(wlo),
                               rtol=1e-6)
    np.testing.assert_allclose(hi.detach().numpy(), np.asarray(whi),
                               rtol=1e-6)
    assert np.abs(np.asarray(wg)).min() > 0
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(wg), rtol=1e-5)
    b = np.array([0.2, 0.5, 1.5, 2.5, 4.6, 8.5, 9.3, -3.0])
    np.testing.assert_array_equal(tquant.round_beta(b), jquant.round_beta(b))
    np.testing.assert_array_equal(tquant.round_beta(torch.tensor(b)),
                                  jquant.round_beta(b))
    assert tquant.round_beta(b).dtype == np.int64
