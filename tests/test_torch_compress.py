"""Gradient compression (``repro_torch.dist.compress``) held against the
JAX package's ``repro.dist.compress`` on the CPU.

``compress`` computes the reference's arithmetic in the reference's order,
so ``q``, ``scale`` and the new error are compared bit for bit on
numpy-seeded inputs, ROADMAP C.7's input among them.  The error-feedback
bound is stated in f32 ulps: ``|err| <= scale / 2 + 2 ulp(max|v|)`` (the
reference's property test uses an absolute 1e-6, which C.7's input
breaks; that test stays as it is).  ``compressed_psum`` runs on 4 gloo
ranks in one spawn (``torch_dist_worker.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import torch_dist_worker
from repro.dist import compress as jcompress
from repro_torch.dist import compress

ULPS = 2


def _ref(g: np.ndarray, e: np.ndarray):
    c, ne = jcompress.compress(jnp.asarray(g), jnp.asarray(e))
    return np.asarray(c.q), np.asarray(c.scale), np.asarray(ne)


def _port(g: np.ndarray, e: np.ndarray):
    c, ne = compress.compress(torch.from_numpy(np.array(g)),
                              torch.from_numpy(np.array(e)))
    return c.q.numpy(), c.scale.numpy(), ne.numpy()


def _assert_same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _bound_ok(v: np.ndarray, err: np.ndarray, scale: np.ndarray) -> bool:
    ulp = np.spacing(np.float32(np.abs(v).max()))
    return float(np.abs(err).max()) <= float(scale) / 2 + ULPS * float(ulp)


@pytest.mark.parametrize("shape,scale,err_scale", [
    ((64,), 1.0, 0.0), ((8, 33), 0.01, 0.001), ((3, 5, 7), 100.0, 0.5),
    ((256,), 1e-30, 0.0), ((16,), 0.0, 0.0), ((4, 4), 1e4, 10.0)])
def test_compress_bit_for_bit(shape, scale, err_scale):
    rng = np.random.default_rng(hash((shape, scale)) % 2 ** 32)
    g = (rng.normal(size=shape) * scale).astype(np.float32)
    e = (rng.normal(size=shape) * err_scale).astype(np.float32)
    want, got = _ref(g, e), _port(g, e)
    _assert_same(want, got)
    assert got[0].dtype == np.int8 and abs(int(got[0].min())) <= 127
    np.testing.assert_array_equal(
        compress.decompress(compress.Compressed(
            torch.from_numpy(got[0]), torch.from_numpy(got[1]))).numpy(),
        got[0].astype(np.float32) * got[1])


def test_c7_input_five_steps_bit_for_bit_within_ulp_bound():
    """ROADMAP C.7: the reference test's draw at seed 600, scale
    85.01720035437488, whose residual exceeds ``scale / 2 + 1e-6``."""
    g = np.array(jax.random.normal(jax.random.PRNGKey(600), (64,))
                 * 85.01720035437488)
    e_ref = e_port = np.zeros(64, np.float32)
    over_abs = False
    for _ in range(5):
        q, s, ne_ref = _ref(g, e_ref)
        got = _port(g, e_port)
        _assert_same((q, s, ne_ref), got)
        v = g + e_port
        assert _bound_ok(v, got[2], got[1])
        over_abs |= float(np.abs(got[2]).max()) > float(s) * 0.5 + 1e-6
        e_ref, e_port = ne_ref, got[2]
    assert over_abs     # the input does break the absolute 1e-6 bound


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 31 - 1), scale=st.floats(0.01, 1000.0),
       n=st.integers(1, 200))
def test_compress_error_feedback_ulp_bound(seed, scale, n):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n,)) * scale).astype(np.float32)
    err = torch.zeros(n)
    for _ in range(5):
        v = g + err.numpy()
        c, err = compress.compress(torch.from_numpy(g), err)
        assert _bound_ok(v, err.numpy(), c.scale.numpy())


def test_compress_tree_and_init_error_follow_the_reference():
    g, e = torch_dist_worker.compress_inputs(0)
    jc, je = jcompress.compress_tree(jax.tree.map(jnp.asarray, g),
                                     jax.tree.map(jnp.asarray, e))
    tg = {"a": torch.from_numpy(g["a"]),
          "b": {"w": torch.from_numpy(g["b"]["w"])}}
    te = {"a": torch.from_numpy(e["a"]),
          "b": {"w": torch.from_numpy(e["b"]["w"])}}
    pc, pe = compress.compress_tree(tg, te)
    for path in (("a",), ("b", "w")):
        def at(t):
            for k in path:
                t = t[k]
            return t
        np.testing.assert_array_equal(np.asarray(at(jc).q),
                                      at(pc).q.numpy())
        np.testing.assert_array_equal(np.asarray(at(je)), at(pe).numpy())
        np.testing.assert_array_equal(
            np.asarray(at(jcompress.decompress_tree(jc, None))),
            at(compress.decompress_tree(pc)).numpy())
    zeros = compress.init_error(tg)
    assert torch.equal(zeros["b"]["w"], torch.zeros(8, 16))


def test_compressed_psum_on_four_gloo_ranks(tmp_path):
    """Each rank's mean equals the mean of the four ranks' dequantized
    values (the reference's compress on each rank's input), and each
    rank's new error equals the reference's ``compress_tree`` of its own
    input."""
    res = torch_dist_worker.spawn("compress", 4, tmp_path, timeout=120)
    deq, errs = [], []
    for r in range(4):
        g, e = torch_dist_worker.compress_inputs(r)
        jc, je = jcompress.compress_tree(jax.tree.map(jnp.asarray, g),
                                         jax.tree.map(jnp.asarray, e))
        deq.append(jax.tree.map(np.asarray,
                                jcompress.decompress_tree(jc, None)))
        errs.append(jax.tree.map(np.asarray, je))
    for key in ("a", "w"):
        def at(t):
            return t["a"] if key == "a" else t["b"]["w"]
        total = at(deq[0]) + at(deq[1]) + at(deq[2]) + at(deq[3])
        want = total / np.float32(4)
        # the ranks' sum may associate differently: 4 ulps of the mean
        atol = 4 * float(np.spacing(np.float32(np.abs(want).max())))
        for r in range(4):
            np.testing.assert_allclose(at(res[r]["mean"]).numpy(), want,
                                       rtol=0, atol=atol)
            np.testing.assert_array_equal(at(res[r]["err"]).numpy(),
                                          at(errs[r]))
        for r in range(1, 4):   # every rank holds the same mean
            np.testing.assert_array_equal(at(res[r]["mean"]).numpy(),
                                          at(res[0]["mean"]).numpy())
