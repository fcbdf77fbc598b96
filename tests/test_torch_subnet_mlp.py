"""K4, the per-unit affine: the port's plain version and its gradient on
the CPU, held against the JAX package's Pallas kernel (interpret mode) and
its einsum reference, at the reference test's shapes and tolerances."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.subnet_mlp import unit_affine_pallas
from repro_torch.kernels import build, ops, subnet_mlp

SHAPES = [(4, 3, 6, 16), (130, 21, 4, 8), (16, 64, 12, 1)]


def _inputs(batch, units, din, dout, seed):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(batch, units, din)).astype(np.float32),
            rs.normal(size=(units, din, dout)).astype(np.float32),
            rs.normal(size=(units, dout)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,units,din,dout", SHAPES)
def test_plain_matches_pallas_interpret_and_reference(batch, units, din, dout,
                                                      dtype):
    """Tolerances of tests/test_kernels.py: 1e-5 in f32, 3e-2 in bf16."""
    x, w, b = _inputs(batch, units, din, dout, seed=batch + din)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx, jw, jb = (jnp.asarray(a, jdt) for a in (x, w, b))
    # the bf16-rounded values, carried exactly into torch
    tx, tw, tb = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  for a in (jx, jw, jb))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for act in (False, True):
        got = subnet_mlp.unit_affine(tx, tw, tb, activate=act)
        assert got.dtype == tdt and got.shape == (batch, units, dout)
        got = got.to(torch.float32).numpy()
        for want in (unit_affine_pallas(jx, jw, jb, activate=act,
                                        interpret=True),
                     jref.unit_affine_ref(jx, jw, jb, activate=act)):
            np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("activate", [False, True])
@pytest.mark.parametrize("broadcast", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_autograd_function_gradients_match_jax(activate, broadcast, bias):
    """dx (through the plain version on w^T), dw and db against jax.grad of
    the einsum; ``broadcast`` is dense mode's stride-0 unit axis."""
    batch, units, din, dout = 9, 5, 7, 4
    x, w, b = _inputs(batch, units, din, dout, seed=3)
    x0 = x[:, 0, :]
    cot = np.random.RandomState(4).normal(
        size=(batch, units, dout)).astype(np.float32)

    def f(xx, ww, bb):
        if broadcast:
            xx = jnp.broadcast_to(xx[:, None, :], (batch, units, din))
        y = jref.unit_affine_ref(xx, ww, bb if bias else 0.0,
                                 activate=activate)
        return jnp.sum(y * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(x0 if broadcast else x, w, b)
    tx = torch.tensor(x0 if broadcast else x, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    xin = tx[:, None, :].expand(batch, units, din) if broadcast else tx
    y = ops.unit_affine(xin, tw, tb if bias else None, activate=activate)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    if bias:
        np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want[2]),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert tb.grad is None


def test_ops_dispatch_by_impl():
    x, w, b = (torch.from_numpy(a) for a in _inputs(6, 3, 5, 2, seed=5))
    want = ops.unit_affine(x, w, b, activate=True, impl="einsum")
    torch.testing.assert_close(ops.unit_affine(x, w, b, activate=True), want,
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.unit_affine(x, w, b, impl="pallas")
    with pytest.raises(ValueError, match="unknown"):
        ops.unit_affine(x, w, b, impl="mxu")


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    build.reset_counters()
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 2, 3, 4, seed=6))
    with pytest.raises(ValueError, match="CUDA"):
        subnet_mlp.unit_affine_cuda(x, w, b)
    subnet_mlp.unit_affine(x, w, b)
    assert build.launch_counts()["unit_affine"] == 0


def test_every_source_is_built_and_a_failed_build_raises(tmp_path,
                                                         monkeypatch):
    assert set(build.SOURCES) == {"lut_kernels", "subnet_mlp",
                                  "flash_attention"}
    assert set(build._SIGNATURES) == set(build.SOURCES)
    assert all(p.is_file() for p in build.SOURCES.values())
    assert "unit_affine_launch" in build._SIGNATURES["subnet_mlp"]
    names = {build._lib_path(n).name for n in build.SOURCES}
    assert len(names) == 3
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    assert not list(tmp_path.glob("*.so"))
