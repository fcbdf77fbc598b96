"""K4, the per-unit affine: the port's plain version and its gradient on
the CPU, held against the JAX package's Pallas kernel (interpret mode) and
its einsum reference, at the reference test's shapes and tolerances."""
import re

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
                                  "flash_attention", "flash_attention_wgmma"}
    assert set(build._SIGNATURES) == set(build.SOURCES)
    assert all(p.is_file() for p in build.SOURCES.values())
    assert "unit_affine_launch" in build._SIGNATURES["subnet_mlp"]
    names = {build._lib_path(n).name for n in build.SOURCES}
    assert len(names) == len(build.SOURCES)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build()
    assert not list(tmp_path.glob("*.so"))


def _c_entry_points(text):
    """{name: ctypes argtypes} of the ``extern "C"`` functions of a CUDA
    source, read from their declarations."""
    blocks = re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"', text, re.S)
    decls = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    for block in blocks:
        decls += re.findall(r'^int (\w+)\(([^)]*)\)', block, re.M)
    out = {}
    for name, params in decls:
        types = []
        for param in filter(None, (p.strip() for p in params.split(","))):
            kind = param.rsplit(None, 1)[0]
            types.append(build._P if "*" in param else
                         build._L if kind.endswith("long long") else
                         build._F if kind.endswith("float") else build._I)
        out[name] = tuple(types)
    return out


@pytest.mark.parametrize("source", sorted(build.SOURCES))
def test_every_c_entry_point_has_its_signature(source):
    """Each ``extern "C"`` function of a source has a ``_SIGNATURES`` row
    with its argument types, and each row names such a function."""
    declared = _c_entry_points(build.SOURCES[source].read_text())
    assert declared and declared == build._SIGNATURES[source]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch,units,din,dout", SHAPES)
def test_shared_rows_match_reference_on_the_broadcast(batch, units, din, dout,
                                                      dtype):
    """x as rows shared by every unit ``[B, din]`` (K4's dense route) through
    ``ops.unit_affine`` and ``UnitAffine`` equals the JAX reference on the
    broadcast ``[B, U, din]`` input: 1e-5 in f32, 3e-2 in bf16; on the CPU it
    also equals the stride-0 view bit for bit."""
    x, w, b = _inputs(batch, units, din, dout, seed=batch + dout)
    x0 = x[:, 0, :]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx0, jw, jb = (jnp.asarray(a, jdt) for a in (x0, w, b))
    jx = jnp.broadcast_to(jx0[:, None, :], (batch, units, din))
    tx0, tw, tb = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                   for a in (jx0, jw, jb))
    tol = 1e-5 if dtype == "float32" else 3e-2
    for act in (False, True):
        want = np.asarray(jref.unit_affine_ref(jx, jw, jb, activate=act),
                          np.float32)
        view = ops.unit_affine(tx0[:, None, :].expand(batch, units, din), tw,
                               tb, activate=act)
        for got in (ops.unit_affine(tx0, tw, tb, activate=act),
                    ops.unit_affine(tx0, tw, tb, activate=act,
                                    impl="einsum"),
                    subnet_mlp.UnitAffine.apply(tx0, tw, tb, act)):
            assert got.dtype == tdt and got.shape == (batch, units, dout)
            assert torch.equal(got, view)
            np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                                       rtol=tol, atol=tol)


@pytest.mark.parametrize("activate", [False, True])
@pytest.mark.parametrize("bias", [False, True])
def test_shared_rows_gradients_match_jax(activate, bias):
    """dx ``[B, din]`` (the plain dense reduction), dw and db of shared rows
    against jax.grad through the broadcast einsum, at 1e-5."""
    batch, units, din, dout = 9, 5, 7, 4
    x, w, b = _inputs(batch, units, din, dout, seed=11)
    x0 = x[:, 0, :]
    cot = np.random.RandomState(12).normal(
        size=(batch, units, dout)).astype(np.float32)

    def f(xx, ww, bb):
        xx = jnp.broadcast_to(xx[:, None, :], (batch, units, din))
        y = jref.unit_affine_ref(xx, ww, bb if bias else 0.0,
                                 activate=activate)
        return jnp.sum(y * cot)

    want = jax.grad(f, argnums=(0, 1, 2))(x0, w, b)
    tx = torch.tensor(x0, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    y = ops.unit_affine(tx, tw, tb if bias else None, activate=activate)
    (y * torch.from_numpy(cot)).sum().backward()
    assert tx.grad.shape == (batch, din)
    for got, ref_grad in ((tx.grad, want[0]), (tw.grad, want[1])) + \
            (((tb.grad, want[2]),) if bias else ()):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref_grad),
                                   rtol=1e-5, atol=1e-5)
    dy = torch.from_numpy(cot)
    np.testing.assert_allclose(
        subnet_mlp.unit_affine_dx_plain(dy, tw.detach()).numpy(),
        np.einsum("buo,uio->bi", cot, w), rtol=1e-5, atol=1e-5)


def _old_layout(monkeypatch):
    """Make apply_subnet see shared rows as their stride-0 [B, U, F]
    broadcast, as the forward passed them before shared rows existed."""
    from repro_torch.core import subnet as tsubnet
    orig = tsubnet.apply_subnet

    def expanded(sn, spec, x, **kw):
        if x.dim() == 2:
            x = x[:, None, :].expand(x.shape[0], sn.w[0].shape[0],
                                     x.shape[1])
        return orig(sn, spec, x, **kw)

    monkeypatch.setattr(tsubnet, "apply_subnet", expanded)


def _graph(loss):
    nodes, seen, stack = [], set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        nodes.append(node)
        stack.extend(n for n, _ in node.next_functions)
    return nodes


def _dense_step_grads(cfg, data, inspect=lambda loss: None):
    from repro_torch.core import assemble as tassemble
    from repro_torch.train import lut_trainer as ttrainer
    net = tassemble.init(5, cfg, dense=True, device="cpu")
    loss = ttrainer.loss_fn(net, cfg, torch.from_numpy(data.x_train),
                            torch.from_numpy(data.y_train), dense=True,
                            lasso=1e-4)
    inspect(loss)
    loss.backward()
    return loss, [p.grad for p in tassemble.leaves(net)
                  if isinstance(p, torch.nn.Parameter)]


def test_dense_step_on_shared_rows_matches_the_broadcast_step(monkeypatch):
    """A dense ``mnist_reduced`` loss and its gradients through shared rows
    equal those through the stride-0 broadcast (rtol 1e-5, atol 1e-7: dx is
    summed over units in another order).  No ``ExpandBackward0`` lies
    between the shared rows and a K4 call, and every K4 call on shared rows
    returns a ``[B, din]`` gradient."""
    from repro_torch.configs import paper_tasks
    from repro_torch.data import synthetic
    cfg = paper_tasks.reduced("mnist")
    data = synthetic.load("mnist", n_train=64, n_test=8)
    dense_layers = sum(not s.assemble for s in cfg.layers)

    def inspect(loss):
        k4 = [n for n in _graph(loss)
              if type(n).__name__ == "UnitAffineBackward"]
        assert len(k4) == 4 * len(cfg.layers)
        inputs = [type(n.next_functions[0][0]).__name__ for n in k4]
        assert "ExpandBackward0" not in inputs
        shared = [n for n in k4 if n.saved_tensors[0].dim() == 2]
        assert len(shared) == 2 * dense_layers   # first affine and bypass

    dx_shapes = []
    dx_rows = subnet_mlp._dx_rows

    def recorded(dy, w):
        dx = dx_rows(dy, w)
        dx_shapes.append(tuple(dx.shape))
        return dx

    monkeypatch.setattr(subnet_mlp, "_dx_rows", recorded)
    loss, grads = _dense_step_grads(cfg, data, inspect)
    widths = [cfg.prev_width(l) for l, s in enumerate(cfg.layers)
              if not s.assemble]
    assert sorted(dx_shapes) == sorted((64, f) for f in widths for _ in "ws")
    _old_layout(monkeypatch)
    loss_old, grads_old = _dense_step_grads(cfg, data)
    torch.testing.assert_close(loss, loss_old, rtol=1e-6, atol=0)
    assert len(grads) == len(grads_old)
    for g, g_old in zip(grads, grads_old):
        torch.testing.assert_close(g, g_old, rtol=1e-5, atol=1e-7)


def test_enumerate_through_shared_rows_gives_identical_tables():
    """The fold's enumeration hands each chunk to the subnets as shared
    rows; the tables equal those of the stride-0 broadcast it passed
    before, entry for entry."""
    from repro_torch.configs import paper_tasks
    from repro_torch.core import assemble as tassemble
    from repro_torch.core import folding as tfolding
    from repro_torch.core import quant as tquant
    from repro_torch.core import subnet as tsubnet
    cfg = paper_tasks.reduced("mnist")
    net = tassemble.init(6, cfg, device="cpu")
    for l, spec in enumerate(cfg.layers):
        layer = net.layers[l]

        def eval_chunk(xi):
            out = tsubnet.apply_subnet(layer.subnet, cfg.subnet_spec(l), xi,
                                       activation=cfg.has_activation(l))
            return tquant.quantize_codes(layer.out_q, cfg.quant_spec(l),
                                         out[..., 0])

        def broadcast(x):
            return eval_chunk(x[:, None, :].expand(x.shape[0], spec.units,
                                                   x.shape[1]))

        want = tfolding._enumerate(cfg, l, tfolding._in_q(net, l), broadcast)
        got = tfolding.fold_layer(net, cfg, l)
        assert got.shape == (spec.units, 2 ** (cfg.in_bits(l) * spec.fan_in))
        assert torch.equal(got, want)
