"""The training forward and one training step, held against the JAX
package on the same inputs and on parameters carried across with
``params_from_reference``: fake quantization and batch-norm, the subnets,
the assembled network (dense, sparse, additive), integer codes, losses,
schedules and AdamW."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.core import assemble as jassemble
from repro.core import quant as jquant
from repro.core import subnet as jsubnet
from repro.train import losses as jlosses
from repro.train import lut_trainer as jtrainer
from repro.train import optim as joptim
from repro_torch import pipeline as tpipeline
from repro_torch.core import assemble as tassemble
from repro_torch.core import quant as tquant
from repro_torch.core import subnet as tsubnet
from repro_torch.data import synthetic as tsynthetic
from repro_torch.train import losses as tlosses
from repro_torch.train import lut_trainer as ttrainer
from repro_torch.train import optim as toptim

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tcfg(cfg):
    return tpipeline.config_from_dict(jpipeline.config_to_dict(cfg))


def _carry(params):
    return tassemble.params_from_reference(_np_tree(params), device="cpu")


def _additive_cfg():
    base = jtasks.reduced("nid")
    layers = (jassemble.LayerSpec(12, 3, 2, False, add_terms=2, add_bits=3),
              jassemble.LayerSpec(4, 3, 2, True),
              jassemble.LayerSpec(1, 4, 2, False))
    return dataclasses.replace(base, layers=layers)


def _ref_params(cfg, seed, dense=False):
    """A parameter pytree in the reference's layout (He-initialized weights,
    random mappings) with non-trivial BN statistics and affine, as jnp
    arrays.  The layout is held against ``jassemble.init`` by
    test_params_round_trip_in_reference_leaf_order; drawing it here keeps
    the reference's slow eager init out of every test."""
    tree = tassemble.params_to_reference(
        tassemble.init(seed, _tcfg(cfg), dense=dense, device="cpu"))
    rs = np.random.RandomState(seed)
    for layer in tree["layers"]:
        bn = layer["subnet"]["bn"]
        n = bn["mean"].shape[0]
        bn["mean"] = rs.normal(0, 0.3, n).astype(np.float32)
        bn["var"] = rs.uniform(0.5, 2.0, n).astype(np.float32)
        bn["gamma"] = rs.uniform(0.5, 1.5, n).astype(np.float32)
        bn["beta"] = rs.normal(0, 0.2, n).astype(np.float32)
    return jax.tree.map(jnp.asarray, tree)


def test_fake_quant_values_and_gradients_at_the_bounds():
    """Ties at qmin/qmax pass half the gradient, as jnp.clip does."""
    for spec in (jquant.QuantSpec(2, signed=False),
                 jquant.QuantSpec(3, signed=True)):
        s = 0.5
        grid = np.arange(spec.qmin - 2, spec.qmax + 3) * s
        x = np.concatenate([grid, grid + 0.1, [0.0, 0.74, 0.76]]
                           ).astype(np.float32)
        ls = np.float32(np.log(s))

        def f(xx, lss):
            return jnp.sum(jquant.fake_quant({"log_scale": lss}, spec, xx)
                           * jnp.arange(xx.shape[0]))

        want_y = jquant.fake_quant({"log_scale": ls}, spec, x)
        want_gx, want_gs = jax.grad(f, argnums=(0, 1))(x, ls)
        tq = tquant.Quantizer(torch.tensor(ls))
        tx = torch.tensor(x, requires_grad=True)
        tspec = tquant.QuantSpec(spec.bits, signed=spec.signed)
        y = tquant.fake_quant(tq, tspec, tx)
        (y * torch.arange(x.shape[0])).sum().backward()
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(want_gx))
        assert set(np.unique(tx.grad.numpy() / np.arange(x.shape[0]).clip(1))
                   ) >= {0.5}
        np.testing.assert_allclose(tq.log_scale.grad.numpy(),
                                   np.asarray(want_gs), rtol=1e-5)


@pytest.mark.parametrize("training,batch_stats", [(True, True),
                                                  (True, False),
                                                  (False, True)])
def test_batchnorm_apply_three_modes(training, batch_stats):
    rs = np.random.RandomState(1)
    x = rs.normal(1.0, 2.0, (33, 7)).astype(np.float32)
    p = {"gamma": rs.uniform(0.5, 2, 7).astype(np.float32),
         "beta": rs.normal(size=7).astype(np.float32),
         "mean": rs.normal(size=7).astype(np.float32),
         "var": rs.uniform(0.5, 2, 7).astype(np.float32)}
    cot = rs.normal(size=(33, 7)).astype(np.float32)

    def f(xx, gamma):
        y, new = jquant.batchnorm_apply(dict(p, gamma=gamma), xx,
                                        training=training,
                                        use_batch_stats=batch_stats)
        return jnp.sum(y * cot), (y, new)

    (_, (want_y, want_new)), want_g = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(x, p["gamma"])
    bn = tquant.BatchNorm(7)
    with torch.no_grad():
        for k in p:
            getattr(bn, k).copy_(torch.from_numpy(p[k]))
    tx = torch.tensor(x, requires_grad=True)
    y = tquant.batchnorm_apply(bn, tx, training=training,
                               use_batch_stats=batch_stats)
    (y * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), **TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(want_new[k]), rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_g[0]), **TOL)
    np.testing.assert_allclose(bn.gamma.grad.numpy(), np.asarray(want_g[1]),
                               **TOL)


@pytest.mark.parametrize("spec_kw", [
    dict(fan_in=6, width=16, depth=2, skip_step=2),
    dict(fan_in=3, width=8, depth=3, skip_step=1),
    dict(fan_in=4, width=8, depth=2, skip_step=2, poly_degree=2),
    dict(fan_in=5, width=8, depth=1, skip_step=0, out_dim=3),
    dict(fan_in=4, width=8, depth=0, skip_step=2),
])
@pytest.mark.parametrize("training", [False, True])
def test_apply_subnet_matches_reference(spec_kw, training):
    spec = jsubnet.SubnetSpec(**spec_kw)
    tspec = tsubnet.SubnetSpec(**spec_kw)
    units = 5

    def q():
        return tquant.Quantizer(torch.tensor(0.0))

    def wrap(sn):
        return tassemble.LUTNet(q(), [tassemble.Layer(sn, q())])

    own = tsubnet.init_subnet(torch.Generator().manual_seed(2), tspec, units)
    tree = tassemble.params_to_reference(wrap(own))
    params = jax.tree.map(jnp.asarray, tree["layers"][0]["subnet"])
    x = np.random.RandomState(3).normal(
        size=(17, units, spec.fan_in)).astype(np.float32)
    for act in (False, True):
        want, new = jax.jit(lambda p, xx: jsubnet.apply_subnet(
            p, spec, xx, activation=act, training=training))(params, x)
        sn = tassemble.params_from_reference(tree, device="cpu"
                                             ).layers[0].subnet
        got = tsubnet.apply_subnet(sn, tspec, torch.from_numpy(x),
                                   activation=act, training=training)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        np.testing.assert_allclose(sn.bn.mean.numpy(),
                                   np.asarray(new["bn"]["mean"]), **TOL)
    assert tsubnet.expanded_fan_in(tspec) == jsubnet.expanded_fan_in(spec)
    shapes = jax.eval_shape(lambda: jsubnet.init_subnet(
        jax.random.PRNGKey(2), spec, units))
    assert jax.tree.structure(shapes) == jax.tree.structure(
        tree["layers"][0]["subnet"])
    sal = tsubnet.input_saliency(sn).detach().numpy()
    np.testing.assert_allclose(sal, np.asarray(jsubnet.input_saliency(params)),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tsubnet.l2_group_penalty(sn).item(),
        float(jsubnet.l2_group_penalty(params)), rtol=1e-6)


CASES = {
    "dense": (lambda: jtasks.reduced("nid"), True),
    "sparse_nid": (lambda: jtasks.reduced("nid"), False),
    "sparse_jsc": (lambda: jtasks.reduced("jsc"), False),
    "sparse_mnist": (lambda: jtasks.reduced("mnist"), False),
    "additive": (_additive_cfg, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_assemble_apply_and_codes_match_reference(case):
    make, dense = CASES[case]
    cfg = make()
    params = _ref_params(cfg, 5, dense)
    x = np.random.RandomState(7).uniform(
        -1.5, 1.5, (40, cfg.in_features)).astype(np.float32)
    for training in (False, True):
        net = _carry(params)
        want, new = jax.jit(lambda p, xx: jassemble.apply(
            p, cfg, xx, training=training, dense=dense))(params, x)
        got = tassemble.apply(net, _tcfg(cfg), torch.from_numpy(x),
                              training=training, dense=dense)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        for a, b in zip(jax.tree.leaves(_np_tree(new)),
                        tassemble.leaves(net)):
            np.testing.assert_allclose(b.detach().numpy(), a, **TOL)
    net = _carry(params)
    if not dense:
        want = jax.jit(lambda xx: jassemble.apply_codes(params, cfg, xx))(x)
        got = tassemble.apply_codes(net, _tcfg(cfg), x)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
    np.testing.assert_allclose(
        tassemble.group_lasso(net, _tcfg(cfg)).item(),
        float(jassemble.group_lasso(params, cfg)), rtol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_params_round_trip_in_reference_leaf_order(case):
    """The port's own init has the reference's pytree layout, shapes and
    dtypes, and carrying a tree across and back changes no bit."""
    make, dense = CASES[case]
    cfg = make()
    shapes = jax.eval_shape(lambda: jassemble.init(jax.random.PRNGKey(8),
                                                   cfg, dense=dense))
    own = tassemble.params_to_reference(
        tassemble.init(0, _tcfg(cfg), dense=dense, device="cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(shapes)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    params = _ref_params(cfg, 8, dense)
    net = _carry(params)
    back = tassemble.params_to_reference(net)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [tuple(t.shape) for t in tassemble.leaves(net)] == [
        tuple(b.shape) for b in jax.tree.leaves(params)]


@pytest.mark.parametrize("dense", [True, False])
def test_one_training_step_matches_reference(dense):
    """Loss, gradients and updated parameters from carried params, with the
    BN statistics refreshed and then decayed by AdamW as in the reference.
    Parameters whose gradient is rounding noise (the last bias before BN,
    which BN cancels) get an Adam step of +-lr either way; they are held to
    the step size instead."""
    cfg = jtasks.reduced("mnist")
    tcfg = _tcfg(cfg)
    data = tsynthetic.load("mnist", n_train=256, n_test=16)
    xb, yb = data.x_train[:64], data.y_train[:64]
    params = _ref_params(cfg, 9, dense)
    lasso = 1e-4 if dense else 0.0
    ocfg = joptim.AdamWConfig(lr=5e-3, weight_decay=1e-4,
                              schedule=joptim.sgdr_schedule(100))

    @jax.jit
    def ref_step(p):
        def loss_fn(pp):
            logits, new_p = jassemble.apply(pp, cfg, xb, training=True,
                                            dense=dense)
            loss = jlosses.softmax_cross_entropy(logits, yb)
            return loss + lasso * jassemble.group_lasso(pp, cfg), new_p

        (loss, new_p), grads = jax.value_and_grad(
            loss_fn, has_aux=True, allow_int=True)(p)
        upd, _, _ = joptim.adamw_update(ocfg, grads, joptim.adamw_init(p),
                                        new_p)
        return loss, grads, upd

    want_loss, grads, want_p = ref_step(params)
    tocfg = toptim.AdamWConfig(lr=5e-3, weight_decay=1e-4,
                               schedule=toptim.sgdr_schedule(100))
    net = _carry(params)
    loss = ttrainer.loss_fn(net, tcfg, torch.from_numpy(xb),
                            torch.from_numpy(yb), dense=dense, lasso=lasso)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-6)
    noise = []
    for p, g in zip(tassemble.leaves(net), jax.tree.leaves(grads)):
        g = np.asarray(g)
        if g.dtype == jax.dtypes.float0:
            continue
        got = np.zeros_like(g) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, g, rtol=1e-4, atol=1e-6)
        noise.append(np.abs(g) < 1e-6)
    net = _carry(params)
    opt = toptim.adamw_init(tassemble.leaves(net))
    opt, _ = ttrainer.train_step(net, tcfg, tocfg, opt, torch.from_numpy(xb),
                                 torch.from_numpy(yb), dense=dense,
                                 lasso=lasso)
    assert opt.step == 1
    floats = [(a, b) for a, b in zip(jax.tree.leaves(want_p),
                                     tassemble.leaves(net))
              if b.dtype.is_floating_point]
    assert len(floats) == len(noise)
    for (a, b), nz in zip(floats, noise):
        a, b = np.asarray(a), b.detach().numpy()
        np.testing.assert_allclose(b[~nz], a[~nz], rtol=1e-5, atol=1e-6)
        assert np.all(np.abs(b[nz] - a[nz]) <= 2 * 5e-3 + 1e-6)
    for layer, jlayer in zip(net.layers, want_p["layers"]):
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                getattr(layer.subnet.bn, k).numpy(),
                np.asarray(jlayer["subnet"]["bn"][k]), rtol=1e-5, atol=1e-7)


def test_adamw_matches_reference_on_a_tree_with_int_leaves():
    rs = np.random.RandomState(11)
    params = {"a": rs.normal(size=(4, 3)).astype(np.float32),
              "b": [rs.normal(size=5).astype(np.float32),
                    np.arange(6, dtype=np.int32)]}
    grads = [rs.normal(size=(4, 3)).astype(np.float32) * 3,
             rs.normal(size=5).astype(np.float32) * 3]
    cfg = joptim.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jg = {"a": grads[0], "b": [grads[1], np.zeros((), jax.dtypes.float0)]}
    jstate = joptim.adamw_init(params)
    tp = [torch.from_numpy(params["a"].copy()),
          torch.from_numpy(params["b"][0].copy()),
          torch.from_numpy(params["b"][1].copy())]
    tstate = toptim.adamw_init(tp)
    tcfg = toptim.AdamWConfig(lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    jp = params
    for _ in range(3):
        jp, jstate, jm = joptim.adamw_update(cfg, jg, jstate, jp)
        tstate, tm = toptim.adamw_update(
            tcfg, tp, [torch.from_numpy(g) for g in grads] + [None], tstate)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jp), tp):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    assert tp[2].dtype == torch.int32 and tp[2].tolist() == list(range(6))


def test_schedules_match_reference():
    for sched_j, sched_t in (
            (joptim.sgdr_schedule(7, 2, 0.05, warmup=3),
             toptim.sgdr_schedule(7, 2, 0.05, warmup=3)),
            (joptim.sgdr_schedule(100), toptim.sgdr_schedule(100)),
            (joptim.cosine_schedule(50, warmup=5),
             toptim.cosine_schedule(50, warmup=5))):
        for step in (0, 1, 2, 6, 7, 8, 20, 21, 22, 49, 50, 300, 301):
            np.testing.assert_allclose(
                sched_t(step), float(sched_j(jnp.asarray(step, jnp.int32))),
                rtol=2e-6, atol=1e-7)


def test_losses_and_gradients_match_reference():
    rs = np.random.RandomState(12)
    logits = rs.normal(size=(9, 4)).astype(np.float32)
    labels = rs.randint(0, 4, 9).astype(np.int32)
    logit = np.array([0.0, 0.0, 1.5, -2.0, 0.0, 3.0], np.float32)
    blab = np.array([1, 0, 1, 0, 0, 1], np.int32)
    for jf, tf, a, lab in ((jlosses.softmax_cross_entropy,
                            tlosses.softmax_cross_entropy, logits, labels),
                           (jlosses.binary_cross_entropy,
                            tlosses.binary_cross_entropy, logit, blab),
                           (jlosses.binary_cross_entropy,
                            tlosses.binary_cross_entropy, logit[:, None],
                            blab)):
        want, want_g = jax.value_and_grad(jf)(a, lab)
        ta = torch.tensor(a, requires_grad=True)
        got = tf(ta, torch.from_numpy(lab))
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
        np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_g),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        float(tlosses.accuracy(torch.from_numpy(logits),
                               torch.from_numpy(labels))),
        float(jlosses.accuracy(logits, labels)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.binary_accuracy(torch.from_numpy(logit),
                                      torch.from_numpy(blab))),
        float(jlosses.binary_accuracy(logit, blab)), rtol=1e-6)


def test_trainer_runs_and_refuses_rolled_training():
    cfg = _tcfg(jtasks.reduced("jsc"))
    data = tsynthetic.load("jsc_openml", n_train=512, n_test=256)
    res = ttrainer.train(cfg, data, steps=5, batch_size=128, device="cpu")
    assert len(res.losses) == 5 and all(np.isfinite(res.losses))
    acc = ttrainer.accuracy(cfg, res.params, data, max_eval=256)
    assert acc == ttrainer.accuracy(cfg, res.params, data, folded=True,
                                    max_eval=256)
    with pytest.raises(NotImplementedError, match="search"):
        ttrainer.train(cfg, data, steps=1, rolled=True, device="cpu")


def test_dense_mlp_reference_learns_nid():
    data = tsynthetic.load("nid", n_train=2048, n_test=512)
    acc = ttrainer.dense_mlp_reference(data, [32], steps=120, device="cpu")
    want = jtrainer.dense_mlp_reference(data, [32], steps=120)
    assert acc > 0.7 and abs(acc - want) < 0.05, (acc, want)
