"""The assembly search of the port held against the JAX package.

The port's inits come from torch generators, not JAX keys, so a whole
search cannot pick the reference's survivors from its own training.  Each
part is held where the two can agree: candidate generation, validation,
rounding, shape signatures and the Pareto logic exactly; the driver's
control flow exactly, with the scorer and the promotion patched in both
packages to fixed functions of a candidate's name; the population forward
and one population step on carried parameters within stated tolerances;
each candidate of a stacked group against its own single forward and step;
a 4-slot CPU mesh (with a straggler and a lost slot) against the sliced
sequential run; and one real search on the CPU end to end, its artifacts
cross-loaded by the JAX package."""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipeline
from repro import search as jsearch
from repro.configs import paper_tasks as jtasks
from repro.core import assemble as jassemble
from repro.core import hwcost as jhwcost
from repro.dist import straggler as jstraggler
from repro.search import driver as jdriver
from repro.train import lut_trainer as jtrainer
from repro.train import optim as joptim
from repro_torch import backends as tbackends
from repro_torch import pipeline as tpipeline
from repro_torch import search as tsearch
from repro_torch.configs import paper_tasks as ttasks
from repro_torch.core import assemble as tassemble
from repro_torch.core import hwcost as thwcost
from repro_torch.data import synthetic as tsynthetic
from repro_torch.dist import straggler as tstraggler
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.search import driver as tdriver
from repro_torch.train import lut_trainer as ttrainer
from repro_torch.train import optim as toptim

TOL = dict(rtol=1e-5, atol=1e-5)      # forwards: f32 summation order only
STEP_TOL = dict(rtol=1e-4, atol=1e-5)  # one optimizer step
LR = 5e-3


@pytest.fixture
def one_thread():
    """One torch thread: the float sums, and so every trajectory compared
    bit for bit, then do not depend on the core count."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tcfg(cfg):
    return tpipeline.config_from_dict(jpipeline.config_to_dict(cfg))


def _cands(cands):
    return [(c.name, jpipeline.config_to_dict(c.cfg), c.learn_beta)
            for c in cands]


def _tcands(cands):
    return [(c.name, tpipeline.config_to_dict(c.cfg), c.learn_beta)
            for c in cands]


def _budgets():
    return {"smoke": (jsearch.SearchBudget.smoke(),
                      tsearch.SearchBudget.smoke()),
            "default": (jsearch.SearchBudget(), tsearch.SearchBudget()),
            "tight": (jsearch.SearchBudget(max_addr_bits=6),
                      tsearch.SearchBudget(max_addr_bits=6))}


# ---------------------------------------------------------------------------
# candidate space, exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", ["smoke", "default", "tight"])
@pytest.mark.parametrize("task", list(jtasks.task_names()))
def test_generate_candidates_match_reference(task, budget):
    """Names, configs, learn_beta flags and order of the candidates, and
    every recorded rejection with its reason."""
    jb, tb = _budgets()[budget]
    assert dataclasses.asdict(jb) == dataclasses.asdict(tb)
    jc, jrej = jsearch.generate_candidates(jtasks.task_config(task), jb)
    tc, trej = tsearch.generate_candidates(ttasks.task_config(task), tb)
    assert _tcands(tc) == _cands(jc)
    assert trej == jrej
    assert [tsearch.shape_signature(c.cfg) for c in tc] == [
        jsearch.shape_signature(c.cfg) for c in jc]
    for c, d in zip(tc, jc):
        assert tsearch.validate(c.cfg, tb) == jsearch.validate(d.cfg, jb)
        assert (round(tdriver._analytic_adp(c.cfg, 3), 6)
                == round(jdriver._analytic_adp(d.cfg, 3), 6))


def test_task_registry_matches_reference():
    assert ttasks.task_names() == jtasks.task_names()
    assert ttasks.reduced_task_names() == jtasks.reduced_task_names()
    for name in ttasks.task_names():
        assert ttasks.task_dataset(name) == jtasks.task_dataset(name)
    with pytest.raises(ValueError, match="unknown task"):
        ttasks.task_dataset("nope")


def test_validate_matches_reference_on_tight_budgets():
    rs = np.random.RandomState(0)
    for task in jtasks.task_names():
        jc, _ = jsearch.generate_candidates(jtasks.task_config(task),
                                            jsearch.SearchBudget())
        for c in jc:
            for addr, cap in ((4, 1 << 30), (12, 100),
                              (int(rs.randint(3, 14)),
                               int(rs.randint(1, 1 << 22)))):
                jb = jsearch.SearchBudget(max_addr_bits=addr,
                                          max_table_entries=cap)
                tb = tsearch.SearchBudget(max_addr_bits=addr,
                                          max_table_entries=cap)
                assert (tsearch.validate(_tcfg(c.cfg), tb)
                        == jsearch.validate(c.cfg, jb)), (task, c.name)


def test_round_and_validate_matches_reference():
    """Random learned betas (ties at .5 included) round to the same widths
    and the same accept / reject verdicts."""
    rs = np.random.RandomState(1)
    for task in ("nid_reduced", "jsc_reduced", "mnist_reduced", "nid"):
        base = jtasks.task_config(task)
        n = len(base.layers) - 1
        for _ in range(25):
            beta = rs.uniform(0.2, 8.8, n)
            if rs.rand() < 0.3:
                beta = np.round(beta * 2) / 2          # exact .5 ties
            for cap in (4 << 20, 2000):
                jb = jsearch.SearchBudget(max_table_entries=cap)
                tb = tsearch.SearchBudget(max_table_entries=cap)
                jcfg, jr = jsearch.round_and_validate(base, beta, jb)
                tcfg, tr = tsearch.round_and_validate(_tcfg(base), beta, tb)
                assert tr == jr
                assert (tcfg is None) == (jcfg is None)
                if tcfg is not None:
                    assert tpipeline.config_to_dict(tcfg) == \
                        jpipeline.config_to_dict(jcfg)


def test_pareto_frontier_and_order_match_reference():
    rs = np.random.RandomState(2)
    for n in (1, 2, 5, 9, 17, 40):
        for _ in range(10):
            acc = rs.randint(0, 6, n) / 5.0         # many ties
            adp = rs.randint(1, 8, n) * 10.0
            pts = [(float(a), float(d)) for a, d in zip(acc, adp)]
            assert tsearch.pareto_frontier(pts) == jsearch.pareto_frontier(pts)
            assert tsearch.pareto_order(pts) == jsearch.pareto_order(pts)


def test_quant_bounds_and_stack_bounds_match_reference():
    base = jtasks.reduced("nid")
    layers = list(base.layers)
    layers[0] = dataclasses.replace(layers[0], add_terms=2, add_bits=3)
    add = dataclasses.replace(base, layers=tuple(layers))
    beta = dataclasses.replace(base, layers=tuple(
        dataclasses.replace(l, bits=l.bits + 1) for l in base.layers))
    for cfgs in ([base, beta, base], [add, add]):
        want = jax.tree.leaves(jtrainer.stack_bounds(cfgs))
        got = tassemble.tree_leaves(ttrainer.stack_bounds(
            [_tcfg(c) for c in cfgs]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    beta_l = np.array([[1.4, 2.5, 3.6], [7.7, 0.2, 2.49]], np.float32)
    want = jax.tree.leaves(jtrainer.bounds_with_rounded_beta(
        base, jtrainer.stack_bounds([base, base]), beta_l))
    got = tassemble.tree_leaves(ttrainer.bounds_with_rounded_beta(
        _tcfg(base), ttrainer.stack_bounds([_tcfg(base)] * 2), beta_l))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_straggler_detector_and_retry_match_reference():
    rs = np.random.RandomState(3)
    dts = list(rs.uniform(0.5, 1.5, 30)) + [9.0, 1.0, 12.0, 0.9]
    jd = jstraggler.StragglerDetector(warmup=3, factor=2.0)
    td = tstraggler.StragglerDetector(warmup=3, factor=2.0)
    assert ([td.observe(i, d) for i, d in enumerate(dts)]
            == [jd.observe(i, d) for i, d in enumerate(dts)])
    assert td.events == jd.events and td.events
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("lost")
        return len(calls)

    restored = []
    assert tstraggler.retry_step(flaky, lambda: restored.append(1)) == 3
    assert len(restored) == 2
    with pytest.raises(RuntimeError, match="always"):
        tstraggler.retry_step(_raise, lambda: None, max_retries=1)


def _raise():
    raise RuntimeError("always")


# ---------------------------------------------------------------------------
# the driver's control flow, exactly, under injected scores
# ---------------------------------------------------------------------------

def _u(*parts) -> float:
    """A fixed number in [0, 1) from its arguments."""
    return (zlib.crc32(repr(parts).encode()) % 10_000) / 10_000.0


def _fake_beta(name, n_hidden):
    return np.array([1.0 + 7.5 * _u(name, "beta", l)
                     for l in range(n_hidden)], np.float32)


def _patch_scorer(monkeypatch, drv, hw, point_cls, accuracy):
    """Rung accuracies and learned betas as fixed functions of a
    candidate's name (and the rung), promotion as the analytic ADP and a
    fixed accuracy, in the package whose driver is ``drv``."""
    def rung(candidates, data, budget, steps, *rest):
        accs = {c.name: _u(c.name, steps) for c in candidates}
        betas = {c.name: _fake_beta(c.name, len(c.cfg.layers) - 1)
                 for c in candidates if c.learn_beta}
        return accs, betas

    def run_slice(job, data, budget, *rest):
        acc = np.array([_u(m.name, job.steps) for m in job.members])
        beta = (np.stack([_fake_beta(m.name, len(m.cfg.layers) - 1)
                          for m in job.members]) if job.learn_beta else None)
        return acc, beta

    def promote(cand, data, budget, rung_acc, **kw):
        rep = hw.report(cand.cfg, pipeline_every=budget.pipeline_every)
        return point_cls(
            name=cand.name, cfg=cand.cfg, accuracy=accuracy(cand, rep),
            luts=rep.luts, adp=rep.area_delay, latency_ns=rep.latency_ns,
            fmax_mhz=rep.fmax_mhz, calibration=1.0, rung_accuracy=rung_acc,
            compiled=None, learned_beta=cand.learn_beta)

    if hasattr(drv, "_rung"):
        # the reference's unsliced rung; the port runs one slice a group
        monkeypatch.setattr(drv, "_rung", rung)
    monkeypatch.setattr(drv, "_run_slice", run_slice)
    monkeypatch.setattr(drv, "_promote", promote)


def _summary(res, to_dict):
    return {"rungs": res.rungs, "evaluated": res.evaluated,
            "rejected": res.rejected,
            "promoted": [(p.name, to_dict(p.cfg), p.accuracy, p.adp,
                          p.rung_accuracy, p.learned_beta)
                         for p in res.promoted],
            "frontier": [p.name for p in res.frontier],
            "dist": res.dist}


ACCURACY = {
    # promoted accuracy independent of size: a frontier of a few points
    "hashed": lambda cand, rep: _u(cand.name, "full"),
    # accuracy falling with area: every bigger design is dominated, so the
    # frontier stays short and phase B fills it from the whole set
    "anti": lambda cand, rep: 1.0 - rep.area_delay / 1e7,
}


@pytest.mark.parametrize("accuracy", sorted(ACCURACY))
@pytest.mark.parametrize("rungs", [(16,), (16, 40)])
@pytest.mark.parametrize("mode", ["plain", "sliced"])
@pytest.mark.parametrize("task", ["nid_reduced", "jsc_reduced"])
def test_search_control_flow_matches_reference(task, mode, rungs, accuracy,
                                               monkeypatch):
    """On ``SearchBudget.smoke()`` (its one rung, and two), unsliced and in
    3 slices: rung survivors, the promotion queue (with the diversity
    slot), the phase-B picks, the rejections (post-rounding ones included)
    and the frontier's names and order are the reference's."""
    _patch_scorer(monkeypatch, jdriver, jhwcost, jdriver.FrontierPoint,
                  ACCURACY[accuracy])
    _patch_scorer(monkeypatch, tdriver, thwcost, tdriver.FrontierPoint,
                  ACCURACY[accuracy])
    kw = dict(rungs=rungs)
    if mode == "sliced":
        kw["population_slices"] = 3
    jb = dataclasses.replace(jsearch.SearchBudget.smoke(), **kw)
    tb = dataclasses.replace(tsearch.SearchBudget.smoke(), **kw)
    want = jdriver.run_search(task, jb, data=object())
    got = tdriver.run_search(task, tb, data=object(), device="cpu")
    assert _summary(got, tpipeline.config_to_dict) == _summary(
        want, jpipeline.config_to_dict)
    assert len(got.promoted) >= tb.promote
    if accuracy == "anti":
        assert len(got.promoted) > tb.promote        # phase B ran


# ---------------------------------------------------------------------------
# population training against the reference
# ---------------------------------------------------------------------------

def _groups():
    base = jtasks.reduced("nid")
    up = dataclasses.replace(base, layers=tuple(
        dataclasses.replace(l, bits=l.bits + 1) for l in base.layers))
    down = dataclasses.replace(base, layers=tuple(
        dataclasses.replace(l, bits=max(1, l.bits - 1)) for l in base.layers))
    layers = list(base.layers)
    layers[0] = dataclasses.replace(layers[0], add_terms=2, add_bits=3)
    add = dataclasses.replace(base, layers=tuple(layers))
    add_up = dataclasses.replace(add, layers=(dataclasses.replace(
        layers[0], add_bits=4),) + tuple(layers[1:]))
    jsc = jtasks.reduced("jsc")
    jsc_up = dataclasses.replace(jsc, layers=tuple(
        dataclasses.replace(l, bits=l.bits + 1) for l in jsc.layers))
    return {"nid_beta": [base, up, down], "nid_additive": [add, add_up],
            "jsc_beta": [jsc, jsc_up]}


def _data(cfg):
    name = {593: "nid", 16: "jsc_openml"}[cfg.in_features]
    return tsynthetic.load(name, n_train=512, n_test=256)


def _population(cfgs, seed=0):
    tcfgs = [_tcfg(c) for c in cfgs]
    pop = ttrainer.init_population(ttrainer.population_seeds(seed, len(cfgs)),
                                   tcfgs[0], device="cpu")
    return tcfgs, pop


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("group", sorted(_groups()))
def test_population_params_round_trip_in_reference_layout(group):
    """A stacked population carried to the reference's vmapped layout has
    the structure, shapes and dtypes of a ``vmap`` of ``assemble.init``;
    carried back it changes no bit, and candidate i is its own init."""
    cfgs = _groups()[group]
    tcfgs, pop = _population(cfgs)
    tree = tassemble.params_to_reference(pop, population=True)
    shapes = jax.eval_shape(lambda k: jax.vmap(
        lambda kk: jassemble.init(kk, cfgs[0]))(k),
        jax.random.split(jax.random.PRNGKey(0), len(cfgs)))
    assert jax.tree.structure(tree) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert (a.shape, a.dtype) == (b.shape, b.dtype)
    back = tassemble.params_to_reference(tassemble.params_from_reference(
        tree, device="cpu", population=True), population=True)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    seeds = ttrainer.population_seeds(0, len(cfgs))
    for i in range(len(cfgs)):
        own = tassemble.params_to_reference(
            tassemble.init(seeds[i], tcfgs[0], device="cpu"))
        one = tassemble.params_to_reference(
            tassemble.population_member(pop, i))
        for a, b in zip(jax.tree.leaves(one), jax.tree.leaves(own)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("group", sorted(_groups()))
def test_population_forward_matches_reference(group):
    """``population_forward`` on port-initialized candidates carried to the
    reference's layout, in training (BN statistics refreshed) and eval,
    against the reference's ``vmap`` of its one-candidate forward: allclose
    at 1e-5."""
    cfgs = _groups()[group]
    tcfgs, pop = _population(cfgs, seed=4)
    rs = np.random.RandomState(5)
    x = rs.uniform(-1.2, 1.2, (48, cfgs[0].in_features)).astype(np.float32)
    tree = tassemble.params_to_reference(pop, population=True)
    jb = jtrainer.stack_bounds(cfgs)
    tb = ttrainer.stack_bounds(tcfgs)
    for training in (False, True):
        want, new = jax.jit(jax.vmap(
            lambda p, b: jtrainer.population_forward(
                p, cfgs[0], b, x, training=training)))(tree, jb)
        got = ttrainer.population_forward(pop, tcfgs[0], tb, x,
                                          training=training)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        for a, b in zip(jax.tree.leaves(_np(new)), jax.tree.leaves(
                tassemble.params_to_reference(pop, population=True))):
            np.testing.assert_allclose(b, a, **TOL)


def _noise_mask(net):
    """For each float leaf of ``net`` (reference leaf order), the entries
    whose gradient in the step just taken was below 1e-6 in magnitude:
    rounding noise (the last bias before BN, which BN cancels) or near it,
    where Adam's step ``g / (|g| + eps)`` turns a relative difference of
    the gradient into one of the step.  They are held to the step size,
    as tests/test_torch_train.py holds the single model's step."""
    return [np.zeros(tuple(p.shape), bool) if p.grad is None
            else p.grad.abs().numpy() < 1e-6
            for p in tassemble.leaves(net) if p.dtype == torch.float32]


def _population_noise(pop):
    """:func:`_noise_mask` of a stacked population in the reference's
    vmapped layout."""
    tree = tassemble.params_to_reference(pop, population=True)
    shapes = [a.shape for a in jax.tree.leaves(tree)
              if a.dtype == np.float32]
    return [m.reshape(sh) for m, sh in zip(_noise_mask(pop), shapes)]


def _hold_step(got_tree, want_tree, noise):
    got = [np.asarray(a) for a in jax.tree.leaves(_np(got_tree))]
    want = [np.asarray(a) for a in jax.tree.leaves(_np(want_tree))]
    floats = [(g, w) for g, w in zip(got, want) if g.dtype == np.float32]
    assert len(floats) == len(noise)
    for (g, w), nz in zip(floats, noise):
        np.testing.assert_allclose(g[~nz], w[~nz], **STEP_TOL)
        assert np.all(np.abs(g[nz] - w[nz]) <= 2 * LR + 1e-6)
    for g, w in zip(got, want):
        if g.dtype != np.float32:
            np.testing.assert_array_equal(g, w)


def _ref_opt(tree, n):
    opt = joptim.adamw_init(tree)
    return joptim.AdamWState(step=jnp.zeros((n,), jnp.int32), m=opt.m,
                             v=opt.v)


@pytest.mark.parametrize("group", ["nid_beta", "nid_additive"])
def test_one_population_step_matches_reference(group, one_thread):
    """One ``train_population`` step from carried parameters on one batch
    (the reference's jitted vmapped step): losses and parameters allclose
    (rtol 1e-4, atol 1e-5; gradient-noise entries within the Adam step),
    BN statistics included; then ``population_accuracy`` of the stepped
    candidates is the reference's, exactly."""
    cfgs = _groups()[group]
    tcfgs, pop = _population(cfgs, seed=6)
    data = _data(cfgs[0])
    xb, yb = data.x_train[:128], data.y_train[:128]
    tree = tassemble.params_to_reference(pop, population=True)
    jb = jtrainer.stack_bounds(cfgs)
    ocfg = joptim.AdamWConfig(lr=LR, weight_decay=1e-4)
    step = jtrainer._population_step(cfgs[0], ocfg)
    want, _, want_l = step(tree, _ref_opt(tree, len(cfgs)), jb, xb, yb)
    tb = ttrainer.stack_bounds(tcfgs)
    opt = toptim.adamw_init(tassemble.leaves(pop))
    opt, loss, _ = ttrainer.population_step(
        pop, tcfgs[0], toptim.AdamWConfig(lr=LR, weight_decay=1e-4), opt, tb,
        torch.from_numpy(xb), torch.from_numpy(yb))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_l), rtol=1e-6)
    _hold_step(tassemble.params_to_reference(pop, population=True), want,
               _population_noise(pop))
    np.testing.assert_array_equal(
        ttrainer.population_accuracy(tcfgs[0], pop, tb, data, max_eval=256),
        jtrainer.population_accuracy(cfgs[0], want, jb, data, max_eval=256))


@pytest.mark.parametrize("learn_beta", [False, True])
@pytest.mark.parametrize("group", ["nid_beta", "nid_additive"])
def test_one_rolled_population_step_matches_reference(group, learn_beta,
                                                      one_thread):
    """One step of the rolled engine (``train_population_rolled``'s loop,
    the reference's ``fori_loop`` program at one step), with and without
    the learned-beta relaxation: final losses, parameters and beta
    allclose (rtol 1e-4, atol 1e-5; gradient-noise entries within the Adam
    step)."""
    cfgs = _groups()[group]
    tcfgs, pop = _population(cfgs, seed=7)
    data = _data(cfgs[0])
    bs = 128
    xb, yb = data.x_train[:bs], data.y_train[:bs]
    tree = tassemble.params_to_reference(pop, population=True)
    jb = jtrainer.stack_bounds(cfgs)
    n_hidden = len(cfgs[0].layers) - 1
    beta0 = np.array([[c.layers[l].bits + 0.3 for l in range(n_hidden)]
                      for c in cfgs], np.float32)
    ocfg = joptim.AdamWConfig(lr=LR, weight_decay=1e-4)
    run = jtrainer._population_rolled(cfgs[0], ocfg, bs, learn_beta, 0.05,
                                      0.05)
    if learn_beta:
        jbeta = jnp.asarray(beta0)
        proxy0 = jnp.maximum(jax.vmap(
            lambda b: jtrainer._beta_area_proxy(cfgs[0], b))(jbeta), 1.0)
    else:
        jbeta = jnp.zeros((len(cfgs), n_hidden), jnp.float32)
        proxy0 = jnp.ones((len(cfgs),), jnp.float32)
    want, _, want_beta, want_l = run(tree, _ref_opt(tree, len(cfgs)), jbeta,
                                     proxy0, jb, xb, yb, jnp.int32(1))
    tb = ttrainer.stack_bounds(tcfgs)
    opt = toptim.adamw_init(tassemble.leaves(pop))
    beta = proxy = None
    if learn_beta:
        beta = torch.from_numpy(beta0)
        proxy = torch.clamp(ttrainer._beta_area_proxy(tcfgs[0], beta),
                            min=1.0)
        np.testing.assert_allclose(proxy.numpy(), np.asarray(proxy0),
                                   rtol=1e-6)
    opt, loss, beta = ttrainer.population_step(
        pop, tcfgs[0], toptim.AdamWConfig(lr=LR, weight_decay=1e-4), opt, tb,
        torch.from_numpy(xb), torch.from_numpy(yb), beta=beta, proxy0=proxy,
        beta_penalty=0.05, beta_lr=0.05)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_l), rtol=1e-5)
    if learn_beta:
        np.testing.assert_allclose(beta.numpy(), np.asarray(want_beta),
                                   **STEP_TOL)
        assert not np.array_equal(beta.numpy(), beta0)
    _hold_step(tassemble.params_to_reference(pop, population=True), want,
               _population_noise(pop))


def test_train_population_rolled_learns_beta_on_the_cpu(one_thread):
    """The rolled engine with the relaxation: beta moves, stays in [1, 8],
    and the candidates score on the rounded grid; the losses collapse to
    the final step's."""
    base = _tcfg(jtasks.reduced("nid"))
    data = _data(jtasks.reduced("nid"))
    bounds = ttrainer.stack_bounds([base, base])
    beta0 = np.full((2, len(base.layers) - 1), 2.0, np.float32)
    res = ttrainer.train_population_rolled(
        base, bounds, data, steps=6, max_train=256, learn_beta=True,
        beta0=beta0, device="cpu")
    assert res.losses.shape == (2, 1) and np.isfinite(res.losses).all()
    assert res.beta.shape == beta0.shape
    assert (res.beta >= 1.0).all() and (res.beta <= 8.0).all()
    assert not np.array_equal(res.beta, beta0)
    acc = ttrainer.population_accuracy(
        base, res.params, ttrainer.bounds_with_rounded_beta(
            base, bounds, res.beta), data, max_eval=256)
    assert acc.shape == (2,) and ((acc >= 0) & (acc <= 1)).all()
    with pytest.raises(ValueError, match="beta0"):
        ttrainer.train_population_rolled(base, bounds, data, steps=1,
                                         learn_beta=True, device="cpu")


@pytest.mark.parametrize("group", sorted(_groups()))
def test_population_candidates_equal_their_single_models(group, one_thread):
    """Candidate i of a stacked group is ``assemble.apply`` of candidate i
    alone (allclose 1e-5) in training and in eval, and after one
    population step equals one ``train_step`` of candidate i alone
    (allclose rtol 1e-4, atol 1e-5; gradient-noise entries within the Adam
    step): BN statistics and the gradient clip stay per candidate."""
    cfgs = _groups()[group]
    tcfgs, pop = _population(cfgs, seed=8)
    seeds = ttrainer.population_seeds(8, len(cfgs))
    singles = [tassemble.init(s, tcfgs[0], device="cpu") for s in seeds]
    data = _data(cfgs[0])
    x = torch.from_numpy(data.x_train[:96])
    y = torch.from_numpy(data.y_train[:96])
    tb = ttrainer.stack_bounds(tcfgs)
    for training in (False, True):
        got = ttrainer.population_forward(pop, tcfgs[0], tb, x,
                                          training=training)
        for i, (c, net) in enumerate(zip(tcfgs, singles)):
            want = tassemble.apply(net, c, x, training=training)
            np.testing.assert_allclose(got[i].detach().numpy(),
                                       want.detach().numpy(), **TOL)
    _, pop = _population(cfgs, seed=8)
    singles = [tassemble.init(s, tcfgs[0], device="cpu") for s in seeds]
    ocfg = toptim.AdamWConfig(lr=LR, weight_decay=1e-4)
    opt = toptim.adamw_init(tassemble.leaves(pop))
    opt, loss, _ = ttrainer.population_step(pop, tcfgs[0], ocfg, opt, tb,
                                            x, y)
    for i, (c, net) in enumerate(zip(tcfgs, singles)):
        sopt = toptim.adamw_init(tassemble.leaves(net))
        sopt, sloss = ttrainer.train_step(net, c, ocfg, sopt, x, y)
        np.testing.assert_allclose(loss[i].item(), sloss.item(), rtol=1e-6)
        want = tassemble.params_to_reference(net)
        got = tassemble.params_to_reference(
            tassemble.population_member(pop, i))
        _hold_step(got, want, _noise_mask(net))


def test_population_clip_is_per_candidate():
    """AdamW over a stacked population clips each candidate by its own
    norm: the reference's ``vmap`` of ``adamw_update`` on the same stacked
    leaves and gradients (one candidate's gradient 1,000x another's)."""
    rs = np.random.RandomState(9)
    p = 3
    leaves = [rs.normal(size=(p * 4, 3)).astype(np.float32),
              rs.normal(size=(p,)).astype(np.float32),
              np.arange(p * 2, dtype=np.int32).reshape(p, 2)]
    grads = [rs.normal(size=(p * 4, 3)).astype(np.float32),
             rs.normal(size=(p,)).astype(np.float32)]
    grads[0][:4] *= 1000.0
    cfg = joptim.AdamWConfig(lr=1e-2, weight_decay=0.1)
    jp = {"a": leaves[0].reshape(p, 4, 3), "b": leaves[1],
          "c": leaves[2]}
    jg = {"a": grads[0].reshape(p, 4, 3), "b": grads[1],
          "c": np.zeros((p, 2), jax.dtypes.float0)}
    jstate = _ref_opt(jp, p)
    tp = [torch.from_numpy(a.copy()) for a in leaves]
    tstate = toptim.adamw_init(tp)
    tcfg = toptim.AdamWConfig(lr=1e-2, weight_decay=0.1)
    upd = jax.vmap(lambda g, s, pp: joptim.adamw_update(cfg, g, s, pp))
    for _ in range(3):
        jp, jstate, jm = upd(jg, jstate, jp)
        tstate, tm = toptim.adamw_update(
            tcfg, tp, [torch.from_numpy(g) for g in grads] + [None], tstate,
            population=p)
    np.testing.assert_allclose(tm["grad_norm"].numpy(),
                               np.asarray(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(tp[0].numpy(),
                               np.asarray(jp["a"]).reshape(p * 4, 3),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tp[1].numpy(), np.asarray(jp["b"]),
                               rtol=1e-6, atol=1e-7)
    assert tp[2].tolist() == leaves[2].tolist()


# ---------------------------------------------------------------------------
# the slice executor on a 4-slot CPU mesh
# ---------------------------------------------------------------------------

def _mesh_budget(**kw):
    return tsearch.DistributedSearchBudget.from_budget(tsearch.SearchBudget(
        n_candidates=12, rungs=(8,), promote=0, min_frontier=0,
        max_promote_extra=0, train_rows=512, eval_rows=256),
        population_slices=4, straggler_grace_s=30.0, **kw)


@pytest.fixture(scope="module")
def mesh_runs():
    """The sliced sequential run (the identity reference) and the clean
    4-slot mesh run, on one torch thread."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = tsynthetic.load("nid", n_train=1024, n_test=512)
        budget = _mesh_budget()
        clean = tdriver.run_search("nid_reduced", budget, data=data,
                                   device="cpu")
        mesh = make_serving_mesh(slots=4, device="cpu")
        meshed = tdriver.run_search("nid_reduced", budget, data=data,
                                    mesh=mesh)
    finally:
        torch.set_num_threads(before)
    return data, budget, clean, meshed


def _run_with_hooks(hooks, budget, data):
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    tdriver._TEST_HOOKS.clear()
    tdriver._TEST_HOOKS.update(hooks)
    try:
        return tdriver.run_search(
            "nid_reduced", budget, data=data,
            mesh=make_serving_mesh(slots=4, device="cpu"))
    finally:
        tdriver._TEST_HOOKS.clear()
        torch.set_num_threads(before)


def test_mesh_rung_survivors_equal_the_sliced_run(mesh_runs):
    _, _, clean, meshed = mesh_runs
    assert clean.dist["mode"] == "sliced"
    assert meshed.dist["mode"] == "mesh" and meshed.dist["devices"] == 4
    assert meshed.dist["partial"] == [] and meshed.dist["remesh_events"] == []
    assert ([r["survivors"] for r in meshed.rungs]
            == [r["survivors"] for r in clean.rungs])
    assert meshed.evaluated == clean.evaluated     # every rung score


def test_delayed_slot_marks_its_slices_partial(mesh_runs):
    """Slot 1 sleeps past the deadline: its slices are reported partial,
    their candidates keep the previous score (0 at the first rung), the
    rung still converges, and every other candidate scores as in the
    clean run."""
    data, budget, clean, _ = mesh_runs
    tight = tsearch.DistributedSearchBudget.from_budget(
        budget, straggler_factor=1.0, straggler_grace_s=2.0)
    slow = _run_with_hooks({"delay": {1: 9999.0}}, tight, data)
    part = set(slow.dist["partial"])
    assert part and slow.dist["straggler_events"]
    assert slow.dist["straggler_events"][0]["device"] == 1
    assert slow.rungs[0]["partial"] == sorted(part)
    assert slow.rungs[0]["survivors"]
    for e_clean, e_slow in zip(clean.evaluated, slow.evaluated):
        if e_slow["name"] in part:
            assert e_slow["rungs"]["8"] == 0.0
        else:
            assert e_slow["rungs"] == e_clean["rungs"]


def test_lost_slot_remeshes_to_the_clean_survivors(mesh_runs):
    data, budget, clean, _ = mesh_runs
    lost = _run_with_hooks({"fail_once": {2}}, budget, data)
    ev = lost.dist["remesh_events"]
    assert ev and ev[0]["device"] == 2 and ev[0]["ok"]
    assert ev[0]["new_devices"] == 3
    assert lost.dist["partial"] == []
    assert ([r["survivors"] for r in lost.rungs]
            == [r["survivors"] for r in clean.rungs])
    assert lost.evaluated == clean.evaluated


# ---------------------------------------------------------------------------
# a real search end to end on the CPU
# ---------------------------------------------------------------------------

def test_toolflow_search_end_to_end_on_the_cpu(tmp_path, one_thread):
    """``Toolflow.search`` on ``nid_reduced`` with the smoke budget cut to
    fewer promotion steps: a ranked, non-dominated frontier whose
    artifacts round-trip save/load, answer identically on every registered
    backend, and give the same codes when the JAX package loads them.
    Accuracy is not held to the reference's at this cut (the seed spread
    is wider than the +-0.03 band, ROADMAP C.2)."""
    budget = dataclasses.replace(tsearch.SearchBudget.smoke(),
                                 pretrain_steps=20, retrain_steps=30)
    res = tpipeline.Toolflow.search("nid_reduced", budget, device="cpu")
    assert res.task == "nid_reduced" and res.frontier
    accs = [p.accuracy for p in res.frontier]
    assert accs == sorted(accs, reverse=True)
    for p in res.frontier:
        for q in res.frontier:
            if p is not q:
                assert not (q.accuracy >= p.accuracy and q.adp <= p.adp
                            and (q.accuracy > p.accuracy or q.adp < p.adp))
    assert all(e["rungs"] for e in res.evaluated)
    assert len(res.stage_seconds["rungs"]) == len(budget.rungs)
    assert len(res.stage_seconds["promotions"]) == len(res.promoted)
    x = np.random.RandomState(0).uniform(
        -1.0, 1.0, (33, 593)).astype(np.float32)
    for i, p in enumerate(res.frontier):
        assert p.calibration == pytest.approx(1.0, abs=0.02)
        assert p.adp > 0 and p.luts > 0
        ref = p.compiled.predict_codes(x, backend="take").numpy()
        path = p.compiled.save(str(tmp_path / f"front_{i}.npz"))
        loaded = tpipeline.CompiledLUTNetwork.load(path, device="cpu")
        for name in tbackends.available():
            np.testing.assert_array_equal(
                loaded.predict_codes(x, backend=name).numpy(), ref,
                err_msg=f"{p.name}/{name}")
        jnet = jpipeline.CompiledLUTNetwork.load(path)
        np.testing.assert_array_equal(
            np.asarray(jnet.predict_codes(x, backend="take")), ref,
            err_msg=f"{p.name}/JAX")
