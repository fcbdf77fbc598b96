"""Stateful stream serving in the port, held against the JAX package on the
same inputs and on parameters carried across with ``params_from_reference``:
the recurrent cell's code paths (exact), ``train_stream`` (within ``TOL``),
stream artifacts and toolflow state across the packages, and the port's own
router, engine cell mode, sequence data and task registry.

Sizes are the reference tests' ``tiny_cell`` and ``seqmnist_reduced`` at a
batch of at most 8."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import traffic
from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.core import quant as jquant
from repro.core.assemble import AssembleConfig as JConfig
from repro.core.assemble import LayerSpec as JLayer
from repro.data import synthetic as jsynthetic
from repro.stream import cell as jcell
from repro.stream import session as jsession
from repro.train import lut_trainer as jtrainer
from repro_torch import backends as tbackends
from repro_torch import pipeline as tpipeline
from repro_torch.configs import paper_tasks as ttasks
from repro_torch.core import assemble as tassemble
from repro_torch.core import quant as tquant
from repro_torch.data import synthetic as tsynthetic
from repro_torch.serve.lut_engine import LUTEngine
from repro_torch.stream import cell as tcell
from repro_torch.stream import session as tsession
from repro_torch.train import lut_trainer as ttrainer
from repro_torch.train import optim as toptim

TOL = dict(rtol=1e-5, atol=1e-5)       # tests/test_torch_train.py's
BACKENDS = tuple(tbackends.available())


@pytest.fixture
def one_thread():
    """Train the port on one CPU thread, so that its float sums do not
    depend on the core count (as in test_torch_toolflow.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def tiny_net(n_state=2, bits=2):
    return JConfig(
        in_features=4 + n_state, input_bits=2, input_signed=False,
        layers=(JLayer(12, 3, 2, False), JLayer(4, 3, bits, True)),
        subnet_width=8, subnet_depth=2, skip_step=2)


def _cells(name, n_state=2):
    """(reference cell config, port cell config) of a named cell."""
    if name == "tiny":
        jc = jcell.StreamCellConfig(net=tiny_net(n_state), n_in=4,
                                    n_state=n_state)
    else:
        jc = jtasks.stream_task_config(name)
    tc = tcell.StreamCellConfig(
        net=tpipeline.config_from_dict(jpipeline.config_to_dict(jc.net)),
        n_in=jc.n_in, n_state=jc.n_state)
    return jc, tc


def _params(tc, seed, dense=False):
    """A parameter tree in the reference's layout with non-trivial BN
    statistics and quantizer scales, drawn by the port's init."""
    tree = tassemble.params_to_reference(
        tassemble.init(seed, tc.net, dense=dense, device="cpu"))
    rs = np.random.RandomState(seed)
    for layer in tree["layers"]:
        bn = layer["subnet"]["bn"]
        n = bn["mean"].shape[0]
        bn["mean"] = rs.normal(0, 0.3, n).astype(np.float32)
        bn["var"] = rs.uniform(0.5, 2.0, n).astype(np.float32)
        bn["gamma"] = rs.uniform(0.5, 1.5, n).astype(np.float32)
        bn["beta"] = rs.normal(0, 0.2, n).astype(np.float32)
    return tree


def _both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            tassemble.params_from_reference(tree, device="cpu"))


def _seqs(n, t, n_in, seed, low=0.0, high=3.0):
    return np.random.default_rng(seed).uniform(
        low, high, (n, t, n_in)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny():
    """The tiny cell folded in both packages from the same parameters."""
    jc, tc = _cells("tiny")
    jp, tp = _both(_params(tc, 0))
    return jc, tc, jp, tp, jcell.compile_cell(jp, jc), \
        tcell.compile_cell(tp, tc)


@pytest.fixture(scope="module")
def seqmnist():
    jc, tc = _cells("seqmnist_reduced")
    jp, tp = _both(_params(tc, 1))
    data = tsynthetic.to_sequences(tsynthetic.load("mnist", n_train=8,
                                                   n_test=8), 16)
    return jc, tc, jp, tp, tcell.compile_cell(tp, tc), data.x_train


# ---------------------------------------------------------------------------
# the cell: config, code paths, state edge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", [(6, 0, "n_state"), (3, 2, "input split"),
                                   (2, 4, "final layer")])
def test_cell_config_validation(split):
    n_in, n_state, msg = split
    net = _cells("tiny")[1].net
    with pytest.raises(ValueError, match=msg):
        tcell.StreamCellConfig(net=net, n_in=n_in, n_state=n_state)


@pytest.mark.parametrize("name", ["tiny", "seqmnist_reduced",
                                  "rwkv_mix_reduced"])
def test_cell_abi_matches_reference(name):
    jc, tc = _cells(name)
    assert (tc.n_out, tc.zero_state_code()) == (jc.n_out,
                                                jc.zero_state_code())
    assert dataclasses.asdict(tc.in_spec()) == dataclasses.asdict(
        jc.in_spec())
    assert dataclasses.asdict(tc.out_spec()) == dataclasses.asdict(
        jc.out_spec())


@pytest.mark.parametrize("case", ["tiny", "seqmnist"])
def test_apply_sequence_codes_matches_reference(case, tiny, seqmnist):
    if case == "tiny":
        jc, tc, jp, tp = tiny[:4]
        xs = _seqs(5, 7, 4, seed=1)
    else:
        jc, tc, jp, tp, _, xs = seqmnist
    want = np.asarray(jcell.apply_sequence_codes(jp, jc, jnp.asarray(xs)))
    got = tcell.apply_sequence_codes(tp, tc, xs)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    s0 = np.random.RandomState(2).randint(
        0, tc.in_spec().levels, (xs.shape[0], tc.n_state)).astype(np.int32)
    np.testing.assert_array_equal(
        tcell.apply_sequence_codes(tp, tc, xs, s0).numpy(),
        np.asarray(jcell.apply_sequence_codes(jp, jc, jnp.asarray(xs),
                                              jnp.asarray(s0))))


@pytest.mark.parametrize("training", [False, True])
def test_apply_sequence_matches_reference(training, tiny):
    jc, tc, jp, _ = tiny[:4]
    tp = _both(_params(tc, 0))[1]
    xs = _seqs(6, 5, 4, seed=3)
    ys, sf, new = jcell.apply_sequence(jp, jc, jnp.asarray(xs),
                                       training=training)
    got_ys, got_sf = tcell.apply_sequence(tp, tc, xs, training=training)
    np.testing.assert_allclose(got_ys.detach().numpy(), np.asarray(ys), **TOL)
    np.testing.assert_allclose(got_sf.detach().numpy(), np.asarray(sf), **TOL)
    for a, b in zip(jax.tree.leaves(new), tassemble.leaves(tp)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("be", BACKENDS)
@pytest.mark.parametrize("case", ["tiny", "seqmnist"])
def test_compiled_cell_step_and_sequence_match_reference(case, be, tiny,
                                                         seqmnist):
    """Per backend: the folded tables equal the reference's, every streamed
    step and the offline sequence equal the reference cell's codes, logits
    and state, and both equal the training graph's code reference."""
    if case == "tiny":
        jc, tc, jp, tp, jcomp, tcomp = tiny
        xs = _seqs(4, 7, 4, seed=4)
    else:
        jc, tc, jp, tp, tcomp, xs = seqmnist
        xs = xs[:, :12]
        jcomp = None
    want = np.asarray(jcell.apply_sequence_codes(jp, jc, jnp.asarray(xs)))
    yc, y, s_fin = tcomp.predict_sequence(xs, backend=be)
    np.testing.assert_array_equal(yc.numpy(), want)
    s = tcomp.init_state_codes(xs.shape[0])
    for t in range(xs.shape[1]):
        c, lg, s = tcomp.step(xs[:, t], s, backend=be)
        np.testing.assert_array_equal(c.numpy(), want[:, t])
        np.testing.assert_array_equal(lg.numpy(), y[:, t].numpy())
    np.testing.assert_array_equal(s.numpy(), s_fin.numpy())
    if jcomp is not None:
        for a, b in zip(jcomp.net.tables, tcomp.net.tables):
            np.testing.assert_array_equal(b, np.asarray(a))
        jyc, jy, js = jcomp.predict_sequence(xs, backend="take")
        np.testing.assert_array_equal(yc.numpy(), np.asarray(jyc))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(s_fin.numpy(), np.asarray(js))


def test_state_recode_matches_reference():
    """The state edge: out-boundary codes re-quantized onto the in-boundary,
    across signedness and widths, at random scales."""
    rs = np.random.RandomState(5)
    specs = [(4, True), (4, False), (1, False), (2, True), (8, True)]
    for (fb, fs) in specs:
        for (tb, ts) in specs:
            jf, jt = jquant.QuantSpec(fb, fs), jquant.QuantSpec(tb, ts)
            tf, tt = tquant.QuantSpec(fb, fs), tquant.QuantSpec(tb, ts)
            for _ in range(3):
                lf, lt = float(rs.uniform(-3, 1)), float(rs.uniform(-3, 1))
                codes = rs.randint(0, 2 ** fb, (64, 3)).astype(np.int32)
                want = jax.jit(lambda c: jquant.recode(
                    {"log_scale": lf}, jf, {"log_scale": lt}, jt, c))(codes)
                got = tquant.recode({"log_scale": lf}, tf,
                                    {"log_scale": lt}, tt,
                                    torch.from_numpy(codes))
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["carried", "requantized", None])
def test_state_migration_matches_reference(mode, tiny):
    jc, tc, jp, tp, jcomp, tcomp = tiny
    if mode is None:
        jc3, tc3 = _cells("tiny", n_state=3)
        jp3, tp3 = _both(_params(tc3, 2))
        jnew, tnew = jcell.compile_cell(jp3, jc3), tcell.compile_cell(tp3,
                                                                      tc3)
    else:
        tree = _params(tc, 0)
        if mode == "requantized":
            tree["in_q"]["log_scale"] = tree["in_q"]["log_scale"] + 0.1
        jp2, tp2 = _both(tree)
        jnew, tnew = jcell.compile_cell(jp2, jc), tcell.compile_cell(tp2, tc)
    assert tcell.state_migration_mode(tcomp, tnew) == mode
    assert jcell.state_migration_mode(jcomp, jnew) == mode
    codes = np.random.RandomState(6).randint(
        0, tc.in_spec().levels, (9, tc.n_state)).astype(np.int32)
    if mode is None:
        with pytest.raises(ValueError, match="drain"):
            tcell.migrate_state_codes(tcomp, tnew, codes)
        return
    got = tcell.migrate_state_codes(tcomp, tnew, codes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcell.migrate_state_codes(jcomp, jnew,
                                                          codes)))


@pytest.mark.parametrize("levels", [2, 4, 2 ** 8, 2 ** 8 + 1, 2 ** 12,
                                    2 ** 16, 2 ** 20])
def test_state_dtype_matches_reference(levels):
    assert tsession.state_dtype(levels) is jsession.state_dtype(levels)


@pytest.mark.parametrize("mode", ["carried", "requantized",
                                  "drained+reset"])
def test_stream_store_packs_codes_and_migrates(mode, tiny):
    """Packing, dtype and the hot-swap migration of live state, each mode
    against the reference's store."""
    jc, tc, jp, tp, jcomp, tcomp = tiny
    store = tsession.StreamStore(tcomp)
    store.open("a")
    store.open("b")
    assert store.get("a").dtype == np.int32
    assert store.nbytes == 2 * tc.n_state            # uint8-packed
    with pytest.raises(ValueError, match="already open"):
        store.open("a")
    store.put("a", np.array([1, 3]))
    if mode == "drained+reset":
        jc2, tc2 = _cells("tiny", n_state=3)
        tree = _params(tc2, 2)
    else:
        jc2, tc2 = jc, tc
        tree = _params(tc, 0)
        if mode == "requantized":
            tree["in_q"]["log_scale"] = tree["in_q"]["log_scale"] + 0.4
    jp2, tp2 = _both(tree)
    jnew, tnew = jcell.compile_cell(jp2, jc2), tcell.compile_cell(tp2, tc2)
    jstore = jsession.StreamStore(jcomp)
    jstore.open("a")
    jstore.open("b")
    jstore.put("a", np.array([1, 3]))
    assert store.migrate(tnew) == jstore.migrate(jnew) == mode
    for sid in ("a", "b"):
        np.testing.assert_array_equal(store.get(sid), jstore.get(sid))
    np.testing.assert_array_equal(store.close("a"), jstore.close("a"))
    assert "a" not in store and len(store) == 1
    assert store.stream_ids() == ["b"]


# ---------------------------------------------------------------------------
# training: truncated BPTT against the reference
# ---------------------------------------------------------------------------

def _toy_seq_data(n=48, t=6, n_in=4, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 3, (n, t, n_in)).astype(np.float32)
    score = xs[:, 0].mean(-1)
    y = (score > np.median(score)).astype(np.int32)
    return jsynthetic.SeqDataset("toy-seq", xs, y, xs[:16], y[:16], 2)


@pytest.mark.parametrize("frozen", [False, True])
@pytest.mark.parametrize("dense", [True, False])
def test_train_stream_matches_reference(dense, frozen, monkeypatch,
                                        one_thread):
    """Three truncated-BPTT steps (windows of 4 over 6 steps) from the same
    parameters: losses at ``TOL``, parameters at ``TOL`` except where the
    gradient is rounding noise.

    Wider, and why: the bias before batch-norm has an analytic gradient of
    0 under batch statistics (BN cancels it), so both packages hand Adam
    rounding noise, which it turns into a step of up to +-lr either way;
    every element whose gradient fell below 1e-6 in some step is held to
    2 lr a step instead (test_torch_train.py's rule for one step), and so
    are the BN running means under batch statistics, which track that bias;
    under frozen statistics the means are leaves that AdamW moves and are
    held at ``TOL`` like the other leaves.  The running
    variances are held at rtol 1e-4: they are moments of pre-BN outputs
    that read those noise elements.  The two BN modes are held separately
    (``frozen`` selects frozen-stats BN for every step): a frozen-stats step
    after batch-stats steps normalizes by running means that have drifted
    with the noise, which flips quantized codes in the reference itself."""
    jc, tc = _cells("tiny")
    tree = tassemble.params_to_reference(
        tassemble.init(3, tc.net, dense=dense, device="cpu"))
    data = _toy_seq_data()
    monkeypatch.setattr(jcell, "init", lambda rng, cell, **kw: jax.tree.map(
        jnp.asarray, tree))
    monkeypatch.setattr(tcell, "init", lambda seed, cell, **kw:
                        tassemble.params_from_reference(tree, device="cpu"))
    grads = []
    update = toptim.adamw_update

    def recording(cfg, params, g, state):
        grads.append([None if x is None else x.detach().clone() for x in g])
        return update(cfg, params, g, state)

    monkeypatch.setattr(ttrainer.optim, "adamw_update", recording)
    lr, steps = 5e-3, 3
    kw = dict(steps=steps, batch_size=16, tbptt=4, lr=lr, dense=dense,
              lasso=1e-4 if dense else 0.0,
              bn_freeze_frac=1.0 if frozen else 0.0)
    want = jtrainer.train_stream(jc, data, **kw)
    got = ttrainer.train_stream(tc, data, device="cpu", **kw)
    np.testing.assert_allclose(got.losses, want.losses, **TOL)
    assert len(grads) == steps
    names = []

    def walk(t, pre):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], f"{pre}/{k}")
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, f"{pre}[{i}]")
        else:
            names.append(pre)
    walk(tree, "")
    leaves = tassemble.leaves(got.params)
    for i, (name, a, b) in enumerate(zip(names, jax.tree.leaves(want.params),
                                         leaves)):
        a, b = np.asarray(a), b.detach().numpy()
        if not b.dtype.kind == "f":
            np.testing.assert_array_equal(b, a, err_msg=name)
            continue
        if name.endswith("bn/var"):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5,
                                       err_msg=name)
            continue
        noise = np.zeros(a.shape, bool)
        for g in grads:
            if g[i] is not None:
                noise |= np.abs(g[i].numpy()) < 1e-6
        if name.endswith("bn/mean"):
            if frozen:
                # frozen stats: the means are leaves that AdamW moves, held
                # like the other leaves; most of their gradients are signal
                assert noise.mean() < 0.5, name
            else:
                noise[:] = True
        np.testing.assert_allclose(b[~noise], a[~noise], err_msg=name,
                                   **TOL)
        assert np.all(np.abs(b[noise] - a[noise]) <= 2 * lr * steps + 1e-6), \
            name


def test_stream_accuracy_folded_equals_unfolded_and_reference(tiny):
    """On shared parameters, the folded and the fake-quant accuracy agree
    with each other and with the reference's."""
    jc, tc, jp, tp = tiny[:4]
    data = _toy_seq_data(n=64, t=5, seed=9)
    for folded in (False, True):
        got = ttrainer.stream_accuracy(tc, tp, data, folded=folded,
                                       max_eval=16)
        want = jtrainer.stream_accuracy(jc, jp, data, folded=folded,
                                        max_eval=16)
        assert got == want
    assert ttrainer.stream_accuracy(tc, tp, data, folded=True) == \
        ttrainer.stream_accuracy(tc, tp, data, folded=False)


# ---------------------------------------------------------------------------
# artifacts and toolflow state across the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stream_artifact_crosses_packages(direction, tiny, tmp_path):
    jc, tc, jp, tp, jcomp, tcomp = tiny
    path = str(tmp_path / "cell.npz")
    xs = _seqs(3, 6, 4, seed=10)
    if direction == "jax_to_port":
        jcomp.net.compile_backend("fused")
        jcomp.save(path)
        back = tcell.CompiledStreamCell.load(path, device="cpu")
        want = np.asarray(jcomp.predict_sequence(xs)[0])
        for be in BACKENDS:
            np.testing.assert_array_equal(
                back.predict_sequence(xs, backend=be)[0].numpy(), want)
    else:
        tcomp.net.compile_backend("fused")
        tcomp.save(path)
        back = jcell.CompiledStreamCell.load(path)
        want = tcomp.predict_sequence(xs)[0].numpy()
        for be in ("take", "fused"):
            np.testing.assert_array_equal(
                np.asarray(back.predict_sequence(xs, backend=be)[0]), want)
    assert (back.cell.n_in, back.cell.n_state) == (tc.n_in, tc.n_state)
    plain = back.net
    plain.extra_meta = {}
    mod = tcell if direction == "jax_to_port" else jcell
    with pytest.raises(ValueError, match="stream_cell"):
        mod.CompiledStreamCell.from_network(plain)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_stream_flow_state_crosses_packages(direction, tiny, tmp_path):
    """A stream ``Toolflow.save_state`` of either package resumes in the
    other: same cell, tbptt, mappings and parameters, same accuracy."""
    jc, tc, jp, tp = tiny[:4]
    data = _toy_seq_data(n=64, t=5, seed=11)
    path = str(tmp_path / "flow.npz")
    tree = tassemble.params_to_reference(tp)
    maps = [None if s.assemble else np.asarray(tree["layers"][l]["mapping"])
            for l, s in enumerate(tc.net.layers)]
    dense_tree = tassemble.params_to_reference(
        tassemble.init(4, tc.net, dense=True, device="cpu"))
    if direction == "jax_to_port":
        flow = jpipeline.Toolflow(jc, tbptt=3, seed=7)
        flow.dense_params = jax.tree.map(jnp.asarray, dense_tree)
        flow.mappings = [None if m is None else jnp.asarray(m) for m in maps]
        flow.params = jp
        flow.save_state(path)
        back = tpipeline.Toolflow.load_state(path, device="cpu")
        leaves = tassemble.leaves(back.params)
        dense = tassemble.leaves(back.dense_params)
    else:
        flow = tpipeline.Toolflow(tc, tbptt=3, seed=7, device="cpu")
        flow.dense_params = tassemble.params_from_reference(dense_tree,
                                                            device="cpu")
        flow.mappings = [None if m is None else torch.from_numpy(m)
                         for m in maps]
        flow.params = tp
        flow.save_state(path)
        back = jpipeline.Toolflow.load_state(path)
        leaves = jax.tree.leaves(back.params)
        dense = jax.tree.leaves(back.dense_params)
    assert back.cell.n_in == tc.n_in and back.cell.n_state == tc.n_state
    assert back.tbptt == 3 and back.hyper["seed"] == 7
    for a, b in zip(leaves, jax.tree.leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a.detach() if isinstance(
            a, torch.Tensor) else a), b)
    for a, b in zip(dense, jax.tree.leaves(dense_tree)):
        np.testing.assert_array_equal(np.asarray(a.detach() if isinstance(
            a, torch.Tensor) else a), b)
    for folded in (False, True):
        assert back.accuracy(data, folded=folded, max_eval=16) == \
            jtrainer.stream_accuracy(jc, jp, data, folded=folded,
                                     max_eval=16)


def test_toolflow_stream_flow_end_to_end(tmp_path, one_thread):
    """``Toolflow(StreamCellConfig)``: TBPTT pretrain -> prune -> retrain
    -> compile, last-step accuracy (fake-quant and folded), and the
    flow-state round trip keeping the cell."""
    _, tc = _cells("tiny")
    data = _toy_seq_data(n=96, t=6, seed=0)
    flow = tpipeline.Toolflow(tc, pretrain_steps=6, retrain_steps=8,
                              batch_size=24, max_train=72, tbptt=3,
                              device="cpu")
    comp = flow.run(data)
    assert isinstance(comp, tcell.CompiledStreamCell)
    assert flow.stages["compile"].metrics["entries"] > 0
    acc = flow.accuracy(max_eval=24)
    assert abs(acc - flow.accuracy(folded=True, max_eval=24)) <= 0.25
    np.testing.assert_array_equal(
        comp.predict_sequence(data.x_test)[0].numpy(),
        tcell.apply_sequence_codes(flow.params, tc, data.x_test).numpy())
    path = flow.save_state(str(tmp_path / "flow.npz"))
    back = tpipeline.Toolflow.load_state(path, device="cpu")
    assert back.cell == tc and back.tbptt == 3
    assert back.accuracy(data, max_eval=24) == acc


# ---------------------------------------------------------------------------
# the router, the engine's cell mode, churn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("be", BACKENDS)
def test_router_bit_identity_and_cross_stream_batching(be, depth, tiny):
    jc, tc, jp, tp, jcomp, tcomp = tiny
    rng = np.random.default_rng(4)
    seqs = {i: _seqs(1, int(rng.integers(3, 9)), 4, seed=10 + i)[0]
            for i in range(9)}
    router = tsession.StreamRouter(tcomp, block=8, backend=be, depth=depth)
    sessions = router.run_sequences(seqs)
    total = sum(len(x) for x in seqs.values())
    for i, xs in seqs.items():
        want, _, s_fin = jcomp.predict_sequence(xs[None])
        np.testing.assert_array_equal(sessions[i].codes(),
                                      np.asarray(want)[0], err_msg=str(i))
        assert sessions[i].closed
        np.testing.assert_array_equal(sessions[i].final_state,
                                      np.asarray(s_fin)[0])
    assert router.engine.stats.ticks < total
    assert len(router.step_latencies_us) == total
    assert router.latency_us(99) >= router.latency_us(50) > 0


@pytest.mark.parametrize("seed", [5, 6])
def test_router_churn_open_close_midstream(seed, tiny):
    """Streams open, burst and close mid-trace; every stream is still
    served in order and bit-identically to the offline scan."""
    jc, tc, jp, tp, jcomp, tcomp = tiny
    trace = traffic.stream_churn_trace(["m"], n_events=40, seed=seed)
    inputs = traffic.make_stream_inputs(trace, {"m": tc.n_in}, seed=seed + 1,
                                        high=3.0)
    router = tsession.StreamRouter(tcomp, block=8, depth=2)
    for ev, x in zip(trace, inputs):
        if ev.action == "open":
            router.open(ev.stream_id)
        elif ev.action == "feed":
            router.feed(ev.stream_id, x)
        else:
            router.close(ev.stream_id)
        for _ in range(ev.gap_ticks):
            router.tick()
    router.pump()
    seqs = traffic.stream_sequences(trace, inputs)
    assert seqs
    for (_, sid), xs in seqs.items():
        want = tcomp.predict_sequence(xs[None])[0].numpy()[0]
        np.testing.assert_array_equal(router.sessions[sid].codes(), want,
                                      err_msg=f"stream {sid}")
        assert router.sessions[sid].closed
    assert len(router.store) == 0
    with pytest.raises(KeyError, match="unknown stream"):
        router.close("never-opened")
    with pytest.raises(ValueError, match="closing"):
        sid = next(iter(seqs))[1]
        router._closing.add(sid)
        router.feed(sid, np.zeros(tc.n_in, np.float32))


def test_engine_cell_mode_validation_and_submit_many(tiny):
    jc, tc, jp, tp, jcomp, tcomp = tiny
    eng = LUTEngine(tcomp.net, cell=tcomp, block=4)
    assert eng.cell is tcomp and eng.backend == tcomp.net.backend
    other = tcell.compile_cell(tp, tc)
    with pytest.raises(ValueError, match="net"):
        LUTEngine(other.net, cell=tcomp)
    xs = _seqs(6, 1, 4, seed=12)[:, 0]
    states = np.random.RandomState(13).randint(0, 4, (6, 2)).astype(np.int32)
    reqs = eng.submit_many(xs, states=states)
    default = eng.submit(xs[0])
    while eng.queue:
        eng.tick()
    eng.drain()
    codes, _, s_next = tcomp.step(xs, states)
    np.testing.assert_array_equal(np.stack([r.codes for r in reqs]),
                                  codes.numpy())
    np.testing.assert_array_equal(np.stack([r.next_state for r in reqs]),
                                  s_next.numpy())
    np.testing.assert_array_equal(
        default.next_state,
        tcomp.step(xs[:1], tcomp.init_state_codes(1))[2].numpy()[0])


def test_meshes_placements_and_the_fleet_lane_raise(tiny):
    """Placements were refused until the serving tier was ported; now a
    step, a router and a cell-mode engine under a placement give the
    unplaced codes, and ``repro_torch.stream`` exports ``replica``."""
    from repro_torch.launch.mesh import make_serving_mesh
    jc, tc, jp, tp, jcomp, tcomp = tiny
    mesh = make_serving_mesh(slots=2, device="cpu")
    xs = _seqs(3, 4, 4, seed=13)
    want = tcomp.predict_sequence(xs, backend="take")[0]
    for pl in (tbackends.Placement(mesh),
               tbackends.Placement(mesh, strategy="units")):
        assert torch.equal(tcomp.predict_sequence(
            xs, backend="pallas", placement=pl)[0], want)
        eng = LUTEngine(tcomp.net, cell=tcomp, block=4, placement=pl)
        router = tsession.StreamRouter(tcomp, engine=eng)
        sessions = router.run_sequences({i: xs[i] for i in range(3)})
        for i, sess in sessions.items():
            np.testing.assert_array_equal(sess.codes(), want[i].numpy())
    router = tsession.StreamRouter(tcomp, mesh=mesh, block=4)
    assert router.engine.backend == tcomp.net.backend
    with pytest.raises(ValueError, match="unit sharding"):
        tcomp.step(xs[:, 0], tcomp.init_state_codes(3), backend="fused",
                   placement=tbackends.Placement(mesh, strategy="units"))
    import repro_torch.stream as tstream
    assert hasattr(tstream, "replica")
    assert tstream.StandbyReplica is tstream.replica.StandbyReplica


# ---------------------------------------------------------------------------
# sequence data and the stream-task registry
# ---------------------------------------------------------------------------

def test_to_sequences_shapes_validation_and_reference():
    ds = tsynthetic.Dataset("d", np.arange(72, dtype=np.float32).reshape(6, 12),
                            np.zeros(6, np.int32),
                            np.zeros((2, 12), np.float32),
                            np.zeros(2, np.int32), 3)
    seq = tsynthetic.to_sequences(ds, 4)
    assert seq.x_train.shape == (6, 3, 4) and seq.x_test.shape == (2, 3, 4)
    assert seq.n_in == 4 and seq.seq_len == 3 and seq.name == "d-seq4"
    np.testing.assert_array_equal(seq.x_train.reshape(6, 12), ds.x_train)
    jseq = jsynthetic.to_sequences(jsynthetic.Dataset(*dataclasses.astuple(
        ds)), 4)
    np.testing.assert_array_equal(seq.x_train, jseq.x_train)
    with pytest.raises(ValueError, match="divisible"):
        tsynthetic.to_sequences(ds, 5)


def test_augment_shift_matches_reference():
    x = np.random.RandomState(14).uniform(0, 1, (5, 784)).astype(np.float32)
    got = tsynthetic.augment_shift(x, np.random.default_rng(3))
    want = jsynthetic.augment_shift(x, np.random.default_rng(3))
    np.testing.assert_array_equal(got, want)


def test_stream_task_registry():
    assert ttasks.stream_task_names() == jtasks.stream_task_names()
    cc = ttasks.stream_task_config("seqmnist_reduced")
    assert cc.n_in == 16 and cc.n_state == 8 and cc.n_out == 10
    for name in ttasks.stream_task_names():
        assert tpipeline.config_to_dict(
            ttasks.stream_task_config(name).net) == jpipeline.config_to_dict(
                jtasks.stream_task_config(name).net)
    with pytest.raises(ValueError, match="unknown stream task"):
        ttasks.stream_task_config("nope")
    with pytest.raises(ValueError, match="unknown stream task"):
        ttasks.stream_task_data("nope")
    rwkv_seq = ttasks.stream_task_data("rwkv_mix_reduced", n_train=8,
                                       n_test=4, device="cpu")
    rwkv_want = jtasks.stream_task_data("rwkv_mix_reduced", n_train=8,
                                        n_test=4)
    assert rwkv_seq.name == rwkv_want.name
    # the trunk's He draws are within 3 ulps of JAX's (data/jax_prng.py)
    np.testing.assert_allclose(rwkv_seq.x_train, rwkv_want.x_train,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(rwkv_seq.y_test, rwkv_want.y_test)
    seq = ttasks.stream_task_data("seqmnist_reduced", n_train=32, n_test=16)
    want = jtasks.stream_task_data("seqmnist_reduced", n_train=32,
                                   n_test=16)
    assert seq.x_train.shape == (32, 49, 16) and seq.n_classes == 10
    assert seq.n_in == 16 and seq.seq_len == 49
    np.testing.assert_array_equal(seq.x_train, want.x_train)
    np.testing.assert_array_equal(seq.y_test, want.y_test)
    assert seq.name == want.name
