"""The port's RWKV-6 layer (``repro_torch.models.rwkv``), its LUT time-mix
and the numpy Threefry behind ``feature_stream`` (``repro_torch.data.
jax_prng``), on the CPU against ``repro.models.rwkv`` and ``jax.random``
with weights carried across and inputs from numpy seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.core.assemble import AssembleConfig as JConfig
from repro.core.assemble import LayerSpec as JLayer
from repro.models import layers as jlayers
from repro.models import rwkv as jrwkv
from repro.stream import cell as jcell
from repro_torch import pipeline as tpipeline
from repro_torch.configs import paper_tasks as ttasks
from repro_torch.core import assemble as tassemble
from repro_torch.data import jax_prng
from repro_torch.models import layers, rwkv
from repro_torch.stream import cell as tcell

# f32: summation orders differ; the per-head group norm divides by a small
# variance (E[x^2] - mu^2), which amplifies them; observed <= 6e-6
F32_TOL = dict(rtol=2e-4, atol=2e-4)
# bf16: XLA's CPU keeps bf16 chains in f32 where PyTorch rounds each op;
# observed 3 ulps (0.05) on block outputs of magnitude 3
BF16_TOL = dict(rtol=6e-2, atol=6e-2)
# jax.random.normal's erfinv evaluates log1p with XLA's own approximation:
# the numpy draws are within 3 f32 ulps of it (about 99% bit-identical)
NORMAL_ULPS = 3


def _np(t):
    return np.array(t, np.float32)


def _layer(spec, jspec, seed=4, lora=True):
    """A layer drawn by JAX, carried to the port; with ``lora`` the
    reference's zero-initialised LoRA outputs and bonus get random values,
    so the data-dependent lerp, decay and bonus terms take part."""
    jp = dict(jax.tree.map(lambda a: a[0], jrwkv.init_rwkv_layer(
        jax.random.PRNGKey(seed), jspec, 1)))
    if lora:
        rs = np.random.RandomState(seed)
        for name, scale in (("ddl_b", 0.1), ("w_b", 0.3), ("u", 1.0),
                            ("mu_x", 0.5), ("mu_k", 0.5), ("gn_bias", 0.1)):
            jp[name] = jnp.asarray(rs.normal(0, scale, jp[name].shape),
                                   jnp.float32)
    p = rwkv.RWKVLayer(spec)
    with torch.no_grad():
        for name, t in p.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name])))
    return jp, p


def _specs(d=16, h=2, f=32, chunk=4):
    return (rwkv.RWKVSpec(d_model=d, n_heads=h, d_ff=f, chunk=chunk),
            jrwkv.RWKVSpec(d_model=d, n_heads=h, d_ff=f, chunk=chunk))


# ---------------------------------------------------------------------------
# the numpy Threefry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 32 - 1])
def test_prng_split_bits_and_uniform_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(key)) == jax_prng.prng_key(seed)
    keys = jax.random.split(key, 16)
    mine = jax_prng.split(jax_prng.prng_key(seed), 16)
    np.testing.assert_array_equal(np.asarray(keys), np.array(mine, np.uint32))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    # the shapes feature_stream draws (d 16, d_ff 32, LoRA 64) and odd ones
    for i, shape in ((0, (1, 16, 64)), (4, (1, 16, 16)), (9, (1, 16, 32)),
                     (10, (1, 32, 16)), (3, (7,)), (5, (3, 5, 2))):
        np.testing.assert_array_equal(
            jax_prng.random_bits(mine[i], shape),
            np.asarray(jax.random.bits(keys[i], shape, jnp.uint32)))
        np.testing.assert_array_equal(
            jax_prng.uniform(mine[i], shape),
            np.asarray(jax.random.uniform(keys[i], shape)))
        np.testing.assert_array_equal(
            jax_prng.uniform(mine[i], shape, lo, 1.0),
            np.asarray(jax.random.uniform(keys[i], shape, jnp.float32,
                                          lo, 1.0)))
    sub = jax.random.split(keys[3], 4)
    np.testing.assert_array_equal(np.asarray(sub),
                                  np.array(jax_prng.split(mine[3], 4),
                                           np.uint32))


def test_prng_normal_within_three_ulps_of_jax():
    keys = jax.random.split(jax.random.PRNGKey(0), 16)
    mine = jax_prng.split(jax_prng.prng_key(0), 16)
    exact = []
    for i in range(4, 12):
        want = np.asarray(jax.random.normal(keys[i], (1, 16, 32)))
        got = jax_prng.normal(mine[i], (1, 16, 32))
        ulps = np.abs(want.view(np.int32).astype(np.int64)
                      - got.view(np.int32).astype(np.int64))
        assert ulps.max() <= NORMAL_ULPS, (i, ulps.max())
        exact.append(float((ulps == 0).mean()))
    big = jax.random.normal(keys[4], (100_000,))
    ulps = np.abs(np.asarray(big).view(np.int32).astype(np.int64)
                  - jax_prng.normal(mine[4], (100_000,)).view(np.int32))
    assert ulps.max() <= NORMAL_ULPS and (ulps == 0).mean() > 0.95
    assert np.mean(exact) > 0.9


def test_reference_layer_equals_jax_init():
    """``rwkv.reference_layer`` is ``init_rwkv_layer(PRNGKey(seed))[0]``
    leaf for leaf: constants exactly, He draws within 3 ulps."""
    spec, jspec = _specs(chunk=16)
    jp = jax.tree.map(lambda a: np.asarray(a[0]),
                      jrwkv.init_rwkv_layer(jax.random.PRNGKey(0), jspec, 1))
    p = rwkv.reference_layer(spec, 0)
    assert sorted(n for n, _ in p.named_parameters()) == sorted(jp)
    for name, t in p.named_parameters():
        # + 0 maps the reference's -0.0 (a negative draw times 0) to 0.0
        got, want = t.numpy() + np.float32(0), jp[name] + np.float32(0)
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= NORMAL_ULPS, name


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk", [(16, 4), (10, 4), (1, 4), (7, 16)])
def test_wkv_chunked_matches_reference(s, chunk):
    """S a multiple of the chunk, S not a multiple (a padded last chunk),
    S = 1 (a decode step), and S below the chunk (one chunk of S)."""
    rs = np.random.RandomState(s + chunk)
    r, k, v = (rs.normal(size=(2, s, 3, 8)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rs.normal(-1.0, 1.0, size=(2, s, 3, 8))).astype(
        np.float32)
    u = rs.normal(size=(3, 8)).astype(np.float32)
    s0 = rs.normal(size=(2, 3, 8, 8)).astype(np.float32)
    jo, js = jrwkv.wkv_chunked(*map(jnp.asarray, (r, k, v, logw, u, s0)),
                               chunk)
    o, st = rwkv.wkv_chunked(*map(torch.from_numpy, (r, k, v, logw, u, s0)),
                             chunk)
    assert o.shape == (2, s, 3, 8) and st.shape == (2, 3, 8, 8)
    np.testing.assert_allclose(o.numpy(), _np(jo), **F32_TOL)
    np.testing.assert_allclose(st.numpy(), _np(js), **F32_TOL)
    # the recurrence, one token at a time
    state, outs = torch.from_numpy(s0).double(), []
    w = torch.from_numpy(np.exp(logw)).double()
    for t in range(s):
        kt, vt, rt = (torch.from_numpy(a[:, t]).double() for a in (k, v, r))
        kv = kt[..., :, None] * vt[..., None, :]
        bonus = torch.from_numpy(u).double()[..., None] * kv
        outs.append(torch.einsum("bhd,bhdm->bhm", rt, state + bonus))
        state = w[:, t][..., None] * state + kv
    np.testing.assert_allclose(o.numpy(), torch.stack(outs, 1).numpy(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 9])
def test_rwkv_block_matches_reference(s, dtype):
    """``rwkv_block`` (ddlerp, decay, WKV, group norm, channel mix) from a
    random state, and its state after, in f32 at 2e-4 and bf16 at
    BF16_TOL."""
    spec, jspec = _specs()
    jp, p = _layer(spec, jspec)
    rs = np.random.RandomState(s)
    x = rs.normal(size=(2, s, 16)).astype(np.float32)
    wkv = rs.normal(size=(2, 2, 8, 8)).astype(np.float32)
    tm, cm = (rs.normal(size=(2, 16)).astype(np.float32) for _ in range(2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    if dtype == "bfloat16":      # the reference casts its blocks first
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        p = p.to(torch.bfloat16)
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(_np(jx.astype(jnp.float32))).to(tdt)
    jy, jst = jrwkv.rwkv_block(jp, jspec, jx, jrwkv.RWKVState(
        jnp.asarray(wkv), jnp.asarray(tm, jdt), jnp.asarray(cm, jdt)))
    y, st = rwkv.rwkv_block(p, spec, tx, rwkv.RWKVState(
        torch.from_numpy(wkv), torch.from_numpy(_np(jnp.asarray(tm, jdt)
                                                    .astype(jnp.float32)))
        .to(tdt), torch.from_numpy(_np(jnp.asarray(cm, jdt)
                                       .astype(jnp.float32))).to(tdt)))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert y.dtype == tdt and st.wkv.dtype == torch.float32
    np.testing.assert_allclose(y.float().numpy(), _np(jy.astype(jnp.float32)),
                               **tol)
    for got, want in zip(st, jst):
        np.testing.assert_allclose(got.float().numpy(),
                                   _np(want.astype(jnp.float32)), **tol)


def test_ddlerp_and_decay_match_reference():
    spec, jspec = _specs()
    jp, p = _layer(spec, jspec, seed=7)
    rs = np.random.RandomState(8)
    x, xx = (rs.normal(size=(2, 5, 16)).astype(np.float32) for _ in range(2))
    for got, want in zip(rwkv._ddlerp(p, torch.from_numpy(x),
                                      torch.from_numpy(xx)),
                         jrwkv._ddlerp(jp, jnp.asarray(x), jnp.asarray(xx))):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(
        rwkv._decay(p, torch.from_numpy(x)).numpy(),
        _np(jrwkv._decay(jp, jnp.asarray(x))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_sinusoids_match_reference(dtype):
    rs = np.random.RandomState(9)
    x = (rs.normal(size=(3, 7, 24)) * 3 + 1).astype(np.float32)
    scale, bias = (rs.normal(size=(24,)).astype(np.float32)
                   for _ in range(2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx = jnp.asarray(x, jdt)
    got = layers.layer_norm(torch.from_numpy(_np(jx.astype(jnp.float32)))
                            .to(tdt), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    want = jlayers.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias))
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=2 ** -6)
    np.testing.assert_allclose(got.float().numpy(),
                               _np(want.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(layers.sinusoidal_positions(50, 24).numpy(),
                               _np(jlayers.sinusoidal_positions(50, 24)),
                               rtol=1e-5, atol=1e-5)


def test_init_rwkv_layer_follows_the_reference_rules():
    spec, _ = _specs(d=32, h=4, f=64)
    p = rwkv.init_rwkv_layer(torch.Generator().manual_seed(0), spec)
    assert float(p.w0.max()) == float(p.w0.min()) == -6.0
    for name in ("ddl_b", "w_b", "u", "mu_x", "gn_bias", "ln1_b"):
        assert not getattr(p, name).any(), name
    for name in ("gn_scale", "ln1", "ln2"):
        assert bool((getattr(p, name) == 1).all()), name
    np.testing.assert_allclose(float(p.wr.std()), 32 ** -0.5, rtol=0.1)
    st = rwkv.init_state(spec, 3)
    assert st.wkv.shape == (3, 4, 8, 8) and st.wkv.dtype == torch.float32
    assert st.shift_tm.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the LUT time mix and the feature stream
# ---------------------------------------------------------------------------

def _lut_cell():
    """tests/test_stream.py:536's cell (6 inputs = 4 features + 2 state,
    n_out 4 = d_model), its parameters drawn by the port and carried to
    the reference, folded in both packages."""
    jcc = jcell.StreamCellConfig(
        net=JConfig(in_features=6, input_bits=1, input_signed=True,
                    layers=(JLayer(12, 3, 1, False), JLayer(6, 2, 3, True)),
                    subnet_width=8, subnet_depth=2, skip_step=2),
        n_in=4, n_state=2)
    tcc = tcell.StreamCellConfig(
        net=tpipeline.config_from_dict(jpipeline.config_to_dict(jcc.net)),
        n_in=4, n_state=2)
    tree = tassemble.params_to_reference(
        tassemble.init(3, tcc.net, device="cpu"))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = tassemble.params_from_reference(tree, device="cpu")
    return jcc, tcc, jp, tp


def test_rwkv_block_lut_tm_matches_reference():
    """The LUT time mix in the WKV slot (tests/test_stream.py:536's case):
    the block's output, the cell's final state and the channel-mix shift
    equal the reference's with the training-graph cell (1e-5) and with the
    folded cell (the same codes); the folded cell inside the block streams
    exactly its offline ``predict_sequence`` of the same pre-LN features,
    in both packages; a cell whose n_out is not d_model is refused."""
    jcc, tcc, jp, tp = _lut_cell()
    spec, jspec = _specs(d=4, h=2, f=8, chunk=4)
    jpl, pl_ = _layer(spec, jspec, seed=4, lora=False)
    x = np.random.RandomState(5).normal(size=(2, 6, 4)).astype(np.float32)
    cm0 = np.zeros((2, 4), np.float32)

    def jtm(x_t, s):
        y, s_next, _ = jcell.apply_step(jp, jcc, x_t, s)
        return y, s_next

    def ttm(x_t, s):
        return tcell.apply_step(tp, tcc, x_t, s)

    jout, js, jcm = jrwkv.rwkv_block_lut_tm(
        jpl, jspec, jnp.asarray(x), jnp.asarray(cm0), jtm, jnp.zeros((2, 2)))
    with torch.no_grad():
        out, s_fin, new_cm = rwkv.rwkv_block_lut_tm(
            pl_, spec, torch.from_numpy(x), torch.from_numpy(cm0), ttm,
            torch.zeros((2, 2)))
    assert out.shape == (2, 6, 4) and s_fin.shape == (2, 2)
    for got, want in ((out, jout), (s_fin, js), (new_cm, jcm)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-5)

    # the folded cell: codes-space state, streamed == offline, both packages
    jcomp = jcell.compile_cell(jp, jcc)
    tcomp = tcell.compile_cell(tp, tcc)
    h1 = layers.layer_norm(torch.from_numpy(x), pl_.ln1, pl_.ln1_b)
    jh1 = jlayers.layer_norm(jnp.asarray(x), jpl["ln1"], jpl["ln1_b"])
    np.testing.assert_allclose(h1.numpy(), _np(jh1), rtol=1e-6, atol=1e-6)
    codes = []

    def folded(x_t, s):
        c, y, s_next = tcomp.step(x_t, s)
        codes.append(c)
        return y, s_next

    out_f, s_codes, _ = rwkv.rwkv_block_lut_tm(
        pl_, spec, torch.from_numpy(x), torch.from_numpy(cm0), folded,
        tcomp.init_state_codes(2))
    offline = tcomp.predict_sequence(h1)
    np.testing.assert_array_equal(torch.stack(codes, 1).numpy(),
                                  offline[0].numpy())
    np.testing.assert_array_equal(s_codes.numpy(), offline[2].numpy())
    jref = np.asarray(jcomp.predict_sequence(np.asarray(jh1, np.float32))[0])
    np.testing.assert_array_equal(offline[0].numpy(), jref)
    # the reference's block around its folded cell's offline outputs (its
    # CompiledStreamCell steps on the host, outside lax.scan)
    jy = jnp.asarray(jcomp.predict_sequence(np.asarray(jh1, np.float32))[1])
    jx2 = jnp.asarray(x) + jy
    jcm_out, _ = jrwkv.channel_mix(
        jpl, jspec, jlayers.layer_norm(jx2, jpl["ln2"], jpl["ln2_b"]),
        jnp.asarray(cm0))
    np.testing.assert_allclose(out_f.numpy(), _np(jx2 + jcm_out), rtol=1e-5,
                               atol=1e-5)

    def narrow(x_t, s):
        y, s_next = ttm(x_t, s)
        return y[:, :3], s_next

    with pytest.raises(ValueError, match="d_model"):
        rwkv.rwkv_block_lut_tm(pl_, spec, torch.from_numpy(x),
                               torch.from_numpy(cm0), narrow,
                               torch.zeros((2, 2)))


def test_feature_stream_and_task_data_match_reference():
    """``feature_stream`` draws its trunk as the reference does (the numpy
    Threefry) and streams the same features; ``stream_task_data(
    "rwkv_mix_reduced")`` equals the reference's.  Features within 2e-5 of
    magnitude ~5: the He draws' 3-ulp differences and the packages'
    summation orders."""
    xs = np.random.RandomState(10).uniform(0, 1, (4, 9, 16)).astype(
        np.float32)
    np.testing.assert_allclose(rwkv.feature_stream(xs, device="cpu"),
                               jrwkv.feature_stream(xs), rtol=2e-5,
                               atol=2e-5)
    got = ttasks.stream_task_data("rwkv_mix_reduced", n_train=24, n_test=8,
                                  device="cpu")
    want = jtasks.stream_task_data("rwkv_mix_reduced", n_train=24, n_test=8)
    assert got.name == want.name == "mnist-like-seq16-rwkv"
    assert got.x_train.shape == (24, 49, 16) and got.x_train.dtype == np.float32
    np.testing.assert_allclose(got.x_train, want.x_train, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(got.x_test, want.x_test, rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(got.y_train, want.y_train)
    np.testing.assert_array_equal(got.y_test, want.y_test)
