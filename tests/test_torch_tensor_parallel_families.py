"""Tensor parallelism of the ``moe``, ``hybrid``, ``ssm`` (RWKV-6) and
``audio`` (whisper) families (``lm.tp_view``,
``launch.steps.make_mesh_train_step`` and ``build_cell``'s serving steps)
on 4 gloo ranks on the CPU, one spawn
(``torch_dist_worker.job_tensor_parallel_families``).

Five f32 configs on ``WIDE`` widths (``torch_dist_worker.
TP_FAMILY_CONFIGS``): mixtral (4 experts, top 2) and dbrx (6 experts, top
4, capacity factor 0.5, so 8-slot experts drop tokens), 32 heads of 16
on 8 KV heads; hymba (d_model 521, so ``d_inner``
1,042: on 4 ranks the chunks of ``in_proj``'s 2,084 columns cut a rank's
channels; 33 heads, so q whole); rwkv6 (10 heads of 52: its own heads at
``model`` 2, every head at 4, where they do not split); whisper (32 heads
of 16, encoder and decoder, the untied head).

Each trains 2 steps through the training loop at ``(1, 2)``, ``(2, 2)``
and ``(1, 4)`` and once unmeshed: losses and grad norms within 1e-6
(relative) of the unmeshed step's, parameters within 1e-5 of each leaf's
largest entry.  Two leaves are held otherwise, each for a reason the
unmeshed step shows by itself:

* an attention key bias (``bk``) has an exact gradient of 0 (a softmax
  ignores a shift shared by every key), so its entries are Adam's response
  to rounding (about 1e-10); it is held at 1e-5 of the model's largest
  parameter, as ``test_torch_train_lm.py`` floors its gradient;
* RWKV's gradient carries the f32 rounding its group norm amplifies
  (ROADMAP C.6): at init ``u``'s gradient is 774, the norm's largest term,
  and f32 against f64 alone moves the leaves' gradients by up to 1.7e-5 of
  their largest entry.  rwkv6's grad norms are held at ``RWKV_NORM_RTOL``
  (every rank at every mesh, the heads-whole path at 4 included, lands at
  5.4e-6 at most), and each leaf within 1e-5 of its largest entry or
  within ``RWKV_UPDATE_TOL`` of its own largest change over the two steps
  (at most 3.1e-4 of it, ``u``'s, on every rank and mesh and against the
  reference).  A leaf left as it was, or moved by a wrong update, lies a
  whole update from the unmeshed one, so it fails either way; ``u``
  starts at 0, so its largest entry is its update.

The unmeshed runs are held against the reference's one-device
``make_train_step`` from the same weights and batches at 1e-5 (JAX in this
process while the ranks run; they import none), with the same two
exceptions.  Every MoE routing of every step (its dispatch table and
token slots, dbrx's capacity drops included) is equal to the unmeshed
step's.

Prefill logits and caches and 4 decode steps' logits through
``build_cell`` at ``(1, 2)`` and ``(1, 4)`` are within 1e-5 of the largest
entry of the unmeshed ones (the logits on the vocabulary, without the
padded columns' -1e30); every MoE routing of the prefill and the decode
steps is equal.

Block 0's forward and backward on rank 0 at ``(1, 4)`` on 2 x 8 tokens:
its flops fall by the factor its shapes give (:func:`_flops`, within
10%), and no all-gather is as large as the smallest sharded block weight
matrix but RWKV's ``ddl_b`` (``[64, 5 d]``, gathered whole: its column
shard splits across the five lerp deltas); the SSM's ``in_proj`` columns
are re-paired by an all-to-all of its product.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from repro.configs import lm_archs as jarchs
from repro.launch import steps as jsteps
from repro.train import optim as joptim
from repro_torch.dist import sharding as shd
from repro_torch.launch import steps
from repro_torch.models import lm, moe

CONFIGS = tuple(w.TP_FAMILY_CONFIGS)
LOSS_RTOL = 1e-6
PARAM_TOL = 1e-5
REF_RTOL = 1e-5
REF_PARAM_TOL = 1e-5
SERVE_TOL = 1e-5
FLOPS_RTOL = 0.10
RWKV_NORM_RTOL = 2e-5
RWKV_UPDATE_TOL = 1e-3
DESIGN = {"mixtral": "tp", "dbrx": "tp", "hymba": "tp (q whole)",
          "rwkv6": "tp", "whisper": "tp"}
# rwkv6's 10 heads do not split over 4 ranks: r, k, v and the decay are
# gathered whole (its "q whole")
DESIGN_AT_4 = {"rwkv6": "tp (q whole)"}


def _norm_rtol(name):
    """The grad-norm rtol of a config (see the docstring)."""
    return RWKV_NORM_RTOL if name == "rwkv6" else LOSS_RTOL


def _leaf_names(cfg):
    model = shd.abstract_model(cfg)
    return [path for path, _, _ in lm.leaves(model)]


def _reference_run(name):
    """The reference's one-device steps from the port's seed-0 weights:
    (losses, grad norms, parameters as numpy in ``lm.leaves`` order)."""
    cfg = w.family_config(name)
    arch, extra = w.TP_FAMILY_CONFIGS[name]
    jcfg = dataclasses.replace(jarchs.smoke(arch), **{**w.WIDE, **extra})
    model = steps.init_fn(cfg)(torch.Generator().manual_seed(0), "cpu")
    tree = jax.tree.map(jnp.asarray, lm.params_to_reference(model))
    opt = joptim.adamw_init(tree)
    step = jax.jit(jsteps.make_train_step(
        jcfg, opt_cfg=joptim.AdamWConfig(**w.MESH_OPT)))
    losses, norms = [], []
    for b in w.family_batches(cfg):
        batch = {k: jnp.asarray(v.numpy(), jnp.float32 if
                                v.is_floating_point() else jnp.int32)
                 for k, v in b.items()}
        tree, opt, m = step(tree, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    flat = []
    for path, layer, _ in lm.leaves(model):
        node = functools.reduce(lambda n, k: n[k], path, tree)
        flat.append(np.asarray(node if layer is None else node[layer]))
    return losses, norms, flat


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(each rank's results, the reference's runs by config)."""
    started = w.start("tensor_parallel_families", 4,
                      tmp_path_factory.mktemp("tpf"))
    refs = {name: _reference_run(name) for name in CONFIGS}
    return w.collect(started, timeout=300), refs


def _params_close(name, got, want, updates):
    """Each leaf of ``got`` against ``want`` (see :func:`_errors_within`;
    ``updates``: each leaf's largest change over the steps); returns the
    failures."""
    errs = [(float(np.abs(np.asarray(p) - np.asarray(q)).max()),
             float(np.abs(np.asarray(q)).max()), u)
            for p, q, u in zip(got, want, updates)]
    return _errors_within(name, errs, REF_PARAM_TOL)


def _errors_within(name, errs, tol):
    """The leaves whose ``(max |diff|, largest entry, largest change)``
    exceed ``tol`` of the largest entry (a key bias: of the model's
    largest entry) and, for rwkv6, also ``RWKV_UPDATE_TOL`` of the
    change."""
    top = max(e[1] for e in errs)
    bad = []
    for path, (diff, scale, update) in zip(
            _leaf_names(w.family_config(name)), errs):
        scale = top if path[-1] == "bk" else scale
        if not (diff <= tol * scale or (
                name == "rwkv6" and diff <= RWKV_UPDATE_TOL * update)):
            bad.append((path, diff, scale, update))
    return bad


@pytest.mark.parametrize("name", CONFIGS)
def test_unmeshed_steps_match_reference(run, name):
    ranks, refs = run
    got = ranks[0][(name, None)]
    losses, norms, params = refs[name]
    np.testing.assert_allclose(got["losses"], losses, rtol=REF_RTOL)
    np.testing.assert_allclose(got["grad_norms"], norms,
                               rtol=max(REF_RTOL, _norm_rtol(name)))
    assert len(got["params"]) == len(params)
    assert all(tuple(p.shape) == q.shape
               for p, q in zip(got["params"], params))
    bad = _params_close(name, [p.numpy() for p in got["params"]], params,
                        got["updates"])
    assert not bad, bad


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", w.TP_MESHES)
def test_tp_steps_match_unmeshed(run, name, shape):
    ranks, _ = run
    ref = ranks[0][(name, None)]
    norm_rtol = _norm_rtol(name)
    want = DESIGN_AT_4.get(name, DESIGN[name]) if shape[1] == 4 \
        else DESIGN[name]
    for r in range(4):
        assert ranks[r][(name, shape, "design")] == want
        got = ranks[r][(name, shape)]
        assert len(got["losses"]) == w.MESH_STEPS
        for a, b in zip(got["losses"], ref["losses"]):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (r, got["losses"],
                                                     ref["losses"])
        for a, b in zip(got["grad_norms"], ref["grad_norms"]):
            assert abs(a - b) <= norm_rtol * abs(b), (r, got["grad_norms"],
                                                     ref["grad_norms"])
        assert len(got["param_err"]) == len(ref["params"])
        bad = _errors_within(name, got["param_err"], PARAM_TOL)
        assert not bad, (r, bad)


def _dispatch_equal(got, want):
    assert len(got) == len(want) > 0
    for (d1, s1), (d2, s2) in zip(got, want):
        assert torch.equal(d1, d2) and torch.equal(s1, s2)


@pytest.mark.parametrize("name", ("mixtral", "dbrx"))
def test_moe_dispatch_equals_unmeshed(run, name):
    """The router reads whole rows on every rank: each step's dispatch
    table and token slots equal the unmeshed step's, capacity drops
    included (a (2, 2) rank routes its own rows: its tables are the
    unmeshed ones' rows)."""
    ranks, _ = run
    want = ranks[0][(name, None, "dispatch")]
    for r in range(1, 4):       # every rank's own unmeshed run
        _dispatch_equal(ranks[r][(name, None, "dispatch")], want)
    dropped = sum(int((s == d.shape[1] * d.shape[2]).sum())
                  for d, s in want)
    # dbrx's 8-slot experts drop tokens; mixtral's hold every token
    assert (dropped > 0) == (name == "dbrx")
    for r in range(4):
        for shape in w.TP_MESHES:
            got = ranks[r][(name, shape, "dispatch")]
            if shape[0] == 1:
                _dispatch_equal(got, want)
            else:
                rows = slice((r // 2) * (w.MESH_BATCH // 2),
                             (r // 2 + 1) * (w.MESH_BATCH // 2))
                _dispatch_equal(got, [(d[rows], s[rows]) for d, s in want])
        for shape in w.TP_SERVE_MESHES:
            _dispatch_equal(ranks[r][(name, shape, "serve dispatch")],
                            ranks[0][(name, None, "serve dispatch")])


@pytest.mark.parametrize("name", CONFIGS)
def test_placements_are_the_rules(run, name):
    """The step trains the leaves the sharding rules place, as they place
    them, and the spec tree is the rules' for the family."""
    ranks, _ = run
    model = shd.abstract_model(w.family_config(name))
    want = {n for n, s in shd.param_placement_specs(model).items()
            if "model" in s}
    for r in range(4):
        sharded = ranks[r][(name, (1, 2))]["sharded"]
        assert {n for n, *_ in sharded} == want


def _close(p, q, tol):
    scale = float(np.abs(np.asarray(q)).max())
    return float(np.abs(np.asarray(p) - np.asarray(q)).max()) <= tol * scale


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", w.TP_SERVE_MESHES)
def test_serving_matches_unmeshed(run, name, shape):
    ranks, _ = run
    ref = ranks[0][(name, None, "serve")]
    vocab = w.family_config(name).vocab
    for r in range(4):
        got = ranks[r][(name, shape, "serve")]
        # the logits come out on each rank's vocabulary columns
        assert got["logits_placements"] == "(Shard(dim=0), Shard(dim=1))"
        assert got["prefill"].shape == ref["prefill"].shape
        assert _close(got["prefill"][:, :vocab], ref["prefill"][:, :vocab],
                      SERVE_TOL), r
        assert set(got["cache"]) == set(ref["cache"])
        for k, v in ref["cache"].items():
            if v.is_floating_point():
                assert _close(got["cache"][k], v, SERVE_TOL), (r, k)
            else:
                assert (got["cache"][k] == v).all(), (r, k)
        assert len(got["decode"]) == w.TP_DECODE
        for a, b in zip(got["decode"], ref["decode"]):
            assert _close(a[:, :vocab], b[:, :vocab], SERVE_TOL), r


def _flops(cfg, size):
    """Block 0's training flops (forward and backward) on rank 0 of a
    ``model`` axis of ``size``, from its shapes: each product ``6 T in
    out`` (forward, dx, dw) over T tokens (an expert's over its ``E C``
    slots a row), ``out`` this rank's chunk where the rules split the
    weight (the SSM's per-channel products over this rank's channels), and
    an attention core ``16 B Sq Skv hd`` a q head over the heads this rank
    runs.  RWKV's WKV core (a few percent here) is left out."""
    b, s = w.TP_BLOCK_BATCH, w.TP_BLOCK_SEQ
    t = b * s
    d, f = cfg.d_model, cfg.d_ff

    def out(n):
        return -(-n // size) if shd.is_sharded((1, n)) else n

    def attn(h, hk, hd, skv, kv=True):
        heads = h
        if size > 1 and out(h * hd) < h * hd and h % size == 0:
            g = h // hk
            hl = h // size
            heads = hl if hl % g == 0 or g % hl == 0 else h
        lin = [(d, out(h * hd)), (h * hd, out(d))]
        if kv:
            lin += [(d, out(hk * hd)), (d, out(hk * hd))]
        return 6 * t * sum(i * o for i, o in lin) \
            + 16 * b * s * skv * hd * heads

    def ffn(gated):
        lin = [(d, out(f)), (f, out(d))] + ([(d, out(f))] if gated else [])
        return 6 * t * sum(i * o for i, o in lin)

    if cfg.family == "ssm":
        r = 64
        lin = [(d, r), (r, 5 * d), (d, r), (r, out(d))] \
            + [(d, out(d))] * 5 + [(d, out(f)), (f, out(d)), (d, out(d))]
        return 6 * t * sum(i * o for i, o in lin)
    hd = cfg.head_dim_
    total = attn(cfg.n_heads, cfg.n_kv_heads, hd, s)
    if cfg.is_enc_dec:
        return total + attn(cfg.n_heads, cfg.n_kv_heads, hd,
                            cfg.enc_context, kv=False) + ffn(False)
    if cfg.family == "moe":
        e = cfg.n_experts
        c = moe.capacity(lm.moe_spec(cfg), s)
        return total + 6 * t * d * e + 6 * b * e * c * (
            2 * d * out(f) + f * out(d))
    di, n = cfg.ssm_expand * d, cfg.ssm_state
    ch = -(-di // size) if out(2 * di) < 2 * di else di
    # in_proj; w_dt and w_dt_out (rank 64); w_b, w_c and C . h; out_proj
    ssm = 6 * t * (d * out(2 * di) + 2 * ch * 64 + 3 * ch * n
                   + di * out(d))
    return total + ssm + ffn(cfg.gated_ffn)


@pytest.mark.parametrize("name", CONFIGS)
def test_block_flops_fall_by_the_shape_factor(run, name):
    ranks, _ = run
    cfg = w.family_config(name)
    whole = ranks[0][(name, None, "block")]["flops"]
    tp = ranks[0][(name, (1, 4), "block")]["flops"]
    factor = _flops(cfg, 1) / _flops(cfg, 4)
    assert abs(whole - _flops(cfg, 1)) <= FLOPS_RTOL * whole
    # mixtral 3.61, dbrx 3.71 (the router and the dispatch stay whole),
    # hymba 3.77 (q whole), rwkv6 3.01 (ddl_a, ddl_b and w_a whole; every
    # head at 4 ranks), whisper 4.00
    assert factor > 2.9
    assert abs(whole / tp - factor) <= FLOPS_RTOL * factor, (whole / tp,
                                                             factor)


@pytest.mark.parametrize("name", CONFIGS)
def test_no_all_gather_moves_a_whole_block_weight(run, name):
    """No all-gather of block 0 is as large as its smallest sharded weight
    matrix (the SSM's depthwise conv filter ``conv_w [4, d_inner]``, four
    taps a channel, is no matrix), RWKV's ``ddl_b`` excepted: it is
    gathered whole, once a layer.  The hybrid re-pairs ``in_proj``'s
    product by an all-to-all, and gathers no weight for it."""
    ranks, _ = run
    cfg = w.family_config(name)
    model = shd.abstract_model(cfg)
    specs = shd.param_placement_specs(model)
    first = "dec.0." if cfg.is_enc_dec else "blocks.0."
    weights = {n: math.prod(p.shape) for n, p in model.named_parameters()
               if n.startswith(first) and p.dim() >= 2
               and "model" in specs[n] and not n.endswith("conv_w")}
    block = ranks[0][(name, (1, 4), "block")]
    sizes = [math.prod(s) for s in block["gathers"]]
    traffic = block["traffic"]
    if name == "rwkv6":
        ddl_b = weights[first + "ddl_b"]
        assert ddl_b in sizes and traffic["ddl_b all-gather"] == ddl_b * 4
        sizes = [n for n in sizes if n != ddl_b]
        del weights[first + "ddl_b"]
    assert sizes and max(sizes) < min(weights.values()), (
        block["gathers"], weights)
    if name == "hymba":
        assert traffic["ssm in_proj all-to-all"] > 0
    if name in ("mixtral", "dbrx"):
        assert traffic["moe ffn all-gather"] > 0


def test_k5_operands_take_the_card_layout(run):
    """Every attention call of every run (training, serving, block 0) hands
    K5 operands whose head dim is contiguous, as its card check requires
    (``flash_attention._check``; the plain version on the CPU takes any
    strides, so only this shows a gathered q, k or v left strided)."""
    ranks, _ = run
    for r in range(4):
        assert ranks[r]["k5_refused"] == [], ranks[r]["k5_refused"][:3]
