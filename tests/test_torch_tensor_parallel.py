"""Tensor parallelism of the dense and vlm families (``lm.tp_view``,
``launch.steps.make_mesh_train_step`` and ``build_cell``'s serving steps)
on 4 gloo ranks on the CPU, one spawn
(``torch_dist_worker.job_tensor_parallel``).

Three f32 configs, widened so that attention splits
(``torch_dist_worker.TP_CONFIGS`` on ``WIDE``: d_model 520, d_ff 517,
uneven on 2 and 4 ranks, a vocabulary padded to 768):

* ``gemma``: MQA, 32 heads of 16 (``wq`` 512 wide), the tied head: the
  table's rows redistributed from its ``Shard(1)`` placement;
* ``qwen``: qkv biases, ``wk``/``wv`` 512 wide, so sharded and gathered
  whole; the untied head;
* ``chameleon`` (vlm, qk-norm): 33 heads, which no mesh splits, so q is
  gathered whole (``design`` says ``tp (q whole)``).

Each trains 2 steps through the training loop at ``(1, 2)``, ``(2, 2)``
and ``(1, 4)`` (the 4 ranks split into replicas of the smaller meshes) and
once unmeshed, with the bounds of ``test_torch_mesh_train.py``: losses and
grad norms within 1e-6 (relative) of the unmeshed step's, parameters
within 1e-5 of each leaf's largest entry (the backward's partial sums run
in another order; AdamW eps 1e-3).  The unmeshed run is held against the
reference's one-device ``make_train_step`` from the same weights and
batches at 1e-5 (JAX in this process, run while the ranks work; they
import none).  Prefill logits and caches and 4 decode steps' logits
through ``build_cell`` at ``(1, 2)`` and ``(1, 4)`` are within 1e-5 of the
largest entry of the unmeshed ones.

Block 0's forward and backward on rank 0 at ``(1, 4)``: its flops fall by
the factor its shapes give (:func:`_flops`, exact to the count here; the
bound is 10%), and no all-gather of the tensor-parallel view is as large
as the smallest sharded block weight.
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
from repro_torch.models import lm

CONFIGS = tuple(w.TP_CONFIGS)
LOSS_RTOL = 1e-6
PARAM_TOL = 1e-5
REF_RTOL = 1e-5
REF_PARAM_TOL = 1e-5
SERVE_TOL = 1e-5
FLOPS_RTOL = 0.10
DESIGN = {"gemma": "tp", "qwen": "tp", "chameleon": "tp (q whole)"}


def _reference_run(name):
    """The reference's one-device steps from the port's seed-0 weights:
    (losses, grad norms, parameters as numpy in ``lm.leaves`` order)."""
    cfg = w.tp_config(name)
    arch, extra = w.TP_CONFIGS[name]
    jcfg = dataclasses.replace(jarchs.smoke(arch), **w.WIDE, **extra)
    model = steps.init_fn(cfg)(torch.Generator().manual_seed(0), "cpu")
    tree = jax.tree.map(jnp.asarray, lm.params_to_reference(model))
    opt = joptim.adamw_init(tree)
    step = jax.jit(jsteps.make_train_step(
        jcfg, opt_cfg=joptim.AdamWConfig(**w.MESH_OPT)))
    losses, norms = [], []
    for b in w.train_batches(cfg, w.MESH_STEPS, w.MESH_BATCH, w.MESH_SEQ):
        tree, opt, m = step(tree, opt, {k: jnp.asarray(v.numpy(), jnp.int32)
                                        for k, v in b.items()})
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
    started = w.start("tensor_parallel", 4, tmp_path_factory.mktemp("tp"))
    refs = {name: _reference_run(name) for name in CONFIGS}
    return w.collect(started, timeout=240), refs


def _close(p, q, tol):
    scale = float(np.abs(np.asarray(q)).max())
    return float(np.abs(np.asarray(p) - np.asarray(q)).max()) <= tol * scale


@pytest.mark.parametrize("name", CONFIGS)
def test_unmeshed_steps_match_reference(run, name):
    ranks, refs = run
    got = ranks[0][(name, None)]
    losses, norms, params = refs[name]
    np.testing.assert_allclose(got["losses"], losses, rtol=REF_RTOL)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=REF_RTOL)
    assert len(got["params"]) == len(params)
    for i, (p, q) in enumerate(zip(got["params"], params)):
        assert tuple(p.shape) == q.shape
        assert _close(p.numpy(), q, REF_PARAM_TOL), i


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", w.TP_MESHES)
def test_tp_steps_match_unmeshed(run, name, shape):
    ranks, _ = run
    ref = ranks[0][(name, None)]
    for r in range(4):
        assert ranks[r][(name, shape, "design")] == DESIGN[name]
        got = ranks[r][(name, shape)]
        assert len(got["losses"]) == w.MESH_STEPS
        for key in ("losses", "grad_norms"):
            for a, b in zip(got[key], ref[key]):
                assert abs(a - b) <= LOSS_RTOL * abs(b), (r, key, got[key],
                                                         ref[key])
        for p, q in zip(got["params"], ref["params"]):
            assert p.shape == q.shape
            assert _close(p, q, PARAM_TOL), r


@pytest.mark.parametrize("name", CONFIGS)
def test_placements_are_the_rules(run, name):
    """The step trains the leaves the sharding rules place, as they place
    them (``Shard`` of the trailing dim, uneven 517 split 259 / 258)."""
    ranks, _ = run
    model = lm.empty_params(w.tp_config(name), "meta", torch.float32)
    want = {n for n, s in shd.param_placement_specs(model).items()
            if "model" in s}
    for r in range(4):
        sharded = ranks[r][(name, (1, 2))]["sharded"]
        assert {n for n, *_ in sharded} == want
        for n, _, local, whole in sharded:
            if whole[-1] == 517:
                assert local[-1] == (259 if r % 2 == 0 else 258), (r, n)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("shape", w.TP_SERVE_MESHES)
def test_serving_matches_unmeshed(run, name, shape):
    ranks, _ = run
    ref = ranks[0][(name, None, "serve")]
    for r in range(4):
        got = ranks[r][(name, shape, "serve")]
        # the logits come out on each rank's vocabulary columns
        assert got["logits_placements"] == "(Shard(dim=0), Shard(dim=1))"
        assert got["prefill"].shape == ref["prefill"].shape
        assert _close(got["prefill"], ref["prefill"], SERVE_TOL), r
        assert set(got["cache"]) == set(ref["cache"])
        for k, v in ref["cache"].items():
            if v.is_floating_point():
                assert _close(got["cache"][k], v, SERVE_TOL), (r, k)
            else:
                assert (got["cache"][k] == v).all(), (r, k)
        assert len(got["decode"]) == w.TP_DECODE
        for a, b in zip(got["decode"], ref["decode"]):
            assert _close(a, b, SERVE_TOL), r


def _flops(cfg, size):
    """Block 0's training flops (forward and backward) on rank 0 of a
    ``model`` axis of ``size``, from its shapes: each linear ``6 T in
    out`` (the forward, dx and dw products) with ``out`` this rank's chunk
    when the rules split the weight, and the attention core ``16 B S^2
    hd`` a q head (the plain version's two forward products, recomputed in
    the backward, and its four gradient products) over this rank's
    heads."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    h, hk = cfg.n_heads, cfg.n_kv_heads
    t = w.MESH_BATCH * w.MESH_SEQ

    def out(n):
        return -(-n // size) if shd.is_sharded((1, n)) else n
    linears = [(d, out(h * hd)), (d, out(hk * hd)), (d, out(hk * hd)),
               (h * hd, out(d)), (d, out(f)), (f, out(d))]
    if cfg.gated_ffn:
        linears.append((d, out(f)))
    heads = h
    if size > 1 and out(h * hd) < h * hd and h % size == 0:
        heads = h // size
    return 6 * t * sum(i * o for i, o in linears) \
        + 16 * w.MESH_BATCH * w.MESH_SEQ ** 2 * hd * heads


@pytest.mark.parametrize("name", CONFIGS)
def test_block_flops_fall_by_the_shape_factor(run, name):
    ranks, _ = run
    cfg = w.tp_config(name)
    whole = ranks[0][(name, None, "block")]["whole"]["flops"]
    tp = ranks[0][(name, (1, 4), "block")]["tp"]["flops"]
    assert whole == _flops(cfg, 1)
    factor = _flops(cfg, 1) / _flops(cfg, 4)
    # gemma 3.852, qwen 3.995 (every product splits but the 1/4-width
    # chunks of 517 round up), chameleon 3.465 (q whole: the attention
    # core stays whole)
    assert factor > 3.4
    assert abs(whole / tp - factor) <= FLOPS_RTOL * factor, (whole / tp,
                                                             factor)


@pytest.mark.parametrize("name", CONFIGS)
def test_no_all_gather_moves_a_whole_block_weight(run, name):
    ranks, _ = run
    cfg = w.tp_config(name)
    model = lm.empty_params(cfg, "meta", torch.float32)
    specs = shd.param_placement_specs(model)
    weights = [math.prod(p.shape) for n, p in model.named_parameters()
               if n.startswith("blocks.0.") and p.dim() == 2
               and "model" in specs[n]]
    block = ranks[0][(name, (1, 4), "block")]
    tp = [math.prod(s) for s in block["tp"]["gathers"]]
    assert tp and max(tp) < min(weights), (block["tp"]["gathers"], weights)


def test_eager_gather_and_uneven_rows(run):
    """The eager all-gather (gloo with CUDA tensors) equals the functional
    one; a tied table whose rows do not split over ``model`` raises."""
    ranks, _ = run
    for r in range(4):
        same, raised = ranks[r]["eager_gather"]
        assert same and raised
