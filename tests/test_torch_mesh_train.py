"""Meshed LM training (``launch.steps.make_mesh_train_step``,
``launch.train --mesh``) on 4 gloo ranks on the CPU, one spawn
(``torch_dist_worker.job_mesh_train``).

The gemma and mixtral smoke configs in f32, widened so that the sharding
rules split their leaves (``torch_dist_worker.WIDE``: d_model 520, d_ff
517, a vocabulary padded to 768; d_ff splits unevenly over 2 and 4 ranks),
train 2 steps from seed 0 through the training loop at ``--mesh 2,2``,
``2,1`` and ``1,2`` (the 4 ranks split into replicas of the smaller
meshes) and once unmeshed on one device.  Each rank's losses and grad
norms are within 1e-6 (relative) of the unmeshed step's, and its
parameters after 2 steps within 1e-5 of each leaf's largest entry.  The
meshed sums run in another order (rows split over ``data``), so the
gradients differ in their last f32 bits; AdamW's eps is 1e-3 here (lr
1e-3) so that its update is Lipschitz in the gradient: with eps 1e-8 a
near-zero gradient entry's sign decides a whole lr step.  The unmeshed run
is held against the reference's one-device ``make_train_step`` from the
same weights and batches (JAX in this process; the ranks import none):
losses and grad norms at 1e-5 relative (the packages' f32 training
tolerance), parameters within 1e-5 of a leaf's largest entry.

A checkpoint written by rank 0 at ``2,2`` restores bit for bit, with its
AdamW moments, at ``1,1`` and ``1,4`` (uneven shards).  The CLI trains the
bf16 smoke gemma at ``--mesh 2,2``; its losses are within 1e-3 (relative,
bf16) of the unmeshed CLI's.  Also: ``constrain`` inside and outside the
rules.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from repro.configs import lm_archs as jarchs
from repro.launch import steps as jsteps
from repro.train import optim as joptim
from repro_torch.configs import lm_archs
from repro_torch.launch import steps
from repro_torch.models import lm

ARCHS = ("gemma-2b", "mixtral-8x22b")
MESHES = ((2, 2), (2, 1), (1, 2))
LOSS_RTOL = 1e-6
PARAM_TOL = 1e-5
REF_RTOL = 1e-5
REF_PARAM_TOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return w.spawn("mesh_train", 4, tmp_path_factory.mktemp("mesh"),
                   timeout=240)


@functools.lru_cache(maxsize=None)
def _reference_run(arch):
    """The reference's one-device steps from the port's seed-0 weights:
    (losses, grad norms, parameters as numpy in ``lm.leaves`` order)."""
    cfg = dataclasses.replace(lm_archs.smoke(arch), **w.WIDE)
    jcfg = dataclasses.replace(jarchs.smoke(arch), **w.WIDE)
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


def _close(p, q, tol):
    scale = float(np.abs(np.asarray(q)).max())
    return float(np.abs(np.asarray(p) - np.asarray(q)).max()) <= tol * scale


@pytest.mark.parametrize("arch", ARCHS)
def test_unmeshed_steps_match_reference(ranks, arch):
    got = ranks[0][(arch, None)]
    losses, norms, params = _reference_run(arch)
    np.testing.assert_allclose(got["losses"], losses, rtol=REF_RTOL)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=REF_RTOL)
    assert len(got["params"]) == len(params)
    for i, (p, q) in enumerate(zip(got["params"], params)):
        assert tuple(p.shape) == q.shape
        assert _close(p.numpy(), q, REF_PARAM_TOL), i


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES)
def test_meshed_steps_match_unmeshed(ranks, arch, shape):
    ref = ranks[0][(arch, None)]
    for r in range(4):
        got = ranks[r][(arch, shape)]
        assert len(got["losses"]) == w.MESH_STEPS
        for key in ("losses", "grad_norms"):
            for a, b in zip(got[key], ref[key]):
                assert abs(a - b) <= LOSS_RTOL * abs(b), (r, key, got[key],
                                                         ref[key])
        for p, q in zip(got["params"], ref["params"]):
            assert p.shape == q.shape
            assert _close(p, q, PARAM_TOL), r


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", [(2, 2), (1, 2)])
def test_meshed_leaves_are_sharded_unevenly(ranks, arch, shape):
    """On a mesh with 2 ranks of ``model`` the rules split leaves, and the
    FFN's 517 columns split 259 / 258: the checks above run on shards."""
    sharded = [ranks[r][(arch, shape)]["sharded"] for r in range(4)]
    assert len(sharded[0]) >= 5
    uneven = {name for name, _, local, whole in sharded[0]
              if whole[-1] == 517 and local[-1] == 259}
    assert uneven
    for r in range(4):          # model rank 1 holds the shorter chunk
        model_rank = r % 2
        for name, placements, local, whole in sharded[r]:
            assert "Shard" in placements
            if name in uneven:
                assert local[-1] == (259 if model_rank == 0 else 258), r


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_2_1_keeps_whole_leaves(ranks, arch):
    """A mesh whose ``model`` axis has one rank places the same leaves as
    ``Shard``, each rank holding the whole (the rules shard over
    ``model`` only)."""
    for r in range(4):
        sharded = ranks[r][(arch, (2, 1))]["sharded"]
        assert [n for n, *_ in sharded] == \
            [n for n, *_ in ranks[r][(arch, (2, 2))]["sharded"]]
        for name, _, local, whole in sharded:
            assert local == whole, (r, name)


def test_cli_mesh_2_2_trains_as_unmeshed(ranks):
    plain = ranks[0]["cli_plain"]
    for r in range(4):
        losses = ranks[r]["cli"]
        assert len(losses) == 2
        for a, b in zip(losses, plain):
            assert abs(a - b) <= 1e-3 * abs(b)
        assert ranks[r]["cli_ckpt_step"] == 2


@pytest.mark.parametrize("shape", [(1, 1), (1, 4)])
def test_checkpoint_from_2_2_restores_bit_for_bit(ranks, shape):
    for r in range(4):
        got = ranks[r][("restore", shape)]
        want = ranks[r][("gemma-2b", (2, 2))]
        assert got["step"] == 2 and got["opt_step"] == 2
        for key in ("params", "m", "v"):
            assert len(got[key]) == len(want[key])
            for p, q in zip(got[key], want[key]):
                assert p.dtype == q.dtype and torch.equal(p, q), (r, key)
        if shape == (1, 4):     # 517 columns: 130, 130, 130, 127
            assert (130 if r < 3 else 127) in \
                {s[-1] for s in got["local_shapes"]}


def test_constrain_redistributes_only_inside_the_rules(ranks):
    for r in range(4):
        outside_same, plain_same, placements, local_shape, equal = \
            ranks[r]["constrain"]
        assert outside_same and plain_same and equal
        assert placements == [("Shard", 0), ("Shard", 1)]
        assert local_shape == (2, 4)
