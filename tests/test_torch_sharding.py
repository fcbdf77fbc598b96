"""Sharding rules (``repro_torch.dist.sharding``) and the abstract cell
arguments (``repro_torch.launch.steps``) held against the JAX package's
``repro.dist.sharding`` / ``repro.launch.steps`` on the CPU.

Both sides are abstract (``jax.eval_shape``; the port's meta device), so
every arch of ``lm_archs`` is compared at its full config, leaf for leaf
and in the reference's leaf order.  Cache specs are compared on (2, 4)
and (2, 2, 2) meshes through ``jax.sharding.AbstractMesh``, which has only
a shape and axis names: no device count changes.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import lm_archs as jarchs
from repro.dist import sharding as jshd
from repro.launch import steps as jsteps
from repro_torch.configs import lm_archs
from repro_torch.dist import sharding as shd
from repro_torch.dist.sharding import Spec
from repro_torch.launch import steps

ARCHS = list(jarchs.ARCHS)
MESHES = {"single": ((2, 4), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}


def _flat(tree, prefix=()):
    """``[(path, leaf)]`` of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _ref_flat(tree, is_leaf):
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return [(tuple(k.key for k in path), leaf) for path, leaf in leaves]


def test_every_arch_has_a_port_config():
    assert set(lm_archs.ARCHS) == set(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_tree_equals_reference_at_full_config(arch):
    ref = _ref_flat(jsteps.param_spec_tree(jarchs.get(arch)),
                    lambda x: isinstance(x, P))
    got = _flat(steps.param_spec_tree(lm_archs.get(arch)))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, want), (_, spec) in zip(ref, got):
        assert isinstance(spec, Spec)
        assert tuple(spec) == tuple(want), (arch, path)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("serve", [False, True])
def test_abstract_params_equal_reference_shapes(arch, serve):
    """The port's meta parameters, stacked per layer, have the reference's
    ``abstract_params`` shapes and types; no storage is held."""
    ref = _ref_flat(jsteps.abstract_params(jarchs.get(arch), serve=serve),
                    lambda x: hasattr(x, "shape"))
    model = steps.abstract_params(lm_archs.get(arch), serve=serve)
    from repro_torch.models import lm
    got = {}
    for path, layer, p in lm.leaves(model):
        assert p.is_meta
        n = got.get(path, (0, p))[0]
        got[path] = (n + (layer is not None), p)
    assert sorted(got) == [p for p, _ in ref]
    for path, leaf in ref:
        n, p = got[path]
        shape = ((n,) if n else ()) + tuple(p.shape)
        assert shape == tuple(leaf.shape), (arch, path)
        assert str(p.dtype).split(".")[-1] == str(leaf.dtype), (arch, path)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_cache_specs_equal_reference(arch, mesh_kind):
    shape, axes = MESHES[mesh_kind]
    mesh = AbstractMesh(shape, axes)
    jcfg, cfg = jarchs.get(arch), lm_archs.get(arch)
    for batch in (8, 6, 3):
        ref = jsteps.cache_spec_tree(jcfg, mesh, batch)
        got = steps.cache_spec_tree(cfg, mesh, batch)
        assert set(got) == set(ref)
        for k in ref:
            assert tuple(got[k]) == tuple(ref[k]), (arch, batch, k)


@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-small",
                                  "rwkv6-7b", "hymba-1.5b"])
@pytest.mark.parametrize("shape_name", list(jsteps.SHAPES))
def test_input_specs_equal_reference_shapes(arch, shape_name):
    ref = jsteps.input_specs(jarchs.get(arch), jsteps.SHAPES[shape_name])
    got = steps.input_specs(lm_archs.get(arch), steps.SHAPES[shape_name])
    assert set(got) == set(ref)
    for k in ref:
        if k == "cache":
            assert set(got[k]) == set(ref[k])
            for c in ref[k]:
                assert tuple(got[k][c].shape) == tuple(ref[k][c].shape)
                assert got[k][c].is_meta
        else:
            assert tuple(got[k].shape) == tuple(ref[k].shape)


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_batch_and_opt_specs_follow_reference(mesh_kind):
    shape, axes = MESHES[mesh_kind]
    mesh = AbstractMesh(shape, axes)
    for arch in ("gemma-2b", "whisper-small"):
        ref = jsteps.batch_specs(jarchs.get(arch), mesh)
        got = steps.batch_specs(lm_archs.get(arch), mesh)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in ref.items()}
    assert shd.dp_axes(mesh) == jshd.dp_axes(mesh)
    pspecs = steps.param_spec_tree(lm_archs.smoke("gemma-2b"))
    ospecs = steps.opt_spec_tree(None, pspecs)
    assert ospecs.step == Spec() and ospecs.m is pspecs and ospecs.v is pspecs


def test_to_shardings_places_specs_on_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    tree = {"w": Spec(None, "model"), "b": Spec(),
            "kv": Spec(None, ("pod", "data")), "l": [Spec("data", None)]}
    got = shd.to_shardings(mesh, tree)
    assert got["w"] == [Replicate(), Replicate(), Shard(1)]
    assert got["b"] == [Replicate()] * 3
    assert got["kv"] == [Shard(1), Shard(1), Replicate()]
    assert got["l"] == [[Replicate(), Shard(0), Replicate()]]
    opt = shd.to_shardings(mesh, steps.opt_spec_tree(None, tree))
    assert opt.step == [Replicate()] * 3 and opt.m["w"] == got["w"]
    assert Spec(None, ("data",)) == Spec(None, "data")
    assert Spec(("a", "b")) == (("a", "b"),)


def test_param_placement_specs_drop_the_layer_axis():
    """A per-layer tensor takes its stacked leaf's spec without ``[L]``:
    a layer's norm ``[D]`` with D >= 512 is sharded over ``model`` as the
    stacked ``[L, D]`` leaf is; smaller and top-level vectors are not."""
    model = steps.abstract_params(lm_archs.get("gemma-2b"))
    specs = shd.param_placement_specs(model)
    assert specs["blocks.0.ln1"] == Spec("model")
    assert specs["blocks.3.attn.wq"] == Spec(None, "model")
    assert specs["blocks.3.attn.wk"] == Spec()           # 1 KV head x 256
    assert specs["embed"] == Spec(None, "model")
    assert specs["final_norm"] == Spec()
    assert set(specs) == {n for n, _ in model.named_parameters()}


def test_production_shapes_without_overrides(monkeypatch):
    from repro_torch.launch import mesh as mesh_mod
    for k in ("REPRO_MESH_SHAPE", "REPRO_MESH_SHAPE_MULTI"):
        monkeypatch.delenv(k, raising=False)
    assert mesh_mod.production_shape() == ((16, 16), ("data", "model"))
    assert mesh_mod.production_shape(multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))


def test_meta_cell_arguments_hold_no_storage():
    b = steps.batch_structs(lm_archs.get("whisper-small"),
                            steps.SHAPES["train_4k"])
    assert all(t.is_meta for t in b.values())
    assert tuple(b["audio_embed"].shape) == (256, 4096, 768)
    c = steps.abstract_cache(lm_archs.get("qwen2-72b"), 128, 32_768)
    assert c["kv_k"].is_meta and c["kv_k"].shape[1] == 128
    assert c["kv_k"].dtype == torch.bfloat16
    np.testing.assert_equal(steps.cell_runnable(
        lm_archs.get("gemma-2b"), steps.SHAPES["long_500k"])[0], False)
