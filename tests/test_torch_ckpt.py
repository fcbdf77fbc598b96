"""The port's checkpoints (``repro_torch.ckpt.checkpoint``): the reference's
roundtrip, atomicity, retention and async tests, the manifest codec
against ``msgpack`` itself, the leaf keys against ``jax.tree_util``'s, and
checkpoints of a smoke LM's (params, AdamW state) written by one package
and restored by the other, bf16 leaves included."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs import lm_archs as jarchs
from repro.launch import steps as jsteps
from repro.train import optim as joptim
from repro_torch.ckpt import checkpoint
from repro_torch.configs import lm_archs
from repro_torch.launch import steps
from repro_torch.models import lm, whisper


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
            "d": [torch.zeros(2), torch.tensor(3)]}
    checkpoint.save(str(tmp_path), 7, tree)
    like = {"a": torch.zeros(2, 3, dtype=torch.int64),
            "b": {"c": torch.zeros(4, dtype=torch.bfloat16)},
            "d": [torch.zeros(2), torch.tensor(0)]}
    restored, step = checkpoint.restore(str(tmp_path), like)
    assert step == 7
    for (_, x), (_, y) in zip(checkpoint._flatten(tree),
                              checkpoint._flatten(restored)):
        assert x.dtype == y.dtype and x.device == y.device
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_checkpoint_atomicity_and_gc(tmp_path):
    tree = {"w": torch.ones(3)}
    for s in (1, 2, 3, 4, 5):
        checkpoint.save(str(tmp_path), s, tree, keep=2)
    steps_ = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path))
    assert steps_ == [4, 5]
    # a stale tmp dir must not be picked up
    os.makedirs(os.path.join(str(tmp_path), "step_0000000009.tmp"))
    assert checkpoint.latest_step(str(tmp_path)) == 5
    assert checkpoint.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), tree)
    with pytest.raises(ValueError, match="checkpoint"):
        checkpoint.restore(str(tmp_path), {"w": torch.ones(4)})


def test_checkpoint_async(tmp_path):
    tree = {"w": torch.full((8,), 2.0)}
    t = checkpoint.save_async(str(tmp_path), 3, tree)
    tree["w"].add_(1.0)           # the snapshot was taken before this
    t.join()
    checkpoint.wait_pending()
    restored, step = checkpoint.restore(str(tmp_path), tree)
    assert step == 3
    torch.testing.assert_close(restored["w"], torch.full((8,), 2.0))


def test_wait_pending_raises_a_writers_error(tmp_path):
    """``save_async`` onto a step that exists fails on its writer thread
    (``os.replace`` onto a full directory); ``wait_pending`` raises that
    error once, and the step written first stays as it was."""
    d = str(tmp_path)
    checkpoint.save(d, 4, {"w": torch.full((8,), 1.0)})
    checkpoint.save_async(d, 4, {"w": torch.full((8,), 5.0)})
    with pytest.raises(OSError):
        checkpoint.wait_pending()
    checkpoint.wait_pending()           # the error is raised once
    restored, step = checkpoint.restore(d, {"w": torch.zeros(8)})
    assert step == 4
    torch.testing.assert_close(restored["w"], torch.full((8,), 1.0))
    checkpoint.save_async(d, 6, {"w": torch.full((8,), 6.0)})
    checkpoint.wait_pending()           # a write that succeeds raises none
    assert checkpoint.latest_step(d) == 6


def test_codec_equals_msgpack():
    objs = [{"step": 5, "arrays": [{"key": "0/blocks/attn/wq",
                                    "file": "arr_00000.npy",
                                    "dtype": "bfloat16",
                                    "shape": [2, 64, 64]}]},
            [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63],
            {"a" * 31: 1, "b" * 32: "x" * 255, "c": "y" * 256,
             "d": "z" * 70_000, "é": "ü"},
            [None, True, False, [], {}], list(range(15)), list(range(16)),
            list(range(70_000)), {str(i): i for i in range(15)},
            {str(i): i for i in range(16)},
            {str(i): [i] for i in range(70_000)}]
    for obj in objs:
        packed = checkpoint.packb(obj)
        assert packed == msgpack.packb(obj)
        assert checkpoint.unpackb(packed) == msgpack.unpackb(packed) == obj
    with pytest.raises(ValueError, match="trailing"):
        checkpoint.unpackb(msgpack.packb(1) + b"\x00")
    with pytest.raises(ValueError, match="unsupported"):
        checkpoint.unpackb(msgpack.packb(1.5))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def _smoke(arch="mixtral-8x22b"):
    jcfg = dataclasses.replace(jarchs.smoke(arch), dtype="float32")
    cfg = dataclasses.replace(lm_archs.smoke(arch), dtype="float32")
    jp = jsteps.init_fn(jcfg)(jax.random.PRNGKey(0))
    mod = whisper if cfg.is_enc_dec else lm
    model = mod.params_from_reference(jax.tree.map(np.asarray, jp), cfg,
                                      "cpu")
    rs = np.random.RandomState(1)
    jopt = joptim.AdamWState(
        step=jnp.asarray(5, jnp.int32),
        m=jax.tree.map(lambda a: jnp.asarray(rs.normal(size=a.shape),
                                              jnp.float32), jp),
        v=jax.tree.map(lambda a: jnp.asarray(rs.uniform(size=a.shape),
                                              jnp.float32), jp))
    opt = steps.opt_init(model)
    codec = steps.StateCodec()
    _, opt = codec.from_tree(jax.tree.map(
        lambda a: torch.from_numpy(np.array(a)), (jp, jopt)), model, opt)
    return jp, jopt, model, opt, codec


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "rwkv6-7b",
                                  "hymba-1.5b", "whisper-small"])
def test_keys_follow_jax_tree_paths(arch):
    """The port's (params, AdamW state) tree flattens to the reference's
    keys in the reference's order (``_flatten`` of both packages), with
    the reference's shapes; the optimizer's leaf order is that order."""
    jp, jopt, model, opt, codec = _smoke(arch)
    jflat = jckpt._flatten((jp, jopt))[0]
    flat = checkpoint._flatten(codec.to_tree(model, opt))
    assert [k for k, _ in flat] == [k for k, _ in jflat]
    for (_, a), (_, b) in zip(jflat, flat):
        assert tuple(a.shape) == tuple(b.shape)
    assert "1/.step" in dict(flat) and "0/embed" in dict(flat)
    if arch == "mixtral-8x22b":
        assert flat[0][0] == "0/blocks/attn/wk"
        assert "1/.m/embed" in dict(flat)


def test_jax_save_restores_in_the_port_and_back(tmp_path):
    """JAX saves (params, opt_state) with bf16 leaves, the port restores
    them exactly, saves them again, and JAX restores the port's files to
    the same bits; the manifests agree key for key."""
    jp, jopt, model, opt, codec = _smoke()
    jtree = (jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp), jopt)
    jckpt.save(str(tmp_path / "jax"), 5, jtree)
    like = (jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.bfloat16),
                         jp), codec.to_tree(model, opt)[1])
    got, step = checkpoint.restore(str(tmp_path / "jax"), like)
    assert step == 5 and int(got[1].step) == 5
    flat_j = jckpt._flatten(jtree)[0]
    flat_p = checkpoint._flatten(got)
    for (kj, a), (kp, t) in zip(flat_j, flat_p):
        assert kj == kp
        want = np.asarray(a)
        if want.dtype == ml_dtypes.bfloat16:
            assert t.dtype == torch.bfloat16
            want = want.view(np.uint16).view(np.int16)
            t = t.view(torch.int16)
        np.testing.assert_array_equal(t.numpy(), want)
    checkpoint.save(str(tmp_path / "port"), 5, got)
    back, _ = jckpt.restore(str(tmp_path / "port"), jtree)
    for a, b in zip(jax.tree.leaves(jtree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.atleast_1d(np.asarray(a)).view(np.uint8),
            np.atleast_1d(np.asarray(b)).view(np.uint8))
    man = [msgpack.unpackb(open(tmp_path / d / "step_0000000005" /
                                "manifest.msgpack", "rb").read())
           for d in ("jax", "port")]
    assert man[0] == man[1]


def test_port_train_state_restores_in_jax_and_back(tmp_path):
    """The port's f32 (params, AdamW state) through its codec: JAX restores
    it into its own trees with equal values, and the port restores it into
    a fresh model and state."""
    jp, jopt, model, opt, codec = _smoke()
    checkpoint.save(str(tmp_path), 9, codec.to_tree(model, opt))
    (rp, ropt), step = jckpt.restore(str(tmp_path), (jp, jopt))
    assert step == 9 and int(ropt.step) == 5
    for a, b in zip(jax.tree.leaves((jp, jopt)), jax.tree.leaves((rp, ropt))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    cfg = dataclasses.replace(lm_archs.smoke("mixtral-8x22b"), dtype="float32")
    fresh = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    fopt = steps.opt_init(fresh)
    tree, _ = checkpoint.restore(str(tmp_path), codec.to_tree(fresh, fopt))
    fresh, fopt = codec.from_tree(tree, fresh, fopt)
    assert fopt.step == 5
    for a, b in zip(steps.train_leaves(model), steps.train_leaves(fresh)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for a, b in zip(opt.m + opt.v, fopt.m + fopt.v):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
