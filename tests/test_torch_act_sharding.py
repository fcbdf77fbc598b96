"""Activation rules (``repro_torch.dist.act_sharding``) on the CPU.

``_resolve`` and ``dp_axes`` are held against the reference's on
``AbstractMesh``es of axes ``(pod, data, model)``, ``(data, model)`` and
``(data,)``.  Every family's smoke config gives bit-identical outputs
(training forward and loss, prefill, decode) with and without
``activation_rules`` on one device.
"""
import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.dist import act_sharding as jact
from repro_torch.configs import lm_archs
from repro_torch.dist import act_sharding
from repro_torch.launch import steps
from repro_torch.models import lm, whisper

MESHES = [((2, 2, 2), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((4,), ("data",))]
NAMES = [None, "batch", "act_batch", "heads", "embed", "model", "act_seq",
         "heads_tp", "tp", "data", "pod", "vocab"]
FAMILIES = ["gemma-2b", "chameleon-34b", "mixtral-8x22b", "rwkv6-7b",
            "hymba-1.5b", "whisper-small"]


@pytest.mark.parametrize("shape,axes", MESHES)
def test_resolve_and_dp_axes_equal_reference(shape, axes):
    mesh = AbstractMesh(shape, axes)
    assert act_sharding.dp_axes(mesh) == jact.dp_axes(mesh)
    for name in NAMES:
        assert act_sharding._resolve(name, mesh) == \
            jact._resolve(name, mesh), name


def test_placements_of_logical_axes():
    from torch.distributed.tensor import Replicate, Shard

    def logical(mesh, axes):
        return act_sharding.placements(
            mesh, [act_sharding._resolve(a, mesh) for a in axes])
    mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    assert logical(mesh, ("batch", "heads", None, "act_seq", None)) == \
        [Shard(0), Shard(0), Shard(1)]
    assert logical(mesh, (None, "embed")) == \
        [Replicate(), Replicate(), Shard(1)]
    assert logical(mesh, ("heads", "model")) == \
        [Replicate(), Replicate(), Shard(0)]      # the first dim claims
    assert logical(AbstractMesh((4,), ("data",)), ("heads", "batch")) == \
        [Shard(1)]


def test_constrain_is_the_identity_without_dtensors():
    x = torch.randn(3, 4)
    assert act_sharding.constrain(x, "batch", "embed") is x
    with act_sharding.activation_rules(AbstractMesh((2, 4),
                                                    ("data", "model"))):
        assert act_sharding.constrain(x, "batch", "embed") is x
    assert act_sharding._ACTIVE_MESH is None
    assert act_sharding.gathered(x) is x


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", loss_chunk=8)


def _run(cfg, model, toks, audio):
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_enc_dec:
        batch["audio_embed"] = audio
        (total, loss, _), grads = steps.value_and_grad(
            steps.make_loss_fn(cfg), model, batch)
        logits, cache = whisper.prefill(model, cfg, audio, toks[:, :8], 16)
        logits2, _ = whisper.decode_step(model, cfg, cache, toks[:, 8:9])
    else:
        (total, loss, _), grads = steps.value_and_grad(
            steps.make_loss_fn(cfg), model, batch)
        logits, cache = lm.prefill(model, cfg, toks[:, :8], 16)
        logits2, _ = lm.decode_step(model, cfg, cache, toks[:, 8:9])
    return [total, loss, logits, logits2] + \
        [g for g in grads if g is not None]


@pytest.mark.parametrize("arch", FAMILIES)
def test_rules_leave_one_device_outputs_bit_identical(arch, one_thread):
    cfg = _f32(lm_archs.smoke(arch))
    model = steps.init_fn(cfg)(torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 17)))
    audio = torch.from_numpy(rng.normal(size=(2, cfg.enc_context,
                                              cfg.d_model)).astype(
        np.float32)) if cfg.is_enc_dec else None
    plain = _run(cfg, model, toks, audio)
    mesh = AbstractMesh((1, 1), ("data", "model"))
    with act_sharding.activation_rules(mesh):
        ruled = _run(cfg, model, toks, audio)
    assert len(plain) == len(ruled)
    for a, b in zip(plain, ruled):
        assert torch.equal(a, b)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
