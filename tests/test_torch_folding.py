"""Folding on the CPU: the port's tables equal the JAX package's from the
same parameters (carried across with ``params_from_reference``), the port's
folded codes equal its own ``apply_codes``, and a port-folded artifact loads
in the reference and predicts identically."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pipeline as jpipeline
from repro.configs import paper_tasks as jtasks
from repro.core import assemble as jassemble
from repro.core import folding as jfolding
from repro_torch import pipeline as tpipeline
from repro_torch.core import assemble as tassemble
from repro_torch.core import folding as tfolding


def _additive_cfg():
    layers = (jassemble.LayerSpec(12, 3, 2, False, add_terms=2, add_bits=3),
              jassemble.LayerSpec(4, 3, 2, True),
              jassemble.LayerSpec(1, 4, 2, False))
    return dataclasses.replace(jtasks.reduced("nid"), layers=layers)


TASKS = {"nid_reduced": lambda: jtasks.reduced("nid"),
         "jsc_reduced": lambda: jtasks.reduced("jsc"),
         "mnist_reduced": lambda: jtasks.reduced("mnist"),
         "additive": _additive_cfg}


def _tcfg(cfg):
    return tpipeline.config_from_dict(jpipeline.config_to_dict(cfg))


def _trained_like_params(cfg, seed):
    """Reference-layout parameters with the spread of trained ones: BN
    statistics and affine, and every quantizer's log-scale, drawn from
    ``seed``."""
    tree = tassemble.params_to_reference(
        tassemble.init(seed, _tcfg(cfg), device="cpu"))
    rs = np.random.RandomState(seed)
    tree["in_q"]["log_scale"] = np.float32(rs.uniform(-1.0, 0.0))
    for layer in tree["layers"]:
        bn = layer["subnet"]["bn"]
        n = bn["mean"].shape[0]
        bn["mean"] = rs.normal(0, 0.5, n).astype(np.float32)
        bn["var"] = rs.uniform(0.3, 3.0, n).astype(np.float32)
        bn["gamma"] = rs.uniform(0.5, 1.5, n).astype(np.float32)
        bn["beta"] = rs.normal(0, 0.3, n).astype(np.float32)
        for q in ("out_q", "add_q"):
            if q in layer:
                layer[q]["log_scale"] = np.float32(rs.uniform(-2.0, 0.0))
    return tree


def _x(cfg, n, seed):
    return np.random.RandomState(seed).uniform(
        -2.0, 2.0, (n, cfg.in_features)).astype(np.float32)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_fold_network_tables_identical_to_reference(task, tmp_path):
    cfg = TASKS[task]()
    tree = _trained_like_params(cfg, seed=3)
    jnet = jfolding.fold_network(jax.tree.map(jnp.asarray, tree), cfg)
    net = tassemble.params_from_reference(tree, device="cpu")
    tnet = tfolding.fold_network(net, _tcfg(cfg))
    assert jpipeline.config_to_dict(jnet.cfg) == \
        tpipeline.config_to_dict(tnet.cfg)
    want = jfolding.tables_to_numpy(jnet)
    got = tfolding.tables_to_numpy(tnet)
    assert len(got) == len(want)
    for t, w in zip(got, want):
        assert t.dtype == np.int32
        np.testing.assert_array_equal(t, w)
    assert any(len(np.unique(t)) > 2 for t in got)
    for m, jm in zip(tnet.mappings, jnet.mappings):
        assert (m is None) == (jm is None)
        if m is not None:
            np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    assert tnet.in_q["log_scale"] == float(jnet.in_q["log_scale"])
    assert tnet.out_q["log_scale"] == float(jnet.out_q["log_scale"])

    # the port's folded inference equals its own quantized model
    x = _x(cfg, 300, seed=4)
    np.testing.assert_array_equal(
        tfolding.folded_apply_codes(tnet, x).numpy(),
        tassemble.apply_codes(net, _tcfg(cfg), x).numpy())

    # a port-folded artifact loads in the reference and predicts the same
    comp = tpipeline.compile_network(net, _tcfg(cfg))
    assert comp.device.type == "cpu"
    path = comp.save(str(tmp_path / "port_folded.npz"))
    jcomp = jpipeline.CompiledLUTNetwork.load(path)
    np.testing.assert_array_equal(
        np.asarray(jcomp.predict_codes(x, backend="take")),
        comp.predict_codes(x, backend="take").numpy())
    np.testing.assert_array_equal(
        np.asarray(jcomp.predict(x)), comp.predict(x).numpy())


def test_fold_layer_enumerates_in_chunks(monkeypatch):
    """The enumeration chunk splits a layer's addresses without changing
    its table."""
    cfg = jtasks.reduced("nid")
    net = tassemble.params_from_reference(_trained_like_params(cfg, 5),
                                          device="cpu")
    whole = tfolding.fold_layer(net, _tcfg(cfg), 3)
    monkeypatch.setattr(tfolding, "_ENUM_CHUNK", 7)
    torch.testing.assert_close(tfolding.fold_layer(net, _tcfg(cfg), 3), whole,
                               rtol=0, atol=0)
    assert whole.shape == (1, 256) and whole.dtype == torch.int32
