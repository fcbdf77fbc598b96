"""The dry run (``repro_torch.launch.dryrun``) in one subprocess with
torch's fake process group, at ``REPRO_MESH_SHAPE=2,4`` /
``REPRO_MESH_SHAPE_MULTI=2,2,2`` and 8 fake ranks, on smoke configs at the
production shapes (meta tensors: nothing is allocated).  The subprocess
imports no JAX; this test holds its records against the reference:

* ``status`` is the reference's ``cell_runnable`` verdict;
* rank 0's parameter bytes equal a sum reckoned from the reference's spec
  tree and ``abstract_params`` shapes (a sharded dim holds
  ``ceil(n / size)`` entries on rank 0);
* a train cell with ``model > 1`` has collectives; a (1, 1) mesh none.

The same subprocess runs full-size gemma-2b ``train_4k`` at ``(2, 4)``
(the tensor-parallel design: each rank's flops fall by the factor the
shapes give) and at ``(2, 1)`` (one rank of ``model``: every layer whole
on every rank), mixtral-8x22b's smoke cell at ``(2, 4)``, and one layer of
each of the other families at full width (``FAMILY_ARCHS``, ``train_4k``)
at ``(2, 4)`` and ``(2, 1)``: every cell is tensor parallel, and a rank's
flops and peak fall.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro.configs import lm_archs as jarchs
from repro.launch import steps as jsteps

ROOT = Path(__file__).resolve().parents[1]
# gemma-2b at every shape (its long_500k is skipped); rwkv6-7b, which is
# sub-quadratic, at long_500k (a batch of 1: the replicated fallback)
CELLS = [("gemma-2b", s) for s in jsteps.SHAPES] + [("rwkv6-7b", "long_500k")]
# one full-width layer of each family beside dense and vlm
FAMILY_ARCHS = ("mixtral-8x22b", "dbrx-132b", "rwkv6-7b", "hymba-1.5b",
                "whisper-small")
MESH_SIZES = {"single": {"data": 2, "model": 4},
              "multi": {"pod": 2, "data": 2, "model": 2}}

SCRIPT = """
import json, os
from repro_torch.launch import dryrun
out = []
for arch, shape in {cells!r}:
    for mesh in ("single", "multi"):
        out.append(dryrun.run_cell(arch, shape, mesh, verbose=False,
                                   smoke=True))
os.environ["REPRO_MESH_SHAPE"] = "1,1"
for shape in ("train_4k", "decode_32k"):
    rec = dryrun.run_cell("gemma-2b", shape, "single", verbose=False,
                          smoke=True)
    rec["mesh"] = "one"
    out.append(rec)
print("RECORDS " + json.dumps(out))
tp = {{}}
for mesh in ("2,4", "2,1"):
    os.environ["REPRO_MESH_SHAPE"] = mesh
    tp[mesh] = dryrun.run_cell("gemma-2b", "train_4k", "single",
                               verbose=False)
os.environ["REPRO_MESH_SHAPE"] = "2,4"
tp["moe"] = dryrun.run_cell("mixtral-8x22b", "train_4k", "single",
                            verbose=False, smoke=True)
print("TP_RECORDS " + json.dumps(tp))
import dataclasses
from repro_torch.configs import lm_archs
full = lm_archs.get
lm_archs.get = lambda name: dataclasses.replace(full(name), n_layers=1,
                                                remat_group=1)
fam = {{}}
for arch in {families!r}:
    for mesh in ("2,4", "2,1"):
        os.environ["REPRO_MESH_SHAPE"] = mesh
        fam[arch + " " + mesh] = dryrun.run_cell(arch, "train_4k", "single",
                                                 verbose=False)
print("FAMILY_RECORDS " + json.dumps(fam))
"""


@pytest.fixture(scope="module")
def output():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_") and k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(ROOT / "src"), REPRO_MESH_SHAPE="2,4",
               REPRO_MESH_SHAPE_MULTI="2,2,2", REPRO_DRYRUN_DEVICES="8",
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(
        cells=CELLS, families=FAMILY_ARCHS)],
                         env=env, cwd=str(ROOT), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def _line(output, tag):
    line = [l for l in output if l.startswith(tag + " ")]
    return json.loads(line[-1][len(tag) + 1:])


@pytest.fixture(scope="module")
def records(output):
    return _line(output, "RECORDS")


@pytest.fixture(scope="module")
def tp_records(output):
    return _line(output, "TP_RECORDS")


@pytest.fixture(scope="module")
def family_records(output):
    return _line(output, "FAMILY_RECORDS")


def _ref_param_bytes(arch, shape_name, sizes):
    """Rank 0's parameter bytes from the reference's specs and shapes."""
    cfg = jarchs.smoke(arch)
    serve = jsteps.SHAPES[shape_name].kind != "train"
    specs = jax.tree.leaves(jsteps.param_spec_tree(cfg),
                            is_leaf=lambda x: isinstance(x, P))
    shapes = jax.tree.leaves(jsteps.abstract_params(cfg, serve=serve))
    total = 0
    for spec, leaf in zip(specs, shapes):
        n = 1
        for dim, size in enumerate(leaf.shape):
            entry = spec[dim] if dim < len(spec) else None
            axes = () if entry is None else \
                (entry,) if isinstance(entry, str) else entry
            split = math.prod(sizes[a] for a in axes)
            n *= -(-size // split)
        total += n * leaf.dtype.itemsize
    return total


def test_every_cell_has_the_reference_status(records):
    assert len(records) == len(CELLS) * 2 + 2
    for rec in records:
        ok, reason = jsteps.cell_runnable(jarchs.smoke(rec["arch"]),
                                          jsteps.SHAPES[rec["shape"]])
        assert rec["status"] == ("ok" if ok else "skipped"), rec
        if not ok:
            assert rec["reason"] == reason


def test_param_bytes_per_rank_equal_reference_specs(records):
    n = 0
    for rec in records:
        if rec["status"] != "ok" or rec["mesh"] == "one":
            continue
        want = _ref_param_bytes(rec["arch"], rec["shape"],
                                MESH_SIZES[rec["mesh"]])
        ma = rec["memory_analysis"]
        assert ma["param_bytes_per_rank"] == want, rec
        assert ma["argument_size_in_bytes"] >= want
        assert ma["peak_bytes_per_rank"] >= ma["argument_size_in_bytes"]
        assert rec["cost_analysis"]["flops"] > 0
        n += 1
    assert n == 8


def test_collectives_where_the_mesh_splits(records):
    for rec in records:
        if rec["status"] != "ok":
            continue
        coll = rec["collectives"]
        count = sum(v["count"] for k, v in coll.items() if k != "total_bytes")
        if rec["mesh"] == "one":
            assert rec["mesh_shape"] == [1, 1]
            assert count == 0 and coll["total_bytes"] == 0, rec
        elif rec["shape"] == "train_4k":
            assert count >= 1 and coll["all-reduce"]["count"] >= 1, rec
            assert coll["total_bytes"] > 0


@pytest.mark.parametrize("causal,window,q_offset,skv", [
    (True, None, 0, 1100), (True, 300, 0, 1100), (False, None, 0, 700),
    (True, None, 400, 1500)])
def test_meta_attention_blocks_equal_the_plain_version(causal, window,
                                                       q_offset, skv):
    """The dry run's meta attention (``_plain_blocked``: the plain version
    a block of ``META_BLOCK_Q`` q rows at a time, so one block's scores are
    alive at once as in K5) gives the plain version's values on CPU
    tensors, and the meta dispatch its shape and type."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator().manual_seed(skv + q_offset)
    sq = skv - q_offset if causal else 1100
    q = torch.randn(1, 4, sq, 16, generator=g)
    k, v = (torch.randn(1, 2, skv, 16, generator=g) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    assert sq > fa.META_BLOCK_Q
    torch.testing.assert_close(fa._plain_blocked(q, k, v, **kw),
                               fa.flash_attention_plain(q, k, v, **kw),
                               rtol=0, atol=1e-6)
    out = fa.flash_attention(*(t.to("meta") for t in (q, k, v)), **kw)
    assert out.device.type == "meta" and out.shape == q.shape \
        and out.dtype == q.dtype


def test_dense_cell_computes_on_its_shards(tp_records):
    """gemma-2b ``train_4k`` at ``(2, 4)`` takes the tensor-parallel
    design, its 8 heads 2 a rank.  Every product of a layer and the head
    splits over the 4 ranks of ``model`` but ``wk`` and ``wv`` (256 wide,
    replicated by the rules), so against the ``(2, 1)`` cell, every rank
    computing each layer whole on the same rows, the flops a rank fall by
    ``whole / (whole / 4 + 3/4 kv)``, with ``kv`` the k and v products'
    flops: 8 a multiply-add (the forward, remat's recompute, dx and dw) of
    128 rows x 4,096 tokens x 2,048 x 256, twice a layer, 18 layers (a
    factor of 3.96)."""
    tp, whole = tp_records["2,4"], tp_records["2,1"]
    assert tp["status"] == whole["status"] == "ok"
    assert tp["design"] == "tp" and whole["design"] == "tp"
    assert tp["mesh_shape"] == [2, 4] and whole["mesh_shape"] == [2, 1]
    f_tp = tp["cost_analysis"]["flops"]
    f_whole = whole["cost_analysis"]["flops"]
    kv = 8 * (256 // 2) * 4096 * 2048 * 256 * 2 * 18
    factor = f_whole / (f_whole / 4 + 0.75 * kv)
    assert 3.9 < factor < 4.0
    assert abs(f_whole / f_tp - factor) <= 0.1 * factor, (f_whole / f_tp,
                                                          factor)
    # the FFN's hidden units are gathered before w_down; no weight is
    assert tp["tp_collectives"]["ffn all-gather"] > 0
    assert tp["tp_collectives"]["head all-to-all"] > 0
    assert whole["tp_collectives"] == {}
    assert tp["memory_analysis"]["peak_bytes_per_rank"] < \
        whole["memory_analysis"]["peak_bytes_per_rank"]


def test_moe_cell_stays_on_the_gather_design(tp_records):
    """The MoE smoke cell at ``(2, 4)`` is tensor parallel, as every
    family is (there is no gather design): at smoke width no
    weight is split, so q is whole, and only the loss's vocabulary
    reductions cross ``model``.  (The name is kept from when the MoE
    family ran on the gather design; the check is now its opposite.)"""
    rec = tp_records["moe"]
    assert rec["status"] == "ok" and rec["design"] == "tp (q whole)"
    assert set(rec["tp_collectives"]) == {"vocab all-reduce"}


def test_no_cell_is_on_a_gather_design(records, tp_records, family_records):
    recs = records + list(tp_records.values()) + \
        list(family_records.values())
    assert {r["design"] for r in recs if r["status"] == "ok"} <= {
        "tp", "tp (q whole)"}


# flops a rank at (2, 1) over those at (2, 4), one full-width layer: every
# product of the layer, the head and the loss splits over the 4 ranks of
# ``model`` but the MoE router, RWKV's low-rank lerp and decay factors and
# hymba's attention core (25 heads: q whole)
FAMILY_FLOPS_FALL = {"mixtral-8x22b": 3.99, "dbrx-132b": 3.99,
                     "rwkv6-7b": 3.9, "hymba-1.5b": 2.7,
                     "whisper-small": 3.99}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_cells_compute_on_their_shards(family_records, arch):
    tp, whole = family_records[arch + " 2,4"], family_records[arch + " 2,1"]
    assert tp["status"] == whole["status"] == "ok", (tp, whole)
    want = "tp (q whole)" if arch == "hymba-1.5b" else "tp"
    assert tp["design"] == want and whole["design"] == "tp"
    fall = whole["cost_analysis"]["flops"] / tp["cost_analysis"]["flops"]
    assert FAMILY_FLOPS_FALL[arch] <= fall <= 4.0, fall
    assert tp["memory_analysis"]["peak_bytes_per_rank"] < \
        whole["memory_analysis"]["peak_bytes_per_rank"]
    assert tp["tp_collectives"] and whole["tp_collectives"] == {}
    if arch in ("mixtral-8x22b", "dbrx-132b"):
        assert tp["tp_collectives"]["moe ffn all-gather"] > 0
    if arch == "hymba-1.5b":
        assert tp["tp_collectives"]["ssm in_proj all-to-all"] > 0
    if arch == "rwkv6-7b":
        assert tp["tp_collectives"]["ddl_b all-gather"] > 0
