"""The port's roofline (``benchmarks/torch_roofline.py``) against the
reference's (``benchmarks/roofline.py``): the ``--lut`` candidate grid,
pick and choice table on ``cpu`` and ``tpu``; ``model_flops`` on every
architecture and shape; the dry-run half's roofs on a synthetic record,
against a hand computation."""
import json

import pytest

from benchmarks import roofline as ref
from benchmarks import torch_roofline as port
from repro.configs import lm_archs as jarchs
from repro.launch import steps as jsteps
from repro_torch.configs import lm_archs, paper_tasks
from repro_torch.kernels import autotune
from repro_torch.launch import steps

TASKS = sorted(paper_tasks.TASKS)


@pytest.mark.parametrize("device", ["cpu", "tpu"])
@pytest.mark.parametrize("task", TASKS)
def test_lut_grid_equals_reference(task, device, capsys):
    """The printed grid's rows and pick line equal the reference's."""
    got = port.print_lut_candidates(task, device)
    out_port = capsys.readouterr().out
    want = ref.print_lut_candidates(task, device)
    out_ref = capsys.readouterr().out
    assert got == want
    assert out_port.splitlines()[-1] == out_ref.splitlines()[-1]


def test_lut_choice_table_cpu_tpu_equal_reference_gpu_is_hopper(tmp_path):
    from repro.kernels import autotune as jautotune
    path = port.write_lut_choices(str(tmp_path / "choices.json"))
    with open(path) as f:
        doc = json.load(f)
    want = jautotune.choice_table()
    got = [c for c in doc["choices"] if c["device"] != "gpu"]
    assert doc["batch"] == want["batch"] and got == want["choices"]
    gpu = {c["task"]: c for c in doc["choices"] if c["device"] == "gpu"}
    assert sorted(gpu) == TASKS
    for task, c in gpu.items():
        assert c["tuning"]["mode"] == autotune.hopper_mode(
            port.task_layers(task), c["table_itemsize"])


@pytest.mark.parametrize("arch", sorted(lm_archs.ARCHS))
def test_model_flops_equal_reference(arch):
    for shape in steps.SHAPES:
        assert port.model_flops(lm_archs.get(arch), steps.SHAPES[shape]) == \
            ref.model_flops(jarchs.get(arch), jsteps.SHAPES[shape])


def _cell(mesh_shape, flops, coll):
    return {"arch": "gemma-2b", "shape": "train_4k", "mesh": "single",
            "status": "ok", "design": "tp (q whole)",
            "mesh_shape": list(mesh_shape), "flops_per_rank": flops,
            "collectives": {**{k: {"count": 1, "bytes": b}
                               for k, b in coll.items()},
                            "total_bytes": sum(coll.values())}}


@pytest.mark.parametrize("mesh_shape,link", [((2, 4), 450e9),
                                             ((16, 16), 50e9)])
def test_roofs_of_a_synthetic_record(tmp_path, mesh_shape, link):
    """Compute over 989 TFLOP/s, wire bytes (all-reduce twice) over NVLink
    within 8 cards and InfiniBand beyond, no memory roof."""
    coll = {"all-reduce": 3e9, "all-gather": 5e9, "reduce-scatter": 1e9}
    rec = {"cells": [_cell(mesh_shape, 2e15, coll),
                     {"arch": "qwen2-72b", "shape": "long_500k",
                      "mesh": "single", "status": "skipped",
                      "reason": "pure full-attention arch"}]}
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(rec))
    row, skipped = port.build_table(str(path))
    devices = mesh_shape[0] * mesh_shape[1]
    compute = 2e15 / 989e12
    collective = (2 * 3e9 + 5e9 + 1e9) / link
    mf = port.model_flops(lm_archs.get("gemma-2b"), steps.SHAPES["train_4k"])
    assert row["devices"] == devices
    assert row["compute_s"] == round(compute, 6)
    assert row["collective_s"] == round(collective, 6)
    assert row["memory_s"] is None and "no bytes accessed" in \
        row["memory_note"]
    assert row["dominant"] == ("compute" if compute > collective
                               else "collective")
    assert row["useful_ratio"] == round(mf / (2e15 * devices), 3)
    assert row["roofline_fraction"] == round(
        mf / (devices * 989e12) / max(compute, collective), 3)
    assert row["design"] == "tp (q whole)" and row["status"] == "ok"
    assert skipped["status"] == "skipped"
