"""The port stands alone: it imports neither JAX nor the reference package
(nor ``msgpack`` or ``ml_dtypes``, which the card's machine lacks), and its
entry points refuse to fall back to the CPU when no card exists."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|"
                       r"from\s+repro[.\s]|import\s+repro\s*$|"
                       r"(import|from)\s+(msgpack|ml_dtypes)\b)", re.M)
# top-level packages no port module may load (the card's machine has
# neither msgpack nor ml_dtypes; checkpoints use the port's own codec)
BANNED = ("jax", "repro", "msgpack", "ml_dtypes")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        mods.append(".".join(parts))
    return mods


def test_port_modules_import_without_jax_or_reference():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        f"banned = {BANNED!r}\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in banned)\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 20
    assert res["bad"] == []


def test_sources_name_no_jax_or_reference_import():
    """The package, ``chip_smoke.py`` and the port's own benches and
    examples (``benchmarks/torch_*.py``, ``examples/torch_*.py``)."""
    benches = sorted((ROOT / "benchmarks").glob("torch_*.py"))
    examples = sorted((ROOT / "examples").glob("torch_*.py"))
    assert benches and examples
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + benches + examples)
    for path in files:
        hits = FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def test_entry_points_refuse_to_run_on_cpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch import device
    from repro_torch import pipeline
    from repro_torch.configs import paper_tasks
    cfg = paper_tasks.reduced("jsc")
    tables = [torch.zeros((s.units, 2 ** (cfg.in_bits(l) * s.fan_in)),
                          dtype=torch.int32).numpy()
              for l, s in enumerate(cfg.layers)]
    maps = [None if s.assemble else torch.zeros(
        (s.units, s.fan_in), dtype=torch.int32).numpy() for s in cfg.layers]
    net = pipeline.CompiledLUTNetwork(cfg, tables, maps, 0.0, 0.0,
                                      device="cpu")
    path = net.save(str(tmp_path / "a.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.CompiledLUTNetwork.load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.CompiledLUTNetwork(cfg, tables, maps, 0.0, 0.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve()
    assert device.resolve("cpu").type == "cpu"
    from repro_torch.configs import lm_archs
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    lcfg = lm_archs.smoke("gemma-2b")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.init_params(lcfg, torch.Generator())
    model = lm.init_params(lcfg, torch.Generator(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(lcfg, model, slots=1, context=16)
    # the stream path: a stream Toolflow, a cell artifact's load, and so a
    # router over a loaded cell, run on the card unless told otherwise
    from repro_torch.core import assemble
    from repro_torch.stream import cell as stream_cell
    from repro_torch.stream.session import StreamRouter
    cc = paper_tasks.stream_task_config("seqmnist_reduced")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.Toolflow(cc)
    assert pipeline.Toolflow(cc, device="cpu").cell == cc
    cell = stream_cell.compile_cell(assemble.init(0, cc.net, device="cpu"),
                                    cc)
    cpath = cell.save(str(tmp_path / "cell.npz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamRouter(stream_cell.CompiledStreamCell.load(cpath))
    router = StreamRouter(stream_cell.CompiledStreamCell.load(
        cpath, device="cpu"), block=4)
    assert router.engine.net.device.type == "cpu"


def test_port_imports_leave_process_state_alone():
    """Importing every port module (the distribution layer and the dry run
    included) starts no process group and leaves ``os.environ`` as it was
    (the reference's dry run sets ``XLA_FLAGS`` when imported; the port's
    must not), and the import bans above cover the new modules."""
    mods = _port_modules()
    for m in ("repro_torch.dist.sharding", "repro_torch.dist.act_sharding",
              "repro_torch.dist.pipeline", "repro_torch.dist.compress",
              "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
              "repro_torch.launch.steps", "repro_torch.launch.train"):
        assert m in mods
    code = (
        "import importlib, json, os, sys\n"
        "before = dict(os.environ)\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "import torch.distributed as dist\n"
        f"banned = {BANNED!r}\n"
        "print(json.dumps({'pg': dist.is_available() and "
        "dist.is_initialized(), 'env': dict(os.environ) == before, "
        "'bad': sorted(k for k in sys.modules "
        "if k.split('.')[0] in banned)}))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("REPRO_") and k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"pg": False, "env": True, "bad": []}
