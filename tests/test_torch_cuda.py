"""The port's kernels and engine on the card, against their plain versions
on the same inputs.  Imports no JAX, so it runs where only PyTorch is
installed: ``python -m pytest -q tests/test_torch_cuda.py`` on a machine
with a CUDA device.  Without one every test skips."""
import numpy as np
import pytest
import torch

from repro_torch import pipeline
from repro_torch.configs import paper_tasks
from repro_torch.kernels import build, lut_cascade, lut_gather
from repro_torch.serve.lut_engine import LUTEngine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _arrays(cfg, seed):
    rs = np.random.RandomState(seed)
    tables, maps = [], []
    for l, spec in enumerate(cfg.layers):
        entries = 2 ** (cfg.in_bits(l) * spec.fan_in)
        tables.append(rs.randint(0, 2 ** spec.bits,
                                 size=(spec.units, entries)).astype(np.int32))
        maps.append(None if spec.assemble else rs.randint(
            0, cfg.prev_width(l), size=(spec.units, spec.fan_in)
        ).astype(np.int32))
    return tables, maps, float(rs.uniform(-2, 0)), float(rs.uniform(-3, 0))


def _x(cfg, n, seed):
    return np.random.RandomState(seed).uniform(
        -1.0, 1.0, (n, cfg.in_features)).astype(np.float32)


@pytest.mark.parametrize("task", ["nid", "jsc_openml", "mnist", "jsc_cernbox",
                                  "nid_reduced", "jsc_reduced"])
def test_backends_on_card_match_cpu(task, cuda):
    cfg = paper_tasks.task_config(task)
    arrays = _arrays(cfg, 1)
    cpu = pipeline.CompiledLUTNetwork(cfg, *arrays, device="cpu")
    gpu = pipeline.CompiledLUTNetwork(cfg, *arrays, device=cuda)
    x = _x(cfg, 257, seed=2)
    want_codes, want_logits = cpu.codes_and_logits(x, backend="take")
    for be in ("take", "onehot", "pallas", "fused"):
        codes, logits = gpu.codes_and_logits(x, backend=be)
        np.testing.assert_array_equal(codes.cpu().numpy(),
                                      want_codes.numpy(), err_msg=be)
        np.testing.assert_array_equal(logits.cpu().numpy(),
                                      want_logits.numpy(), err_msg=be)


@pytest.mark.parametrize("unit_tile", [1, 8, 16, 32])
def test_streamed_and_resident_kernels_match_plain(unit_tile, cuda):
    net = pipeline.CompiledLUTNetwork(
        paper_tasks.task_config("nid"),
        *_arrays(paper_tasks.task_config("nid"), 3), device=cuda)
    plan = net.compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    tables = plan.tensor("tables", cuda)
    maps = [plan.tensor(f"map_{l}", cuda) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    ops = lut_cascade.prepare(tables, layers, maps)
    for b in (1, 33, 300):
        codes = torch.randint(0, 2, (b, layers[0][0]), dtype=torch.int32,
                              device=cuda)
        want = lut_cascade.lut_cascade_plain(codes, tables, maps, layers)
        for got in (lut_cascade.lut_cascade_streamed(codes, ops,
                                                     unit_tile=unit_tile),
                    lut_cascade.lut_cascade_resident(codes, ops)):
            torch.cuda.synchronize()
            assert torch.equal(got, want)


def test_lookup_kernel_matches_plain_and_counts(cuda):
    build.reset_counters()
    for entries in (2, 64, 4096, 32768):
        table = torch.randint(0, 100, (7, entries), dtype=torch.int32,
                              device=cuda)
        addr = torch.randint(0, entries, (129, 7), dtype=torch.int32,
                             device=cuda)
        got = lut_gather.lut_lookup_cuda(table, addr)
        torch.cuda.synchronize()
        assert torch.equal(got, lut_gather.lut_lookup_plain(table, addr))
    assert build.launch_counts()["lut_lookup"] == 4


def test_engine_on_card_matches_cpu_engine(cuda):
    cfg = paper_tasks.task_config("nid")
    arrays = _arrays(cfg, 4)
    x = _x(cfg, 300, seed=5)
    for backend in ("fused", "pallas"):
        want = LUTEngine(pipeline.CompiledLUTNetwork(cfg, *arrays,
                                                     device="cpu"),
                         block=64, depth=2, backend=backend).run(x)
        got = LUTEngine(pipeline.CompiledLUTNetwork(cfg, *arrays,
                                                    device=cuda),
                        block=64, depth=2, backend=backend).run(x)
        np.testing.assert_array_equal(got, want)
