"""The port's kernels and engine on the card, against their plain versions
on the same inputs.  Imports no JAX, so it runs where only PyTorch is
installed: ``python -m pytest -q tests/test_torch_cuda.py`` on a machine
with a CUDA device.  Without one every test skips."""
import numpy as np
import pytest
import torch

from repro_torch import pipeline
from repro_torch.configs import paper_tasks
from repro_torch.kernels import (build, flash_attention, lut_cascade,
                                 lut_gather, subnet_mlp)
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


@pytest.mark.parametrize("b,u,din,dout,stride0,act", [
    (1, 7, 6, 64, False, True), (33, 60, 784, 64, True, False),
    (257, 21, 64, 1, False, False), (130, 9, 64, 784, False, False),
    (64, 100, 12, 16, False, True), (5, 3, 40, 50, True, True)])
def test_unit_affine_kernel_matches_plain_and_counts(b, u, din, dout, stride0,
                                                     act, cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(b + din)
    x = torch.rand((b, din) if stride0 else (b, u, din), generator=gen)
    w = torch.randn((u, din, dout), generator=gen) * (2.0 / din) ** 0.5
    bias = torch.randn((u, dout), generator=gen) * 0.1
    x, w, bias = x.to(cuda), w.to(cuda), bias.to(cuda)
    if stride0:
        x = x[:, None, :].expand(b, u, din)
    build.reset_counters()
    got = subnet_mlp.unit_affine_cuda(x, w, bias, activate=act)
    torch.cuda.synchronize()
    assert build.launch_counts()["unit_affine"] == 1
    tol = 1e-5 * max(1.0, (din / 64) ** 0.5)
    torch.testing.assert_close(
        got, subnet_mlp.unit_affine_plain(x, w, bias, activate=act),
        rtol=tol, atol=tol)
    # the fixed reduction order: the first rows alone give the same bits
    part = subnet_mlp.unit_affine_cuda(x[:1].contiguous(), w, bias,
                                       activate=act)
    assert torch.equal(part, got[:1])
    wt = w.transpose(1, 2).contiguous().transpose(1, 2)   # strided view
    torch.testing.assert_close(subnet_mlp.unit_affine_cuda(x, wt, None),
                               subnet_mlp.unit_affine_plain(x, w, None),
                               rtol=tol, atol=tol)


def test_unit_affine_bf16_and_gradient(cuda):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((70, 11, 6), generator=gen).to(cuda)
    w = (torch.randn((11, 6, 64), generator=gen) * 0.5).to(cuda)
    bias = (torch.randn((11, 64), generator=gen) * 0.1).to(cuda)
    got = subnet_mlp.unit_affine_cuda(x.bfloat16(), w.bfloat16(),
                                      bias.bfloat16(), activate=True)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), subnet_mlp.unit_affine_plain(
            x.bfloat16(), w.bfloat16(), bias.bfloat16(),
            activate=True).float(), rtol=3e-2, atol=3e-2)
    x0 = torch.rand((40, 300), generator=gen).to(cuda).requires_grad_()
    w = (torch.randn((9, 300, 64), generator=gen) * 0.08).to(cuda)
    w.requires_grad_()
    bias.requires_grad_()
    cot = torch.randn((40, 9, 64), generator=gen).to(cuda)
    grads = []
    for fn in (subnet_mlp.unit_affine, subnet_mlp.unit_affine_plain):
        for t in (x0, w):
            t.grad = None
        b9 = bias[:9]
        y = fn(x0[:, None, :].expand(40, 9, 300), w, b9, activate=True)
        (y * cot).sum().backward()
        grads.append([x0.grad.clone(), w.grad.clone()])
    for g, p in zip(*grads):
        torch.testing.assert_close(g, p, rtol=1e-4,
                                   atol=1e-5 * float(p.abs().max()))


# the reference test's cases (tests/test_kernels.py), D = 32
FLASH_CASES = [(hq, hkv, sq, skv, causal, window)
               for hq, hkv in ((4, 4), (4, 2), (8, 1))
               for sq, skv, causal, window in ((64, 64, True, None),
                                               (64, 64, False, None),
                                               (100, 100, True, 32),
                                               (1, 96, True, None),
                                               (1, 96, True, 24))]


def _qkv(b, hq, hkv, sq, skv, d, seed, dev, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                 for shape in ((b, hq, sq, d), (b, hkv, skv, d),
                               (b, hkv, skv, d)))


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_and_counts(hq, hkv, sq, skv,
                                                         causal, window,
                                                         cuda):
    """The reference's tolerance, rtol = atol = 2e-5, in f32."""
    q, k, v = _qkv(2, hq, hkv, sq, skv, 32, hq + sq, cuda)
    kw = dict(causal=causal, window=window, q_offset=skv - sq)
    build.reset_counters()
    got = flash_attention.flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(
        got, flash_attention.flash_attention_plain(q, k, v, **kw),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("s", [1024, 130, 7])
def test_flash_attention_gemma_shapes_f32_bf16_and_strides(s, cuda):
    """gemma-2b's prefill: 8 q heads on 1 KV head, D = 256, causal.  f32 at
    2e-5; bf16 within one bf16 ulp (both sides compute in f32 from the same
    bf16 values and round once), rtol 2^-7, atol 1e-5.  A q given as the
    strided view the model passes gives the same result."""
    q, k, v = _qkv(1, 8, 1, s, s, 256, s, cuda)
    want = flash_attention.flash_attention_plain(q, k, v)
    torch.testing.assert_close(flash_attention.flash_attention_cuda(q, k, v),
                               want, rtol=2e-5, atol=2e-5)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(flash_attention.flash_attention_cuda(qt, k, v),
                               want, rtol=2e-5, atol=2e-5)
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = flash_attention.flash_attention_cuda(qb, kb, vb)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_plain(qb, kb, vb).float(),
        rtol=2 ** -7, atol=1e-5)


def test_flash_attention_window_and_refusals(cuda):
    q, k, v = _qkv(1, 8, 1, 1024, 1024, 256, 5, cuda)
    torch.testing.assert_close(
        flash_attention.flash_attention_cuda(q, k, v, window=256),
        flash_attention.flash_attention_plain(q, k, v, window=256),
        rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_cuda(*_qkv(1, 2, 1, 4, 4, 264, 0,
                                                   cuda))
    with pytest.raises(TypeError, match="float32"):
        flash_attention.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention.flash_attention_cuda(q.requires_grad_(), k, v)
