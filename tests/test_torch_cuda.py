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


# ragged K4 cases against the reference kernel: (b, u, din, dout, layout)
# with layout "rows" (shared rows [B, din]), "view" (stride-0 [B, U, din]),
# "units" (x per unit), "wT" (per unit, w given as a transposed view) or
# "bmajor" (per unit, x a permute of [din, U, B]: with B 2 or 6 odd units
# start off a 16-byte boundary)
K4_EXACT_CASES = [(1, 7, 6, 64, "units"), (33, 60, 784, 64, "rows"),
                  (257, 21, 64, 1, "units"), (130, 9, 64, 784, "units"),
                  (64, 100, 12, 16, "units"), (5, 3, 40, 50, "view"),
                  (300, 140, 360, 64, "rows"), (200, 330, 784, 1, "rows"),
                  (65, 13, 6, 64, "view"), (70, 11, 64, 6, "wT"),
                  (129, 5, 1, 64, "wT"), (17, 3, 70, 70, "wT"),
                  (2, 2, 40, 64, "bmajor"), (6, 2, 40, 64, "bmajor"),
                  (4, 3, 20, 64, "bmajor")]


def _k4(b, u, din, dout, layout, dtype, dev, seed):
    gen = torch.Generator().manual_seed(seed)
    shared = layout in ("rows", "view")
    if layout == "bmajor":     # per-unit x, batch axis contiguous
        x = torch.rand((din, u, b), generator=gen).permute(2, 1, 0)
    else:
        x = torch.rand((b, din) if shared else (b, u, din), generator=gen)
    if layout == "wT":
        w = (torch.randn((u, dout, din), generator=gen)
             * (2.0 / din) ** 0.5).transpose(1, 2)
    else:
        w = torch.randn((u, din, dout), generator=gen) * (2.0 / din) ** 0.5
    bias = torch.randn((u, dout), generator=gen) * 0.1
    x, w, bias = (t.to(dev, dtype) for t in (x, w, bias))
    if layout == "bmajor":
        assert x.stride() == (1, b, u * b)
    if layout == "view":
        x = x[:, None, :].expand(b, u, din)
    return x, w, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,u,din,dout,layout", K4_EXACT_CASES)
def test_unit_affine_equals_reference_kernel_and_counts_by_route(
        b, u, din, dout, layout, dtype, cuda):
    x, w, bias = _k4(b, u, din, dout, layout, dtype, cuda, b + din)
    route = "dense" if layout in ("rows", "view") else "units"
    assert subnet_mlp.route(x) == route
    for act, bb in ((False, None), (True, bias)):
        build.reset_counters()
        got = subnet_mlp.unit_affine_cuda(x, w, bb, activate=act)
        want = subnet_mlp.unit_affine_reference_cuda(x, w, bb, activate=act)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        assert counts[f"unit_affine_{route}"] == 1
        assert counts["unit_affine"] == 1
        assert counts["unit_affine_reference"] == 1
        assert got.dtype == dtype and got.shape == (b, u, dout)
        assert torch.equal(got, want)


def test_unit_affine_layouts_give_equal_bits(cuda):
    """The same rows as a stride-0 view, as shared rows and as a
    materialised [B, U, din] copy: the bits the fold relies on."""
    for b, u, din, dout in ((64, 300, 6, 64), (256, 90, 784, 64),
                            (33, 200, 360, 1)):
        x, w, bias = _k4(b, u, din, dout, "rows", torch.float32, cuda, din)
        view = x[:, None, :].expand(b, u, din)
        outs = [subnet_mlp.unit_affine_cuda(t, w, bias, activate=True)
                for t in (x, view, view.contiguous())]
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("b,u,din,dout", [(256, 150, 784, 64),
                                          (40, 9, 300, 64),
                                          (257, 70, 360, 1)])
def test_unit_affine_dense_dx_reduction(b, u, din, dout, cuda):
    """dx [B, din] of shared rows by the reduction kernel against plain
    autograd through the broadcast (rtol 1e-4, atol 1e-5 * scale), bit-equal
    between two runs and between a batch and its first rows; one launch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, bias = _k4(b, u, din, dout, "rows", torch.float32, cuda, b)
    cot = torch.randn((b, u, dout), generator=torch.Generator().manual_seed(
        1)).to(cuda)
    leaf = x.clone().requires_grad_()
    build.reset_counters()
    y = subnet_mlp.unit_affine(leaf, w, bias, activate=True)
    (y * cot).sum().backward()
    assert build.launch_counts()["unit_affine_dx"] == 1
    got = leaf.grad
    assert got.shape == (b, din)
    leaf.grad = None
    (subnet_mlp.unit_affine_plain(leaf[:, None, :].expand(b, u, din), w,
                                  bias, activate=True) * cot).sum().backward()
    want = leaf.grad
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))
    dy = torch.where(subnet_mlp.unit_affine_plain(x, w, bias) > 0, cot, 0.0)
    again = subnet_mlp.unit_affine_dx_cuda(dy, w)
    part = subnet_mlp.unit_affine_dx_cuda(dy[:33].contiguous(), w)
    torch.cuda.synchronize()
    assert torch.equal(again, subnet_mlp.unit_affine_dx_cuda(dy, w))
    assert torch.equal(part, again[:33])
    torch.testing.assert_close(again.float(), subnet_mlp.unit_affine_dx_plain(
        dy, w), rtol=1e-4, atol=1e-5 * float(want.abs().max()))


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


# the wgmma kernel's cases: (b, hq, hkv, sq, skv, d, window, q_offset) --
# gemma-2b at every serve prompt length, a window of 256, minitron-4b's
# D 128 GQA, and decode-shaped Sq < Skv with q_offset
WGMMA_CASES = ([(1, 8, 1, s, s, 256, None, 0)
                for s in (1024, 700, 512, 130, 33, 7)]
               + [(1, 8, 1, 1024, 1024, 256, 256, 0),
                  (1, 24, 8, 1024, 1024, 128, None, 0),
                  (1, 24, 8, 130, 130, 128, None, 0),
                  (2, 4, 2, 1, 96, 64, None, 95),
                  (2, 4, 2, 1, 96, 64, 24, 95),
                  (2, 4, 2, 100, 100, 64, 32, 0),
                  (1, 8, 1, 1, 96, 256, None, 95)])


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,window,q_offset", WGMMA_CASES)
def test_flash_attention_wgmma_matches_plain_and_counts(b, hq, hkv, sq, skv,
                                                        d, window, q_offset,
                                                        cuda):
    """bf16 at the unchanged tolerance, rtol 2^-7, atol 1e-5: one bf16 ulp
    of the f32 computation, which p split into two bf16 terms keeps."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, sq + d, cuda, torch.bfloat16)
    kw = dict(window=window, q_offset=q_offset)
    build.reset_counters()
    got = flash_attention.flash_attention_wgmma_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    assert build.launch_counts()[flash_attention.WGMMA] == 1
    assert build.launch_counts()[flash_attention.TF32] == 0
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    torch.testing.assert_close(
        got.float(), flash_attention.flash_attention_plain(q, k, v, **kw).float(),
        rtol=2 ** -7, atol=1e-5)


def test_flash_attention_routes_bf16_to_wgmma_and_f32_to_simt(cuda):
    """The model's strided q in bf16 goes to the wgmma kernel; the same
    operands in f32 still go to the TF32 kernel, at the reference's 2e-5."""
    q, k, v = _qkv(1, 8, 1, 700, 700, 256, 9, cuda)
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    for dtype, kernel, tol in ((torch.bfloat16, flash_attention.WGMMA,
                                dict(rtol=2 ** -7, atol=1e-5)),
                               (torch.float32, flash_attention.TF32,
                                dict(rtol=2e-5, atol=2e-5))):
        qd, kd, vd = (t.to(dtype) for t in (qt, k, v))
        assert flash_attention.route(qd, kd, vd) == kernel
        build.reset_counters()
        got = flash_attention.flash_attention_cuda(qd, kd, vd)
        torch.cuda.synchronize()
        counts = build.launch_counts()
        assert counts[kernel] == 1 and sum(counts.values()) == 1
        torch.testing.assert_close(
            got.float(),
            flash_attention.flash_attention_plain(qd, kd, vd).float(), **tol)


def test_flash_attention_wgmma_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 8, 1, 64, 64, 256, 1, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="16 B"):
        flash_attention.flash_attention_wgmma_cuda(q.float(), k.float(),
                                                   v.float())
    with pytest.raises(ValueError, match="16 B"):      # base 8 B off
        flash_attention.flash_attention_wgmma_cuda(q[..., 4:132], k[..., :128],
                                                   v[..., :128])


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


# K5's TF32 kernel: (b, hq, hkv, sq, skv, d, causal, window, q_offset) at
# every head-dim bucket, ragged S, windows, q_offset and Sq 1
TF32_CASES = ([(2, 4, 2, 77, 77, d, True, None, 0) for d in (8, 16, 32, 96, 256)]
              + [(1, 4, 1, 1, 96, d, True, 24, 95) for d in (8, 16, 32, 96, 256)]
              + [(1, 8, 1, 300, 300, 256, True, 64, 0),
                 (2, 4, 2, 100, 130, 96, False, None, 30),
                 (1, 2, 2, 65, 65, 16, True, None, -3)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,window,q_offset",
                         TF32_CASES)
def test_flash_attention_tf32_kernel_matches_plain_and_counts(
        b, hq, hkv, sq, skv, d, causal, window, q_offset, dtype, cuda):
    """The split-TF32 kernel holds the reference's f32 tolerance (rtol =
    atol = 2e-5) and one bf16 ulp (rtol 2^-7, atol 1e-5), with q
    contiguous and as the model's strided view; rows that see no key give
    0 (as the Pallas kernel; ``mha_ref`` averages them); one launch a
    call."""
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, sq + d, cuda, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    want = flash_attention.flash_attention_plain(q, k, v, **kw).float()
    if causal and q_offset < 0:      # rows that see no key give 0
        want[:, :, :-q_offset] = 0.0
    qt = q.transpose(1, 2).contiguous().transpose(1, 2)
    for qq in (q, qt):
        build.reset_counters()
        got = flash_attention.flash_attention_tf32_cuda(qq, k, v, **kw)
        torch.cuda.synchronize()
        assert build.launch_counts()[flash_attention.TF32] == 1
        assert got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got.float(), want, **tol)


def test_flash_attention_tf32_kernel_unaligned_rows(cuda):
    """Row strides that allow no 4-byte copy (bf16, odd element stride)
    and 8-byte ones (f32, stride D + 2) take narrower copies, same
    result."""
    for dtype, pad in ((torch.bfloat16, 1), (torch.float32, 2)):
        q, k, v = _qkv(1, 4, 2, 70, 70, 24, 3, cuda, dtype)
        kp = torch.zeros((1, 2, 70, 24 + pad), dtype=dtype, device=cuda)
        kp[..., :24] = k
        kp = kp[..., :24]
        assert flash_attention.copy_width(kp) < flash_attention.copy_width(k)
        tol = (dict(rtol=2e-5, atol=2e-5) if dtype == torch.float32
               else dict(rtol=2 ** -7, atol=1e-5))
        torch.testing.assert_close(
            flash_attention.flash_attention_tf32_cuda(q, kp, v).float(),
            flash_attention.flash_attention_plain(q, k, v).float(), **tol)


def _ring_network(rs):
    """A cascade whose tables (2.4 MB of int8: 6-input L-LUTs on 2-bit
    codes, 4,096 entries) do not fit a K2 CTA's share: the ring route."""
    spec = ((784, 512, 6, 2, 0), (512, 64, 6, 2, 0), (64, 16, 4, 2, 1))
    layers, tables, maps, off = [], [], [], 0
    for prev, units, fan, bits, asm in spec:
        entries = 2 ** (bits * fan)
        layers.append((prev, units, entries, off, fan, bits, asm))
        tables.append(rs.randint(0, 4, (units, entries)))
        maps.append(None if asm else rs.randint(0, prev, (units, fan)))
        off += units
    tab = np.zeros((off, max(t.shape[1] for t in tables)), np.int8)
    for (_, u, e, o, *_), t in zip(layers, tables):
        tab[o:o + u, :e] = t
    return tuple(layers), tab, maps


def _cascade(codes, tables, maps, layers):
    """Layer by layer through the ``take`` lookup (the oracle)."""
    h = codes
    for (_, units, entries, off, fan, bits, asm), mp in zip(layers, maps):
        ci = (h.reshape(h.shape[0], units, fan) if asm
              else h[:, mp.long()])
        w = 2 ** (bits * torch.arange(fan - 1, -1, -1, device=h.device))
        addr = (ci.long() * w).sum(-1).clamp_max(entries - 1).int()
        h = lut_gather.lut_lookup_plain(tables[off:off + units].int(), addr)
    return h


@pytest.mark.parametrize("tdtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("unit_tile", [1, 8, 16, 32])
def test_streamed_cluster_kernel_bit_exact(unit_tile, tdtype, cuda):
    """K2 at mnist's widths (its main-path plan) and on a table set that
    takes the ring, bit for bit against ``lut_cascade_plain`` and the
    per-layer ``take`` cascade, B in {1, 33, 1024, 4099}; one launch a
    call."""
    rs = np.random.RandomState(unit_tile)
    cfg = paper_tasks.task_config("mnist")
    plan = pipeline.CompiledLUTNetwork(
        cfg, *_arrays(cfg, 5), device=cuda).compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    maps = [plan.tensor(f"map_{l}", cuda) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    rlayers, rtab, rmaps = _ring_network(rs)
    nets = [(layers, plan.tensor("tables", cuda), maps),
            (rlayers, torch.from_numpy(rtab).to(cuda),
             [None if m is None else torch.from_numpy(m).int().to(cuda)
              for m in rmaps])]
    for (lay, tab, mp), route in zip(nets, ("resident", "ring")):
        tab = tab.to(tdtype)
        cplan = lut_cascade.plan_cluster(lay, tab.element_size(),
                                         unit_tile=unit_tile,
                                         max_entries=tab.shape[1])
        if route == "ring" or tdtype == torch.int8:
            assert cplan.route == route
        ops = lut_cascade.prepare(tab, lay, mp)
        for b in (1, 33, 1024, 4099):
            codes = torch.from_numpy(rs.randint(
                0, 2 ** lay[0][5], (b, lay[0][0])).astype(np.int32)).to(cuda)
            build.reset_counters()
            got = lut_cascade.lut_cascade_streamed(codes, ops,
                                                   unit_tile=unit_tile)
            torch.cuda.synchronize()
            assert build.launch_counts()["lut_cascade_streamed"] == 1
            assert torch.equal(got, lut_cascade.lut_cascade_plain(
                codes, tab, mp, lay))
            assert torch.equal(got, _cascade(codes, tab, mp, lay))


@pytest.mark.parametrize("cluster,rows", [(1, 8), (2, 8), (4, 16), (8, 32),
                                          (8, 8), (3, 5)])
def test_streamed_cluster_plans_bit_exact(cluster, rows, cuda):
    """Every cluster size and tile height the plan sweep tries gives the
    same bits (resident where the share fits, else the ring)."""
    cfg = paper_tasks.task_config("mnist")
    plan = pipeline.CompiledLUTNetwork(
        cfg, *_arrays(cfg, 6), device=cuda).compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    tables = plan.tensor("tables", cuda)
    maps = [plan.tensor(f"map_{l}", cuda) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    ops = lut_cascade.prepare(tables, layers, maps)
    codes = torch.randint(0, 2, (1024, layers[0][0]), dtype=torch.int32,
                          device=cuda)
    want = lut_cascade.lut_cascade_plain(codes, tables, maps, layers)
    cplan = lut_cascade.plan_cluster(layers, 1, cluster=cluster, rows=rows)
    got = lut_cascade.launch_streamed(codes, ops, cplan)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _resident_ops(task, cuda, tdtype=None, seed=7):
    cfg = paper_tasks.task_config(task)
    plan = pipeline.CompiledLUTNetwork(
        cfg, *_arrays(cfg, seed), device=cuda).compile_backend("fused").plan
    layers = tuple(tuple(int(v) for v in l) for l in plan.meta["layers"])
    tables = plan.tensor("tables", cuda)
    if tdtype is not None:
        tables = tables.to(tdtype)
    maps = [plan.tensor(f"map_{l}", cuda) if f"map_{l}" in plan.buffers
            else None for l in range(len(layers))]
    return layers, tables, maps, lut_cascade.prepare(tables, layers, maps)


@pytest.mark.parametrize("task", ["nid", "jsc_openml"])
def test_resident_kernel_bit_exact_and_counts(task, cuda):
    """K1 on its default plan at ragged batches (ragged last tiles), one
    launch a call; the plan's CTAs an SM are what the runtime reports, or
    fewer where shared memory and threads say so."""
    layers, tables, maps, ops = _resident_ops(task, cuda)
    rs = np.random.RandomState(len(task))
    for b in (1, 3, 33, 1023, 4097):
        codes = torch.from_numpy(rs.randint(
            0, 2 ** layers[0][5], (b, layers[0][0])).astype(np.int32)).to(cuda)
        build.reset_counters()
        got = lut_cascade.lut_cascade_resident(codes, ops)
        torch.cuda.synchronize()
        assert build.launch_counts()["lut_cascade_resident"] == 1
        assert torch.equal(got, lut_cascade.lut_cascade_plain(
            codes, tables, maps, layers))
        cpu = lut_cascade.plan_resident(
            layers, tables.element_size(), b,
            torch.cuda.get_device_properties(0).multi_processor_count,
            max_entries=tables.shape[1])
        plan = lut_cascade.resident_plan(ops, b, 0)
        assert plan.rows == cpu.rows
        assert plan.ctas_per_sm == min(cpu.ctas_per_sm,
                                       lut_cascade.resident_occupancy(
            0, tables.element_size(), lut_cascade.act_itemsize(layers),
            plan.smem_bytes))


@pytest.mark.parametrize("tdtype", [torch.int8, torch.int16, torch.int32])
@pytest.mark.parametrize("bits", [6, 9, 17])
def test_resident_kernel_table_and_activation_widths(tdtype, bits, cuda):
    """int8/int16/int32 tables; uint8 (6-bit), uint16 (9-bit) and uint32
    (17-bit) activation tiles, codes kept below each table's 64 entries."""
    rs = np.random.RandomState(bits)
    layers = ((20, 12, 64, 0, 1, bits, 0), (12, 8, 64, 12, 1, bits, 0),
              (8, 4, 64, 20, 2, 3, 1))
    tables = torch.from_numpy(rs.randint(0, 8, (24, 64))).to(tdtype).to(cuda)
    maps = [torch.from_numpy(rs.randint(0, 20, (12, 1))).int().to(cuda),
            torch.from_numpy(rs.randint(0, 12, (8, 1))).int().to(cuda), None]
    assert lut_cascade.act_itemsize(layers) == {6: 1, 9: 2, 17: 4}[bits]
    ops = lut_cascade.prepare(tables, layers, maps)
    for b in (1, 5, 1023):
        codes = torch.from_numpy(rs.randint(0, 64, (b, 20)).astype(
            np.int32)).to(cuda)
        got = lut_cascade.lut_cascade_resident(codes, ops)
        torch.cuda.synchronize()
        assert torch.equal(got, lut_cascade.lut_cascade_plain(
            codes, tables, maps, layers))


@pytest.mark.parametrize("rows,ctas,sms", [(4, 1, 1), (4, 1, 3), (8, 2, 5),
                                           (32, 1, 2), (12, 1, 7)])
def test_resident_kernel_persistent_grid_smaller_than_tiles(rows, ctas, sms,
                                                            cuda):
    """Grids of 1-10 CTAs walking 33-1025 tiles: each CTA's next tile's
    codes load while its current one runs."""
    layers, tables, maps, ops = _resident_ops("nid", cuda)
    codes = torch.randint(0, 2, (4100, layers[0][0]), dtype=torch.int32,
                          device=cuda)
    plan = lut_cascade.plan_resident(layers, 1, 4100, sms, rows=rows,
                                     ctas_per_sm=ctas)
    assert plan.grid < plan.tiles
    got = lut_cascade.launch_resident(codes, ops, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, lut_cascade.lut_cascade_plain(codes, tables,
                                                          maps, layers))


@pytest.mark.parametrize("units", [1, 3, 9, 60, 2160])
def test_lookup_kernel_shapes_and_clamped_addresses(units, cuda):
    """K3 at U 1-2160, T 2-32768, B 1-4096, addresses outside [0, T)
    clamped; a misaligned addr (an offset view) takes the scalar route;
    one launch a call."""
    rs = np.random.RandomState(units)
    for entries in (2, 64, 4096, 32768):
        if units * entries > 2 ** 24:
            continue
        table = torch.from_numpy(rs.randint(0, 1000, (units, entries)).astype(
            np.int32)).to(cuda)
        for b in (1, 3, 1024, 4096):
            flat = torch.from_numpy(rs.randint(
                -5, entries + 5, (b * units + 1,)).astype(np.int32)).to(cuda)
            for addr in (flat[:-1].view(b, units), flat[1:].view(b, units)):
                build.reset_counters()
                got = lut_gather.lut_lookup_cuda(table, addr)
                torch.cuda.synchronize()
                assert build.launch_counts()["lut_lookup"] == 1
                assert torch.equal(got, lut_gather.lut_lookup_plain(
                    table, addr.clamp(0, entries - 1)))


# ---------------------------------------------------------------------------
# stream serving (cell mode) on the card
# ---------------------------------------------------------------------------

def _stream_cell(tmp_path, seed=0):
    """``seqmnist_reduced`` folded on the CPU from a seeded init and saved;
    returns (artifact path, CPU cell)."""
    from repro_torch.core import assemble
    from repro_torch.stream import cell as stream_cell
    cc = paper_tasks.stream_task_config("seqmnist_reduced")
    params = assemble.init(seed, cc.net, device="cpu")
    cpu = stream_cell.compile_cell(params, cc)
    return cpu.save(str(tmp_path / "cell.npz")), cpu


def _stream_inputs(n, t, seed):
    return (np.random.RandomState(seed).uniform(0, 1, (n, t, 16))
            > 0.5).astype(np.float32)


def test_cell_engine_on_card_serves_ragged_blocks_like_take(cuda, tmp_path):
    """300 streams x 7 steps over blocks of 64 (ragged last blocks) through
    a cell-mode engine on the card: ``fused`` (K1, one launch a block) and
    ``pallas`` (K3, one a layer a block) equal ``take`` on the card and the
    CPU, codes and state, step by step."""
    from repro_torch.stream import cell as stream_cell
    path, cpu = _stream_cell(tmp_path)
    card = stream_cell.CompiledStreamCell.load(path, device=cuda)
    xs = _stream_inputs(300, 7, seed=1)
    want, _, want_s = cpu.predict_sequence(xs, backend="take")
    take, _, take_s = card.predict_sequence(xs, backend="take")
    assert torch.equal(take.cpu(), want) and torch.equal(take_s.cpu(), want_s)
    layers = len(card.cell.net.layers)
    for backend, kname, per_block in (("fused", "lut_cascade_resident", 1),
                                      ("pallas", "lut_lookup", layers)):
        eng = LUTEngine(card.net, cell=card, block=64, depth=2,
                        backend=backend)
        states = card.init_state_codes(300).cpu().numpy()
        build.reset_counters()
        for t in range(7):
            reqs = eng.submit_many(xs[:, t], states=states)
            while eng.queue:
                eng.tick()
            eng.drain()
            np.testing.assert_array_equal(
                np.stack([r.codes for r in reqs]), want[:, t].numpy(),
                err_msg=f"{backend} step {t}")
            states = np.stack([r.next_state for r in reqs])
        np.testing.assert_array_equal(states, want_s.numpy())
        assert eng.stats.ticks == 7 * 5
        assert build.launch_counts()[kname] == per_block * eng.stats.ticks


def test_router_on_card_keeps_next_state_per_stream_at_depth_2(cuda,
                                                               tmp_path):
    """Streams of different lengths share blocks with two blocks in flight:
    every stream's codes and final state equal its own offline scan, so no
    next state crossed to another stream."""
    from repro_torch.stream import cell as stream_cell
    from repro_torch.stream.session import StreamRouter
    path, cpu = _stream_cell(tmp_path, seed=2)
    card = stream_cell.CompiledStreamCell.load(path, device=cuda)
    rs = np.random.RandomState(3)
    seqs = {i: _stream_inputs(1, int(rs.randint(1, 12)), seed=10 + i)[0]
            for i in range(150)}
    for backend in ("fused", "pallas"):
        router = StreamRouter(card, block=64, depth=2, backend=backend)
        sessions = router.run_sequences(seqs)
        for i, xs in seqs.items():
            want, _, s_fin = cpu.predict_sequence(xs[None], backend="take")
            np.testing.assert_array_equal(sessions[i].codes(), want[0].numpy(),
                                          err_msg=f"{backend} stream {i}")
            np.testing.assert_array_equal(sessions[i].final_state,
                                          s_fin[0].numpy())


def test_stream_toolflow_on_card_round_trips_its_state(cuda, tmp_path):
    """A stream ``Toolflow`` trained on the card (K4 forward and backward)
    resumes from ``save_state`` on the card and on the CPU with equal
    parameters, accuracy and folded codes."""
    from repro_torch.data.synthetic import SeqDataset
    cc = paper_tasks.stream_task_config("seqmnist_reduced")
    xs = _stream_inputs(96, 10, seed=4)
    y = (xs[:, :3].sum((1, 2)) > 24).astype(np.int32)
    data = SeqDataset("toy", xs[16:], y[16:], xs[:16], y[:16], 10)
    build.reset_counters()
    flow = pipeline.Toolflow(cc, pretrain_steps=2, retrain_steps=2,
                             batch_size=32, tbptt=4, device=cuda)
    comp = flow.run(data)
    assert build.launch_counts().get("unit_affine", 0) > 0
    path = flow.save_state(str(tmp_path / "flow.npz"))
    for dev in (cuda, "cpu"):
        back = pipeline.Toolflow.load_state(path, device=dev)
        assert back.cell == cc and back.tbptt == 4
        for a, b in zip(back.params.parameters(), flow.params.parameters()):
            assert torch.equal(a.cpu(), b.cpu())
        assert back.accuracy(data, folded=True) == flow.accuracy(folded=True)
        np.testing.assert_array_equal(
            back.compile().predict_sequence(xs[:16])[0].cpu().numpy(),
            comp.predict_sequence(xs[:16])[0].cpu().numpy())
