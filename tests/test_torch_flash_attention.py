"""K5, blockwise flash attention: the port's plain version and its
``flash_scan`` on the CPU, held against the JAX package's Pallas kernel
(interpret mode), its ``ref.mha_ref`` and the model's scan, on the same
inputs made with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import attention as jattention
from repro_torch.kernels import build, flash_attention, ops
from repro_torch.models import attention

# tests/test_kernels.py's cases: (hq, hkv) x (sq, skv, causal, window), D 32
CASES = [(hq, hkv, sq, skv, causal, window)
         for hq, hkv in ((4, 4), (4, 2), (8, 1))
         for sq, skv, causal, window in ((64, 64, True, None),
                                         (64, 64, False, None),
                                         (100, 100, True, 32),
                                         (1, 96, True, None),
                                         (1, 96, True, 24))]


def _qkv(b, hq, hkv, sq, skv, d, seed):
    rs = np.random.RandomState(seed)
    return (rs.normal(size=(b, hq, sq, d)).astype(np.float32),
            rs.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rs.normal(size=(b, hkv, skv, d)).astype(np.float32))


@pytest.mark.parametrize("hq,hkv,sq,skv,causal,window", CASES)
def test_plain_matches_pallas_interpret_and_reference(hq, hkv, sq, skv,
                                                      causal, window):
    """The reference test's tolerance: rtol = atol = 2e-5 in f32."""
    q, k, v = _qkv(2, hq, hkv, sq, skv, 32, seed=hq + sq)
    kw = dict(causal=causal, window=window, q_offset=skv - sq)
    got = flash_attention.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                          **kw).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32,
                                        interpret=True, **kw),
                 jref.mha_ref(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mqa_head_dim_256(dtype):
    """gemma-2b's layout (8 q heads on one KV head, D 256), causal, ragged
    S = 70 against Pallas with blocks of 32.  f32 at 2e-5.  bf16: both
    compute in f32 from the same bf16 values and round the output once, so
    they differ by at most one bf16 ulp: rtol 2^-7, atol 1e-5."""
    q, k, v = _qkv(1, 8, 1, 70, 70, 256, seed=11)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(tdt)
                  for a in (jq, jk, jv))
    got = flash_attention.flash_attention(tq, tk, tv)
    assert got.dtype == tdt and got.shape == (1, 8, 70, 256)
    want = flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32,
                                  interpret=True)
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else \
        dict(rtol=2 ** -7, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("window", [None, 24])
def test_flash_scan_matches_model_scan_grouped_layout(window):
    """The port's flash_scan (through ops.flash_attention) against the JAX
    model's scan, grouped layout [B, Hkv, G, S, hd], f32, at 2e-5."""
    b, hkv, g, s, d = 2, 2, 2, 40, 16
    rs = np.random.RandomState(3)
    q = rs.normal(size=(b, hkv, g, s, d)).astype(np.float32)
    k = rs.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rs.normal(size=(b, hkv, s, d)).astype(np.float32)
    pos = jnp.arange(s, dtype=jnp.int32)
    want = jattention.flash_scan(*map(jnp.asarray, (q, k, v)), causal=True,
                                 window=window, q_positions=pos,
                                 k_positions=pos, block_k=16)
    got = attention.flash_scan(*map(torch.from_numpy, (q, k, v)),
                               causal=True, window=window,
                               q_positions=range(s), k_positions=range(s))
    assert got.shape == (b, hkv, g, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    with pytest.raises(NotImplementedError, match="range"):
        attention.flash_scan(*map(torch.from_numpy, (q, k, v)), causal=True,
                             window=None, q_positions=range(s),
                             k_positions=torch.arange(s))


def test_ops_dispatch_cpu_takes_the_plain_path():
    q, k, v = map(torch.from_numpy, _qkv(1, 4, 2, 9, 9, 16, seed=5))
    build.reset_counters()
    want = ops.flash_attention(q, k, v, impl="ref")
    torch.testing.assert_close(ops.flash_attention(q, k, v), want, rtol=0,
                               atol=0)
    assert build.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ops.flash_attention(q, k, v, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="unknown"):
        ops.flash_attention(q, k, v, impl="mxu")
    # a gradient goes through FlashAttentionFn: the plain version's autograd
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*leaves).sum().backward()
    ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*ref_leaves, impl="ref").sum().backward()
    for got, want in zip(leaves, ref_leaves):
        torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=0)
    assert build.launch_counts()["flash_attention"] == 0


def test_flash_attention_source_is_built_and_a_failed_build_raises(
        tmp_path, monkeypatch):
    """Both K5 sources are registered with their entry points, and a failed
    build of either raises (nothing falls back to the other kernel or to
    the plain version)."""
    entry = {"flash_attention": "flash_attention_launch",
             "flash_attention_wgmma": "flash_attention_wgmma_launch"}
    sources = dict(build.SOURCES)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc", lambda: "/bin/false")
    for name, fn in entry.items():
        assert sources[name].is_file()
        assert fn in build._SIGNATURES[name]
        monkeypatch.setattr(build, "SOURCES", {name: sources[name]})
        with pytest.raises(RuntimeError, match="nvcc failed"):
            build.build()
    assert not list(tmp_path.glob("*.so"))


def test_port_follows_the_kernel_where_the_reference_forms_differ_in_bf16():
    """bf16 q/k/v [1, 8, 192, 256], causal (ROADMAP C.3): the JAX model's
    scan rounds p to bf16 and pre-scales q in bf16, the Pallas kernel does
    everything in f32.  The port's plain K5 stays within one bf16 ulp
    (rtol 2^-7) of the kernel, and the two reference forms differ by more
    than the port does from the kernel."""
    q, k, v = _qkv(1, 8, 1, 192, 192, 256, seed=7)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    pallas = np.asarray(flash_attention_pallas(
        jq, jk, jv, block_q=64, block_k=64, interpret=True), np.float32)
    pos = jnp.arange(192, dtype=jnp.int32)
    scan = np.asarray(jattention.flash_scan(
        jq.reshape(1, 1, 8, 192, 256), jk, jv, causal=True, window=None,
        q_positions=pos, k_positions=pos, block_k=64), np.float32)
    port = flash_attention.flash_attention(
        *(torch.from_numpy(np.array(a, np.float32)).bfloat16()
          for a in (jq, jk, jv))).float().numpy()
    np.testing.assert_allclose(port, pallas, rtol=2 ** -7, atol=1e-5)
    port_err = np.abs(port - pallas).max()
    scan_err = np.abs(scan.reshape(pallas.shape) - pallas).max()
    assert scan_err > port_err


# -- the wgmma kernel's numerical design, emulated on the CPU ---------------

def _wgmma_emulation(q, k, v, *, causal=True, window=None, q_offset=0,
                     split_p=True, bk=64):
    """Plain-torch emulation of ``flash_attention_wgmma_kernel``'s rounding
    points (a test helper, on no path): bf16 inputs; f32 sums of exact
    bf16 products per BK-key tile; scale with log2(e) folded in and exp2;
    online rescale per tile; p split into bf16(p) + bf16(p - bf16(p))
    (or rounded once with ``split_p=False``) against f32 V; the output
    divided by max(l, 1e-30) and rounded to bf16 once."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * 1.4426950408889634
    neg = torch.tensor(-1e30)
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    qpos = torch.arange(sq)[:, None] + q_offset
    for k0 in range(0, k.shape[2], bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, torch.einsum("bhqd,bhkd->bhqk", qf, kt) * c,
                        neg)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        mu = torch.where(mn == -1e30, torch.zeros(()), mn)
        p = torch.exp2(s - mu)
        alpha = torch.exp2(m - mu)
        l = l * alpha + p.sum(-1, keepdim=True)
        hi = p.bfloat16().float()
        parts = [hi, (p - hi).bfloat16().float()] if split_p else [hi]
        acc = acc * alpha + sum(torch.einsum("bhqk,bhkd->bhqd", t, vt)
                                for t in parts)
        m = mn
    return (acc / l.clamp_min(1e-30)).bfloat16()


# (b, hq, hkv, sq, skv, d, causal, window, q_offset)
WGMMA_CASES = {
    "gemma causal": (1, 8, 1, 256, 256, 256, True, None, 0),
    "window 24": (1, 8, 1, 256, 256, 256, True, 24, 0),
    "gqa 4/2 d64": (2, 4, 2, 100, 100, 64, True, None, 0),
    "gqa 4/2 d128": (2, 4, 2, 100, 100, 128, True, None, 0),
    "decode sq 1 skv 96": (2, 4, 2, 1, 96, 128, True, None, 95),
}


@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_wgmma_emulation_matches_pallas_interpret_and_reference(case):
    """The split-p design holds the unchanged bf16 tolerance (rtol 2^-7,
    atol 1e-5) against the Pallas kernel in interpret mode and against
    ``mha_ref``, both f32 inside."""
    b, hq, hkv, sq, skv, d, causal, window, q_offset = WGMMA_CASES[case]
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, seed=sq + d)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _wgmma_emulation(*(torch.from_numpy(np.asarray(a, np.float32))
                             .bfloat16() for a in (jq, jk, jv)), **kw)
    for want in (flash_attention_pallas(jq, jk, jv, block_q=64, block_k=64,
                                        interpret=True, **kw),
                 jref.mha_ref(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=1e-5)


def test_splitting_p_is_what_holds_the_tolerance():
    """gemma's layout at S 256, causal: p rounded once to bf16 moves the
    output further from the f32 computation than the split does, and the
    split stays within one bf16 ulp of it."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _qkv(1, 8, 1, 256, 256, 256, seed=21))
    want = flash_attention.flash_attention_plain(q, k, v).float()
    split = _wgmma_emulation(q, k, v).float()
    single = _wgmma_emulation(q, k, v, split_p=False).float()
    torch.testing.assert_close(split, want, rtol=2 ** -7, atol=1e-5)
    assert (single - want).abs().max() > (split - want).abs().max()


def _bf16(*shape, offset=0):
    """A bf16 tensor of ``shape`` whose base is ``offset`` elements into
    its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:].view(shape)


def _route_case(name):
    q, k = _bf16(1, 8, 32, 256), _bf16(1, 1, 32, 256)
    return {
        "gemma contiguous": ((q, k, k), flash_attention.WGMMA),
        "model's strided q": ((q.transpose(1, 2).contiguous().transpose(1, 2),
                               k, k), flash_attention.WGMMA),
        "d 128": ((_bf16(1, 24, 9, 128), _bf16(1, 8, 9, 128),
                   _bf16(1, 8, 9, 128)), flash_attention.WGMMA),
        "d 64": ((_bf16(2, 4, 1, 64), _bf16(2, 2, 96, 64),
                  _bf16(2, 2, 96, 64)), flash_attention.WGMMA),
        "size-1 axes with any stride": ((_bf16(1, 1, 40, 256)[:, :, 3:4],
                                         k, k), flash_attention.WGMMA),
        "float32": ((q.float(), k.float(), k.float()), flash_attention.TF32),
        "d 32": ((_bf16(1, 4, 8, 32), _bf16(1, 4, 8, 32),
                  _bf16(1, 4, 8, 32)), flash_attention.TF32),
        "d 96": ((_bf16(1, 4, 8, 96), _bf16(1, 4, 8, 96),
                  _bf16(1, 4, 8, 96)), flash_attention.TF32),
        "base not 16 B aligned": ((_bf16(1, 8, 32, 256, offset=1), k, k),
                                  flash_attention.TF32),
        "row stride not a multiple of 16 B": (
            (q, _bf16(1, 1, 32, 260)[..., :256], k), flash_attention.TF32),
        "row stride a multiple of 16 B": (
            (q, _bf16(1, 1, 32, 264)[..., :256], k), flash_attention.WGMMA),
        "stride 0 on KV heads": ((q, k, _bf16(1, 1, 32, 256).expand(
            1, 8, 32, 256)), flash_attention.TF32),
    }[name]


@pytest.mark.parametrize("name", [
    "gemma contiguous", "model's strided q", "d 128", "d 64",
    "size-1 axes with any stride", "float32", "d 32", "d 96",
    "base not 16 B aligned", "row stride not a multiple of 16 B",
    "row stride a multiple of 16 B", "stride 0 on KV heads"])
def test_route_picks_the_kernel_from_dtype_head_dim_strides_and_alignment(
        name):
    (q, k, v), want = _route_case(name)
    assert flash_attention.route(q, k, v) == want


@pytest.mark.parametrize("fn", ["flash_attention_cuda",
                                "flash_attention_tf32_cuda",
                                "flash_attention_wgmma_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors_and_count_nothing(fn):
    q, k = _bf16(1, 8, 16, 256), _bf16(1, 1, 16, 256)
    build.reset_counters()
    with pytest.raises(ValueError, match="CUDA"):
        getattr(flash_attention, fn)(q, k, k)
    assert build.launch_counts()[flash_attention.TF32] == 0
    assert build.launch_counts()[flash_attention.WGMMA] == 0


# -- the TF32 kernel's numerical design, emulated on the CPU ----------------

def _tf32(x):
    """f32 truncated to TF32 (10 explicit mantissa bits): what the tensor
    cores read of a .tf32 operand."""
    bits = x.float().contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _split(x):
    """x = hi + lo as the kernel splits it: hi = x truncated to TF32, lo =
    x - hi, which enters the mma truncated to TF32."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma(a, b, split):
    """sum_k a[..., k] b[k, ...] as the kernel forms it: 8-deep chunks in
    order, each adding a_lo b_hi and a_hi b_lo to one f32 accumulator and
    a_hi b_hi to another (exact products of TF32 terms; QK^T adds the two
    once a tile, PV keeps one) -- or, with ``split=False``, one product of
    operands truncated once to TF32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if not split:
        al, bl = torch.zeros_like(al), torch.zeros_like(bl)
    shape = a.shape[:-1] + b.shape[-1:]
    big, small = torch.zeros(shape), torch.zeros(shape)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        small = small + al[..., ks] @ bh[..., ks, :]
        small = small + ah[..., ks] @ bl[..., ks, :]
        big = big + ah[..., ks] @ bh[..., ks, :]
    return small + big


def _tf32_emulation(q, k, v, *, causal=True, window=None, q_offset=0,
                    split=True, bk=32):
    """Plain-torch emulation of ``flash_attention_tf32_kernel``'s rounding
    points (a test helper, on no path): per BK-key tile, S = Q K^T and
    O += P V through :func:`_mma`; s * scale, masks, the running max and
    sum with exp in f32 as the Pallas kernel; o = acc / max(l, 1e-30)
    rounded to q's type once.  (The kernel's two warps a row, each over
    half of a tile's keys, merge at the end; that reorders f32 sums only.)"""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    neg = torch.tensor(-1e30)
    m = torch.full((b, hq, sq, 1), -1e30)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    qpos = torch.arange(sq)[:, None] + q_offset
    for k0 in range(0, k.shape[2], bk):
        kt, vt = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
        kpos = torch.arange(k0, k0 + kt.shape[2])[None, :]
        mask = torch.ones((sq, kt.shape[2]), dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = torch.where(mask, _mma(qf, kt.transpose(-1, -2), split)
                        * (d ** -0.5), neg)
        mn = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(mask, torch.exp(s - mn), torch.zeros(()))
        alpha = torch.exp(m - mn)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mma(p, vt, split)
        m = mn
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


TF32_CASES = {**{f"k5 {c}": (2, *c[:4], 32, *c[4:]) for c in CASES},
              "gemma causal d256": (1, 8, 1, 96, 96, 256, True, None)}


@pytest.mark.parametrize("case", list(TF32_CASES))
def test_tf32_emulation_matches_pallas_interpret_and_reference(case):
    """Split operands (3 products each) hold the reference's f32 tolerance,
    rtol = atol = 2e-5, against the Pallas kernel in interpret mode and
    ``mha_ref`` on the 15 reference cases at D 32 and at D 256, causal."""
    b, hq, hkv, sq, skv, d, causal, window = TF32_CASES[case]
    q, k, v = _qkv(b, hq, hkv, sq, skv, d, seed=hq + sq + d)
    kw = dict(causal=causal, window=window, q_offset=skv - sq)
    got = _tf32_emulation(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    for want in (flash_attention_pallas(jq, jk, jv, block_q=32, block_k=32,
                                        interpret=True, **kw),
                 jref.mha_ref(jq, jk, jv, **kw)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_one_tf32_rounding_breaks_the_f32_tolerance():
    """The same kernel with every operand truncated once to TF32 (one
    product each) misses rtol = atol = 2e-5 on gemma's layout at D 256,
    and the split stays within it."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 1, 96, 96, 256,
                                                 seed=29))
    want = flash_attention.flash_attention_plain(q, k, v)
    split = _tf32_emulation(q, k, v)
    single = _tf32_emulation(q, k, v, split=False)
    torch.testing.assert_close(split, want, rtol=2e-5, atol=2e-5)
    assert not torch.allclose(single, want, rtol=2e-5, atol=2e-5)
    assert (single - want).abs().max() > 10 * (split - want).abs().max()
