"""K5: blockwise online-softmax attention (GQA, causal, sliding window).

Replaces ``repro/kernels/flash_attention.py`` ``flash_attention_pallas`` /
``_flash_kernel``, whose grid walked KV blocks on a sequential fourth axis
with the running max, sum and accumulator in VMEM scratch.  On Hopper one
CTA per (q tile, q head, batch row) loops over the KV tiles inside it, with
the KV head ``h // (Hq // Hkv)`` (KV is never repeated) and the masks from
absolute positions.  Two CUDA kernels compute it, and :func:`route` picks
one from dtypes, shapes, strides and alignment alone:

* ``csrc/flash_attention_wgmma.cu`` ``flash_attention_wgmma_kernel`` takes
  bf16 q/k/v with D in {64, 128, 256} in layouts TMA can read (16 B
  aligned bases, strides that are positive multiples of 16 B): bf16 tiles
  by TMA, QK^T and PV on ``wgmma`` with f32 accumulators, p split into two
  bf16 terms so that the result stays within one bf16 ulp of the f32
  computation.  Every bf16 prefill layer of the LM runs here.
* ``csrc/flash_attention.cu`` ``flash_attention_tf32_kernel`` takes the
  rest (f32, other head dims, other layouts): QK^T and PV on the TF32
  tensor cores (``mma.sync`` m16n8k8) with f32 accumulators, every f32
  operand split into two TF32 terms (three products where the function
  has one) so that the result holds the Pallas kernel's f32 tolerance;
  bf16 operands are exact in TF32 and need fewer products.

Both are bound by operations (4.3 GFLOP at gemma-2b's 1024-token prefill).
A route is a choice, not a fallback: a failed build or launch of either
kernel raises.  There is no backward: the reference has none for this
kernel, and the gradient comes with LM training.

On a CPU tensor the plain version (``ref.mha_ref``) runs; on a CUDA tensor
a kernel runs or the wrapper raises.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mha_ref

TF32 = "flash_attention"
WGMMA = "flash_attention_wgmma"
LAUNCHES = build.counter(TF32)
WGMMA_LAUNCHES = build.counter(WGMMA)

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535          # q heads and batch rows are grid y and z
WGMMA_HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _no_grad(q, k, v, what: str) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{what} has no backward: call it under "
                           "torch.inference_mode() or torch.no_grad()")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K5 (``ref.mha_ref``)."""
    return mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)


def _check(q, k, v, what: str, window: Optional[int]) -> None:
    """What both kernels require of their operands; raises otherwise."""
    _no_grad(q, k, v, what)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"{what}: q, k and v must be on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k and v must all be float32 or all "
                        f"bfloat16 (got {[q.dtype, k.dtype, v.dtype]})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bsz, hq, _, d = q.shape
    hkv = k.shape[1]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{what}: {hq} q heads are not a multiple of {hkv} "
                         "KV heads")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} must be a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if hq > MAX_GRID_YZ or bsz > MAX_GRID_YZ:
        raise ValueError(f"{what}: {hq} heads or {bsz} rows exceed "
                         f"{MAX_GRID_YZ}")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} < 1")
    if q.stride()[3] != 1 or k.stride()[3] != 1 or v.stride()[3] != 1:
        raise ValueError(f"{what}: the head dim of q, k and v must be "
                         "contiguous")


def _tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """Element strides of the first three axes as the tensor map gets them:
    an axis of size 1 is never stepped, so its stride becomes D."""
    n, s = t.shape, t.stride()
    return (s[0] if n[0] > 1 else n[3], s[1] if n[1] > 1 else n[3],
            s[2] if n[2] > 1 else n[3])


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that takes these operands: :data:`WGMMA` for bf16 with a
    head dim in :data:`WGMMA_HEAD_DIMS`, bases 16 B aligned and strides on
    the first three axes that are positive multiples of 16 B (what TMA
    reads); :data:`TF32` for everything else.  Reads dtypes, shapes,
    strides and base addresses only (the tuple accessors: this runs on
    every launch)."""
    bf16 = torch.bfloat16
    if q.dtype != bf16 or k.dtype != bf16 or v.dtype != bf16 or \
            q.shape[3] not in WGMMA_HEAD_DIMS:
        return TF32
    for t in (q, k, v):
        if t.stride()[3] != 1 or t.data_ptr() % 16:
            return TF32
        for s in _tma_strides(t):        # 16 B = 8 bf16 elements
            if s <= 0 or s % 8:
                return TF32
    return WGMMA


def flash_attention_tf32_cuda(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None,
                              q_offset: int = 0) -> torch.Tensor:
    """Launch ``flash_attention_tf32_kernel``.  q ``[B, Hq, Sq, D]``, k/v
    ``[B, Hkv, Skv, D]`` with any strides on the first three axes and D
    contiguous, all f32 or all bf16 on one CUDA device, ``Hq % Hkv == 0``,
    D a multiple of 8 up to 256 -> ``[B, Hq, Sq, D]`` contiguous in q's
    type."""
    _check(q, k, v, "flash_attention_tf32_cuda", window)
    return _launch_tf32(q, k, v, causal, window, q_offset)


def flash_attention_wgmma_cuda(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: Optional[int] = None,
                               q_offset: int = 0,
                               split_p: bool = True) -> torch.Tensor:
    """Launch ``flash_attention_wgmma_kernel`` on operands that
    :func:`route` sends there (it raises on any other) -> ``[B, Hq, Sq,
    D]`` contiguous bf16.  ``split_p=False`` rounds p to bf16 once instead
    of splitting it: a measurement of what the split buys, never the
    model's path."""
    _check(q, k, v, "flash_attention_wgmma_cuda", window)
    if route(q, k, v) != WGMMA:
        raise ValueError("flash_attention_wgmma_cuda takes bf16 q, k, v with "
                         f"a head dim in {WGMMA_HEAD_DIMS}, 16 B aligned, "
                         "with strides that are positive multiples of 16 B")
    return _launch_wgmma(q, k, v, causal, window, q_offset, split_p)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """K5 on CUDA tensors: the kernel that :func:`route` picks (see
    :func:`flash_attention_tf32_cuda` for what both take)."""
    _check(q, k, v, "flash_attention_cuda", window)
    if route(q, k, v) == WGMMA:
        return _launch_wgmma(q, k, v, causal, window, q_offset, True)
    return _launch_tf32(q, k, v, causal, window, q_offset)


def copy_width(*ts: torch.Tensor) -> int:
    """Bytes of one row copy of the TF32 kernel that every row start of
    ``ts`` allows: 16 (f32 only: a bf16 tile row in shared memory is 8 B
    aligned), 8 or 4 when the bases and the strides of the first three axes
    (those of size > 1) are multiples of it, else 0 (element copies)."""
    esz = ts[0].element_size()
    for w in ((16, 8, 4) if esz == 4 else (8, 4)):
        if all(t.data_ptr() % w == 0 and all(
                s * esz % w == 0 for n, s in zip(t.shape[:3], t.stride()[:3])
                if n > 1) for t in ts):
            return w
    return 0


def _launch_tf32(q, k, v, causal, window, q_offset) -> torch.Tensor:
    bsz, hq, sq, d = q.shape
    o = torch.empty((bsz, hq, sq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = build.library(TF32)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bsz, hq,
            k.shape[1], sq, k.shape[2], d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), 0 if window is None else window,
            q_offset, d ** -0.5, _DTYPES[q.dtype], copy_width(q),
            copy_width(k, v), stream)
    build.check(err, TF32)
    LAUNCHES.add()
    return o


def _launch_wgmma(q, k, v, causal, window, q_offset, split_p) -> torch.Tensor:
    bsz, hq, sq, d = q.shape
    o = torch.empty((bsz, hq, sq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = build.library(WGMMA)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bsz, hq,
            k.shape[1], sq, k.shape[2], d, *_tma_strides(q),
            *_tma_strides(k), *_tma_strides(v), int(causal),
            0 if window is None else window, q_offset, d ** -0.5,
            int(split_p), stream)
    build.check(err, WGMMA)
    WGMMA_LAUNCHES.add()
    return o


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """K5 on CUDA tensors, its plain version on CPU tensors (forward only)."""
    if q.device.type == "cpu":
        _no_grad(q, k, v, "flash_attention")
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
