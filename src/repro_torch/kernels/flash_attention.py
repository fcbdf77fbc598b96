"""K5: blockwise online-softmax attention (GQA, causal, sliding window).

Replaces ``repro/kernels/flash_attention.py`` ``flash_attention_pallas`` /
``_flash_kernel``, whose grid walked KV blocks on a sequential fourth axis
with the running max, sum and accumulator in VMEM scratch.  On Hopper the
CUDA kernel (``csrc/flash_attention.cu`` ``flash_attention_kernel``) runs
one CTA per (q tile, q head, batch row) and loops over the KV tiles inside
it, with the KV head ``h // (Hq // Hkv)`` (KV is never repeated) and the
masks from absolute positions.  It computes in f32 inside, as the Pallas
kernel does, with f32 FMAs on the CUDA cores; it is bound by operations
(4.3 GFLOP at gemma-2b's 1024-token prefill).

Every layer's prefill attention of the LM runs here (``models.attention.
flash_scan``).  There is no backward: the reference has none for this
kernel, and the gradient comes with LM training.

On a CPU tensor the plain version (``ref.mha_ref``) runs; on a CUDA tensor
the kernel runs or the wrapper raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import mha_ref

LAUNCHES = build.counter("flash_attention")

MAX_HEAD_DIM = 256
MAX_GRID_YZ = 65535          # q heads and batch rows are grid y and z
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


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch K5.  q ``[B, Hq, Sq, D]``, k/v ``[B, Hkv, Skv, D]`` with any
    strides on the first three axes and D contiguous, all f32 or all bf16
    on one CUDA device, ``Hq % Hkv == 0``, D a multiple of 8 up to 256 ->
    ``[B, Hq, Sq, D]`` contiguous in q's type."""
    _no_grad(q, k, v, "flash_attention_cuda")
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: q, k and v must be on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_cuda: q, k and v must all be "
                        "float32 or all bfloat16 (got "
                        f"{[q.dtype, k.dtype, v.dtype]})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    bsz, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_cuda: {hq} q heads are not a "
                         f"multiple of {hkv} KV heads")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_cuda: head dim {d} must be a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if hq > MAX_GRID_YZ or bsz > MAX_GRID_YZ:
        raise ValueError(f"flash_attention_cuda: {hq} heads or {bsz} rows "
                         f"exceed {MAX_GRID_YZ}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window {window} < 1")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_cuda: the head dim of q, k and v "
                         "must be contiguous")
    o = torch.empty((bsz, hq, sq, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = build.library("flash_attention")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bsz, hq,
            hkv, sq, skv, d, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], int(causal), 0 if window is None else window,
            q_offset, d ** -0.5, _DTYPES[q.dtype], stream)
    build.check(err, "flash_attention")
    LAUNCHES.add()
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
