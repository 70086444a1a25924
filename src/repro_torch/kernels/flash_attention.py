"""Flash attention for prefill and the embedder: plain PyTorch version and
the CUDA kernel's wrapper.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``.
The kernel is ``csrc/flash_attention.cu``; its header says what bounds it
on the H100 and how it is laid out. Beyond the Pallas kernel it takes a
ragged Sq/Sk (tier prompts have any length) and an optional per-row key
count ``kv_len`` (B,): keys at positions ``>= kv_len[b]`` are masked, which
is how the embedder's right-padded PAD keys are excluded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel (incremented where it is launched, only)
launches = 0


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          scale: float | None = None, kv_len=None):
    """q (B, Sq, H, hd); k, v (B, Sk, KV, hd); positions aligned to the
    sequence end; f32 math, output in q's dtype. ``kv_len`` (B,) int masks
    keys at positions >= kv_len[b]."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = scale if scale is not None else hd ** -0.5
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, hd).float() * s
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float())
    qpos = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    kpos = torch.arange(Sk, device=dev)[None, :]
    diff = qpos - kpos
    mask = torch.ones((1, Sq, Sk), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (diff >= 0)
    if window > 0:
        mask = mask & (diff < window)
    if kv_len is not None:
        mask = mask & (kpos[None] < kv_len.to(dev).view(B, 1, 1))
    scores = torch.where(mask[:, None, None], scores,
                         torch.tensor(NEG_INF, device=dev))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def check_inputs(q, k, v, name: str) -> None:
    """The shapes, types and layout the attention kernels take."""
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError(f"{name} kernel takes CUDA tensors on one device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} kernel takes f32 or bf16 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous q/k/v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name} kernel takes 16-byte aligned q/k/v (its "
                         f"tile copies are 16 bytes wide)")
    hd, KV = k.shape[-1], k.shape[-2]
    H = q.shape[-2]
    if q.shape[-1] != hd or hd not in HEAD_DIMS or H % KV:
        raise ValueError(f"{name} kernel: head_dim {hd} must be one of "
                         f"{HEAD_DIMS} and H={H} a multiple of KV={KV}")


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: int = 0,
                         scale: float | None = None, kv_len=None):
    """Launch ``csrc/flash_attention.cu``; same contract as
    :func:`flash_attention_plain`."""
    global launches
    check_inputs(q, k, v, "flash_attention")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if kv_len is not None:
        if kv_len.shape != (B,) or kv_len.dtype != torch.int32 or \
                kv_len.device != q.device:
            raise ValueError("kv_len must be (B,) int32 on q's device")
    s = scale if scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    err = _build.lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(), B, Sq, Sk, H, KV, hd,
        int(causal), int(window), float(s), _DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_fwd")
    launches += 1
    return out
