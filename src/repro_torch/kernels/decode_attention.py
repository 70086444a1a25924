"""Decode attention (one query token against the KV cache): plain PyTorch
version and the CUDA kernel's wrapper.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention_pallas``.
The kernel is ``csrc/decode_attention.cu``; its header says what bounds it
on the H100 and how it is laid out. ``cache_len`` may be a scalar or (B,),
as in the JAX reference oracle (the Pallas kernel took a scalar only).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_DTYPES, NEG_INF,
                                                 check_inputs)

MAX_GROUP = 16          # csrc/decode_attention.cu MAX_G

#: launches of the CUDA kernel (incremented where it is launched, only)
launches = 0


def _lengths(cache_len, B: int, device) -> torch.Tensor:
    return torch.as_tensor(cache_len, dtype=torch.int32,
                           device=device).expand(B).contiguous()


def decode_attention_plain(q, k, v, cache_len, *, window: int = 0,
                           scale: float | None = None):
    """q (B, H, hd); k, v (B, M, KV, hd); cache_len () or (B,): positions
    < cache_len are valid, and with ``window`` > 0 only those
    >= cache_len - window. f32 math, output in q's dtype."""
    B, H, hd = q.shape
    M, KV = k.shape[1], k.shape[2]
    G = H // KV
    s = scale if scale is not None else hd ** -0.5
    qg = q.reshape(B, KV, G, hd).float() * s
    scores = torch.einsum("bkgh,bmkh->bkgm", qg, k.float())
    cl = _lengths(cache_len, B, q.device)[:, None]
    kpos = torch.arange(M, device=q.device)[None, :]
    mask = kpos < cl
    if window > 0:
        mask = mask & (kpos >= cl - window)
    scores = torch.where(mask[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgm,bmkh->bkgh", probs, v.float())
    return out.reshape(B, H, hd).to(q.dtype)


def decode_attention_cuda(q, k, v, cache_len, *, window: int = 0,
                          scale: float | None = None):
    """Launch ``csrc/decode_attention.cu``; same contract as
    :func:`decode_attention_plain`. A cache_len of 0 yields zeros (the
    kernel loads no tile), where the plain version averages all M rows."""
    global launches
    check_inputs(q, k, v, "decode_attention")
    B, H, hd = q.shape
    M, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or H // KV > MAX_GROUP:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (or G > {MAX_GROUP})")
    cl = _lengths(cache_len, B, q.device)
    s = scale if scale is not None else hd ** -0.5
    out = torch.empty_like(q)
    err = _build.lib().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        cl.data_ptr(), B, M, H, KV, hd, int(window), float(s),
        _DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "decode_attention_fwd")
    launches += 1
    return out
