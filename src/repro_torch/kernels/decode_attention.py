"""Decode attention (one query token against the KV cache): plain PyTorch
version and the CUDA kernel's wrapper.

Replaces ``src/repro/kernels/decode_attention.py::decode_attention_pallas``.
The kernel is ``csrc/decode_attention.cu``; its header says what bounds it
on the H100 and how it is laid out. ``cache_len`` may be a scalar or (B,),
as in the JAX reference oracle (the Pallas kernel took a scalar only).

The kernel splits each row's cache over several CTAs (split-KV) and merges
their partials in the same launch; :func:`split` picks the chunk, and the
wrapper keeps one workspace and ticket buffer per (stream, shape).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (_DTYPES, NEG_INF,
                                                 check_inputs)

MAX_GROUP = 16          # csrc/decode_attention.cu MAX_G
MIN_CHUNK, MAX_CHUNK = 32, 128   # keys a split-KV chunk (below the cap)
MAX_CHUNKS = 64         # csrc/decode_attention.cu MAX_CHUNKS

#: launches of the CUDA kernel (incremented where it is launched, only)
launches = 0

_workspaces: dict = {}
_sm_counts: dict = {}


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


def split(M: int, window: int, rows: int, sms: int) -> tuple[int, int]:
    """(chunk, n_chunks) for a cache of M slots: a row's valid range holds
    at most min(M, window) keys (M without a window), cut into chunks of
    MIN_CHUNK..MAX_CHUNK keys (a multiple of MIN_CHUNK below the cap), as
    many as ``rows`` (B * KV) times them takes to fill ``sms`` SMs, but
    none under one 32-key tile (at llama3-8b B=1, cache 301, 10 chunks of
    32 ran faster than 20 of 16 in every card run: PERF.md); past
    MAX_CHUNKS * MAX_CHUNK keys the chunks grow instead of their number."""
    span = min(M, window) if window > 0 else M
    want = -(-sms // rows)
    chunk = min(MAX_CHUNK,
                max(MIN_CHUNK, span // want // MIN_CHUNK * MIN_CHUNK))
    if -(-span // chunk) > MAX_CHUNKS:
        per = -(-span // MAX_CHUNKS)
        chunk = -(-per // MIN_CHUNK) * MIN_CHUNK
    return chunk, -(-span // chunk)


def _workspace(device, stream: int, B: int, KV: int, G: int, hd: int,
               n_chunks: int):
    """The (partials, tickets) pair of one (stream, shape), allocated once:
    the kernel leaves the tickets at zero after every launch."""
    key = (device, stream, B, KV, G, hd, n_chunks)
    if key not in _workspaces:
        _workspaces[key] = (
            torch.empty(B * KV * n_chunks * G * (hd + 2), dtype=torch.float32,
                        device=device),
            torch.zeros(B * KV, dtype=torch.int32, device=device))
    return _workspaces[key]


def decode_attention_cuda(q, k, v, cache_len, *, window: int = 0,
                          scale: float | None = None):
    """Launch ``csrc/decode_attention.cu``; same contract as
    :func:`decode_attention_plain`. A cache_len of 0 yields zeros (the
    kernel loads no key), where the plain version averages all M rows."""
    global launches
    check_inputs(q, k, v, "decode_attention")
    B, H, hd = q.shape
    M, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or H // KV > MAX_GROUP:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)} (or G > {MAX_GROUP})")
    cl = _lengths(cache_len, B, q.device)
    s = scale if scale is not None else hd ** -0.5
    dev = q.device
    if dev not in _sm_counts:
        _sm_counts[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    chunk, n_chunks = split(M, int(window), B * KV, _sm_counts[dev])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = tickets = None
    if n_chunks > 1:
        ws, tickets = _workspace(dev, stream, B, KV, H // KV, hd, n_chunks)
    out = torch.empty_like(q)
    err = _build.lib().decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        cl.data_ptr(), B, M, H, KV, hd, int(window), float(s),
        _DTYPES[q.dtype], chunk, n_chunks,
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), stream)
    _build.check(err, "decode_attention_fwd")
    launches += 1
    return out
