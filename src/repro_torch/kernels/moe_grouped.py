"""Grouped expert products of a dropless MoE layer over the routed slots:
plain PyTorch versions and the CUDA kernel's wrappers.

Replaces no Pallas kernel: the JAX package leaves these products to XLA
as batched matmuls (``src/repro/models/layers.py::moe``). The kernel is
``csrc/moe_grouped.cu``; its header says what bounds it on the H100 and
how it is laid out. Both functions take the slots sorted by expert, ``a``
(N, K) with expert e's rows in ``[offsets[e], offsets[e + 1])`` and
``offsets`` (E + 1,) int32 on ``a``'s device, and the experts' weights in
their own layouts, and accumulate in f32:

* :func:`gate_up_plain`: h = silu(a w_gate[e]) * (a w_up[e]) rounded once
  to ``a``'s dtype (JAX rounds h there);
* :func:`down_plain`: a w_down[e] rounded once to ``a``'s dtype (JAX
  rounds the expert output there).

A third, small kernel in the same source combines each token's k slot
outputs by their gates (:func:`combine_plain`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

MAX_EXPERTS = 128

#: launches of the grouped products and of the combine (incremented where
#: they are launched, only)
launches = 0
combine_launches = 0


def _segments(offsets: torch.Tensor):
    bounds = offsets.tolist()
    return [(e, lo, hi) for e, (lo, hi) in enumerate(zip(bounds, bounds[1:]))
            if hi > lo]


def gate_up_plain(a, w_gate, w_up, offsets):
    """a (N, D), w_gate and w_up (E, D, F) -> h (N, F) in ``a``'s dtype."""
    h = a.new_empty((a.shape[0], w_gate.shape[2]))
    for e, lo, hi in _segments(offsets):
        x = a[lo:hi].float()
        h[lo:hi] = (F.silu(x @ w_gate[e].float()) * (x @ w_up[e].float())
                    ).to(a.dtype)
    return h


def down_plain(h, w_down, offsets):
    """h (N, F), w_down (E, F, D) -> (N, D) in ``h``'s dtype."""
    y = h.new_empty((h.shape[0], w_down.shape[2]))
    for e, lo, hi in _segments(offsets):
        y[lo:hi] = (h[lo:hi].float() @ w_down[e].float()).to(h.dtype)
    return y


def combine_plain(y, inv, gates):
    """y (N, D) slot outputs in expert order, inv (T k,) each flat slot's
    row of y, gates (T, k) f32 -> (T, D) in y's dtype: for each token the
    sum over its k slots, in slot order from 0, of gate * output in f32,
    rounded once."""
    T, k = gates.shape
    rows = y.index_select(0, inv).view(T, k, -1).float()
    acc = torch.zeros((T, y.shape[1]), dtype=torch.float32, device=y.device)
    for j in range(k):
        acc = acc + rows[:, j] * gates[:, j, None]
    return acc.to(y.dtype)


def _check(a, ws, offsets, name: str) -> None:
    if a.device.type != "cuda" or any(w.device != a.device for w in ws) or \
            offsets.device != a.device:
        raise ValueError(f"{name} kernel takes CUDA tensors on one device")
    if a.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16
                                        for w in ws):
        raise TypeError(f"{name} kernel takes bf16 slots and weights, got "
                        f"{a.dtype}/{[w.dtype for w in ws]}")
    if a.dim() != 2 or any(w.dim() != 3 or w.shape != ws[0].shape
                           for w in ws):
        raise ValueError(f"{name} kernel takes a (N, K) and (E, K, ncols) "
                         f"weights of one shape")
    E, K, ncols = ws[0].shape
    if a.shape[1] != K or K % 8 or ncols % 8 or not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{name} kernel: K {a.shape[1]} / {K} and ncols "
                         f"{ncols} must match and be multiples of 8, E "
                         f"{E} at most {MAX_EXPERTS}")
    if offsets.shape != (E + 1,) or offsets.dtype != torch.int32:
        raise ValueError(f"{name} kernel takes (E + 1,) int32 offsets")
    if not (a.is_contiguous() and offsets.is_contiguous() and
            all(w.is_contiguous() for w in ws)) or \
            any(t.data_ptr() % 16 for t in (a, *ws)):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte aligned "
                         f"tensors (its tensor maps read 16-byte rows)")


def _launch(gated: bool, a, w0, w1, offsets):
    global launches
    E, K, ncols = w0.shape
    out = torch.empty((a.shape[0], ncols), dtype=a.dtype, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _build.lib().moe_grouped_gemm(
        int(gated), a.data_ptr(), w0.data_ptr(), w1.data_ptr(),
        out.data_ptr(), offsets.data_ptr(), a.shape[0], K, ncols, E, stream)
    _build.check(err, "moe_grouped_gemm")
    with _build.COUNT_LOCK:
        launches += 1
        _build.note_stream("moe_grouped", stream)
    return out


def gate_up_cuda(a, w_gate, w_up, offsets):
    """Launch ``csrc/moe_grouped.cu`` for gate and up; the contract of
    :func:`gate_up_plain`."""
    _check(a, (w_gate, w_up), offsets, "moe_grouped")
    return _launch(True, a, w_gate, w_up, offsets)


def down_cuda(h, w_down, offsets):
    """Launch ``csrc/moe_grouped.cu`` for down; the contract of
    :func:`down_plain`."""
    _check(h, (w_down,), offsets, "moe_grouped")
    return _launch(False, h, w_down, w_down, offsets)


def combine_cuda(y, inv, gates):
    """Launch ``csrc/moe_grouped.cu``'s combine; the contract of
    :func:`combine_plain`."""
    global combine_launches
    T, k = gates.shape
    if y.device.type != "cuda" or inv.device != y.device or \
            gates.device != y.device:
        raise ValueError("moe_combine kernel takes CUDA tensors on one device")
    if y.dtype != torch.bfloat16 or inv.dtype != torch.int64 or \
            gates.dtype != torch.float32:
        raise TypeError(f"moe_combine kernel takes bf16 y, int64 inv and f32 "
                        f"gates, got {y.dtype}/{inv.dtype}/{gates.dtype}")
    if y.dim() != 2 or y.shape[1] % 8 or inv.shape != (T * k,) or \
            not (y.is_contiguous() and inv.is_contiguous() and
                 gates.is_contiguous()) or y.data_ptr() % 16:
        raise ValueError("moe_combine kernel takes a contiguous, 16-byte "
                         "aligned (N, D) y with D a multiple of 8, (T k,) inv "
                         "and (T, k) gates")
    out = torch.empty((T, y.shape[1]), dtype=y.dtype, device=y.device)
    stream = torch.cuda.current_stream(y.device).cuda_stream
    err = _build.lib().moe_combine(y.data_ptr(), inv.data_ptr(),
                                   gates.data_ptr(), out.data_ptr(), T, k,
                                   y.shape[1], stream)
    _build.check(err, "moe_combine")
    with _build.COUNT_LOCK:
        combine_launches += 1
        _build.note_stream("moe_combine", stream)
    return out
