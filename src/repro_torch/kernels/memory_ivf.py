"""Centroid routing for the IVF two-level store read: the plain PyTorch
version and the CUDA kernel's wrapper.

Replaces ``src/repro/kernels/memory_ivf.py::ivf_route_batch_padded_pallas``
(and its B=1 wrapper ``ivf_route_padded_pallas``). The kernel is
``csrc/ivf_route.cu``; its header says what bounds it on the H100 and how
one CTA a query replaces the TPU's sequential (n_probe, B) accumulator.

The centroid plane keeps the store's padded layout
(:mod:`repro_torch.kernels.memory_topk`): ``cent`` (Pp, Ep) f32, one
L2-normalized centroid a row, and ``cmask`` (Pp, 1) int32 with
``MASK_VALID`` set on seeded clusters. The route is the store's top-k
order, (score desc, centroid row asc), with the same sentinels, and
rejects ``n_probe`` exactly where the top-k read rejects ``k``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.memory_topk import (MASK_VALID, check_cuda_inputs,
                                             check_k,
                                             memory_topk_batch_padded_plain,
                                             memory_topk_padded_plain)

#: launches of the CUDA kernel (incremented where it is launched, only)
launches = 0


def ivf_route_padded_plain(cent, q, cmask, n_probe: int,
                           required: int = MASK_VALID):
    """Single query: q (E,) -> (scores (n_probe,), cids (n_probe,))."""
    return memory_topk_padded_plain(cent, q, cmask, n_probe, required)


def ivf_route_batch_padded_plain(cent, qs, cmask, n_probe: int,
                                 required: int = MASK_VALID):
    """qs (B, E) -> (scores (B, n_probe), cids (B, n_probe)), each row
    sorted by (score desc, centroid row asc)."""
    return memory_topk_batch_padded_plain(cent, qs, cmask, n_probe, required)


def ivf_route_batch_padded_cuda(cent, qs, cmask, n_probe: int,
                                required: int = MASK_VALID):
    """Launch ``csrc/ivf_route.cu`` on CUDA tensors: cent (Pp, Ep) f32,
    qs (B, E) f32, cmask (Pp, 1) int32 -> (scores (B, n_probe) f32,
    cids (B, n_probe) int32)."""
    global launches
    qp = check_cuda_inputs(cent, qs, cmask, "ivf_route")
    Pp, Ep = cent.shape
    B = qs.shape[0]
    check_k(n_probe, Pp)
    dev = cent.device
    out_s = torch.empty((B, n_probe), dtype=torch.float32, device=dev)
    out_r = torch.empty((B, n_probe), dtype=torch.int32, device=dev)
    err = _build.lib().ivf_route_batch_padded(
        cent.data_ptr(), qp.data_ptr(), cmask.data_ptr(), Pp, Ep, B, n_probe,
        required, out_s.data_ptr(), out_r.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "ivf_route_batch_padded")
    launches += 1
    return out_s, out_r
