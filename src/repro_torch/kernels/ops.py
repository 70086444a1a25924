"""Kernel dispatch, by the device of the tensors alone.

* CPU tensors take the plain PyTorch version.
* CUDA tensors launch the hand-written kernel (``csrc/*.cu``), or raise.

There is no implementation switch and no fallback: a kernel that cannot
build or launch is an error. ``chip_smoke.py`` calls the plain versions
directly when it holds a kernel against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import memory_topk as _mt
from repro_torch.kernels.memory_topk import MASK_VALID

KERNELS = {"memory_topk": _mt, "flash_attention": _fa,
           "decode_attention": _da}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def launch_counts() -> dict[str, int]:
    """Launch count of every CUDA kernel since the last reset."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def memory_topk_batch_padded(mem, qs, mask, k: int,
                             required: int = MASK_VALID):
    """Zero-copy multi-query top-k over the padded store layout:
    (sims (B, k), idx (B, k)) sorted by (sim desc, row asc)."""
    if _on_cuda(mem):
        return _mt.memory_topk_batch_padded_cuda(mem, qs, mask, k, required)
    _mt.check_k(k, mem.shape[0])
    return _mt.memory_topk_batch_padded_plain(mem, qs, mask, k, required)


def memory_topk_padded(mem, q, mask, k: int, required: int = MASK_VALID):
    """Single-query top-k: (sims (k,), idx (k,)). On the card it is the
    batch kernel with one query, as in the JAX package."""
    if _on_cuda(mem):
        s, r = _mt.memory_topk_batch_padded_cuda(mem, q[None], mask, k,
                                                 required)
        return s[0], r[0]
    _mt.check_k(k, mem.shape[0])
    return _mt.memory_topk_padded_plain(mem, q, mask, k, required)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, kv_len=None):
    if _on_cuda(q):
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        kv_len=kv_len)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, kv_len=kv_len)


def decode_attention(q, k, v, cache_len, *, window: int = 0,
                     scale: float | None = None):
    if _on_cuda(q):
        return _da.decode_attention_cuda(q, k, v, cache_len, window=window,
                                         scale=scale)
    return _da.decode_attention_plain(q, k, v, cache_len, window=window,
                                      scale=scale)
