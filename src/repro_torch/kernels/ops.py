"""Kernel dispatch, by the device of the tensors alone.

* CPU tensors take the plain PyTorch version.
* CUDA tensors launch the hand-written kernel (``csrc/*.cu``), or raise.

The kernels are forward-only: their outputs carry no autograd history. So
a CUDA call whose input requires grad, with grad mode on, raises rather
than cut the graph silently (training runs the model-level
``models.layers.attention``). The plain versions stay differentiable.

There is no implementation switch and no fallback: a kernel that cannot
build or launch is an error. ``chip_smoke.py`` calls the plain versions
directly when it holds a kernel against them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import memory_ivf as _ivf
from repro_torch.kernels import memory_topk as _mt
from repro_torch.kernels import moe_grouped as _moe
from repro_torch.kernels.memory_topk import MASK_VALID

#: each kernel's launch counter: (module, attribute)
KERNELS = {"memory_topk": (_mt, "launches"),
           "memory_top1": (_mt, "top1_launches"),
           "ivf_route": (_ivf, "launches"),
           "ivf_scan": (_ivf, "scan_launches"),
           "flash_attention": (_fa, "launches"),
           "decode_attention": (_da, "launches"),
           "moe_grouped": (_moe, "launches"),
           "moe_combine": (_moe, "combine_launches")}


def _on_cuda(t: torch.Tensor, *inputs) -> bool:
    """Does the call go to a kernel? By ``t``'s device; on the card, no
    tensor among ``t`` and ``inputs`` may require grad while grad mode is
    on."""
    if t.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                torch.is_tensor(x) and x.requires_grad
                for x in (t, *inputs)):
            raise RuntimeError(
                "a CUDA kernel got an input that requires grad: the kernels "
                "are forward-only and would cut the autograd graph; detach "
                "the inputs, run under torch.no_grad(), or train with "
                "models.layers.attention")
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def launch_counts() -> dict[str, int]:
    """Launch count of every CUDA kernel since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNELS.items()}


def reset_launches() -> None:
    with _build.COUNT_LOCK:
        for mod, attr in KERNELS.values():
            setattr(mod, attr, 0)
        _build.STREAM_LAUNCHES.clear()


def stream_launches() -> dict[tuple[str, int], int]:
    """Launches by (kernel, CUDA stream handle) since the last reset."""
    with _build.COUNT_LOCK:
        return dict(_build.STREAM_LAUNCHES)


def memory_top1_batch_padded(mem, qs, mask, required: int = MASK_VALID):
    """Zero-copy multi-query top-1 over the padded store layout:
    (sims (B,), idx (B,)), the max sim and the lowest row of a tie; an
    empty view gives (-2.0, 0)."""
    if _on_cuda(mem, qs, mask):
        return _mt.memory_top1_batch_padded_cuda(mem, qs, mask, required)
    return _mt.memory_top1_batch_padded_plain(mem, qs, mask, required)


def memory_top1_padded(mem, q, mask, required: int = MASK_VALID):
    """Single-query top-1: (sim (), idx ()). On the card it is the top-1
    kernel with one query."""
    if _on_cuda(mem, q, mask):
        s, r = _mt.memory_top1_batch_padded_cuda(mem, q[None], mask,
                                                 required)
        return s[0], r[0]
    return _mt.memory_top1_padded_plain(mem, q, mask, required)


def _compact_store(mem, mask):
    """The compact (C, E) store and (C,) mask as the top-1 kernels read
    them. On the card a contiguous f32 store with E % 4 == 0 goes in as it
    is (the scan takes any row count; only the mask is widened to a (C, 1)
    int32 plane, where a bool mask's 1 is MASK_VALID); anything else takes
    the padded layout (one O(C * E) copy: not a serving path)."""
    if _on_cuda(mem, mask) and mem.dtype == torch.float32 and \
            mem.is_contiguous() and mem.shape[1] % 4 == 0 and \
            mem.data_ptr() % 16 == 0:
        return mem, mask.to(torch.int32).reshape(-1, 1)
    return _mt.to_padded_layout(mem, mask)


def memory_top1(mem, q, mask):
    """Compact layout: mem (C, E), q (E,), mask (C,) bool -> (sim, idx)."""
    memp, maskp = _compact_store(mem, mask)
    return memory_top1_padded(memp, q, maskp)


def memory_top1_batch(mem, qs, mask):
    """Compact layout: mem (C, E), qs (B, E), mask (C,) bool."""
    memp, maskp = _compact_store(mem, mask)
    return memory_top1_batch_padded(memp, qs, maskp)


def memory_topk_batch_padded(mem, qs, mask, k: int,
                             required: int = MASK_VALID):
    """Zero-copy multi-query top-k over the padded store layout:
    (sims (B, k), idx (B, k)) sorted by (sim desc, row asc)."""
    if _on_cuda(mem, qs, mask):
        return _mt.memory_topk_batch_padded_cuda(mem, qs, mask, k, required)
    _mt.check_k(k, mem.shape[0])
    return _mt.memory_topk_batch_padded_plain(mem, qs, mask, k, required)


def memory_topk_padded(mem, q, mask, k: int, required: int = MASK_VALID):
    """Single-query top-k: (sims (k,), idx (k,)). On the card it is the
    batch kernel with one query, as in the JAX package."""
    if _on_cuda(mem, q, mask):
        s, r = _mt.memory_topk_batch_padded_cuda(mem, q[None], mask, k,
                                                 required)
        return s[0], r[0]
    _mt.check_k(k, mem.shape[0])
    return _mt.memory_topk_padded_plain(mem, q, mask, k, required)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: float | None = None, kv_len=None):
    if _on_cuda(q, k, v, kv_len):
        return _fa.flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        kv_len=kv_len)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, kv_len=kv_len)


def decode_attention(q, k, v, cache_len, *, window: int = 0,
                     scale: float | None = None, ring: bool = False):
    """One query token against the cache; ``ring`` reads a ring of
    slots (:mod:`repro_torch.kernels.decode_attention`)."""
    if _on_cuda(q, k, v, cache_len):
        return _da.decode_attention_cuda(q, k, v, cache_len, window=window,
                                         scale=scale, ring=ring)
    return _da.decode_attention_plain(q, k, v, cache_len, window=window,
                                      scale=scale, ring=ring)


def ivf_route_batch_padded(cent, qs, cmask, n_probe: int,
                           required: int = MASK_VALID):
    """Top-``n_probe`` centroid rows per query over the padded centroid
    plane: (scores (B, n_probe), cids (B, n_probe)) sorted by
    (score desc, row asc)."""
    if _on_cuda(cent, qs, cmask):
        return _ivf.ivf_route_batch_padded_cuda(cent, qs, cmask, n_probe,
                                                required)
    _mt.check_k(n_probe, cent.shape[0])
    return _ivf.ivf_route_batch_padded_plain(cent, qs, cmask, n_probe,
                                             required)


def ivf_route_padded(cent, q, cmask, n_probe: int,
                     required: int = MASK_VALID):
    """Single-query route: (scores (n_probe,), cids (n_probe,)); on the
    card the batch kernel with one query."""
    if _on_cuda(cent, q, cmask):
        s, c = _ivf.ivf_route_batch_padded_cuda(cent, q[None], cmask,
                                                n_probe, required)
        return s[0], c[0]
    _mt.check_k(n_probe, cent.shape[0])
    return _ivf.ivf_route_padded_plain(cent, q, cmask, n_probe, required)


def ivf_scan_batch(scores, cids, cidmap, members, assign, emb, mask, hard,
                   added_at, guide, qs, k: int, required: int, cs: int = 0,
                   csp: int = 0):
    """The IVF candidate read after the route: each query's top k over its
    routed clusters' member rows and the winners' packed meta, (sims
    (B, k), meta (B, k, 4 + G))
    (:func:`repro_torch.kernels.memory_ivf.ivf_scan_batch_plain`); ``cs``/
    ``csp`` > 0 read a sharded store's rows at (g // cs) * csp + g % cs."""
    if _on_cuda(emb, scores, qs, mask):
        return _ivf.ivf_scan_batch_cuda(scores, cids, cidmap, members,
                                        assign, emb, mask, hard, added_at,
                                        guide, qs, k, required, cs, csp)
    return _ivf.ivf_scan_batch_plain(scores, cids, cidmap, members, assign,
                                     emb, mask, hard, added_at, guide, qs, k,
                                     required, cs, csp)


def moe_gate_up(a, w_gate, w_up, offsets):
    """The experts' gate and up products over slots sorted by expert:
    h (N, F) = silu(a w_gate[e]) * (a w_up[e]) in f32, rounded once
    (:func:`repro_torch.kernels.moe_grouped.gate_up_plain`)."""
    if _on_cuda(a, w_gate, w_up):
        return _moe.gate_up_cuda(a, w_gate, w_up, offsets)
    return _moe.gate_up_plain(a, w_gate, w_up, offsets)


def moe_down(h, w_down, offsets):
    """The experts' down product over slots sorted by expert: (N, D) =
    h w_down[e] in f32, rounded once
    (:func:`repro_torch.kernels.moe_grouped.down_plain`)."""
    if _on_cuda(h, w_down):
        return _moe.down_cuda(h, w_down, offsets)
    return _moe.down_plain(h, w_down, offsets)


def moe_combine(y, inv, gates):
    """Each token's k slot outputs weighted by its gates, summed in slot
    order in f32 and rounded once: (T, D) from y (N, D) in expert order,
    inv (T k,) and gates (T, k)
    (:func:`repro_torch.kernels.moe_grouped.combine_plain`)."""
    if _on_cuda(y, gates):
        return _moe.combine_cuda(y, inv, gates)
    return _moe.combine_plain(y, inv, gates)
