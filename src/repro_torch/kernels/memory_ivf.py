"""The IVF two-level store read's two kernels: the centroid route and the
candidate read, each with its plain PyTorch version and its CUDA
kernel's wrapper.

* The route replaces ``src/repro/kernels/memory_ivf.py::
  ivf_route_batch_padded_pallas`` (and its B=1 wrapper
  ``ivf_route_padded_pallas``). The kernel is ``csrc/ivf_route.cu``, the
  store read's scan core (``csrc/store_scan.cuh``) over the centroid plane.
* The candidate read is the counterpart of the body of
  ``src/repro/core/memory_ivf.py::_ivf_topk_batch_jit`` after its route
  (which XLA fuses; there is no Pallas kernel). The kernel is
  ``csrc/ivf_scan.cu``: one launch for the batch, each kept candidate's
  row read by slot, every dot summed in the scan core's order.

Each header says what bounds its kernel on the H100 and what its design
does about it.

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
from repro_torch.kernels.memory_topk import (MASK_VALID, _lane_dots,
                                             _pad_queries, _state,
                                             _store_queries, _topk_select,
                                             check_k,
                                             memory_topk_batch_padded_plain,
                                             memory_topk_padded_plain,
                                             pack_meta_parts)

_SENTINEL = 2 ** 30

#: launches of the route and the candidate-read kernels (each incremented
#: where its kernel is launched, only)
launches = 0
scan_launches = 0


def ivf_route_padded_plain(cent, q, cmask, n_probe: int,
                           required: int = MASK_VALID):
    """Single query: q (E,) -> (scores (n_probe,), cids (n_probe,))."""
    return memory_topk_padded_plain(cent, q, cmask, n_probe, required)


def ivf_route_batch_padded_plain(cent, qs, cmask, n_probe: int,
                                 required: int = MASK_VALID):
    """qs (B, E) -> (scores (B, n_probe), cids (B, n_probe)), each row
    sorted by (score desc, centroid row asc)."""
    return memory_topk_batch_padded_plain(cent, qs, cmask, n_probe, required)


#: the per-tile lists of 64-bit keys, allocated once per (kernel, device,
#: stream, size); the tickets and keys are memory_topk's state words, which
#: every launch leaves at zero
_lists: dict = {}
_TILE = 32


def _key_lists(kind: str, dev, stream: int, n: int) -> torch.Tensor:
    key = (kind, dev, stream, n)
    if key not in _lists:
        _lists[key] = torch.empty(max(n, 1), dtype=torch.int64, device=dev)
    return _lists[key]


def ivf_route_batch_padded_cuda(cent, qs, cmask, n_probe: int,
                                required: int = MASK_VALID):
    """Launch ``csrc/ivf_route.cu`` on CUDA tensors: cent (Pp, Ep) f32,
    qs (B, E) f32, cmask (Pp, 1) int32 -> (scores (B, n_probe) f32,
    cids (B, n_probe) int32). One launch; the outputs are the only
    allocations (the workspaces are kept per stream and shape)."""
    global launches
    q = _store_queries(cent, qs, cmask, "ivf_route")
    Pp, Ep = cent.shape
    B = qs.shape[0]
    check_k(n_probe, Pp)
    dev = cent.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    tickets = _state("route", dev, stream, -(-B // 8))   # ceil(B / 4) u32
    lists = _key_lists("route", dev, stream,
                       B * -(-Pp // _TILE) * min(n_probe, _TILE))
    out_s = torch.empty((B, n_probe), dtype=torch.float32, device=dev)
    out_r = torch.empty((B, n_probe), dtype=torch.int32, device=dev)
    err = _build.lib().ivf_route_batch_padded(
        cent.data_ptr(), q.data_ptr(), cmask.data_ptr(), Pp, Ep, q.shape[1],
        B, n_probe, required, tickets.data_ptr(), lists.data_ptr(),
        lists.numel(), out_s.data_ptr(), out_r.data_ptr(), stream)
    _build.check(err, "ivf_route_batch_padded")
    launches += 1
    return out_s, out_r


# ---------------------------------------------------------------------------
# The candidate read
# ---------------------------------------------------------------------------


def global_cids(cids: torch.Tensor, cidmap: torch.Tensor) -> torch.Tensor:
    """Centroid-plane rows -> cluster ids; padding rows map to the 2**30
    sentinel (their -2.0 scores drop them at the gather)."""
    ps = cidmap.shape[0]
    return torch.where(cids < ps, cidmap[cids.long().clamp(0, ps - 1)],
                       _SENTINEL)


def gather_candidates(members, assign, scores, cids):
    """Expand routed clusters into a candidate slot list. Dead probes
    (score <= -2.0), empty bucket slots and stale members (``assign`` no
    longer points back at the probed cluster) are dropped by one mask;
    survivors are unique."""
    P, M = members.shape
    C = assign.shape[0]
    cids_c = cids.long().clamp(0, P - 1)
    slots = members[cids_c]
    slots = slots.reshape(slots.shape[:-2] + (-1,))          # (..., P'*M)
    owner = cids_c.repeat_interleave(M, dim=-1)
    ok = (scores.repeat_interleave(M, dim=-1) > -2.0) & (slots >= 0)
    ok = ok & (assign[slots.long().clamp(0, C - 1)] == owner)
    return slots, ok


def ivf_select_plain(scores, cids, cidmap, members, assign, emb, mask, qs,
                     k: int, required: int):
    """The selection of :func:`ivf_scan_batch_plain`: (sims (B, k),
    keys (B, k), wbits (B, k)). Each query's top k over its n_probe x M
    candidates by (sim desc, key asc): a dropped candidate has sim -2.0 and
    key 2**30 + its position, a kept one lacking ``required`` sim -2.0 and
    key its slot, a kept one its dot (summed in the card's order) and its
    slot; wbits is a kept winner's mask bits. A round that lands on the
    dropped candidates gives (-2.0, 2**30) and bits 0 (the selection
    rounds' sentinel, as in the JAX package). Memory is O(B * L * Ep); the
    caller chunks B."""
    C = assign.shape[0]
    slots, ok = gather_candidates(members, assign, scores,
                                  global_cids(cids, cidmap))
    L = slots.shape[1]
    phys = slots.long().clamp(0, C - 1)
    rows = torch.where(ok[..., None], emb[phys], 0.0)        # (B, L, Ep)
    bits = torch.where(ok, mask[phys, 0], 0)                 # (B, L)
    qp = _pad_queries(qs, emb.shape[1])
    sims = _lane_dots(rows, qp[:, None, :])
    sims = torch.where(ok & ((bits & required) == required), sims, -2.0)
    # dropped candidates get distinct keys above every slot, so several
    # sentinel rounds keep the -2.0 sim (as the exact scan's distinct
    # masked rows do) instead of collapsing onto one consumed key
    keys = torch.where(ok, slots, _SENTINEL + torch.arange(
        L, dtype=torch.int32, device=qs.device)[None, :])
    top_s, top_r = _topk_select(sims.T, keys.T, k)           # (k, B)
    top_s, top_r = top_s.T, top_r.T
    hit = keys[:, :, None] == top_r[:, None, :]              # (B, L, k)
    wbits = (bits[:, :, None] * hit).sum(dim=1).to(torch.int32)
    return top_s, top_r, wbits


def ivf_scan_batch_plain(scores, cids, cidmap, members, assign, emb, mask,
                         hard, added_at, guide, qs, k: int, required: int):
    """The candidate read after the route and its epilogue: scores/cids
    (B, n_probe) from the route, cidmap (ps,), members (P, M), assign (C,),
    the store's emb (Cp, Ep), mask (Cp, 1), hard (C,), added_at (C,) and
    guide (C, G), qs (B, E) -> (sims (B, k), meta (B, k, 4 + G)): the
    selection of :func:`ivf_select_plain` and the winners' packed meta
    (:func:`~repro_torch.kernels.memory_topk.pack_meta_parts`, the key
    clamped into the C slots as its index)."""
    top_s, top_r, wbits = ivf_select_plain(scores, cids, cidmap, members,
                                           assign, emb, mask, qs, k,
                                           required)
    return top_s, pack_meta_parts(top_r.clamp(0, assign.shape[0] - 1), wbits,
                                  hard, added_at, guide)


def _check_scan(scores, cids, cidmap, members, assign, emb, mask, hard,
                added_at, guide, qs, k):
    tensors = (scores, cids, cidmap, members, assign, emb, mask, hard,
               added_at, guide, qs)
    if emb.device.type != "cuda" or any(t.device != emb.device
                                        for t in tensors):
        raise ValueError("ivf_scan kernel takes CUDA tensors on one device")
    if scores.dtype != torch.float32 or hard.dtype != torch.bool or any(
            t.dtype != torch.int32 for t in (cids, cidmap, members, assign,
                                             mask, added_at, guide)):
        raise TypeError("ivf_scan kernel takes f32 scores, bool hard and "
                        "int32 cids, cidmap, members, assign, mask, "
                        "added_at and guide")
    B, n_probe = scores.shape
    C = assign.shape[0]
    if cids.shape != (B, n_probe) or qs.shape[0] != B or \
            mask.shape != (emb.shape[0], 1) or assign.dim() != 1 or \
            C > emb.shape[0] or hard.shape != (C,) or \
            added_at.shape != (C,) or guide.dim() != 2 or \
            guide.shape[0] != C:
        raise ValueError(f"bad shapes scores {tuple(scores.shape)}, cids "
                         f"{tuple(cids.shape)}, emb {tuple(emb.shape)}, "
                         f"mask {tuple(mask.shape)}, qs {tuple(qs.shape)}, "
                         f"assign {tuple(assign.shape)}")
    L = n_probe * members.shape[1]
    if not 1 <= k <= L:
        raise ValueError(f"k={k} must be in [1, {L}], the candidates a "
                         f"query")


def ivf_scan_batch_cuda(scores, cids, cidmap, members, assign, emb, mask,
                        hard, added_at, guide, qs, k: int, required: int):
    """Launch ``csrc/ivf_scan.cu`` on CUDA tensors (the arguments and
    results of :func:`ivf_scan_batch_plain`). One launch for the batch;
    the outputs are the only allocations (the workspaces are kept per
    stream and shape)."""
    global scan_launches
    _check_scan(scores, cids, cidmap, members, assign, emb, mask, hard,
                added_at, guide, qs, k)
    q = _store_queries(emb, qs, mask, "ivf_scan")
    scores, cids, cidmap, members, assign, hard, added_at, guide = (
        t.contiguous() for t in (scores, cids, cidmap, members, assign, hard,
                                 added_at, guide))
    B, n_probe = scores.shape
    P, M = members.shape
    C, G = guide.shape
    dev = emb.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = _state("ivf_scan", dev, stream, 2 * B)     # B keys, B tickets
    lists = _key_lists("ivf_scan", dev, stream, B * -(-(n_probe * M) // _TILE)
                       * min(k, _TILE)) if k > 1 else None
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_meta = torch.empty((B, k, 4 + G), dtype=torch.int32, device=dev)
    err = _build.lib().ivf_scan_batch(
        scores.data_ptr(), cids.data_ptr(), cidmap.data_ptr(),
        cidmap.shape[0], members.data_ptr(), P, M, assign.data_ptr(), C,
        emb.data_ptr(), mask.data_ptr(), emb.shape[1], hard.data_ptr(),
        added_at.data_ptr(), guide.data_ptr(), G, q.data_ptr(), q.shape[1], B,
        n_probe, k, required, state.data_ptr(),
        None if lists is None else lists.data_ptr(),
        0 if lists is None else lists.numel(), out_s.data_ptr(),
        out_meta.data_ptr(), stream)
    _build.check(err, "ivf_scan_batch")
    scan_launches += 1
    return out_s, out_meta
