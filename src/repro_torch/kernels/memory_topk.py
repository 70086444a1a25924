"""Masked reads of the padded guide store: the layout contract, and for
the top-k and the top-1 read the plain PyTorch versions and the CUDA
kernels' wrappers.

* top-k replaces ``src/repro/kernels/memory_topk.py::
  memory_topk_batch_padded_pallas`` (and its B=1 wrapper
  ``memory_topk_padded_pallas``); the kernel is ``csrc/memory_topk.cu``;
* top-1 replaces ``memory_top1_batch_padded_pallas`` and
  ``memory_top1_padded_pallas``; the kernel is ``csrc/memory_top1.cu``,
  and ``ops.memory_top1``/``memory_top1_batch`` are the compact-layout
  wrappers ``memory_top1_pallas``/``memory_top1_batch_pallas``.

Both kernels are one launch around the scan core ``csrc/store_scan.cuh``,
whose header says what bounds them on the H100 and how one pass over the
store, with the queries on chip and the merge after a ticket in the same
launch, replaces the TPU's sequential accumulator. Their wrappers keep the
kernels' workspaces per (device, stream, shape): a read allocates only its
outputs.

Layout contract (identical to the JAX package, so row indices agree):

* ``mem`` is (Cp, Ep) f32, rows padded to a multiple of the row tile (8)
  and lanes to a multiple of 128; padding rows and lanes are zero.
* ``mask`` is a (Cp, 1) int32 bit plane: bit 0 = valid, bit 1 = has_guide
  (:data:`MASK_VALID`/:data:`MASK_GUIDE`). A query passes ``required``, the
  bits a row must carry to take part; padding rows are 0, never valid.

The result of every path is sorted by (sim descending, row ascending):
:func:`_topk_select` is the definition of that order, mirrored from the
JAX reference (k rounds of max, lowest row among ``>= best``, consume to
-3.0). ``torch.topk``/``torch.sort`` are not used: their order for ties and
for ±0.0 is not this one.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

DEFAULT_BLOCK_C = 1024

MASK_VALID = 1
MASK_GUIDE = 2

_ROW_TILE = 8
_ROW_SENTINEL = 2 ** 30

#: launches of the top-k and the top-1 CUDA kernels (each incremented where
#: its kernel is launched, only)
launches = 0
top1_launches = 0


def padded_rows(c: int, block_c: int = DEFAULT_BLOCK_C) -> int:
    """Row count of the persistent kernel layout for a capacity-``c``
    store: a multiple of the row tile, up to one full block."""
    tile = min(block_c, _round_up(c, _ROW_TILE))
    return _round_up(c, _round_up(tile, _ROW_TILE))


def padded_lanes(e: int) -> int:
    """Lane count of the persistent kernel layout for embed dim ``e``."""
    return _round_up(e, 128)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _pick_block(cp: int, block_c: int) -> int:
    """Largest row-tile multiple <= block_c that divides the padded row
    count. The CUDA kernel does not need it; it fixes the ``k <= block``
    contract exactly where the JAX package fixes it."""
    if cp % _ROW_TILE:
        raise ValueError(f"padded row count {cp} is not a multiple of the "
                         f"row tile {_ROW_TILE}; build the store with "
                         f"padded_rows()/to_padded_layout()")
    bc = max(min(block_c, cp) // _ROW_TILE * _ROW_TILE, _ROW_TILE)
    while cp % bc:
        bc -= _ROW_TILE
    return bc


def to_padded_layout(mem: torch.Tensor, mask: torch.Tensor,
                     *, block_c: int = DEFAULT_BLOCK_C
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact (C, E) store + (C,) mask -> padded (Cp, Ep) store + (Cp, 1)
    int32 bit plane (a bool mask becomes the MASK_VALID bit)."""
    C, E = mem.shape
    Cp, Ep = padded_rows(C, block_c), padded_lanes(E)
    memp = torch.zeros((Cp, Ep), dtype=mem.dtype, device=mem.device)
    memp[:C, :E] = mem
    bits = mask.to(torch.int32)
    if mask.dtype == torch.bool:
        bits = bits * MASK_VALID
    maskp = torch.zeros((Cp, 1), dtype=torch.int32, device=mem.device)
    maskp[:C, 0] = bits
    return memp, maskp


def check_k(k: int, cp: int, block_c: int = DEFAULT_BLOCK_C) -> None:
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    bc = _pick_block(cp, block_c)
    if k > bc:
        raise ValueError(f"k={k} exceeds the kernel block of {bc} rows; "
                         f"raise block_c (or shrink k)")


def pack_meta_parts(idx, bits, hard, added_at, guide) -> torch.Tensor:
    """THE packed-meta layout of a store read's result, [index, has_guide,
    hard, added_at, guide...]. Gathers clamp ``idx`` into the logical rows,
    as JAX gathers do."""
    g = idx.long().clamp(max=hard.shape[0] - 1)
    head = torch.stack([idx.to(torch.int32),
                        (bits & MASK_GUIDE) // MASK_GUIDE,
                        hard[g].to(torch.int32), added_at[g]], dim=-1)
    return torch.cat([head, guide[g]], dim=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path; the card's oracle)
# ---------------------------------------------------------------------------


def _topk_select(sims: torch.Tensor, rows: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k over the leading axis by (sim desc, row asc): k rounds of max,
    lowest row among ``sims >= best``, consume to -3.0. IEEE compares, so
    ±0.0 are equal and the row decides."""
    out_s, out_r = [], []
    never = torch.full_like(rows, _ROW_SENTINEL)
    consumed = torch.tensor(-3.0, dtype=sims.dtype, device=sims.device)
    for _ in range(k):
        best = sims.max(dim=0).values
        at_best = sims >= best[None]
        best_row = torch.where(at_best, rows, never).min(dim=0).values
        out_s.append(best)
        out_r.append(best_row)
        sims = torch.where(at_best & (rows == best_row[None]), consumed,
                           sims)
    return torch.stack(out_s), torch.stack(out_r)


def _masked(sims: torch.Tensor, mask: torch.Tensor, required: int
            ) -> torch.Tensor:
    valid = (mask[:, 0] & required) == required
    shape = (-1,) + (1,) * (sims.dim() - 1)
    return torch.where(valid.view(shape), sims,
                       torch.tensor(-2.0, device=sims.device))


def _masked_dots(mem, qs, mask, required: int, k: int) -> torch.Tensor:
    """(Cp, B) sims for a top-``k`` read: -2.0 where a row lacks
    ``required``; for each query the card's sim (:func:`_dots`) of every
    row that carries it and can be among its top ``k``, and -inf for the
    rows that cannot (so the (sim desc, row asc) top-k of the result is
    the top-k of the card's sims).

    A row can be among the top k unless its f64 dot lies more than 2
    delta below the k-th largest f64 dot of the view: the card's sum is
    within delta = 2**-16 |m| |q| of the exact dot (at most 96 roundings
    of 2**-24 over sum |m_i q_i| <= |m| |q|, for rows of up to 2048
    lanes), so k rows beat it. Only the (row, query) pairs near the top
    are summed in the card's order."""
    Cp, Ep = mem.shape
    valid = (mask[:, 0] & required) == required
    sims = torch.full((Cp, qs.shape[0]), -2.0, dtype=torch.float32,
                      device=mem.device)
    rows = valid.nonzero()[:, 0]
    if not rows.numel():
        return sims
    m = mem[rows].float()
    qp = _pad_queries(qs, Ep)
    approx = m.double() @ qp.double().T                        # (V, B)
    if rows.numel() <= k or not bool(torch.isfinite(approx).all()):
        sims[rows] = _dots(m, qs)
        return sims
    kth = approx.topk(k, dim=0).values[-1]
    delta = 2.0 ** -16 * m.double().norm(dim=1).max() * \
        qp.double().norm(dim=1) + 2.0 ** -140
    r, b = (approx >= kth - 2 * delta).nonzero(as_tuple=True)
    near = torch.full(approx.shape, float("-inf"), dtype=torch.float32,
                      device=mem.device)
    near[r, b] = _lane_dots(m[r], qp[b])
    sims[rows] = near
    return sims


def _pad_queries(qs: torch.Tensor, ep: int) -> torch.Tensor:
    """(B, E) queries -> (B, Ep) f32, zero lanes after E: the only copy a
    read makes, O(B * E)."""
    qp = torch.zeros((qs.shape[0], ep), dtype=torch.float32,
                     device=qs.device)
    qp[:, :qs.shape[1]] = qs.float()
    return qp


SUM_BLOCK = 32
#: chain elements a step of :func:`_chains` takes at once
_CHAIN_ELEMS = 1 << 18
#: inputs whose nonzero magnitudes lie in [2**-60, 2**50] keep every
#: partial sum of a chain in f32's normal range or exact (see _lane_dots)
_TAME = (2.0 ** -60, 2.0 ** 50)
_TIE_BITS = (0x1FFFFFFF, 0x10000000)  # f64 low bits of an f32 rounding tie


def _tame(x: torch.Tensor) -> bool:
    a = x.abs()
    return bool(a.max() <= _TAME[1]) and \
        bool(torch.where(a > 0, a, _TAME[0]).min() >= _TAME[0])


def _fma_exact(p: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """fmaf: ``acc`` (f32 values) plus the exact f64 product ``p``, rounded
    once to f32. The f64 sum is rounded to odd (its TwoSum error says
    whether it is exact and on which side the exact sum lies: an inexact
    sum is truncated toward zero and its last bit set), and f64 has
    53 >= 24 + 2 bits, so rounding that to f32 gives the correctly rounded
    sum."""
    s = p + acc
    bb = s - p
    err = (p - (s - bb)) + (acc - bb)
    bits = s.view(torch.int64)
    trunc = bits - (torch.signbit(err) ^ torch.signbit(s)).to(torch.int64)
    return torch.where(err != 0, trunc | 1, bits).view(torch.float64).float()


def _chains(m: torch.Tensor, q: torch.Tensor, tame: bool) -> torch.Tensor:
    """The 32-lane FMA chains: m and q (32, ...) f64 (f32 values),
    broadcastable -> (...) f32, each ``acc = fmaf(m[e], q[e], acc)`` from
    +0.0, e ascending. For tame inputs (:func:`_lane_dots`) a step is the
    f64 sum rounded to f32, which is the FMA except where that sum lies
    exactly on an f32 rounding tie; those elements take :func:`_fma_exact`.
    Other inputs take it throughout."""
    prods = m * q
    shape = prods.shape[1:]
    prods = prods.reshape(SUM_BLOCK, -1)
    acc = torch.zeros(prods.shape[1], dtype=torch.float64, device=m.device)
    s, low = torch.empty_like(acc), torch.empty_like(acc, dtype=torch.int64)
    out = torch.empty_like(acc, dtype=torch.float32)
    tie = torch.empty_like(acc, dtype=torch.bool)
    for p in prods:
        if not tame:
            out = _fma_exact(p, acc)
            acc.copy_(out)
            continue
        torch.add(p, acc, out=s)
        torch.bitwise_and(s.view(torch.int64), _TIE_BITS[0], out=low)
        torch.eq(low, _TIE_BITS[1], out=tie)
        out.copy_(s)
        if bool(tie.any()):
            at = tie.nonzero()[:, 0]
            out[at] = _fma_exact(p[at], acc[at])
        acc.copy_(out)
    return out.view(shape)


def _lane_dots(m: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Dots over the last axis of m (N, ..., Ep) and q (broadcastable to
    it; its first axis 1 or N), f32, each the value the card's scan core
    computes (``csrc/store_scan.cuh``, "Summation order"), bit for bit:
    within each block of 32 lanes one FMA chain from +0.0, lanes
    ascending, then the blocks' partial sums added in order to a total
    from +0.0. Lanes past Ep are zero, as the card stages them (+0.0 added
    to a chain or a total that is never -0.0 changes nothing). So identical
    rows give identical sims wherever they sit, and ties fall to the lowest
    row.

    The chains run over rows, queries and blocks at once: 32 dependent
    steps, then one add a block. An FMA is emulated from the exact f64
    product (two f32 values have at most 48 product bits). Where every
    nonzero input magnitude lies in [2**-60, 2**50], products are 0 or
    f32-normal, so a partial sum in f32's subnormal range is an exact
    cancellation, and the f64 sum rounded to f32 can differ from the FMA
    only where it lies exactly on an f32 rounding tie (:func:`_chains`).
    Rows go in chunks of about 2**18 chain elements."""
    ep = m.shape[-1]
    nb = -(-ep // SUM_BLOCK)
    pad = nb * SUM_BLOCK - ep

    def blocks(x):
        x = torch.nn.functional.pad(x.float(), (0, pad)).double()
        return x.view(x.shape[:-1] + (nb, SUM_BLOCK)).movedim(-1, 0)
    md, qd = blocks(m), blocks(q)
    tame = _tame(md) and _tame(qd)
    per_row = torch.broadcast_shapes(md.shape, qd.shape)[2:].numel()
    step = max(1, _CHAIN_ELEMS // per_row)
    out = []
    for i in range(0, md.shape[1], step):
        acc = _chains(md[:, i:i + step],
                      qd[:, i:i + step] if qd.shape[1] > 1 else qd, tame)
        total = torch.zeros(acc.shape[:-1], dtype=torch.float32,
                            device=m.device)
        for b in range(nb):
            total = total + acc[..., b]
        out.append(total)
    return torch.cat(out)


def _dots(mem: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(Cp, Ep) rows against (B, E) queries -> (Cp, B) f32 dots, each the
    value the card's scan computes (:func:`_lane_dots`)."""
    qp = _pad_queries(qs, mem.shape[1])
    return _lane_dots(mem[:, None, :], qp[None])


def memory_top1_padded_plain(mem, q, mask, required: int = MASK_VALID):
    """Single query: q (E,) -> (sim (), idx ()). The first maximum (the
    lowest row of a tie), as the JAX oracle's argmax; an empty view gives
    (-2.0, 0)."""
    sims = _masked_dots(mem, q[None], mask, required, 1)[:, 0]
    idx = torch.argmax(sims)
    return sims[idx], idx.to(torch.int32)


def memory_top1_batch_padded_plain(mem, qs, mask, required: int = MASK_VALID):
    """qs (B, E) -> (sims (B,), idx (B,)), each the first maximum of its
    row of (B, Cp) sims."""
    sims = _masked_dots(mem, qs, mask, required, 1).T
    idx = torch.argmax(sims, dim=1)
    return sims.gather(1, idx[:, None])[:, 0], idx.to(torch.int32)


def memory_top1_plain(mem, q, mask):
    """Compact layout: mem (C, E), q (E,), mask (C,) bool -> (sim, idx)."""
    return memory_top1_padded_plain(*_compact(mem, mask, q))


def memory_top1_batch_plain(mem, qs, mask):
    """Compact layout: mem (C, E), qs (B, E), mask (C,) bool."""
    return memory_top1_batch_padded_plain(*_compact(mem, mask, qs))


def _compact(mem, mask, q):
    memp, maskp = to_padded_layout(mem, mask)
    return memp, q, maskp


def memory_topk_padded_plain(mem, q, mask, k: int,
                             required: int = MASK_VALID):
    """Single query: q (E,) -> (sims (k,), idx (k,))."""
    sims = _masked_dots(mem, q[None], mask, required, k)[:, 0]
    rows = torch.arange(sims.shape[0], dtype=torch.int32, device=mem.device)
    return _topk_select(sims, rows, k)


def memory_topk_batch_padded_plain(mem, qs, mask, k: int,
                                   required: int = MASK_VALID):
    """qs (B, E) -> (sims (B, k), idx (B, k)), each row sorted by
    (sim desc, row asc)."""
    sims = _masked_dots(mem, qs, mask, required, k)             # (Cp, B)
    rows = torch.arange(sims.shape[0], dtype=torch.int32,
                        device=mem.device)[:, None].expand_as(sims)
    s, r = _topk_select(sims, rows, k)                          # (k, B)
    return s.T.contiguous(), r.T.contiguous()


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

#: the store kernels' workspaces, each allocated once per (kernel, device,
#: stream, shape): the state words (here B keys, then the ticket; the IVF
#: kernels keep their keys and tickets in them too), which every launch
#: leaves at zero, and top-k's tile lists, room for B x k entries a
#: tile of the finest tiling the kernel uses (32 rows) and 4 spare (the
#: kernel reads them back 16 bytes at a time)
_states: dict = {}
_lists: dict = {}
_FINEST_TILE = 32


def _check_cuda(mem, qs, mask, name: str) -> None:
    if mem.device.type != "cuda" or qs.device != mem.device or \
            mask.device != mem.device:
        raise ValueError(f"{name} kernel takes CUDA tensors on one device")
    if mem.dtype != torch.float32 or mask.dtype != torch.int32:
        raise TypeError(f"{name} kernel takes f32 mem and int32 mask, "
                        f"got {mem.dtype}/{mask.dtype}")
    if not (mem.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{name} kernel takes contiguous mem and mask")
    Cp, Ep = mem.shape
    if qs.dim() != 2 or mask.shape != (Cp, 1) or qs.shape[1] > Ep or \
            Ep % 4 or qs.shape[0] < 1:
        raise ValueError(f"bad shapes mem {tuple(mem.shape)}, qs "
                         f"{tuple(qs.shape)}, mask {tuple(mask.shape)}")


def _store_queries(mem, qs, mask, name: str) -> torch.Tensor:
    """Validate a store read for the scan kernels and return the queries
    as the kernel reads them: ``qs`` itself when it is contiguous f32 rows
    of a multiple of 4 lanes on a 16-byte boundary (no device op), else
    padded to Ep."""
    _check_cuda(mem, qs, mask, name)
    if qs.dtype == torch.float32 and qs.is_contiguous() and \
            qs.shape[1] % 4 == 0 and qs.data_ptr() % 16 == 0:
        return qs
    return _pad_queries(qs, mem.shape[1])


def _state(kind: str, dev, stream: int, B: int) -> torch.Tensor:
    key = (kind, dev, stream, B)
    if key not in _states:
        _states[key] = torch.zeros(B + 1, dtype=torch.int64, device=dev)
    return _states[key]


def _tile_lists(dev, stream: int, B: int, cp: int, k: int):
    key = (dev, stream, B, cp, k)
    if key not in _lists:
        n = B * -(-cp // _FINEST_TILE) * k + 4
        _lists[key] = (torch.empty(n, dtype=torch.float32, device=dev),
                       torch.empty(n, dtype=torch.int32, device=dev))
    return _lists[key]


def memory_topk_batch_padded_cuda(mem, qs, mask, k: int,
                                  required: int = MASK_VALID):
    """Launch ``csrc/memory_topk.cu`` on CUDA tensors: mem (Cp, Ep) f32,
    qs (B, E) f32, mask (Cp, 1) int32 -> (sims (B, k) f32, idx (B, k)
    int32). One launch; the outputs are the only allocations."""
    global launches
    q = _store_queries(mem, qs, mask, "memory_topk")
    Cp, Ep = mem.shape
    B = qs.shape[0]
    check_k(k, Cp)
    dev = mem.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = _state("topk", dev, stream, B)
    cand_s = cand_r = None
    if k > 1:
        cand_s, cand_r = _tile_lists(dev, stream, B, Cp, k)
    out_s = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_r = torch.empty((B, k), dtype=torch.int32, device=dev)
    err = _build.lib().memory_topk_batch_padded(
        mem.data_ptr(), q.data_ptr(), mask.data_ptr(), Cp, Ep, q.shape[1], B,
        k, required, state.data_ptr(),
        None if cand_s is None else cand_s.data_ptr(),
        None if cand_r is None else cand_r.data_ptr(),
        0 if cand_s is None else cand_s.numel(), out_s.data_ptr(),
        out_r.data_ptr(), stream)
    _build.check(err, "memory_topk_batch_padded")
    launches += 1
    return out_s, out_r


def memory_top1_batch_padded_cuda(mem, qs, mask, required: int = MASK_VALID):
    """Launch ``csrc/memory_top1.cu`` on CUDA tensors: mem (Cp, Ep) f32,
    qs (B, E) f32, mask (Cp, 1) int32 -> (sims (B,) f32, idx (B,) int32).
    One launch for the B queries (B = 1 is the single-query read); any Cp,
    so a compact (C, E) store with E % 4 == 0 goes in as it is."""
    global top1_launches
    q = _store_queries(mem, qs, mask, "memory_top1")
    Cp, Ep = mem.shape
    B = qs.shape[0]
    dev = mem.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = _state("top1", dev, stream, B)
    out_s = torch.empty((B,), dtype=torch.float32, device=dev)
    out_r = torch.empty((B,), dtype=torch.int32, device=dev)
    err = _build.lib().memory_top1_batch_padded(
        mem.data_ptr(), q.data_ptr(), mask.data_ptr(), Cp, Ep, q.shape[1], B,
        required, state.data_ptr(), out_s.data_ptr(), out_r.data_ptr(),
        stream)
    _build.check(err, "memory_top1_batch_padded")
    top1_launches += 1
    return out_s, out_r
