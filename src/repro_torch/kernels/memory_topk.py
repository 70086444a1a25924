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


def _pad_queries(qs: torch.Tensor, ep: int) -> torch.Tensor:
    """(B, E) queries -> (B, Ep) f32, zero lanes after E: the only copy a
    read makes, O(B * E)."""
    qp = torch.zeros((qs.shape[0], ep), dtype=torch.float32,
                     device=qs.device)
    qp[:, :qs.shape[1]] = qs.float()
    return qp


def _dots(mem: torch.Tensor, qs: torch.Tensor) -> torch.Tensor:
    """(Cp, Ep) rows against (B, E) queries -> (Cp, B) f32 dots, summed the
    same way for every row (the lane products summed over the lanes), so
    identical rows give identical sims and ties fall to the lowest row.
    PyTorch's CPU matrix-vector and matrix products do not promise that:
    they sum a matrix's last rows in another order, a few ulp apart. The
    queries go in chunks of at most 2**24 product elements."""
    m = mem.float()
    qp = _pad_queries(qs, m.shape[1])
    step = max(1, (1 << 24) // m.numel())
    return torch.cat([(m[:, None, :] * qp[None, i:i + step]).sum(-1)
                      for i in range(0, qp.shape[0], step)], dim=1)


def memory_top1_padded_plain(mem, q, mask, required: int = MASK_VALID):
    """Single query: q (E,) -> (sim (), idx ()). The first maximum (the
    lowest row of a tie), as the JAX oracle's argmax; an empty view gives
    (-2.0, 0)."""
    sims = _masked(_dots(mem, q[None])[:, 0], mask, required)
    idx = torch.argmax(sims)
    return sims[idx], idx.to(torch.int32)


def memory_top1_batch_padded_plain(mem, qs, mask, required: int = MASK_VALID):
    """qs (B, E) -> (sims (B,), idx (B,)), each the first maximum of its
    row of (B, Cp) sims."""
    sims = _masked(_dots(mem, qs), mask, required).T
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
    sims = _masked(_dots(mem, q[None])[:, 0], mask, required)
    rows = torch.arange(sims.shape[0], dtype=torch.int32, device=mem.device)
    return _topk_select(sims, rows, k)


def memory_topk_batch_padded_plain(mem, qs, mask, k: int,
                                   required: int = MASK_VALID):
    """qs (B, E) -> (sims (B, k), idx (B, k)), each row sorted by
    (sim desc, row asc)."""
    sims = _masked(_dots(mem, qs), mask, required)              # (Cp, B)
    rows = torch.arange(sims.shape[0], dtype=torch.int32,
                        device=mem.device)[:, None].expand_as(sims)
    s, r = _topk_select(sims, rows, k)                          # (k, B)
    return s.T.contiguous(), r.T.contiguous()


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

#: the store kernels' workspaces, each allocated once per (kernel, device,
#: stream, shape): the state words (B keys, then the ticket), which every
#: launch leaves at zero, and top-k's tile lists, room for B x k entries a
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


def check_cuda_inputs(mem, qs, mask, name: str) -> torch.Tensor:
    """Validate a padded store (or centroid plane) read for a CUDA kernel:
    mem (Cp, Ep) f32 and mask (Cp, 1) int32, contiguous, qs (B, E) with
    E <= Ep, all on one card. Returns the (B, Ep) f32 padded queries."""
    _check_cuda(mem, qs, mask, name)
    return _pad_queries(qs, mem.shape[1])


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
