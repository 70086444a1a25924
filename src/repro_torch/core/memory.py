"""Skill & guide memory (the paper's vector store, section III-F) on the
device: the counterpart of ``src/repro/core/memory.py`` for the
single-device store.

The store keeps the JAX package's persistent kernel layout: ``emb`` is
(Cp, Ep) f32 (rows padded to the block multiple, lanes to 128) and
``valid``/``has_guide`` live in a (Cp, 1) int32 mask bit plane, so a read
hands the buffers to the top-k kernel as they are. Logical ring slots are
rows [0, C); padding rows carry mask 0.

Reads and writes take a :class:`MemoryState` or a wrapped store with the
same method API (:class:`repro_torch.core.memory_ivf.IVFMemory`): the
module functions dispatch as the JAX package's do, a ``MemoryState`` to
the function here, a wrapped store to its method.

Differences from the JAX package, by design:

* writes (:func:`add`, :func:`add_batch`, :func:`mark_soft`, :func:`touch`,
  :meth:`CommitBuffer.apply_ops`) update the tensors **in place** and
  return the same state, where JAX builds a new functional state;
* the ring pointer ``ptr`` is a host int (no device scalar to sync);
* a result's :meth:`~_MetaViews.device_get` moves ``sim`` and ``meta`` to
  the host in one ``.cpu()`` (the sims ride as int32 bit patterns).

Not ported yet: the write-ahead journal (``MemoryJournal``,
``open_journaled_stream``).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.memory_topk import (DEFAULT_BLOCK_C, MASK_GUIDE,
                                             MASK_VALID, pack_meta_parts,
                                             padded_lanes, padded_rows)


@dataclasses.dataclass(frozen=True)
class MemoryConfig:
    capacity: int = 4096
    embed_dim: int = 384
    guide_len: int = 8


@dataclasses.dataclass
class MemoryState:
    emb: torch.Tensor       # (Cp, Ep) f32, persistent kernel layout
    mask: torch.Tensor      # (Cp, 1) int32 bit plane MASK_VALID | MASK_GUIDE
    guide: torch.Tensor     # (C, G) int32
    hard: torch.Tensor      # (C,) bool
    added_at: torch.Tensor  # (C,) int32 logical time
    ptr: int = 0            # ring insert pointer (host)

    @property
    def capacity(self) -> int:
        return self.hard.shape[0]

    @property
    def device(self) -> torch.device:
        return self.emb.device

    @property
    def valid(self) -> torch.Tensor:
        return (self.mask[:self.capacity, 0] & MASK_VALID) != 0

    @property
    def has_guide(self) -> torch.Tensor:
        return (self.mask[:self.capacity, 0] & MASK_GUIDE) != 0

    @property
    def size_fast(self) -> int:
        """Occupancy from the ring pointer (entries are only ever added)."""
        return min(self.ptr, self.capacity)


def init_memory(cfg: MemoryConfig, device="cuda") -> MemoryState:
    dev = resolve_device(device)
    C, E, G = cfg.capacity, cfg.embed_dim, cfg.guide_len
    Cp, Ep = padded_rows(C), padded_lanes(E)
    return MemoryState(
        emb=torch.zeros((Cp, Ep), dtype=torch.float32, device=dev),
        mask=torch.zeros((Cp, 1), dtype=torch.int32, device=dev),
        guide=torch.zeros((C, G), dtype=torch.int32, device=dev),
        hard=torch.zeros((C,), dtype=torch.bool, device=dev),
        added_at=torch.zeros((C,), dtype=torch.int32, device=dev),
    )


def _on(state: MemoryState, x, dtype) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=state.device).to(dtype)


# ---------------------------------------------------------------------------
# Writes (in place)
# ---------------------------------------------------------------------------


def add_batch(state, embs, guides, has_guide, hard, now):
    """Insert K entries at consecutive ring slots (FIFO eviction): embs
    (K, E); guides (K, G); has_guide/hard (K,) bool; now (K,) int32. One
    scatter per field, in place. Returns the store."""
    if not isinstance(state, MemoryState):
        state.add_batch(embs, guides, has_guide, hard, now)
        return state
    embs = _on(state, embs, torch.float32)
    K, C = embs.shape[0], state.capacity
    if K > C:
        raise ValueError(f"microbatch commit of {K} entries exceeds "
                         f"memory capacity {C}")
    idx = (state.ptr + torch.arange(K, device=state.device)) % C
    state.emb[idx] = 0.0
    state.emb[idx, :embs.shape[1]] = embs
    bits = MASK_VALID + MASK_GUIDE * _on(state, has_guide, torch.int32)
    state.mask[idx, 0] = bits
    state.guide[idx] = _on(state, guides, torch.int32)
    state.hard[idx] = _on(state, hard, torch.bool)
    state.added_at[idx] = _on(state, now, torch.int32)
    state.ptr += K
    return state


def add(state, emb, guide, has_guide, hard, now):
    """Insert one entry at the ring pointer."""
    if not isinstance(state, MemoryState):
        state.add(emb, guide, has_guide, hard, now)
        return state
    return add_batch(state, np.asarray(emb)[None], np.asarray(guide)[None],
                     np.asarray(has_guide).reshape(1),
                     np.asarray(hard).reshape(1), np.asarray(now).reshape(1))


def mark_soft(state, index):
    """Clear hard flag(s) after a successful re-probe; ``index`` scalar or
    (K,)."""
    if not isinstance(state, MemoryState):
        state.mark_soft(index)
        return state
    state.hard[_on(state, index, torch.int64)] = False
    return state


def touch(state, index, now):
    """Refresh entry timestamp(s): the re-probe cool-down restarts."""
    if not isinstance(state, MemoryState):
        state.touch(index, now)
        return state
    state.added_at[_on(state, index, torch.int64)] = _on(state, now,
                                                         torch.int32)
    return state


def grow_memory(state: MemoryState, new_capacity: int
                ) -> tuple[MemoryState, torch.Tensor]:
    """Grow-in-place capacity re-layout, as the JAX ``grow_memory``:
    returns ``(grown_state, remap)`` with ``remap[s]`` the new slot of old
    slot ``s``. An unwrapped ring copies straight across (identity remap);
    a wrapped one is linearized oldest-first and the pointer becomes C."""
    C = state.capacity
    if new_capacity < C:
        raise ValueError(f"cannot shrink memory: {new_capacity} < {C}")
    dev = state.device
    fresh = init_memory(MemoryConfig(capacity=new_capacity,
                                     embed_dim=state.emb.shape[1],
                                     guide_len=state.guide.shape[1]), dev)
    ar = torch.arange(C, device=dev)
    if state.ptr <= C:
        order, new_ptr, remap = ar, state.ptr, ar.clone()
    else:
        shift = state.ptr % C
        order, new_ptr, remap = (ar + shift) % C, C, (ar - shift) % C
    fresh.emb[:C] = state.emb[order]
    fresh.mask[:C] = state.mask[order]
    fresh.guide[:C] = state.guide[order]
    fresh.hard[:C] = state.hard[order]
    fresh.added_at[:C] = state.added_at[order]
    fresh.ptr = new_ptr
    return fresh, remap.to(torch.int32)


# ---------------------------------------------------------------------------
# Reads
# ---------------------------------------------------------------------------


class _MetaViews:
    """Per-field views over the packed int32 ``meta``
    [index, has_guide, hard, added_at, guide_0..guide_{G-1}]; they work on
    device tensors and host arrays alike."""

    @property
    def index(self):
        return self.meta[..., 0]

    @property
    def has_guide(self):
        return self.meta[..., 1] != 0

    @property
    def hard(self):
        return self.meta[..., 2] != 0

    @property
    def added_at(self):
        return self.meta[..., 3]

    @property
    def guide(self):
        return self.meta[..., 4:]

    def device_get(self):
        """The whole result on the host as numpy, in one transfer."""
        if not torch.is_tensor(self.sim):
            return self
        bits = self.sim.contiguous().view(torch.int32)[..., None]
        host = torch.cat([bits, self.meta], dim=-1).cpu().numpy()
        sim = np.ascontiguousarray(host[..., 0]).view(np.float32).reshape(
            host.shape[:-1])
        return type(self)(sim, np.ascontiguousarray(host[..., 1:]))


@dataclasses.dataclass(frozen=True)
class QueryResult(_MetaViews):
    sim: object           # (...,) f32
    meta: object          # (..., 4 + G) int32


@dataclasses.dataclass(frozen=True)
class TopKResult(_MetaViews):
    sim: object           # (..., k) f32, sorted by (sim desc, row asc)
    meta: object          # (..., k, 4 + G) int32


def pack_meta(state: MemoryState, idx) -> torch.Tensor:
    return pack_meta_parts(idx, state.mask[idx.long(), 0], state.hard,
                           state.added_at, state.guide)


def required_bits(guides_only: bool) -> int:
    return MASK_VALID | (MASK_GUIDE if guides_only else 0)


def _check_k(k: int, capacity: int) -> None:
    bound = min(capacity, DEFAULT_BLOCK_C)
    if not 1 <= k <= bound:
        raise ValueError(f"retrieval k={k} must be in [1, {bound}] "
                         f"(min of capacity={capacity} and the kernel "
                         f"block {DEFAULT_BLOCK_C})")


def query(state, emb, guides_only: bool = False) -> QueryResult:
    """Top-1 cosine search for one query (the top-1 kernel on the card):
    the best row and its metadata; an empty view gives sim -2.0 at row 0.
    ``guides_only`` restricts the view to guide entries."""
    if not isinstance(state, MemoryState):
        return state.query(emb, guides_only=guides_only)
    sim, idx = kops.memory_top1_padded(
        state.emb, _on(state, emb, torch.float32), state.mask,
        required_bits(guides_only))
    return QueryResult(sim=sim, meta=pack_meta(state, idx))


def query_batch(state, embs, guides_only: bool = False) -> QueryResult:
    """Top-1 search for a microbatch in one store pass: embs (B, E) ->
    QueryResult with a leading B axis."""
    if not isinstance(state, MemoryState):
        return state.query_batch(embs, guides_only=guides_only)
    sims, idx = kops.memory_top1_batch_padded(
        state.emb, _on(state, embs, torch.float32), state.mask,
        required_bits(guides_only))
    return QueryResult(sim=sims, meta=pack_meta(state, idx))


def query_topk(state, emb, k: int, guides_only: bool = False) -> TopKResult:
    """Top-k cosine search for one query, sorted by (sim desc, row asc);
    slots past the view's population carry the -2.0 sentinel."""
    _check_k(k, state.capacity)
    if not isinstance(state, MemoryState):
        return state.query_topk(emb, k, guides_only=guides_only)
    sims, idx = kops.memory_topk_padded(
        state.emb, _on(state, emb, torch.float32), state.mask, k,
        required_bits(guides_only))
    return TopKResult(sim=sims, meta=pack_meta(state, idx))


def query_topk_batch(state, embs, k: int,
                     guides_only: bool = False) -> TopKResult:
    """Top-k search for a microbatch in one store pass: embs (B, E) ->
    TopKResult with (B, k) leading axes."""
    _check_k(k, state.capacity)
    if not isinstance(state, MemoryState):
        return state.query_topk_batch(embs, k, guides_only=guides_only)
    sims, idx = kops.memory_topk_batch_padded(
        state.emb, _on(state, embs, torch.float32), state.mask, k,
        required_bits(guides_only))
    return TopKResult(sim=sims, meta=pack_meta(state, idx))


# ---------------------------------------------------------------------------
# Epoch-versioned commit buffer and the commit stream
# ---------------------------------------------------------------------------


class CommitBuffer:
    """Staging area for shadow-plane writes, applied in epochs, with the
    JAX ``CommitBuffer``'s contract: inserts land in logical-time order,
    soft-clears as a sorted index set, touches last-``now``-wins per
    index, and a flag op is dropped when its slot was overwritten by any
    insert since its ``ptr_snapshot`` (the eviction guard)."""

    def __init__(self):
        self._records: list[tuple] = []      # (now, emb, guide, hg, hard)
        self._soft_clears: list[tuple] = []  # (now, index, ptr_snapshot)
        self._touches: list[tuple] = []      # (now, index, ptr_snapshot)
        self.epoch = 0
        self.entries_applied = 0

    def stage_add(self, emb, guide, has_guide: bool, hard: bool,
                  now: int) -> None:
        self._records.append((int(now), emb, guide, bool(has_guide),
                              bool(hard)))

    def stage_soft_clear(self, index: int, now: int,
                         ptr_snapshot: int | None = None) -> None:
        self._soft_clears.append((int(now), int(index), ptr_snapshot))

    def stage_touch(self, index: int, now: int,
                    ptr_snapshot: int | None = None) -> None:
        self._touches.append((int(now), int(index), ptr_snapshot))

    @property
    def pending(self) -> int:
        return len(self._records) + len(self._soft_clears) + \
            len(self._touches)

    def mark(self) -> tuple:
        """Cursor over the staging area, for :meth:`rollback`."""
        return (len(self._records), len(self._soft_clears),
                len(self._touches))

    def rollback(self, mark: tuple) -> None:
        """Discard every op staged since ``mark``."""
        r, s, t = mark
        del self._records[min(r, len(self._records)):]
        del self._soft_clears[min(s, len(self._soft_clears)):]
        del self._touches[min(t, len(self._touches)):]

    def take_ops(self):
        records = sorted(self._records, key=lambda r: r[0])
        soft_clears, touches = self._soft_clears, self._touches
        self._records, self._soft_clears, self._touches = [], [], []
        return records, soft_clears, touches

    def apply(self, state):
        if not self.pending:
            return state, 0
        return self.apply_ops(state, *self.take_ops())

    def apply_ops(self, state, records, soft_clears, touches):
        """Apply one epoch's ops to ``state`` (in place). Inserts go in
        capacity-sized chunks, so an epoch larger than the ring degrades to
        the sequential FIFO result, each split into power-of-two runs
        (13 -> 8 + 4 + 1) as the JAX package splits them: the store's bytes
        do not depend on the split, but an IVF index assigns each insert
        against its run's start centroids."""
        records = sorted(records, key=lambda r: r[0])
        C = state.capacity
        base_ptr = state.ptr
        end_ptr = base_ptr + len(records)

        def evicted(idx: int, snap) -> bool:
            snap = base_ptr if snap is None else min(int(snap), base_ptr)
            covered = end_ptr - snap
            return covered >= C or (idx - snap) % C < covered

        for chunk in (run for start in range(0, len(records), C)
                      for run in _po2_runs(records[start:start + C])):
            state = add_batch(state,
                      np.stack([np.asarray(r[1]) for r in chunk]),
                      np.stack([np.asarray(r[2], np.int32) for r in chunk]),
                      np.asarray([r[3] for r in chunk], bool),
                      np.asarray([r[4] for r in chunk], bool),
                      np.asarray([r[0] for r in chunk], np.int32))
        softs = sorted({idx for _, idx, snap in soft_clears
                        if not evicted(idx, snap)})
        if softs:
            state = mark_soft(state, np.asarray(softs, np.int64))
        by_idx = {idx: now for now, idx, snap in
                  sorted(touches, key=lambda t: t[:2])
                  if not evicted(idx, snap)}
        if by_idx:
            order = sorted(by_idx)
            state = touch(state, np.asarray(order, np.int64),
                  np.asarray([by_idx[i] for i in order], np.int32))
        self.epoch += 1
        self.entries_applied += len(records)
        return state, len(records)


def _po2_runs(seq):
    """Split ``seq`` into power-of-two runs, in order: 13 -> 8 + 4 + 1."""
    i = 0
    while i < len(seq):
        step = 1 << ((len(seq) - i).bit_length() - 1)
        yield seq[i:i + step]
        i += step


class CommitStream:
    """The serve/learn commit interface: one :class:`CommitBuffer`, the
    lock that serializes applies against snapshot reads, the single host
    counter of committed entries, and the subscribed controller views
    that receive every applied store."""

    def __init__(self, buffer: CommitBuffer | None = None):
        self.buffer = buffer if buffer is not None else CommitBuffer()
        self.lock = threading.RLock()
        self.commits = 0
        self._views: list = []

    def subscribe(self, view) -> None:
        if view not in self._views:
            self._views.append(view)
            view.commit_epoch_seen = self.buffer.epoch

    def count(self, n: int = 1) -> None:
        with self.lock:
            self.commits += n

    def apply(self, state):
        """Apply the staged epoch and broadcast the store to every view
        under one lock hold. Returns the store."""
        with self.lock:
            if not self.buffer.pending:
                return state
            state, n = self.buffer.apply(state)
            self.commits += n
            for v in self._views:
                v.memory = state
                v.commit_epoch_seen = self.buffer.epoch
        return state

    def grow(self, state, new_capacity: int):
        """Grow the store (a wrapped store through its own ``grow``) and
        re-broadcast it; refuses while ops are staged. Returns
        ``(new_state, remap)``."""
        with self.lock:
            if self.buffer.pending:
                raise RuntimeError(
                    f"grow with {self.buffer.pending} staged commit ops; "
                    f"drain (apply) the epoch first")
            if isinstance(state, MemoryState):
                state, remap = grow_memory(state, new_capacity)
            else:
                state, remap = state.grow(new_capacity)
            for v in self._views:
                v.memory = state
                if hasattr(v, "_ptr_base"):
                    v._ptr_base = state.ptr - self.commits
            return state, remap
