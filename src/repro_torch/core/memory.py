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

Because the writes are in place, ordering across CUDA streams is explicit
where JAX gets it from functional updates. Every access to a shared store
holds the commit stream's lock (:class:`StoreLock`). A read ends on the
host (its ``device_get``). A write (an epoch's apply, a grow, an IVF index
refresh) ends with :func:`settle`: made on a side stream (the async
drainer's), it is waited for on the host; made on the device's default
stream (the serve thread's, where the inline and deferred main path runs
everything), it is left queued, and a side-stream holder orders its stream
after the default stream when it takes the lock. So whatever stream takes
the lock next sees whole epochs, and the single-stream path pays no sync.
Store tensors made on a side stream are recorded on the device's default
stream, where the serve plane runs (:func:`publish`), so the caching
allocator never hands their blocks out while the serve plane may still
read them.

Crash consistency: :class:`MemoryJournal` (write-ahead log + periodic
snapshot) and :func:`open_journaled_stream`, as the JAX package's. The WAL
frames hold host numpy and Python values only, in the JAX package's frame
format, so a journal written on the card recovers on the CPU, and a WAL
the JAX package wrote recovers here. The snapshot goes through
:mod:`repro_torch.training.checkpoint`.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import threading
import warnings
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.memory_topk import (DEFAULT_BLOCK_C, MASK_GUIDE,
                                             MASK_VALID, pack_meta_parts,
                                             padded_lanes, padded_rows)
from repro_torch.serving.transport import HEADER, frame_message
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint


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

    def debug_size(self) -> int:
        """Occupancy from the ``valid`` bits: a blocking device sync (a
        reduction over the store), for debugging and tests. A method, not a
        property, so the sync is loud where it is called: hot paths use
        :attr:`size_fast` or the commit stream's host counters."""
        return int(self.valid.sum())


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


def settle(state) -> None:
    """End a write under the store lock. On a side stream, wait for it on
    the host, so a reader on any stream that takes the lock next sees all
    of it. On the device's default stream, leave it queued: a reader on
    that stream runs after it, and a side-stream holder of the lock waits
    for the default stream first (:class:`StoreLock`)."""
    if state.device.type == "cuda":
        stream = torch.cuda.current_stream(state.device)
        if stream != torch.cuda.default_stream(state.device):
            stream.synchronize()


class StoreLock:
    """The re-entrant lock around a shared store. A holder whose current
    CUDA stream is not the default one (the async drainer) makes its
    stream wait for the default stream's queued work when it takes the
    lock, so it sees the writes that :func:`settle` left queued there."""

    def __init__(self):
        self._lock = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._lock.acquire(blocking, timeout)
        if got and torch.cuda.is_initialized():
            stream = torch.cuda.current_stream()
            default = torch.cuda.default_stream(stream.device)
            if stream != default:
                stream.wait_stream(default)
        return got

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def publish(*tensors: torch.Tensor) -> None:
    """Tensors made for a store on a side stream (the async drainer's):
    record them on the device's default stream, where the serve plane
    reads, so the caching allocator does not reuse their blocks before the
    default stream's work on them is done."""
    for t in tensors:
        if t.device.type != "cuda":
            continue
        default = torch.cuda.default_stream(t.device)
        if torch.cuda.current_stream(t.device) != default:
            t.record_stream(default)


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
    publish(fresh.emb, fresh.mask, fresh.guide, fresh.hard, fresh.added_at)
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
# Epoch-versioned commit buffer
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


# ---------------------------------------------------------------------------
# Write-ahead journal: crash-consistent persistence of the commit stream
# ---------------------------------------------------------------------------


class JournalCorruptionWarning(UserWarning):
    """A WAL replay hit a torn or corrupt frame and stopped there; carries
    where (``offset``) and why (``reason``)."""

    def __init__(self, path: str, offset: int, reason: str):
        super().__init__(f"WAL replay stopped at byte {offset} of "
                         f"{path}: {reason}")
        self.path = path
        self.offset = offset
        self.reason = reason


def _host(x):
    """A record field as a host value (numpy), whatever device it is on."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _state_tree(state: MemoryState) -> dict:
    return {"emb": state.emb, "mask": state.mask, "guide": state.guide,
            "hard": state.hard, "added_at": state.added_at,
            "ptr": np.asarray(state.ptr, np.int64)}


class MemoryJournal:
    """Epoch-granular write-ahead journal and periodic snapshot of one
    commit stream's store, the JAX ``MemoryJournal``'s protocol.

    Layout: ``<dir>/wal.log`` (frames of :mod:`repro_torch.serving.
    transport`, one an epoch: its taken ops as host values, its number and
    the engine-state manifest), ``<dir>/snapshot.npz`` (the store and the
    buffer counters through :mod:`repro_torch.training.checkpoint`) and
    ``<dir>/manifest.pkl`` (the manifest as of the snapshot).

    An epoch's ops are written and fsynced **before** they are applied
    (:meth:`CommitStream.apply`): a crash before the write loses the epoch
    (recovery lands on the one before), a crash after it recovers with it
    (one epoch ahead of the dead process's store); never a torn state.
    Every ``snapshot_every`` epochs the store is snapshotted atomically and
    the WAL truncated; records carry their epoch number, so a crash between
    the two is harmless. :meth:`recover` replays surviving epochs through
    :meth:`CommitBuffer.apply_ops`, the path live drains take, and stops
    at a torn or corrupt frame with a :class:`JournalCorruptionWarning`.
    Only the plain :class:`MemoryState` store is journalable.
    """

    def __init__(self, path: str, *, snapshot_every: int = 8,
                 fault_plan=None):
        if snapshot_every < 1:
            raise ValueError(f"snapshot_every must be >= 1, "
                             f"got {snapshot_every}")
        os.makedirs(path, exist_ok=True)
        self.path = path
        self.wal_path = os.path.join(path, "wal.log")
        self.snap_path = os.path.join(path, "snapshot.npz")
        self.manifest_path = os.path.join(path, "manifest.pkl")
        self.snapshot_every = snapshot_every
        self.fault_plan = fault_plan
        self._wal = open(self.wal_path, "ab")
        self.epochs_logged = 0
        self.snapshots = 0

    @staticmethod
    def _read_records(path):
        """Yield the payloads of a WAL file; stop with a warning at the
        first torn or corrupt frame (a clean end is silent)."""
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            data = f.read()
        offset = 0
        while offset < len(data):
            head = data[offset:offset + HEADER.size]
            if len(head) < HEADER.size:
                warnings.warn(JournalCorruptionWarning(
                    path, offset, f"torn header ({len(head)} of "
                                  f"{HEADER.size} bytes)"))
                return
            length, crc = HEADER.unpack(head)
            start = offset + HEADER.size
            payload = data[start:start + length]
            if len(payload) < length:
                warnings.warn(JournalCorruptionWarning(
                    path, offset, f"torn payload ({len(payload)} of "
                                  f"{length} bytes)"))
                return
            if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                warnings.warn(JournalCorruptionWarning(
                    path, offset, "crc mismatch"))
                return
            yield pickle.loads(payload)
            offset = start + length

    def _append(self, record: dict) -> None:
        self._wal.write(frame_message(record))
        self._wal.flush()
        os.fsync(self._wal.fileno())
        self.epochs_logged += 1

    def log_epoch(self, epoch: int, records, soft_clears, touches,
                  manifest: dict | None = None) -> None:
        """Make one epoch's ops durable (write, flush, fsync). The
        ``wal_write`` fault site fires before the write. ``manifest`` rides
        in the same frame, so store and engine state are durable
        together."""
        if self.fault_plan is not None:
            self.fault_plan.fire("wal_write", epoch=epoch)
        host_records = [(now, _host(emb), _host(g).astype(np.int32),
                         bool(hg), bool(hard))
                        for now, emb, g, hg, hard in records]
        self._append({"epoch": int(epoch), "records": host_records,
                      "soft_clears": list(soft_clears),
                      "touches": list(touches), "manifest": manifest})

    def log_checkpoint(self, epoch: int, manifest: dict) -> None:
        """Journal a manifest-only record as of the current epoch (clean
        shutdown): replay takes the manifest and applies nothing."""
        self._append({"epoch": int(epoch), "checkpoint": True,
                      "manifest": manifest})

    def maybe_snapshot(self, state, buffer: CommitBuffer,
                       manifest: dict | None = None) -> None:
        if buffer.epoch % self.snapshot_every == 0:
            self.snapshot(state, buffer, manifest)

    def snapshot(self, state, buffer: CommitBuffer,
                 manifest: dict | None = None) -> None:
        """Snapshot the store and the buffer counters atomically, then
        truncate the WAL. The manifest lands first (tmpfile +
        ``os.replace``): dying between the two leaves the WAL's own
        manifests covering every epoch past the snapshot."""
        if manifest is not None:
            tmp = self.manifest_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump({"epoch": int(buffer.epoch),
                             "manifest": manifest}, f, protocol=4)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.manifest_path)
        save_checkpoint(self.snap_path, {
            "state": _state_tree(state),
            "meta": np.asarray([buffer.epoch, buffer.entries_applied],
                               np.int64)})
        self._wal.close()
        self._wal = open(self.wal_path, "wb")   # truncate
        self._wal.flush()
        os.fsync(self._wal.fileno())
        self.snapshots += 1

    def close(self) -> None:
        if not self._wal.closed:
            self._wal.close()

    def stats(self) -> dict:
        return {"epochs_logged": self.epochs_logged,
                "snapshots": self.snapshots}

    @staticmethod
    def recover(path: str, mem_cfg: MemoryConfig, device="cuda"):
        """Rebuild the store from ``path`` on ``device`` after a crash.

        Returns ``(state, epoch, entries_applied, manifest)`` (the newest
        manifest consistent with the recovered store, None if none was
        journaled), or None for a fresh directory. Replays every complete
        WAL record newer than the snapshot, in file order."""
        dev = resolve_device(device)
        snap_path = os.path.join(path, "snapshot.npz")
        wal_path = os.path.join(path, "wal.log")
        man_path = os.path.join(path, "manifest.pkl")
        have_snap = os.path.exists(snap_path)
        have_wal = os.path.exists(wal_path) and \
            os.path.getsize(wal_path) > 0
        if not have_snap and not have_wal:
            return None
        manifest = None
        if have_snap:
            tree = load_checkpoint(snap_path, device=dev)
            st = tree["state"]
            state = MemoryState(emb=st["emb"], mask=st["mask"],
                                guide=st["guide"], hard=st["hard"],
                                added_at=st["added_at"],
                                ptr=int(st["ptr"]))
            epoch, entries = (int(x) for x in tree["meta"].tolist())
            if os.path.exists(man_path):
                with open(man_path, "rb") as f:
                    manifest = pickle.load(f)["manifest"]
        else:
            state, epoch, entries = init_memory(mem_cfg, device=dev), 0, 0
        replay = CommitBuffer()
        replay.epoch, replay.entries_applied = epoch, entries
        for rec in MemoryJournal._read_records(wal_path):
            if rec.get("checkpoint"):
                if rec["epoch"] >= replay.epoch:
                    manifest = rec["manifest"]
                continue                      # manifest only, no ops
            if rec["epoch"] <= epoch:
                continue                      # the snapshot covers it
            state, _ = replay.apply_ops(state, rec["records"],
                                        rec["soft_clears"], rec["touches"])
            replay.epoch = rec["epoch"]
            if rec.get("manifest") is not None:
                manifest = rec["manifest"]
        return state, replay.epoch, replay.entries_applied, manifest


# ---------------------------------------------------------------------------
# Commit stream: the serve/learn interface around the commit buffer
# ---------------------------------------------------------------------------


class CommitStream:
    """The serve/learn commit interface: one :class:`CommitBuffer`, the
    lock that serializes applies against snapshot reads, the single host
    counter of committed entries, and the subscribed controller views
    that receive every applied store.

    With a :class:`MemoryJournal` the stream is crash-consistent: each
    epoch is journaled (write-ahead, fsynced) before its apply, with the
    ``state_provider``'s engine-state manifest in the same frame, and the
    store is snapshotted periodically. A fault plan fires at the
    ``wal_write`` / ``commit_apply`` boundary."""

    def __init__(self, buffer: CommitBuffer | None = None, *,
                 journal: MemoryJournal | None = None, fault_plan=None):
        self.buffer = buffer if buffer is not None else CommitBuffer()
        self.lock = StoreLock()
        self.commits = 0
        self._views: list = []
        self.journal = journal
        self.fault_plan = fault_plan
        # engine-state exporter (set by the owning controller), called
        # under the lock right before an epoch is journaled
        self.state_provider = None
        # per-epoch ops tap: called under the lock after each apply with
        # (epoch, records, soft_clears, touches, entries)
        self.ops_listener = None
        # metrics registry (set by the owning fabric): applied epochs and
        # entries and the current epoch, host numbers bumped under the lock
        self.metrics = None

    def subscribe(self, view) -> None:
        if view not in self._views:
            self._views.append(view)
            view.commit_epoch_seen = self.buffer.epoch

    def count(self, n: int = 1) -> None:
        with self.lock:
            self.commits += n

    def apply(self, state):
        """Apply the staged epoch and broadcast the store to every view
        under one lock hold; with a journal, the epoch is durable before
        the apply and the ``commit_apply`` fault site fires between the
        two. The write ends with :func:`settle` before the lock is
        released. Returns the store."""
        with self.lock:
            if not self.buffer.pending:
                return state
            records, soft_clears, touches = self.buffer.take_ops()
            epoch = self.buffer.epoch + 1
            manifest = None
            if self.journal is not None:
                if self.state_provider is not None:
                    manifest = self.state_provider()
                self.journal.log_epoch(epoch, records, soft_clears,
                                       touches, manifest)
            if self.fault_plan is not None:
                self.fault_plan.fire("commit_apply", epoch=epoch)
            state, n = self.buffer.apply_ops(state, records, soft_clears,
                                             touches)
            settle(state)
            self.commits += n
            for v in self._views:
                v.memory = state
                v.commit_epoch_seen = self.buffer.epoch
            if self.ops_listener is not None:
                self.ops_listener(epoch, records, soft_clears, touches, n)
            if self.metrics is not None:
                with self.metrics.lock:
                    self.metrics.counter("commit/epochs_applied").inc()
                    self.metrics.counter("commit/entries_applied").inc(n)
                    self.metrics.gauge("commit/epoch").set(
                        self.buffer.epoch)
            if self.journal is not None:
                self.journal.maybe_snapshot(state, self.buffer, manifest)
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
            settle(state)
            for v in self._views:
                v.memory = state
                if hasattr(v, "_ptr_base"):
                    v._ptr_base = state.ptr - self.commits
            return state, remap

    def checkpoint(self) -> None:
        """Journal a manifest-only record at the current epoch (clean
        shutdown); a no-op without a journal or a state provider."""
        with self.lock:
            if self.journal is None or self.state_provider is None:
                return
            self.journal.log_checkpoint(self.buffer.epoch,
                                        self.state_provider())

    def commit_direct(self, state, *, record=None, soft_clear=None,
                      touch_op=None):
        """Commit the sequential controller's per-request write as one
        single-op epoch through the journaled path. ``record`` is a
        ``stage_add`` tuple ``(emb, guide, has_guide, hard, now)``;
        ``soft_clear``/``touch_op`` are ``(index, now, ptr_snapshot)``.
        Returns the store."""
        with self.lock:
            if record is not None:
                self.buffer.stage_add(*record)
            if soft_clear is not None:
                self.buffer.stage_soft_clear(*soft_clear)
            if touch_op is not None:
                self.buffer.stage_touch(*touch_op)
            return self.apply(state)


def open_journaled_stream(path: str, mem_cfg: MemoryConfig, *,
                          snapshot_every: int = 8, fault_plan=None,
                          device="cuda"):
    """Open (or re-open after a crash) a journaled commit stream at
    ``path``. Returns ``(stream, recovered_state, manifest)``, both None
    for a fresh directory; the recovered store lives on ``device`` and the
    buffer counters resume from the recovered epoch."""
    recovered = MemoryJournal.recover(path, mem_cfg, device=device)
    journal = MemoryJournal(path, snapshot_every=snapshot_every,
                            fault_plan=fault_plan)
    stream = CommitStream(journal=journal, fault_plan=fault_plan)
    state, manifest = None, None
    if recovered is not None:
        state, epoch, entries, manifest = recovered
        stream.buffer.epoch = epoch
        stream.buffer.entries_applied = entries
    return stream, state, manifest
