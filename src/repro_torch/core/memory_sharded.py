"""Sharded skill/guide memory: the counterpart of
``src/repro/core/memory_sharded.py``, the (C, E) ring split into S row
shards.

Logical ring slots [0, C) are split into S shards, shard *s* owning slots
[s·Cs, (s+1)·Cs) with Cs = C/S. The shards live on one device, as the
global layout of the JAX package's row-sharded array: one (S·Csp, Ep) f32
``emb`` and one (S·Csp, 1) int32 ``mask``, shard *s* holding physical rows
[s·Csp, (s+1)·Csp) with Csp = ``padded_rows(Cs)``, in the single-device
store's padded kernel layout. So ring slot *g* lives at physical row
(g // Cs)·Csp + g % Cs, and a shard's rows are a zero-copy slice that the
store-read kernels take as they take a whole :class:`MemoryState`.
Per-entry metadata that never feeds a kernel (``guide``, ``hard``,
``added_at``) is one (C, ...) tensor each, as JAX keeps it replicated; the
ring pointer ``ptr`` is a host int, as in the port's ``MemoryState``.

Reads run the top-1 or top-k kernel once a shard (S launches) and combine
the S partial results in plain torch, as the JAX package combines them in
plain jnp outside any kernel body:

* top-1: the first maximum over the shards, so a tie across shards goes to
  the lowest shard; with the kernel's lowest-row tie-break inside a shard
  that is the lowest global row, the single-device result;
* top-k: the S·k (sim, global row) candidates re-selected by
  :func:`~repro_torch.kernels.memory_topk._topk_select`, the (sim desc,
  row asc) order of every store read. ``k`` is capped at Cs, so a shard
  never hands in one of its padding rows, whose global row would be the
  next shard's.

The winners' mask bits are read at their physical rows. One shard is the
store itself: its read is returned as it is, with no merge.

Every dot is summed in the card's order on either device, and a row's dot
does not depend on where the row sits, so every read is bit-identical to
the single-device store's read after the same commits, ties included
(``tests/test_torch_memory_sharded.py``, :func:`parity_selftest`).

Writes are in place, as the port's ``MemoryState``'s: a commit scatters
its padded rows and mask bits once (at the slots' physical rows) and each
metadata field once (at the slots), and makes no tensor the store keeps,
so a commit on the async drainer's side stream has nothing to
:func:`~repro_torch.core.memory.publish`. The ``core.memory`` functions,
the commit buffer, the store lock and :func:`~repro_torch.core.memory.
settle` take this store as they take an IVF-wrapped one.

Run ``python -m repro_torch.core.memory_sharded [--device cpu]`` for the
parity self-test.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import memory as mem
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.memory_ivf import phys_rows
from repro_torch.kernels.memory_topk import (MASK_GUIDE, MASK_VALID,
                                             _topk_select, pack_meta_parts,
                                             padded_lanes, padded_rows)


class ShardedMemory:
    """Row-sharded ring store with the single-device store's API
    (``shards`` logical shards on ``device``)."""

    def __init__(self, cfg: mem.MemoryConfig, shards: int = 1,
                 device="cuda"):
        if shards < 1:
            raise ValueError(f"shards={shards} must be >= 1")
        if cfg.capacity % shards:
            raise ValueError(f"capacity {cfg.capacity} not divisible by "
                             f"{shards} shards")
        dev = resolve_device(device)
        self.cfg = cfg
        self.shards = int(shards)
        self.cs = cfg.capacity // self.shards        # logical rows a shard
        self.csp = padded_rows(self.cs)              # physical rows a shard
        self.ep = padded_lanes(cfg.embed_dim)
        S, C, G = self.shards, cfg.capacity, cfg.guide_len
        self.emb = torch.zeros((S * self.csp, self.ep), dtype=torch.float32,
                               device=dev)
        self.mask = torch.zeros((S * self.csp, 1), dtype=torch.int32,
                                device=dev)
        self.guide = torch.zeros((C, G), dtype=torch.int32, device=dev)
        self.hard = torch.zeros((C,), dtype=torch.bool, device=dev)
        self.added_at = torch.zeros((C,), dtype=torch.int32, device=dev)
        self.ptr = 0

    # -- occupancy and views --------------------------------------------
    @property
    def capacity(self) -> int:
        return self.cfg.capacity

    @property
    def device(self) -> torch.device:
        return self.emb.device

    @property
    def size_fast(self) -> int:
        return min(self.ptr, self.capacity)

    def _logical(self, x: torch.Tensor) -> torch.Tensor:
        """The C logical rows of a physical (S·Csp, ...) tensor, in slot
        order."""
        S, cs, csp = self.shards, self.cs, self.csp
        return x.view((S, csp) + x.shape[1:])[:, :cs].reshape(
            (S * cs,) + x.shape[1:])

    def logical_rows(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(C, Ep) rows and (C,) mask bits in slot order (one copy each)."""
        return self._logical(self.emb), self._logical(self.mask)[:, 0]

    @property
    def valid(self) -> torch.Tensor:
        return (self.logical_rows()[1] & MASK_VALID) != 0

    @property
    def has_guide(self) -> torch.Tensor:
        return (self.logical_rows()[1] & MASK_GUIDE) != 0

    def _reads(self, read, q, *rest) -> list:
        """``read(rows, q, mask, *rest)`` (a store-read op) on each shard's
        rows, in shard order."""
        return [read(self.emb[lo:lo + self.csp], q,
                     self.mask[lo:lo + self.csp], *rest)
                for lo in range(0, self.shards * self.csp, self.csp)]

    def _result(self, cls, sim, idx):
        """The packed result of global rows ``idx``: their mask bits at
        their physical rows, the metadata at the rows."""
        bits = self.mask[phys_rows(idx.long(), self.cs, self.csp), 0]
        return cls(sim=sim, meta=pack_meta_parts(idx, bits, self.hard,
                                                 self.added_at, self.guide))

    # -- reads ----------------------------------------------------------
    def _top1(self, read, q, guides_only: bool) -> mem.QueryResult:
        parts = self._reads(read, q, mem.required_bits(guides_only))
        if self.shards == 1:                  # the shard is the store
            return self._result(mem.QueryResult, *parts[0])
        sims = torch.stack([p[0] for p in parts])             # (S, ...)
        local = torch.stack([p[1] for p in parts])
        best = torch.argmax(sims, dim=0, keepdim=True)  # first max: lowest s
        idx = best[0] * self.cs + local.gather(0, best)[0]
        return self._result(mem.QueryResult, sims.gather(0, best)[0], idx)

    def query(self, emb, guides_only: bool = False) -> mem.QueryResult:
        """Top-1 for one query: the top-1 kernel on each shard, the first
        maximum over the shards."""
        return self._top1(kops.memory_top1_padded,
                          mem._on(self, emb, torch.float32), guides_only)

    def query_batch(self, embs, guides_only: bool = False
                    ) -> mem.QueryResult:
        return self._top1(kops.memory_top1_batch_padded,
                          mem._on(self, embs, torch.float32), guides_only)

    def _check_topk(self, k: int) -> None:
        mem._check_k(k, self.capacity)
        if k > self.cs:
            # each shard must supply k real (non-padding) local rows, so
            # the merge never sees a local padding row, whose global slot
            # number would collide with the next shard's
            raise ValueError(f"retrieval k={k} exceeds the {self.cs} "
                             f"logical rows per shard ({self.shards} "
                             f"shards over capacity {self.capacity})")

    def _topk(self, read, q, k: int, guides_only: bool) -> mem.TopKResult:
        self._check_topk(k)
        parts = self._reads(read, q, k, mem.required_bits(guides_only))
        if self.shards == 1:                  # the shard is the store
            return self._result(mem.TopKResult, *parts[0])
        # the S·k candidates on the leading axis, as _topk_select takes them
        sims = torch.cat([p[0] for p in parts], dim=-1).movedim(-1, 0)
        local = torch.cat([p[1] for p in parts], dim=-1).movedim(-1, 0)
        shard = torch.arange(self.shards * k, device=self.device) // k
        rows = shard.view((-1,) + (1,) * (local.dim() - 1)) * self.cs + local
        out_s, out_r = _topk_select(sims, rows, k)            # (k, ...)
        return self._result(mem.TopKResult, out_s.movedim(0, -1).contiguous(),
                            out_r.movedim(0, -1))

    def query_topk(self, emb, k: int,
                   guides_only: bool = False) -> mem.TopKResult:
        """Top-k for one query: the top-k kernel on each shard, then the
        merge of the S·k candidates."""
        return self._topk(kops.memory_topk_padded,
                          mem._on(self, emb, torch.float32), k, guides_only)

    def query_topk_batch(self, embs, k: int,
                         guides_only: bool = False) -> mem.TopKResult:
        return self._topk(kops.memory_topk_batch_padded,
                          mem._on(self, embs, torch.float32), k, guides_only)

    # -- writes (in place) ----------------------------------------------
    def add(self, emb, guide, has_guide, hard, now) -> None:
        self.add_batch(torch.as_tensor(emb)[None],
                       torch.as_tensor(guide)[None],
                       torch.as_tensor(has_guide).reshape(1),
                       torch.as_tensor(hard).reshape(1),
                       torch.as_tensor(now).reshape(1))

    def add_batch(self, embs, guides, has_guide, hard, now) -> None:
        """Microbatch commit at consecutive ring slots (FIFO), the
        semantics of :func:`repro_torch.core.memory.add_batch`: one scatter
        of the padded rows and mask bits, one of each metadata field."""
        embs = mem._on(self, embs, torch.float32)
        K, C = embs.shape[0], self.capacity
        if K > C:
            raise ValueError(f"microbatch commit of {K} entries exceeds "
                             f"memory capacity {C}")
        slots = (self.ptr + torch.arange(K, device=self.device)) % C
        phys = phys_rows(slots, self.cs, self.csp)
        self.emb[phys] = F.pad(embs, (0, self.ep - embs.shape[1]))
        self.mask[phys, 0] = MASK_VALID + MASK_GUIDE * mem._on(
            self, has_guide, torch.int32)
        self.guide[slots] = mem._on(self, guides, torch.int32)
        self.hard[slots] = mem._on(self, hard, torch.bool)
        self.added_at[slots] = mem._on(self, now, torch.int32)
        self.ptr += K

    def mark_soft(self, index) -> None:
        self.hard[mem._on(self, index, torch.int64)] = False

    def touch(self, index, now) -> None:
        self.added_at[mem._on(self, index, torch.int64)] = mem._on(
            self, now, torch.int32)

    # -- debug / parity -------------------------------------------------
    def debug_size(self) -> int:
        """Occupancy from the mask bits: a device sync, for tests only
        (hot paths use :attr:`size_fast`)."""
        return int(((self.mask[:, 0] & MASK_VALID) != 0).sum())

    def to_single_device(self) -> mem.MemoryState:
        """The same store as a :class:`~repro_torch.core.memory.
        MemoryState` on this device (tests, checkpoints)."""
        C = self.capacity
        state = mem.init_memory(self.cfg, device=self.device)
        emb, bits = self.logical_rows()
        state.emb[:C] = emb
        state.mask[:C, 0] = bits
        state.guide.copy_(self.guide)
        state.hard.copy_(self.hard)
        state.added_at.copy_(self.added_at)
        state.ptr = self.ptr
        mem.publish(state.emb, state.mask, state.guide, state.hard,
                    state.added_at)
        return state


# ---------------------------------------------------------------------------
# Parity self-test
# ---------------------------------------------------------------------------


def _same(a, b, what) -> int:
    a, b = a.device_get(), b.device_get()
    if not (torch.equal(torch.from_numpy(a.sim).view(torch.int32),
                        torch.from_numpy(b.sim).view(torch.int32))
            and (a.meta == b.meta).all()):
        raise AssertionError(f"sharded read differs from the single-device "
                             f"read: {what}")
    return a.sim.size


def parity_selftest(capacity: int = 64, embed_dim: int = 16,
                    guide_len: int = 4, n_commits: int = 6,
                    n_queries: int = 16, seed: int = 0, shards: int = 4,
                    device="cuda") -> dict:
    """Drive a single-device :class:`MemoryState` and a ShardedMemory
    through the same commit stream (wraparound, duplicate rows in
    different shards for the tie-breaks) and require every read, in both
    mask views, to be bit-identical: ``query``, ``query_batch``,
    ``query_topk`` and ``query_topk_batch`` at every k in (1, 2, 4, 8) up
    to Cs, sims by their bits and the whole packed meta. Every other
    commit wave goes through :class:`~repro_torch.core.memory.
    CommitBuffer` (staged in a shuffled order, with flag updates and a
    duplicate touch target). Returns a summary dict."""
    import numpy as np

    cfg = mem.MemoryConfig(capacity=capacity, embed_dim=embed_dim,
                           guide_len=guide_len)
    rng = np.random.default_rng(seed)
    single = mem.init_memory(cfg, device=device)
    sharded = ShardedMemory(cfg, shards=shards, device=device)
    cs = sharded.cs
    topks = [k for k in (1, 2, 4, 8) if k <= cs]
    checks = deferred_epochs = 0
    for step in range(n_commits):
        K = int(rng.integers(1, max(2, capacity // 2)))
        embs = rng.normal(size=(K, embed_dim)).astype(np.float32)
        embs /= np.linalg.norm(embs, axis=1, keepdims=True)
        if K > 3:
            embs[2] = embs[0]          # exact duplicate -> tie-break path
        if K > cs:
            embs[cs] = embs[0]         # ... and one in the next shard
        guides = rng.integers(0, 50, size=(K, guide_len)).astype(np.int32)
        hg = rng.random(K) < 0.5
        hd = rng.random(K) < 0.3
        now = (np.arange(K) + step * capacity).astype(np.int32)
        if step % 2:
            order = rng.permutation(K)
            stores = [single, sharded]
            for i, store in enumerate(stores):
                buf = mem.CommitBuffer()
                for j in order:
                    buf.stage_add(embs[j], guides[j], bool(hg[j]),
                                  bool(hd[j]), int(now[j]))
                t = int(now[-1])
                buf.stage_touch(0, t + 1)
                buf.stage_touch(0, t + 2)      # duplicate: later now wins
                buf.stage_soft_clear(1, t + 1)
                stores[i], n = buf.apply(store)
                assert n == K and buf.epoch == 1 and buf.pending == 0
            single, sharded = stores
            deferred_epochs += 1
        else:
            mem.add_batch(single, embs, guides, hg, hd, now)
            mem.add_batch(sharded, embs, guides, hg, hd, now)

        qs = rng.normal(size=(n_queries, embed_dim)).astype(np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        qs[0] = embs[0]                # an exact stored row (duplicated)
        for g in (False, True):
            checks += _same(mem.query_batch(single, qs, guides_only=g),
                            mem.query_batch(sharded, qs, guides_only=g),
                            f"query_batch step {step}")
            checks += _same(mem.query(single, qs[0], guides_only=g),
                            mem.query(sharded, qs[0], guides_only=g),
                            f"query step {step}")
            for k in topks:
                checks += _same(
                    mem.query_topk_batch(single, qs, k, guides_only=g),
                    mem.query_topk_batch(sharded, qs, k, guides_only=g),
                    f"query_topk_batch step {step} k={k}")
                checks += _same(
                    mem.query_topk(single, qs[0], k, guides_only=g),
                    mem.query_topk(sharded, qs[0], k, guides_only=g),
                    f"query_topk step {step} k={k}")
    assert sharded.size_fast == single.size_fast
    assert sharded.debug_size() == int(single.valid.sum())
    assert deferred_epochs > 0, "the deferred-commit sweep never ran"
    return {"shards": sharded.shards, "capacity": capacity,
            "device": str(sharded.device), "checks": checks,
            "topk_checked": topks, "deferred_commit_epochs": deferred_epochs,
            "bit_identical": True}


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(description=parity_selftest.__doc__)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    print(json.dumps(parity_selftest(shards=args.shards,
                                     device=args.device)))
