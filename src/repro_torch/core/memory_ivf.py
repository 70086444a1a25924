"""IVF two-level retrieval plane, the counterpart of
``src/repro/core/memory_ivf.py`` over the single-device store.

The exact store scan (:mod:`repro_torch.core.memory`) touches all C rows
per query. :class:`IVFMemory` keeps an inverted-file index over the same
store and reads in two levels:

1. **Route**: score the queries against the P cluster centroids (the
   ``ivf_route`` kernel on the card; the centroid plane in the store's
   padded layout) and keep the top ``probes`` clusters under the
   (score desc, row asc) order.
2. **Scan**: read only the probed clusters' member rows. The
   single-query read gathers them sorted by slot and runs the top-k kernel
   over the small gathered buffer, so its lowest-row tie-break is the
   global (sim desc, slot asc) order; the batch read is the ``ivf_scan``
   kernel on the card (one launch for the batch, each kept row read by
   slot), which selects over each query's candidates keyed by slot, as its
   plain version does with the top-k rounds. Both sum every dot in the
   card's order, so a row's sim is the exact scan's, bit for bit.

Probing all clusters reproduces the exact scan on every valid entry; the
exact scan stays the default (``RARConfig.retrieval_clusters = 0``
constructs no wrapper) and the recall oracle (:meth:`exact_query_topk`).

The index (online k-means on add, FIFO member buckets, the
``assign[slot] == cluster`` re-check that drops stale members, full
:meth:`IVFMemory.reindex`) is host numpy, the same code as the JAX
package's, so cluster assignments are identical on the same op sequence;
device mirrors refresh lazily before the next read. With ``offload=True``
a host mirror of the rows serves the clusters not routed to within the
last ``cold_after`` queries (single-query reads).

Not ported: the sharded backing store (its per-shard centroid subsets);
a store other than a :class:`~repro_torch.core.memory.MemoryState` is
refused.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import memory as mem
from repro_torch.kernels import ops as kops
from repro_torch.kernels.memory_ivf import gather_candidates, global_cids
from repro_torch.kernels.memory_topk import MASK_VALID, _round_up, padded_rows

_SENTINEL = 2 ** 30


# ---------------------------------------------------------------------------
# Read path
# ---------------------------------------------------------------------------


def _scan_sorted(store, slots_s, rows, bits, q, k: int, required: int
                 ) -> mem.TopKResult:
    """Level 2 of a single-query read over slot-sorted candidates: the
    top-k kernel over the gathered (Lp, Ep) buffer, then the packed meta
    of the winners' global slots."""
    C = store.capacity
    L = slots_s.shape[0]
    Lp = padded_rows(L)
    dev = store.device
    gmem = torch.zeros((Lp, store.emb.shape[1]), dtype=torch.float32,
                       device=dev)
    gmem[:L] = rows
    gmask = torch.zeros((Lp, 1), dtype=torch.int32, device=dev)
    gmask[:L, 0] = bits
    sims, lidx = kops.memory_topk_padded(gmem, q, gmask, k, required)
    li = lidx.long().clamp(0, L - 1)
    gidx = slots_s[li].clamp(0, C - 1)
    return mem.TopKResult(sim=sims, meta=mem.pack_meta_parts(
        gidx, gmask[li, 0], store.hard, store.added_at, store.guide))


def _ivf_topk(plane, members, assign, store, q, k: int, n_probe: int,
              required: int) -> mem.TopKResult:
    """Single-query read: route, gather, sort by slot (stable: the order
    of the dropped candidates decides the meta of -2.0 slots), scan."""
    cent, cmask, cidmap = plane
    C = store.capacity
    scores, cids = kops.ivf_route_padded(cent, q, cmask, n_probe,
                                         MASK_VALID)
    slots, ok = gather_candidates(members, assign, scores,
                                  global_cids(cids, cidmap))
    order = torch.argsort(torch.where(ok, slots, _SENTINEL), stable=True)
    slots_s, ok_s = slots[order], ok[order]
    phys = slots_s.long().clamp(0, C - 1)
    rows = torch.where(ok_s[:, None], store.emb[phys], 0.0)
    bits = torch.where(ok_s, store.mask[phys, 0], 0)
    return _scan_sorted(store, slots_s, rows, bits, q, k, required)


def _ivf_topk_batch(plane, members, assign, store, qs, k: int, n_probe: int,
                    required: int) -> mem.TopKResult:
    """Multi-query read: the route, then the candidate read and its
    packed-meta epilogue (one ``ivf_scan`` launch on the card; on the CPU
    its plain version, whose memory is O(B * L * Ep), so the caller chunks
    B there)."""
    cent, cmask, cidmap = plane
    scores, cids = kops.ivf_route_batch_padded(cent, qs, cmask, n_probe,
                                               MASK_VALID)
    return mem.TopKResult(*kops.ivf_scan_batch(
        scores, cids, cidmap, members, assign, store.emb, store.mask,
        store.hard, store.added_at, store.guide, qs, k, required))


# ---------------------------------------------------------------------------
# The store wrapper
# ---------------------------------------------------------------------------


class IVFMemory:
    """IVF wrapper around a :class:`~repro_torch.core.memory.MemoryState`,
    presenting the store method API, so the ``core.memory`` functions, the
    commit buffer and the controllers work against it unchanged. Reads go
    through the two-level path; writes update the backing store in place
    and the cluster index incrementally. The backing store stays the exact
    oracle (:meth:`exact_query_topk`)."""

    def __init__(self, store, *, clusters: int, probes: int = 4,
                 bucket_cap: int | None = None, offload: bool = False,
                 cold_after: int = 1024):
        if isinstance(store, IVFMemory):
            raise TypeError("backing store is already IVF-wrapped")
        if not isinstance(store, mem.MemoryState):
            raise TypeError(f"IVFMemory wraps a single-device MemoryState, "
                            f"got {type(store).__name__}: the sharded "
                            f"backing store is not ported (ROADMAP queue 1 "
                            f"item 10)")
        C = store.capacity
        if not 2 <= clusters <= C:
            raise ValueError(f"retrieval_clusters={clusters} must be in "
                             f"[2, capacity={C}]")
        if not 1 <= probes <= clusters:
            raise ValueError(f"retrieval_probes={probes} must be in "
                             f"[1, clusters={clusters}]")
        self.store = store
        self.clusters = int(clusters)
        self.probes = int(probes)
        self._ep = store.emb.shape[1]
        if bucket_cap is None:
            # ~4x the average cluster occupancy of a full ring: skewed
            # clusters overflow (FIFO bucket eviction) only past that
            bucket_cap = max(8, math.ceil(4 * C / self.clusters))
        self.bucket_cap = _round_up(int(bucket_cap), 8)
        self.offload = bool(offload)
        self.cold_after = int(cold_after)
        self._ptr_host = store.ptr
        # host index state (numpy; mutated on the learn path only)
        self._cent = np.zeros((self.clusters, self._ep), np.float32)
        self._csum = np.zeros((self.clusters, self._ep), np.float32)
        self._ccount = np.zeros(self.clusters, np.int64)
        self._seeded = 0
        self._assign = np.full(C, -1, np.int32)
        self._members = np.full((self.clusters, self.bucket_cap), -1,
                                np.int32)
        self._mptr = np.zeros(self.clusters, np.int64)
        if self.offload:
            self._emb_host = np.zeros((C, self._ep), np.float32)
            self._bits_host = np.zeros(C, np.int32)
            self._last_probe = np.zeros(self.clusters, np.int64)
            self._tier_hot = np.ones(self.clusters, bool)
        # stats (host counters, no device syncs)
        self.bucket_evictions = 0
        self.reindexes = 0
        self.host_fetch_rows = 0
        self.device_fetch_rows = 0
        self._qcount = 0
        self._dirty = True
        self._plane = None
        self._members_dev = None
        self._assign_dev = None
        if self._ptr_host:
            self.reindex()

    # -- delegation -----------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.store.capacity

    @property
    def device(self) -> torch.device:
        return self.store.device

    @property
    def guide(self):
        return self.store.guide

    @property
    def hard(self):
        return self.store.hard

    @property
    def added_at(self):
        return self.store.added_at

    @property
    def valid(self):
        return self.store.valid

    @property
    def has_guide(self):
        return self.store.has_guide

    @property
    def ptr(self) -> int:
        return self.store.ptr

    @property
    def size_fast(self) -> int:
        return min(self._ptr_host, self.capacity)

    # -- index maintenance ----------------------------------------------
    def _ivf_add(self, X: np.ndarray, slots: np.ndarray) -> None:
        """Online k-means + bucket update for K new rows landing at ring
        ``slots``. Assignment scores use the batch-start centroids
        (minibatch k-means); centroid running means update sequentially."""
        P, M = self.clusters, self.bucket_cap
        nearest = (np.argmax(X @ self._cent.T, axis=1)
                   if self._seeded == P else None)
        for j in range(X.shape[0]):
            slot = int(slots[j])
            x = X[j]
            if self._seeded < P:
                c = self._seeded        # round-robin seeding
                self._seeded += 1
            elif nearest is not None:
                c = int(nearest[j])
            else:
                c = int(np.argmax(self._cent[:self._seeded] @ x))
            self._csum[c] += x
            self._ccount[c] += 1
            m = self._csum[c] / self._ccount[c]
            n = float(np.linalg.norm(m))
            self._cent[c] = m / n if n > 0.0 else m
            prev = int(self._assign[slot])
            if prev >= 0:               # ring overwrite: unbucket first
                b = self._members[prev]
                b[b == slot] = -1
            row = self._members[c]
            pos = int(self._mptr[c]) % M
            old = int(row[pos])
            if old >= 0 and old != slot:
                self._assign[old] = -1  # bucket overflow: evict oldest
                self.bucket_evictions += 1
            row[pos] = slot
            self._mptr[c] += 1
            self._assign[slot] = c
        self._dirty = True

    def reindex(self) -> None:
        """Rebuild the whole index from the backing store: k-means
        (round-robin seeding from the oldest valid rows, two refinement
        sweeps once fully seeded) and buckets keeping each cluster's newest
        ``bucket_cap`` members. One bulk store transfer, at attach and grow
        time."""
        C, P, M = self.capacity, self.clusters, self.bucket_cap
        st = self.store
        emb = st.emb[:C].cpu().numpy().astype(np.float32)
        bits = st.mask[:C, 0].cpu().numpy().astype(np.int32)
        if self.offload:
            self._emb_host[:] = emb
            self._bits_host[:] = bits
        self._assign = np.full(C, -1, np.int32)
        self._members = np.full((P, M), -1, np.int32)
        self._mptr = np.zeros(P, np.int64)
        self._csum = np.zeros((P, self._ep), np.float32)
        self._ccount = np.zeros(P, np.int64)
        self._cent = np.zeros((P, self._ep), np.float32)
        self.reindexes += 1
        self._dirty = True
        slot = np.arange(C)
        vs = slot[(bits & MASK_VALID) != 0]
        if not len(vs):
            self._seeded = 0
            return
        ptr = self._ptr_host
        age = slot if ptr <= C else (slot - ptr) % C
        vs = vs[np.argsort(age[vs], kind="stable")]          # oldest first
        X = emb[vs]
        self._seeded = min(P, len(vs))
        s = self._seeded
        cent = X[:s].copy()
        a = np.zeros(len(vs), np.int64)
        sweeps = 2 if s == P else 1
        for _ in range(sweeps + 1):
            a = np.argmax(X @ cent.T, axis=1)
            csum = np.zeros((s, self._ep), np.float32)
            np.add.at(csum, a, X)
            cc = np.bincount(a, minlength=s)
            nz = cc > 0
            cent[nz] = csum[nz] / cc[nz, None]
            norms = np.linalg.norm(cent, axis=1)
            cent[norms > 0] /= norms[norms > 0, None]
        self._cent[:s] = cent
        self._csum[:s] = csum
        self._ccount[:s] = cc
        for c in range(s):
            ms = vs[a == c]                                  # oldest first
            if len(ms) > M:
                self.bucket_evictions += len(ms) - M
                ms = ms[-M:]
            self._members[c, :len(ms)] = ms
            self._mptr[c] = len(ms)
            self._assign[ms] = c

    def _refresh(self) -> None:
        """Lazy upload of the device mirrors: the centroid plane in the
        padded kernel layout and the member/assign tables. O(P * Ep +
        P * M) once per index mutation, off the per-query path."""
        if not self._dirty:
            return
        P, Ep, dev = self.clusters, self._ep, self.device
        pp = padded_rows(P)
        cent = np.zeros((pp, Ep), np.float32)
        cent[:P] = self._cent
        cm = np.zeros((pp, 1), np.int32)
        cm[:P, 0] = np.where(self._ccount > 0, MASK_VALID, 0)
        self._plane = (torch.from_numpy(cent).to(dev),
                       torch.from_numpy(cm).to(dev),
                       torch.arange(P, dtype=torch.int32, device=dev))
        self._members_dev = torch.from_numpy(self._members).to(dev)
        self._assign_dev = torch.from_numpy(self._assign).to(dev)
        self._dirty = False

    # -- reads ----------------------------------------------------------
    def _check_topk(self, k: int) -> None:
        mem._check_k(k, self.capacity)
        budget = self.probes * self.bucket_cap
        if k > budget:
            raise ValueError(f"retrieval k={k} exceeds the probed "
                             f"candidate budget {budget} "
                             f"({self.probes} probes x {self.bucket_cap} "
                             f"bucket rows); raise probes or bucket_cap")

    def _queries(self, x) -> torch.Tensor:
        return mem._on(self.store, x, torch.float32)

    def query_topk(self, emb, k: int,
                   guides_only: bool = False) -> mem.TopKResult:
        self._check_topk(k)
        self._refresh()
        if self.offload:
            return self._query_topk_tiered(emb, k, guides_only)
        self._qcount += 1
        return _ivf_topk(self._plane, self._members_dev, self._assign_dev,
                         self.store, self._queries(emb), k, self.probes,
                         mem.required_bits(guides_only))

    def query_topk_batch(self, embs, k: int, guides_only: bool = False,
                         _chunk: int = 8) -> mem.TopKResult:
        """One read for the whole batch on the card; chunks of ``_chunk``
        queries on the CPU, whose plain candidate read gathers the rows."""
        self._check_topk(k)
        self._refresh()
        qs = self._queries(embs)
        B = qs.shape[0]
        self._qcount += B
        if self.device.type == "cuda":
            _chunk = B
        outs = [_ivf_topk_batch(self._plane, self._members_dev,
                                self._assign_dev, self.store,
                                qs[i:i + _chunk], k, self.probes,
                                mem.required_bits(guides_only))
                for i in range(0, B, _chunk)]
        if len(outs) == 1:
            return outs[0]
        return mem.TopKResult(sim=torch.cat([o.sim for o in outs]),
                              meta=torch.cat([o.meta for o in outs]))

    def query(self, emb, guides_only: bool = False) -> mem.QueryResult:
        r = self.query_topk(emb, 1, guides_only=guides_only)
        return mem.QueryResult(sim=r.sim[..., 0], meta=r.meta[..., 0, :])

    def query_batch(self, embs, guides_only: bool = False
                    ) -> mem.QueryResult:
        r = self.query_topk_batch(embs, 1, guides_only=guides_only)
        return mem.QueryResult(sim=r.sim[..., 0], meta=r.meta[..., 0, :])

    def _query_topk_tiered(self, emb, k: int,
                           guides_only: bool) -> mem.TopKResult:
        """Offload read: route on the device, bring the routed cluster ids
        to the host (the one extra transfer the tiering costs), gather the
        cold candidates from the host mirror and the hot ones on the
        device."""
        q = self._queries(emb)
        cent, cmask, cidmap = self._plane
        scores, cids = kops.ivf_route_padded(cent, q, cmask, self.probes,
                                             MASK_VALID)
        scores = scores.cpu().numpy()
        cids = global_cids(cids, cidmap).cpu().numpy()
        P, M, C = self.clusters, self.bucket_cap, self.capacity
        cids_c = np.clip(cids, 0, P - 1)
        live = scores > -2.0
        # the tier decision uses the state before this query's probes: a
        # cold cluster routed to now pays its host fetch this once, then
        # is hot for the queries after it
        self._tier_hot = self._last_probe > (self._qcount -
                                             self.cold_after)
        self._last_probe[cids_c[live]] = self._qcount
        slots = self._members[cids_c].reshape(-1)
        owner = np.repeat(cids_c, M)
        ok = np.repeat(live, M) & (slots >= 0)
        ok &= self._assign[np.clip(slots, 0, C - 1)] == owner
        order = np.argsort(np.where(ok, slots, _SENTINEL), kind="stable")
        slots_s = slots[order]
        ok_s = ok[order]
        hot_s = ok_s & self._tier_hot[owner[order]]
        cold_s = ok_s & ~hot_s
        safe = np.clip(slots_s, 0, C - 1)
        host_rows = np.where(cold_s[:, None], self._emb_host[safe], 0.0)
        host_bits = np.where(cold_s, self._bits_host[safe], 0)
        self.host_fetch_rows += int(cold_s.sum())
        self.device_fetch_rows += int(hot_s.sum())
        self._qcount += 1
        st, dev = self.store, self.device
        slots_t = torch.from_numpy(slots_s.astype(np.int32)).to(dev)
        hot_t = torch.from_numpy(hot_s).to(dev)
        phys = slots_t.long().clamp(0, C - 1)
        rows = torch.where(hot_t[:, None], st.emb[phys], 0.0) + \
            torch.from_numpy(host_rows.astype(np.float32)).to(dev)
        bits = torch.where(hot_t, st.mask[phys, 0], 0) + \
            torch.from_numpy(host_bits.astype(np.int32)).to(dev)
        return _scan_sorted(st, slots_t, rows, bits, q, k,
                            mem.required_bits(guides_only))

    # -- exact oracle ---------------------------------------------------
    def exact_query_topk(self, emb, k: int,
                         guides_only: bool = False) -> mem.TopKResult:
        """The exhaustive O(C) scan over the backing store: the recall
        oracle."""
        return mem.query_topk(self.store, emb, k, guides_only=guides_only)

    def exact_query_topk_batch(self, embs, k: int,
                               guides_only: bool = False) -> mem.TopKResult:
        return mem.query_topk_batch(self.store, embs, k,
                                    guides_only=guides_only)

    # -- writes ---------------------------------------------------------
    def add(self, emb, guide, has_guide, hard, now) -> None:
        self.add_batch(np.asarray(emb)[None], np.asarray(guide)[None],
                       np.asarray([has_guide]), np.asarray([hard]),
                       np.asarray([now], np.int32))

    def add_batch(self, embs, guides, has_guide, hard, now) -> None:
        X = (embs.cpu().numpy() if torch.is_tensor(embs)
             else np.asarray(embs)).astype(np.float32)
        K, C = X.shape[0], self.capacity
        mem.add_batch(self.store, X, guides, has_guide, hard, now)
        slots = (self._ptr_host + np.arange(K)) % C
        self._ptr_host += K
        if X.shape[1] < self._ep:
            X = np.pad(X, ((0, 0), (0, self._ep - X.shape[1])))
        if self.offload:
            hg = (has_guide.cpu().numpy() if torch.is_tensor(has_guide)
                  else np.asarray(has_guide)).astype(bool)
            self._emb_host[slots] = X
            self._bits_host[slots] = np.where(hg, 3, 1)  # VALID|GUIDE
        self._ivf_add(X, slots)

    def mark_soft(self, index) -> None:
        mem.mark_soft(self.store, index)

    def touch(self, index, now) -> None:
        mem.touch(self.store, index, now)

    # -- grow-in-place --------------------------------------------------
    def grow(self, new_capacity: int):
        """Grow the backing store (:func:`~repro_torch.core.memory.
        grow_memory`) and re-bucket the clusters against the re-laid-out
        slots. Returns ``(self, remap)``, the :meth:`CommitStream.grow`
        contract."""
        self.store, remap = mem.grow_memory(self.store, new_capacity)
        self._ptr_host = self.store.ptr
        C = self.store.capacity
        self._assign = np.full(C, -1, np.int32)
        if self.offload:
            self._emb_host = np.zeros((C, self._ep), np.float32)
            self._bits_host = np.zeros(C, np.int32)
        self.reindex()
        return self, remap

    # -- introspection --------------------------------------------------
    def stats(self) -> dict:
        """Host-counter snapshot (no device syncs)."""
        out = {
            "clusters": self.clusters,
            "probes": self.probes,
            "bucket_cap": self.bucket_cap,
            "seeded": int(self._seeded),
            "indexed": int((self._assign >= 0).sum()),
            "bucket_evictions": self.bucket_evictions,
            "reindexes": self.reindexes,
            "queries": self._qcount,
        }
        if self.offload:
            out.update(hot_clusters=int(self._tier_hot.sum()),
                       cold_clusters=int((~self._tier_hot).sum()),
                       host_fetch_rows=self.host_fetch_rows,
                       device_fetch_rows=self.device_fetch_rows)
        return out


def wrap_store(store, cfg):
    """Apply a :class:`~repro_torch.core.rar.RARConfig`'s retrieval knobs
    to a store: identity when IVF is off (``retrieval_clusters == 0``, the
    default) or the store is already wrapped."""
    if not cfg.retrieval_clusters or isinstance(store, IVFMemory):
        return store
    return IVFMemory(store, clusters=cfg.retrieval_clusters,
                     probes=cfg.retrieval_probes)
