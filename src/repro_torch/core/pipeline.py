"""Microbatched RAR controller, the counterpart of
``src/repro/core/pipeline.py``: the batched data plane over the section III
procedure, with the shadow plane on a queue.

:meth:`MicrobatchRAR.process_batch` serves B requests per step with the
routing semantics of the sequential :class:`repro_torch.core.rar.RAR`
(both run :mod:`repro_torch.core.decisions`):

1. embed the microbatch (``embed_batch_fn`` in one call, or precomputed
   embeddings);
2. one batched top-k read of the store
   (:func:`repro_torch.core.memory.query_topk_batch`, the CUDA top-k
   kernel on the card) and one host transfer of the packed result;
3. partition the requests into the serving groups;
4. one strong sweep (memory_hard + shadow) and one weak serve sweep
   through the length-bucketed serving engine (flash attention prefill,
   decode attention steps);
5. hand the shadow items to the :class:`~repro_torch.core.shadow.ShadowQueue`;
   the drain runs the weak-alone, guide-from-memory and fresh-guide sweeps
   and lands one commit epoch through the commit stream: inline, at
   barriers (``deferred``, ``adaptive``), or on the async drainer's thread
   and CUDA stream.

Within a microbatch every read sees the store at step start and writes
commit at drain-epoch end; at B = 1 with inline drains this is exactly
``RAR.process``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import decisions
from repro_torch.core import memory as mem
from repro_torch.core import shadow as shq
from repro_torch.core.fm import TierUnavailableError
from repro_torch.core.rar import RAR, Outcome, select_guides, splice_guides
from repro_torch.serving.metrics import MetricsRegistry


def _answers(tier, prompts: list[np.ndarray]) -> np.ndarray:
    """One logical answer sweep over possibly mixed-length prompts. The
    length-bucketed path is preferred even for uniform groups: partition
    sizes vary per microbatch, and bucketing keeps the engine's jit cache
    at O(#lengths · log B) entries instead of one per observed size.
    Tiers without it (test doubles) take the prompt list directly."""
    many = getattr(tier, "answer_many", None)
    if many is not None:
        return np.asarray(many(prompts))
    return np.asarray(tier.answer_batch(prompts))


def _guides(tier, greqs: list[np.ndarray], guide_len: int) -> np.ndarray:
    """One guide-generation sweep over possibly mixed-length requests."""
    many = getattr(tier, "generate_guides_many", None)
    if many is not None:
        return np.asarray(many(greqs, guide_len))
    return np.asarray(tier.generate_guides(greqs, guide_len))


class MicrobatchRAR(RAR):
    """Batched controller. Inherits the sequential ``process`` (so a
    microbatch of 1 can also be served request-at-a-time if desired) and
    adds :meth:`process_batch` plus the queue-scheduled shadow plane."""

    def __init__(self, *args, embed_batch_fn=None, **kwargs):
        super().__init__(*args, **kwargs)
        # optional (prompts) -> (B, E) embedder: one call per microbatch
        # instead of ``embed_fn`` once per prompt
        self.embed_batch_fn = embed_batch_fn
        self.metrics_registry = self._metrics_registry()
        self.shadow = self._make_shadow_queue()

    def _metrics_registry(self) -> MetricsRegistry:
        """The registry the shadow queue mirrors its stats into (a private
        one for a standalone controller)."""
        return MetricsRegistry()

    def _metrics_prefix(self) -> str:
        return "shadow/"

    def _drain_policy(self):
        """Drain policy for ``shadow_mode="adaptive"``; None lets the queue
        build a private :class:`~repro_torch.core.shadow.
        AdaptiveDrainPolicy`."""
        return None

    def _make_shadow_queue(self) -> shq.ShadowQueue:
        """The controller's shadow queue, staged into (and locked against)
        the commit stream, on the store's device."""
        return shq.ShadowQueue(runner=self._drain_shadow,
                               mode=self.cfg.shadow_mode,
                               flush_every=self.cfg.shadow_flush_every,
                               buffer=self.commit_stream.buffer,
                               store_lock=self.commit_stream.lock,
                               fault_plan=self.fault_plan,
                               metrics=self.metrics_registry,
                               metrics_prefix=self._metrics_prefix(),
                               drain_policy=self._drain_policy(),
                               device=self.memory.device)

    def metrics(self) -> dict:
        """Host-side metrics snapshot: the registry, commit-stream progress
        and (adaptive mode) the drain policy's fitted cost model. No
        device sync."""
        out = {"registry": self.metrics_registry.snapshot(),
               "commit": {"epoch": self.commit_stream.buffer.epoch,
                          "entries_applied":
                              self.commit_stream.buffer.entries_applied,
                          "commits": self.commit_stream.commits}}
        if self.shadow.drain_policy is not None:
            out["drain_policy"] = self.shadow.drain_policy.stats()
        return out

    # ------------------------------------------------------------------
    def flush_shadow(self, timeout: float | None = None) -> None:
        """Barrier: drain all pending shadow items and apply their
        commits; every outstanding Outcome is resolved on return (except
        probes deferred behind a still-open breaker, which stay
        parked). ``timeout`` bounds the wait for the async drainer."""
        self.replay_deferred()
        self.shadow.flush(timeout=timeout)

    def close_shadow(self, timeout: float | None = 60) -> None:
        """Flush and stop the drainer. As in the JAX package, the batched
        controller journals no closing checkpoint: a journal's last
        manifest is that of its last commit epoch."""
        self.replay_deferred()
        self.shadow.close(timeout=timeout)

    def replay_deferred(self, force: bool = False) -> int:
        """Batched replay of probes deferred during a strong-tier
        outage: one strong sweep recovers the answers the probes were
        waiting on, then a synchronous drain epoch resolves them through
        the normal shadow plane (their Outcomes' ``case``/
        ``strong_calls`` update in place; ``response``/``served_by``
        stay weak). Skips while the breaker is open unless ``force``."""
        if not self.deferred_probes or \
                not (force or self._strong_ok()):
            return 0
        items, self.deferred_probes = self.deferred_probes, []
        try:
            strong_ans = _answers(self.strong,
                                  [it.prompt for it in items])
        except TierUnavailableError:
            self.deferred_probes = items + self.deferred_probes
            return 0
        for it, a in zip(items, strong_ans):
            it.strong_ans = int(a)
            it.strong_calls = 1
        # counter first: the drain epoch journals the recovery manifest,
        # which must already show these probes as replayed (the epoch's
        # WAL write is the atomic point — before it, the manifest still
        # parks them; after it, the replay is durable)
        self.probes_replayed += len(items)
        self.shadow.drain_now(items)
        return len(items)

    # ------------------------------------------------------------------
    def _lookup_batch(self, embs, guides_only: bool = False
                      ) -> mem.TopKResult:
        """One batched memory read: top-``retrieval_k`` entries per
        query, fused epilogue, one host transfer (the batched analog of
        ``RAR._lookup``)."""
        return mem.query_topk_batch(self.memory, embs,
                                    self.cfg.retrieval_k,
                                    guides_only=guides_only).device_get()

    def _snapshot_lookup(self, embs, guides_only: bool = False
                         ) -> mem.TopKResult:
        """A read under the commit stream's store lock: the drainer's
        commit apply and this snapshot serialize, so the result always
        reflects a whole number of drain epochs (no torn multi-field
        reads on the mutable sharded store)."""
        with self.shadow.store_lock:
            return self._lookup_batch(embs, guides_only=guides_only)

    # ------------------------------------------------------------------
    # Serve plane
    # ------------------------------------------------------------------
    def process_batch(self, prompts: list[np.ndarray],
                      guide_requests: list[np.ndarray],
                      keys: list | None = None,
                      embs: np.ndarray | None = None,
                      nows: list[int] | None = None) -> list[Outcome]:
        """Serve one microbatch. ``prompts[i]``/``guide_requests[i]``/
        ``keys[i]`` mirror the arguments of ``RAR.process``; ``embs`` may
        carry precomputed request embeddings (B, E). ``nows`` may carry
        pre-allocated logical time stamps (the process fabric allocates
        them from the parent's shared clock at dispatch, so a redispatch
        after a worker death reuses the *same* stamps — the byte-identity
        anchor)."""
        B = len(prompts)
        if B > self.cfg.memory.capacity:
            # every request may record one entry; reject before any FM
            # call rather than letting the commit scatter fail afterwards
            raise ValueError(
                f"microbatch of {B} exceeds memory capacity "
                f"{self.cfg.memory.capacity}")
        if keys is None:
            keys = [None] * B
        if nows is None:
            nows = self._advance_now(B)
        else:
            nows = list(nows)
            self.now = max(self.now, max(nows))   # keep the mirror sane

        if embs is None and self.embed_batch_fn is not None:
            embs = self.embed_batch_fn(prompts)
        elif embs is None:
            embs = np.stack([np.asarray(self.embed_fn(p)) for p in prompts])
        embs = np.asarray(embs.cpu() if hasattr(embs, "cpu") else embs)

        # ---- phase 1: one batched top-k memory read (snapshot at batch
        # start). One dispatch (kernel + fused metadata epilogue) and one
        # host transfer of the packed struct — not a per-field gather
        # each. Entry [i, 0] is request i's top-1 routing decision; the
        # tail entries feed multi-guide splicing. The host-side ring
        # pointer is captured under the same lock: re-probe flag updates
        # staged later carry it so the commit buffer can drop them if an
        # intervening drain epoch evicts the target slot.
        with self.shadow.store_lock:
            q = self._lookup_batch(embs)
            ptr_snap = self._ptr_base + self.commit_stream.commits

        # ---- phase 2: partition (the decision core's classification —
        # the same code path the sequential controller runs per request).
        # The strong tier's breaker feeds in as a routing input: while it
        # is open, hard/shadow requests land in the degraded groups.
        part = decisions.partition(
            q, nows, self.cfg,
            lambda i: self.route_weak_fn(np.asarray(embs[i]), keys[i]),
            strong_ok=self._strong_ok())
        outcomes: list[Outcome | None] = [None] * B

        # ---- phase 3: one strong sweep (memory_hard + shadow requests).
        # The shadow requests' strong answer is user-facing (§III-D: the
        # strong FM serves while learning happens in the background), so
        # it stays on the serve plane. If the sweep itself hits an outage
        # (the routing peek raced the breaker), the whole strong side of
        # the batch degrades mid-flight — no errored requests.
        items: list[shq.ShadowItem] = []
        strong_reqs = part.hard + [i for i, _ in part.shadow]
        if strong_reqs:
            try:
                strong_ans = _answers(self.strong, [prompts[i]
                                                    for i in strong_reqs])
            except TierUnavailableError:
                part.hard_degraded += part.hard
                part.deferred += part.shadow
                part.hard, part.shadow = [], []
            else:
                for i, a in zip(part.hard, strong_ans):
                    outcomes[i] = Outcome(int(a), "strong", 1,
                                          "memory_hard")
                for (i, reprobe), a in zip(part.shadow,
                                           strong_ans[len(part.hard):]):
                    out = Outcome(int(a), "strong", 1, shq.PENDING)
                    outcomes[i] = out
                    items.append(shq.ShadowItem(
                        seq=self.shadow.next_seq(), now=nows[i],
                        prompt=prompts[i], guide_request=guide_requests[i],
                        emb=np.asarray(embs[i]), strong_ans=int(a),
                        outcome=out, reprobe_index=reprobe,
                        ptr_snapshot=ptr_snap))

        # ---- phase 4: one weak *serve* sweep (guided hits, bare hits,
        # router passthroughs). Shadow weak probes are not serve work and
        # run in the drain instead.
        weak_prompts: list[np.ndarray] = []
        weak_tags: list[tuple[str, int]] = []
        for i in part.guide:
            weak_prompts.append(splice_guides(
                prompts[i], select_guides(q.sim[i], q.has_guide[i],
                                          q.guide[i],
                                          self.cfg.sim_threshold,
                                          self.cfg.max_guides)))
            weak_tags.append(("guide", i))
        for i in part.skill:
            weak_prompts.append(prompts[i])
            weak_tags.append(("skill", i))
        for i in part.router:
            weak_prompts.append(prompts[i])
            weak_tags.append(("router", i))
        # degraded groups ride the same weak sweep (appended after the
        # regular groups, so non-degraded batches are byte-identical to
        # the pre-resilience sweep order)
        for i in part.hard_degraded:
            weak_prompts.append(prompts[i])
            weak_tags.append(("hard_degraded", i))
        deferred_reprobe = dict(part.deferred)
        for i, _ in part.deferred:
            weak_prompts.append(prompts[i])
            weak_tags.append(("deferred", i))
        if weak_prompts:
            weak_ans = _answers(self.weak, weak_prompts)
            for (tag, i), a in zip(weak_tags, weak_ans):
                a = int(a)
                if tag == "guide":
                    outcomes[i] = Outcome(a, "weak", 0, "memory_guide",
                                          guide_source="memory")
                elif tag == "skill":
                    outcomes[i] = Outcome(a, "weak", 0, "memory_skill")
                elif tag == "hard_degraded":
                    outcomes[i] = Outcome(a, "weak", 0,
                                          "memory_hard_degraded")
                elif tag == "deferred":
                    # weak serves now; the suppressed strong probe parks
                    # until the breaker closes (replay_deferred)
                    out = Outcome(a, "weak", 0, "shadow_deferred")
                    outcomes[i] = out
                    self.deferred_probes.append(shq.ShadowItem(
                        seq=self.shadow.next_seq(), now=nows[i],
                        prompt=prompts[i],
                        guide_request=guide_requests[i],
                        emb=np.asarray(embs[i]), strong_ans=-1,
                        outcome=out,
                        reprobe_index=deferred_reprobe[i],
                        ptr_snapshot=ptr_snap, strong_calls=0))
                    self.probes_deferred += 1
                else:
                    outcomes[i] = Outcome(a, "weak", 0, "router_weak")

        # ---- phase 5: hand the shadow work to the queue. Inline mode
        # drains here; deferred/async return after the serve sweeps alone.
        self.shadow.submit(items)
        return outcomes

    # ------------------------------------------------------------------
    # Shadow plane (runs wherever the queue schedules it)
    # ------------------------------------------------------------------
    def _drain_shadow(self, items: list[shq.ShadowItem]) -> None:
        """Run the three batched shadow sweeps over one coalesced drain
        epoch and apply all resulting memory writes atomically.

        Failure atomicity: if any sweep raises (a transient
        ``TierError``, an injected fault), everything this epoch touched
        is rolled back — the commit buffer's partially-staged ops, every
        item's Outcome fields, and the RQ2/coalescing counters — before
        the exception propagates. The queue re-queues the items
        (``ShadowQueue._requeue``), so the retry at the next barrier
        replays against a clean slate and is byte-identical to a first
        run: the lost-failed-epoch bugfix needs both halves."""
        buf = self.shadow.buffer
        mark = buf.mark()
        saved = [(it.strong_calls, it.outcome.case,
                  it.outcome.strong_calls, it.outcome.guide_source)
                 for it in items]
        counters = (self.guides_from_memory, self.guides_generated,
                    self.shadow.items_coalesced,
                    self.shadow.reclaimed_weak_calls,
                    self.shadow.reclaimed_strong_calls)
        try:
            self._drain_shadow_epoch(items)
        except BaseException:
            buf.rollback(mark)
            for it, (sc, case, osc, gs) in zip(items, saved):
                it.strong_calls = sc
                it.outcome.strong_calls = osc
                it.outcome.case = case
                it.outcome.guide_source = gs
            (self.guides_from_memory, self.guides_generated,
             self.shadow.items_coalesced,
             self.shadow.reclaimed_weak_calls,
             self.shadow.reclaimed_strong_calls) = counters
            raise

    def _drain_shadow_epoch(self, items: list[shq.ShadowItem]) -> None:
        buf = self.shadow.buffer
        probe_calls = 0               # FM calls this epoch (drain cost)
        empty_guide = np.zeros((self.cfg.memory.guide_len,), np.int32)

        # ---- coalescing: near-duplicate items share one shadow pass.
        # The group leader runs the probe sweeps; followers adopt its
        # resolution (their own re-probe flags still move) and skip their
        # probe calls — the reclaimed work the queue stats record. Off by
        # default (dedup_sim=None → every item is its own group, byte-
        # identical to the pre-dedup drain).
        dedup = self.cfg.shadow_dedup_sim
        if dedup is not None and len(items) > 1:
            groups = decisions.coalesce_shadow_items(
                np.stack([it.emb for it in items]), dedup)
        else:
            groups = [[j] for j in range(len(items))]
        flw = {items[g[0]].seq: [items[j] for j in g[1:]] for g in groups}
        leaders = [items[g[0]] for g in groups]
        self.shadow.items_coalesced += len(items) - len(leaders)

        probed_2a: set[int] = set()    # leader seqs that ran the 2a probe
        fresh_ran: set[int] = set()    # leader seqs that ran the 2b sweep

        def settle(it: shq.ShadowItem, stage: str, guide) -> None:
            """Apply ``stage``'s resolution (decision core) to a leader
            and its coalesced followers: the leader stages the insert and
            bumps the RQ2 counters; every member resolves its Outcome and
            moves its own re-probe flags; followers' skipped probe calls
            are tallied at the leader's actual probe depth."""
            depth = 1 + (it.seq in probed_2a) + (it.seq in fresh_ran)
            for m in [it] + flw.get(it.seq, []):
                res = decisions.resolve_shadow_case(
                    stage, m.reprobe_index is not None)
                if m is it:
                    if res.record:
                        buf.stage_add(m.emb, guide, res.has_guide,
                                      res.hard, m.now)
                    if res.guide_source == "memory":
                        self.guides_from_memory += 1
                    elif res.guide_source == "fresh":
                        self.guides_generated += 1
                else:
                    self.shadow.reclaimed_weak_calls += depth
                    if it.seq in fresh_ran:
                        self.shadow.reclaimed_strong_calls += 1
                if res.clear_hard:
                    buf.stage_soft_clear(m.reprobe_index, m.now,
                                         m.ptr_snapshot)
                if res.touch:
                    buf.stage_touch(m.reprobe_index, m.now, m.ptr_snapshot)
                m.outcome.strong_calls = m.strong_calls
                m.outcome.case = res.case
                m.outcome.guide_source = res.guide_source

        # ---- sweep 1: weak-alone probes (Case 1)
        weak_ans = _answers(self.weak, [it.prompt for it in leaders])
        probe_calls += len(leaders)
        pending: list[shq.ShadowItem] = []
        for it, a in zip(leaders, weak_ans):
            if self.aligned_fn(int(a), it.strong_ans):
                settle(it, "case1", empty_guide)
            else:
                pending.append(it)

        # ---- sweep 2: guide-from-memory probes (Case 2a), against the
        # store snapshot at drain start
        still: list[shq.ShadowItem] = []
        if pending:
            gq = self._snapshot_lookup(
                np.stack([it.emb for it in pending]), guides_only=True)
            probes, probe_items, probe_guides = [], [], []
            for j, it in enumerate(pending):
                if decisions.wants_guide_probe(float(gq.sim[j, 0]),
                                               self.cfg):
                    guides = select_guides(gq.sim[j], gq.has_guide[j],
                                           gq.guide[j],
                                           self.cfg.guide_sim_threshold,
                                           self.cfg.max_guides)
                    probes.append(splice_guides(it.prompt, guides))
                    probe_items.append(it)
                    probed_2a.add(it.seq)
                    # on success the *top* guide is recorded (one guide
                    # block per stored entry), matching the sequential
                    # controller
                    probe_guides.append(guides[0])
                else:
                    still.append(it)
            if probes:
                probe_ans = _answers(self.weak, probes)
                probe_calls += len(probes)
                for it, g, a in zip(probe_items, probe_guides, probe_ans):
                    if self.aligned_fn(int(a), it.strong_ans):
                        settle(it, "case2a", g)
                    else:
                        still.append(it)
            still.sort(key=lambda it: it.seq)

        # ---- sweep 3: fresh guides (one strong generate_guides sweep)
        # + guided weak probes (Case 2b)
        failed: list[shq.ShadowItem] = []
        if still and self.cfg.allow_fresh_guides:
            try:
                fresh = _guides(self.strong,
                                [it.guide_request for it in still],
                                self.cfg.memory.guide_len)
            except TierUnavailableError:
                # strong tier down mid-drain: no fresh guide available —
                # the items resolve as Case 3, exactly like the
                # sequential probe's degraded case-2b leg (no strong
                # call charged)
                failed = still
            else:
                for it in still:
                    it.strong_calls += 1
                    fresh_ran.add(it.seq)
                probe_calls += len(still)      # strong guide generations
                probe_ans = _answers(self.weak,
                                     [splice_guides(it.prompt, [g])
                                      for it, g in zip(still, fresh)])
                probe_calls += len(still)      # guided weak probes
                for it, g, a in zip(still, fresh, probe_ans):
                    if self.aligned_fn(int(a), it.strong_ans):
                        settle(it, "case2b", g)
                    else:
                        failed.append(it)
        else:
            failed = still

        for it in failed:                              # Case 3
            settle(it, "case3", empty_guide)

        # ---- one epoch apply through the commit stream: adds first
        # (FIFO order by logical time, matching the sequential
        # add-then-flag order), then re-probe flag updates; flag updates
        # whose pre-epoch slot this epoch's scatter just evicted are
        # dropped (CommitBuffer contract). The apply, the commit-counter
        # bump and the broadcast to every subscribed replica view happen
        # atomically under the stream's store lock.
        self.shadow.note_probe_calls(probe_calls)
        self.memory = self.commit_stream.apply(self.memory)
