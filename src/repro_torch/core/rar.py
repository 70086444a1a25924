"""Real-time Adapting Routing, the paper's section III procedure: the
counterpart of ``src/repro/core/rar.py``.

Request lifecycle: embed the request and read the skill/guide memory
(top-``retrieval_k``); on a hit (sim >= threshold) a hard entry routes to
the strong FM, an entry with a guide serves the weak FM with the guide
spliced in, a bare skill entry serves the weak FM unaided; on a miss the
static router decides, and a strong route runs shadow inference (Cases
1/2a/2b/3) that records what the weak FM can do. Every classification is
:mod:`repro_torch.core.decisions`; :class:`RAR` is the batch-of-1 driver
that owns the FM calls and the store writes, and
:class:`repro_torch.core.pipeline.MicrobatchRAR` batches it.

With ``retrieval_clusters > 0`` the store is wrapped in the IVF
two-level read (:mod:`repro_torch.core.memory_ivf`). With ``journal_path``
a standalone controller opens (or re-opens after a crash) a journaled
commit stream (:func:`repro_torch.core.memory.open_journaled_stream`): its
store and its engine state (clock, RQ2 counters, tier and engine counters,
parked probes) ride in every write-ahead epoch and come back on re-open,
so resumed serving equals a run that never crashed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core import decisions
from repro_torch.core import memory as mem
from repro_torch.core.decisions import select_guides  # noqa: F401
from repro_torch.core.fm import (FMTier, ResilientTier, RetryPolicy,
                                 TierUnavailableError)
from repro_torch.core.memory_ivf import wrap_store
from repro_torch.data import tokenizer as tk


def retry_policy(cfg: "RARConfig") -> RetryPolicy:
    """The tier-resilience knobs of a :class:`RARConfig` as a
    :class:`repro_torch.core.fm.RetryPolicy`."""
    return RetryPolicy(max_retries=cfg.tier_max_retries,
                       timeout=cfg.tier_timeout,
                       backoff_base=cfg.tier_backoff_base,
                       backoff_max=cfg.tier_backoff_max,
                       breaker_threshold=cfg.breaker_threshold,
                       breaker_cooldown=cfg.breaker_cooldown,
                       breaker_adaptive=cfg.breaker_adaptive,
                       breaker_ewma_alpha=cfg.breaker_ewma_alpha)


def splice_guides(prompt: np.ndarray, guides) -> np.ndarray:
    """Insert retrieved guide blocks right after BOS, best-first (the
    multi-guide in-context serving format over the top-k read path); PAD
    columns of each fixed-width guide block are dropped. With a single
    guide this is exactly the PR-2 :func:`splice_guide` format."""
    parts = [prompt[:1]]
    for guide in guides:
        g = np.asarray(guide)
        parts.append(g[g != tk.PAD])
    parts.append(prompt[1:])
    return np.concatenate(parts).astype(np.int32)


def splice_guide(prompt: np.ndarray, guide: np.ndarray) -> np.ndarray:
    """Insert one guide's tokens right after BOS (the weak FM's trained
    guide-consumption format)."""
    return splice_guides(prompt, [guide])


@dataclasses.dataclass(frozen=True)
class RARConfig:
    # Similarity thresholds are calibrated to the embedder, mirroring the
    # paper's procedure (§IV-A2: they measure a 0.442 median pairwise
    # similarity for MiniLM on MMLU and pick 0.2). Our contrastive encoder
    # separates skills much harder (same-skill ≈ 0.99, cross-skill ≈ 0.0),
    # so the equivalent operating point is ≈ 0.6.
    sim_threshold: float = 0.6        # skill-memory routing threshold
    guide_sim_threshold: float = 0.6  # guide acquisition threshold
    align_threshold: float = 0.9      # response-embedding cosine for "aligned"
    reprobe_period: int = 1000        # logical time before a hard entry re-probes
    memory: mem.MemoryConfig = mem.MemoryConfig()
    allow_fresh_guides: bool = True   # False = RQ2 inter-domain setting
    # Multi-guide retrieval: every memory read returns the top
    # ``retrieval_k`` entries (one store pass, ``memory.query_topk``) and
    # up to ``max_guides`` retrieved guides above threshold are spliced
    # into the weak FM's prompt (best-first). The paper's top-1 procedure
    # is retrieval_k = max_guides = 1, which is bit-identical to the PR-2
    # top-1 data plane (pinned in tests/test_pipeline.py).
    retrieval_k: int = 1
    max_guides: int = 1
    # Two-level (IVF) retrieval plane: > 0 wraps the store in
    # ``core.memory_ivf.IVFMemory`` with this many clusters, probing
    # ``retrieval_probes`` of them per read; 0 (the default) keeps the
    # exact store scan.
    retrieval_clusters: int = 0
    retrieval_probes: int = 4
    # Shadow-plane scheduling (batched controller only; the sequential
    # reference interleaves shadow inference per request by definition).
    # "inline" runs the shadow sweeps inside every process_batch (the
    # default and the equivalence reference); "deferred" accumulates
    # shadow items and drains synchronously every ``shadow_flush_every``
    # batches (0 = only at explicit flush barriers); "async" drains on a
    # background thread at the same cadence, taking learning off the
    # serve critical path entirely; "adaptive" drains on the caller
    # thread when an online cost model says the pending set's estimated
    # staleness cost exceeds the amortized drain cost (the serving
    # fabric shares ONE policy across all replicas — the global
    # cadence), with ``shadow_flush_every`` demoted to a hard staleness
    # cap (drain no later than N batches; 0 = uncapped). See
    # :mod:`repro_torch.core.shadow`.
    shadow_mode: str = "inline"
    shadow_flush_every: int = 1
    # Intra-queue shadow dedup: before a drain epoch, pending shadow
    # items whose embedding cosine reaches ``shadow_dedup_sim`` coalesce
    # into one group — the group leader runs the probe sweeps, followers
    # adopt its resolution, and the skipped probe calls are tallied on
    # the queue (``reclaimed_weak_calls``/``reclaimed_strong_calls``).
    # None (default) disables coalescing and is byte-identical to the
    # pre-dedup drain.
    shadow_dedup_sim: float | None = None
    # Tier-call resilience (all defaults off → tiers are never wrapped
    # and every byte-identity pin holds unchanged). When any knob is on,
    # the controllers wrap their tiers in
    # :class:`repro_torch.core.fm.ResilientTier`: transient failures retry with
    # exponential backoff + seeded jitter; ``breaker_threshold``
    # consecutive failures open a circuit breaker that sheds strong-tier
    # calls for ``breaker_cooldown`` seconds — during which routing
    # *degrades* (memory-hard and shadow-probe cases serve weak-only and
    # the suppressed probes are deferred for replay) instead of erroring.
    # ``tier_timeout`` is cooperative — enforced against injected latency
    # spikes; see :mod:`repro_torch.core.fm`.
    tier_max_retries: int = 0
    tier_timeout: float | None = None
    tier_backoff_base: float = 0.02
    tier_backoff_max: float = 1.0
    breaker_threshold: int = 0
    breaker_cooldown: float = 1.0
    # Adaptive breaker (off by default — the static breaker's
    # byte-identity pins hold unchanged): derive the *effective*
    # threshold/cooldown from an EWMA of observed per-call error rates,
    # so a tier with a flaky history opens faster and cools longer. See
    # :class:`repro_torch.core.fm.CircuitBreaker`.
    breaker_adaptive: bool = False
    breaker_ewma_alpha: float = 0.2
    # Replica supervision (serving fabric): how many times a crashed
    # replica's microbatch is redispatched to a surviving replica before
    # its Ticket surfaces the error.
    max_redispatch: int = 2
    # Crash-consistent memory: a directory for the commit stream's
    # write-ahead journal + periodic snapshot (None = in-process only).
    # Every ``snapshot_every`` epochs the store snapshots and the WAL
    # truncates; ``CommitStream.recover`` restores byte-identically.
    journal_path: str | None = None
    snapshot_every: int = 8

    @property
    def tier_resilience(self) -> bool:
        """Is any tier-resilience knob on (wrap tiers at construction)?"""
        return (self.tier_max_retries > 0 or self.breaker_threshold > 0
                or self.tier_timeout is not None)

    def __post_init__(self):
        if self.retrieval_k < 1:
            raise ValueError(f"retrieval_k={self.retrieval_k} must be "
                             f">= 1 (every request reads the memory)")
        if not 1 <= self.max_guides <= self.retrieval_k:
            raise ValueError(
                f"max_guides={self.max_guides} must be in [1, "
                f"retrieval_k={self.retrieval_k}] (guides come from the "
                f"top-k read; guided paths record/serve at least one)")
        if self.retrieval_clusters < 0:
            raise ValueError(f"retrieval_clusters="
                             f"{self.retrieval_clusters} must be >= 0 "
                             f"(0 = exact scan)")
        if self.retrieval_clusters:
            if not 2 <= self.retrieval_clusters <= self.memory.capacity:
                raise ValueError(
                    f"retrieval_clusters={self.retrieval_clusters} must "
                    f"be in [2, memory.capacity="
                    f"{self.memory.capacity}]")
            if not 1 <= self.retrieval_probes <= self.retrieval_clusters:
                raise ValueError(
                    f"retrieval_probes={self.retrieval_probes} must be "
                    f"in [1, retrieval_clusters="
                    f"{self.retrieval_clusters}]")
            if self.journal_path is not None:
                raise ValueError(
                    "retrieval_clusters > 0 is incompatible with "
                    "journal_path: the WAL snapshots the raw "
                    "MemoryState; run the IVF plane without a journal "
                    "or journal with the exact scan")
        if self.shadow_mode not in ("inline", "deferred", "async",
                                    "adaptive"):
            raise ValueError(f"shadow_mode={self.shadow_mode!r} must be "
                             f"'inline', 'deferred', 'async' or "
                             f"'adaptive'")
        if self.shadow_flush_every < 0:
            raise ValueError(f"shadow_flush_every={self.shadow_flush_every}"
                             f" must be >= 0 (0 = explicit flushes only)")
        if self.shadow_mode == "inline" and self.shadow_flush_every != 1:
            raise ValueError("shadow_mode='inline' drains every batch; "
                             "set shadow_flush_every=1 (or pick "
                             "'deferred'/'async' to defer drains)")
        if self.shadow_dedup_sim is not None and \
                not 0.0 < self.shadow_dedup_sim <= 1.0:
            raise ValueError(
                f"shadow_dedup_sim={self.shadow_dedup_sim} must be in "
                f"(0, 1] (a cosine threshold) or None to disable "
                f"coalescing")
        if self.tier_max_retries < 0:
            raise ValueError(f"tier_max_retries={self.tier_max_retries} "
                             f"must be >= 0")
        if self.tier_timeout is not None and self.tier_timeout <= 0:
            raise ValueError(f"tier_timeout={self.tier_timeout} must be "
                             f"> 0 seconds (or None to disable)")
        if self.tier_backoff_base <= 0 or self.tier_backoff_max <= 0:
            raise ValueError(
                f"backoff base/max ({self.tier_backoff_base}/"
                f"{self.tier_backoff_max}) must be > 0")
        if self.breaker_threshold < 0:
            raise ValueError(f"breaker_threshold={self.breaker_threshold}"
                             f" must be >= 0 (0 disables the breaker)")
        if self.breaker_cooldown <= 0:
            raise ValueError(f"breaker_cooldown={self.breaker_cooldown} "
                             f"must be > 0 seconds")
        if not 0.0 < self.breaker_ewma_alpha <= 1.0:
            raise ValueError(
                f"breaker_ewma_alpha={self.breaker_ewma_alpha} must be "
                f"in (0, 1] (an EWMA smoothing factor)")
        if self.max_redispatch < 0:
            raise ValueError(f"max_redispatch={self.max_redispatch} must "
                             f"be >= 0 (0 = fail the ticket on the first "
                             f"crash)")
        if self.snapshot_every < 1:
            raise ValueError(f"snapshot_every={self.snapshot_every} must "
                             f"be >= 1 journal epochs")


@dataclasses.dataclass
class Outcome:
    response: int            # answer index served to the user
    served_by: str           # "weak" | "strong"
    strong_calls: int        # strong-FM inferences consumed by this request
    case: str                # routing path taken
    guide_source: str | None = None   # "memory" | "fresh"


class RAR:
    """The adaptive routing controller, the thin batch-of-1 driver over
    the decision core. Owns the memory state (built on ``device``); the
    FM tiers, embedder and static router are injected."""

    def __init__(self, weak: FMTier, strong: FMTier,
                 embed_fn: Callable[[np.ndarray], np.ndarray],
                 route_weak_fn: Callable[[np.ndarray, object], bool],
                 cfg: RARConfig = RARConfig(),
                 aligned_fn: Callable[[int, int], bool] | None = None,
                 memory=None, commit_stream: mem.CommitStream | None = None,
                 fault_plan=None, device="cuda"):
        if cfg.tier_resilience:
            policy = retry_policy(cfg)
            if not isinstance(weak, ResilientTier):
                weak = ResilientTier(weak, policy, fault_plan=fault_plan,
                                     seed=1)
            if not isinstance(strong, ResilientTier):
                strong = ResilientTier(strong, policy,
                                       fault_plan=fault_plan, seed=2)
        self.weak = weak
        self.strong = strong
        self.fault_plan = fault_plan
        self.embed_fn = embed_fn
        self.route_weak_fn = route_weak_fn
        self.cfg = cfg
        self.aligned_fn = aligned_fn or (lambda a, b: a == b and a >= 0)
        # crash-consistent memory: only a standalone controller opens its
        # journal (an injected commit stream owns its own)
        recovered, manifest = None, None
        standalone_journal = (cfg.journal_path is not None
                              and commit_stream is None)
        if standalone_journal:
            commit_stream, recovered, manifest = mem.open_journaled_stream(
                cfg.journal_path, cfg.memory,
                snapshot_every=cfg.snapshot_every, fault_plan=fault_plan,
                device=device)
        if memory is None:
            memory = recovered if recovered is not None \
                else mem.init_memory(cfg.memory, device=device)
        elif (memory.capacity != cfg.memory.capacity
              or memory.guide.shape[1] != cfg.memory.guide_len):
            raise ValueError(
                f"injected memory store (capacity {memory.capacity}, "
                f"guide_len {memory.guide.shape[1]}) does not match "
                f"cfg.memory {cfg.memory}")
        # two-level retrieval: wrap the store once (an injected store that
        # is already wrapped stays as it is)
        self.memory = wrap_store(memory, cfg)
        self.now = 0
        # counters for the RQ2 analysis (Fig. 7)
        self.guides_from_memory = 0
        self.guides_generated = 0
        # probes suppressed during a strong-tier outage, replayed by
        # ``replay_deferred`` once the breaker closes
        self.deferred_probes: list = []
        self.probes_deferred = 0
        self.probes_replayed = 0
        self.commit_stream = (commit_stream if commit_stream is not None
                              else mem.CommitStream())
        self.commit_stream.subscribe(self)
        if self.commit_stream.journal is not None and \
                not isinstance(self.memory, mem.MemoryState):
            raise ValueError("journal_path requires the plain MemoryState "
                             "store")
        # a recovered store's writes are inside ptr already; the stream's
        # counter only counts commits made after recovery
        self._ptr_base = self.memory.ptr
        if standalone_journal:
            self.commit_stream.state_provider = self._manifest_state
            if manifest is not None:
                self._restore_manifest(manifest)

    # ------------------------------------------------------------------
    @property
    def memory_occupancy(self) -> int:
        """Ring occupancy from the commit stream's host counter."""
        return min(self._ptr_base + self.commit_stream.commits,
                   self.cfg.memory.capacity)

    def flush_shadow(self) -> None:
        """Barrier: replay probes deferred during a strong-tier outage
        (the sequential controller has no queue of its own)."""
        self.replay_deferred()

    def close_shadow(self) -> None:
        """Flush, and journal a manifest-only checkpoint, so engine state
        that advanced past the last store commit survives a later kill."""
        self.replay_deferred()
        self.commit_stream.checkpoint()

    # -- full-state crash consistency (recovery manifest) ---------------
    def _manifest_state(self) -> dict:
        """Engine state journaled with every WAL epoch, host values only
        (the store is the WAL's and the snapshot's; occupancy is rebuilt
        from the recovered ring pointer)."""
        man = {"now": self.now,
               "guides_from_memory": self.guides_from_memory,
               "guides_generated": self.guides_generated,
               "probes_deferred": self.probes_deferred,
               "probes_replayed": self.probes_replayed,
               "deferred_probes": list(self.deferred_probes),
               "tiers": {}, "engines": {}}
        for name, tier in (("weak", self.weak), ("strong", self.strong)):
            if isinstance(tier, ResilientTier):
                man["tiers"][name] = tier.export_state()
            engine = getattr(tier, "engine", None)
            if hasattr(engine, "export_counters"):
                man["engines"][name] = engine.export_counters()
        return man

    def _restore_manifest(self, man: dict) -> None:
        self.now = man["now"]
        self.guides_from_memory = man["guides_from_memory"]
        self.guides_generated = man["guides_generated"]
        self.probes_deferred = man["probes_deferred"]
        self.probes_replayed = man["probes_replayed"]
        self.deferred_probes = list(man["deferred_probes"])
        for name, tier in (("weak", self.weak), ("strong", self.strong)):
            if isinstance(tier, ResilientTier) and \
                    name in man.get("tiers", {}):
                tier.restore_state(man["tiers"][name])
            engine = getattr(tier, "engine", None)
            if hasattr(engine, "restore_counters") and \
                    name in man.get("engines", {}):
                engine.restore_counters(man["engines"][name])

    def _strong_ok(self) -> bool:
        """The strong tier's availability (circuit breaker peek)."""
        breaker = getattr(self.strong, "breaker", None)
        return True if breaker is None else breaker.available()

    def _advance_now(self, n: int) -> list[int]:
        """Allocate the next ``n`` logical time stamps."""
        base = self.now
        self.now = base + n
        return list(range(base + 1, base + n + 1))

    # ------------------------------------------------------------------
    def _weak_answer(self, prompt: np.ndarray) -> int:
        return int(self.weak.answer_batch(prompt[None])[0])

    def _strong_answer(self, prompt: np.ndarray) -> int:
        return int(self.strong.answer_batch(prompt[None])[0])

    def _guided(self, prompt: np.ndarray, guides) -> np.ndarray:
        return splice_guides(prompt, guides)

    def _lookup(self, emb, guides_only: bool = False) -> mem.TopKResult:
        """One memory read: top-``retrieval_k`` entries, one transfer."""
        return mem.query_topk(self.memory, emb, self.cfg.retrieval_k,
                              guides_only=guides_only).device_get()

    # ------------------------------------------------------------------
    def process(self, prompt: np.ndarray, guide_request: np.ndarray,
                key: object = None) -> Outcome:
        """Serve one request. ``prompt`` ends with the ANS marker;
        ``guide_request`` is the strong FM's guide-generation prompt for
        the same request; ``key`` identifies the sample for oracle
        routers."""
        now = self._advance_now(1)[0]
        emb = self.embed_fn(prompt)
        # one device round-trip: the fused top-k query returns a packed
        # struct; entry 0 is the top-1 decision, the tail feeds splicing
        q = self._lookup(emb)
        route = decisions.classify(
            float(q.sim[0]), bool(q.hard[0]), bool(q.has_guide[0]),
            int(q.added_at[0]), int(q.index[0]), now, self.cfg,
            lambda: self.route_weak_fn(np.asarray(emb), key),
            strong_ok=self._strong_ok())

        if route.group == "memory_hard":
            if not route.degraded:
                try:
                    return Outcome(self._strong_answer(prompt), "strong",
                                   1, "memory_hard")
                except TierUnavailableError:
                    # strong went down between the routing peek and the
                    # call — degrade exactly as if classified degraded
                    pass
            # degraded: the strong tier is unavailable — weak serves the
            # hard case rather than erroring; the entry's flags and
            # cool-down are untouched, so the re-probe fires once the
            # breaker closes
            return Outcome(self._weak_answer(prompt), "weak", 0,
                           "memory_hard_degraded")
        if route.group == "memory_guide":
            guides = select_guides(q.sim, q.has_guide, q.guide,
                                   self.cfg.sim_threshold,
                                   self.cfg.max_guides)
            ans = self._weak_answer(self._guided(prompt, guides))
            return Outcome(ans, "weak", 0, "memory_guide",
                           guide_source="memory")
        if route.group == "memory_skill":
            return Outcome(self._weak_answer(prompt), "weak", 0,
                           "memory_skill")
        if route.group == "router_weak":
            return Outcome(self._weak_answer(prompt), "weak", 0,
                           "router_weak")
        if route.degraded:
            return self._defer_probe(prompt, guide_request, emb, now,
                                     route.reprobe_index)
        return self._shadow(prompt, guide_request, emb, now,
                            reprobe_index=route.reprobe_index)

    # ------------------------------------------------------------------
    def _shadow(self, prompt: np.ndarray, guide_request: np.ndarray,
                emb, now: int, reprobe_index: int | None = None) -> Outcome:
        """Strong FM serves the user; probe the weak FM in the background
        (§III-D). One strong call minimum, +1 if a fresh guide is needed.
        If the strong tier turns out unavailable at the serve call (the
        routing peek raced the breaker), the request degrades: weak
        serves and the probe is deferred."""
        try:
            strong_ans = self._strong_answer(prompt)
        except TierUnavailableError:
            return self._defer_probe(prompt, guide_request, emb, now,
                                     reprobe_index)
        return self._probe(prompt, guide_request, emb, now, reprobe_index,
                           strong_ans)

    def _defer_probe(self, prompt: np.ndarray, guide_request: np.ndarray,
                     emb, now: int,
                     reprobe_index: int | None) -> Outcome:
        """Degraded shadow route: the weak FM serves the user *now*; the
        suppressed strong probe is parked as a deferred ShadowItem and
        replayed when the breaker closes — learning pauses instead of
        silently diverging (no entry is recorded from a weak-only
        guess)."""
        from repro_torch.core.shadow import ShadowItem
        out = Outcome(self._weak_answer(prompt), "weak", 0,
                      "shadow_deferred")
        self.deferred_probes.append(ShadowItem(
            seq=0, now=now, prompt=prompt, guide_request=guide_request,
            emb=np.asarray(emb), strong_ans=-1, outcome=out,
            reprobe_index=reprobe_index, strong_calls=0))
        self.probes_deferred += 1
        return out

    def replay_deferred(self, force: bool = False) -> int:
        """Replay probes deferred during a strong-tier outage: run the
        strong serve call they skipped, then the full probe cascade —
        the Outcome's ``case``/``strong_calls``/``guide_source`` resolve
        in place (its ``response``/``served_by`` stay weak: the user was
        already answered). Skips (keeps deferring) while the breaker is
        still open unless ``force``. Returns the number replayed."""
        if not self.deferred_probes or \
                not (force or self._strong_ok()):
            return 0
        queue, kept = list(self.deferred_probes), []
        replayed = 0
        while queue:
            it = queue.pop(0)
            self.deferred_probes = kept + queue
            try:
                strong_ans = self._strong_answer(it.prompt)
            except TierUnavailableError:
                kept.append(it)                   # still down — keep it
                continue
            replayed += 1
            self.probes_replayed += 1
            self._probe(it.prompt, it.guide_request, it.emb, it.now,
                        it.reprobe_index, strong_ans, outcome=it.outcome)
        self.deferred_probes = kept
        return replayed

    def _probe(self, prompt: np.ndarray, guide_request: np.ndarray,
               emb, now: int, reprobe_index: int | None, strong_ans: int,
               outcome: Outcome | None = None) -> Outcome:
        """The probe cascade (Cases 1/2a/2b/3). The stages run here; what
        each stage's alignment *means* — what is recorded, which flags
        move, which case resolves — comes from
        :func:`repro_torch.core.decisions.resolve_shadow_case`. With
        ``outcome`` (deferred replay) the resolution lands on the
        existing weak-served Outcome instead of minting a strong one."""
        strong_calls = 1
        reprobe = reprobe_index is not None
        empty_guide = np.zeros((self.cfg.memory.guide_len,), np.int32)

        def finish(stage: str, guide, strong_calls: int) -> Outcome:
            """Apply the stage's resolution: store effects (add, then
            flag moves — the sequential write order) + RQ2 counters."""
            res = decisions.resolve_shadow_case(stage, reprobe)
            # counters first: a journaled commit writes the manifest
            if res.guide_source == "memory":
                self.guides_from_memory += 1
            elif res.guide_source == "fresh":
                self.guides_generated += 1
            if self.commit_stream.journal is not None:
                # one single-op epoch through the write-ahead path (its
                # K=1 add_batch is the same write as add)
                record = ((emb, guide, res.has_guide, res.hard, now)
                          if res.record else None)
                soft = ((reprobe_index, now, None) if res.clear_hard
                        else None)
                tch = ((reprobe_index, now, None) if res.touch else None)
                if record or soft or tch:
                    self.memory = self.commit_stream.commit_direct(
                        self.memory, record=record, soft_clear=soft,
                        touch_op=tch)
            else:
                if res.record:
                    self.memory = mem.add(self.memory, emb, guide,
                                          np.asarray(res.has_guide),
                                          np.asarray(res.hard),
                                          np.int32(now))
                    self.commit_stream.count(1)
                if res.clear_hard:
                    self.memory = mem.mark_soft(self.memory,
                                                np.int32(reprobe_index))
                if res.touch:
                    self.memory = mem.touch(self.memory,
                                            np.int32(reprobe_index),
                                            np.int32(now))
            if outcome is None:
                return Outcome(strong_ans, "strong", strong_calls,
                               res.case, guide_source=res.guide_source)
            outcome.strong_calls = strong_calls
            outcome.case = res.case
            outcome.guide_source = res.guide_source
            return outcome

        # Case 1 — weak alone
        weak_ans = self._weak_answer(prompt)
        if self.aligned_fn(weak_ans, strong_ans):
            return finish("case1", empty_guide, strong_calls)

        # Case 2a — guide(s) from memory: probe the weak FM with up to
        # max_guides retrieved guides in context; on success the *top*
        # guide is recorded (the stored entry keeps one guide block)
        gq = self._lookup(emb, guides_only=True)
        if decisions.wants_guide_probe(float(gq.sim[0]), self.cfg):
            guides = select_guides(gq.sim, gq.has_guide, gq.guide,
                                   self.cfg.guide_sim_threshold,
                                   self.cfg.max_guides)
            guided_ans = self._weak_answer(self._guided(prompt, guides))
            if self.aligned_fn(guided_ans, strong_ans):
                return finish("case2a", guides[0], strong_calls)

        # Case 2b — fresh guide from the strong FM. If guide generation
        # hits an outage mid-cascade, skip it (the user already has the
        # strong answer): fall through to Case 3 without the +1 charge.
        if self.cfg.allow_fresh_guides:
            try:
                guide = self.strong.generate_guides(
                    guide_request[None], self.cfg.memory.guide_len)[0]
            except TierUnavailableError:
                guide = None
            if guide is not None:
                strong_calls += 1
                guided_ans = self._weak_answer(
                    self._guided(prompt, [guide]))
                if self.aligned_fn(guided_ans, strong_ans):
                    return finish("case2b", guide, strong_calls)

        # Case 3 — weak fails even with guides
        return finish("case3", empty_guide, strong_calls)
