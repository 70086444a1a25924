"""Pure routing/case decision core — the paper's §III classification,
written exactly once.

Every RAR controller answers the same two questions:

1. **Routing** — given a request's top-k memory read and the static
   router, which serving path does it take?  :func:`classify` (one
   request) and :func:`partition` (a microbatch) produce the
   ``{memory_hard, memory_guide, memory_skill, router_weak, shadow}``
   groups from the packed :class:`repro_torch.core.memory.TopKResult` fields.
2. **Shadow resolution** — given which probe stage of the shadow
   procedure first aligned, what gets recorded, which re-probe flags
   move, and what case the user's Outcome resolves to.
   :func:`resolve_shadow_case` covers Cases 1/2a/2b/3 (§III-D).

Before this module the answers were written three times — the sequential
``RAR.process``/``RAR._shadow`` pair and the batched
``MicrobatchRAR.process_batch``/``_drain_shadow`` pair — and every
replica-level feature would have meant a fourth copy.  Everything here is
pure and side-effect-free over host scalars/arrays: controllers own all
FM calls and store mutations, this module owns every decision, and the
replicated serving fabric (``repro.serving.fabric`` in the JAX package)
adds serve replicas without touching any classification code.  The existing
byte-identity suites (B=1 ≡ sequential, deferred ≡ inline, top-1 pin)
hold because both controllers now literally execute the same functions.

Guide selection (:func:`select_guides`) and shadow coalescing
(:func:`coalesce_shadow_items`) live here too: both are pure ranking /
grouping rules over retrieval results, i.e. decisions about *what* to
serve or probe, not *how*.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np

from repro_torch.data import tokenizer as tk

#: the five serving groups a classified request can land in
GROUPS = ("memory_hard", "memory_guide", "memory_skill", "router_weak",
          "shadow")

#: Outcome.case values of requests served in degraded (weak-only) mode —
#: the strong tier's breaker was open, so the strong serve / shadow probe
#: was suppressed and (for shadow) deferred for replay
DEGRADED_CASES = ("memory_hard_degraded", "shadow_deferred")

#: the shadow procedure's probe stages, in execution order; a request
#: resolves at the first stage whose weak answer aligns ("case3" = none)
SHADOW_STAGES = ("case1", "case2a", "case2b", "case3")


# ---------------------------------------------------------------------------
# Routing: request → serving group
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Route:
    """One request's routing decision. ``group`` ∈ :data:`GROUPS`;
    ``reprobe_index`` is set when a ``shadow`` route re-probes a hard
    entry past its cool-down (the entry whose flags the shadow pass may
    update). ``degraded`` marks a route whose strong-tier leg was
    suppressed because the strong tier is unavailable: a degraded
    ``memory_hard`` is served weak-only, a degraded ``shadow`` serves
    weak and defers its probe for replay."""
    group: str
    reprobe_index: int | None = None
    degraded: bool = False


def classify(sim: float, hard: bool, has_guide: bool, added_at: int,
             hit_index: int, now: int, cfg,
             route_weak: Callable[[], bool],
             strong_ok: bool = True) -> Route:
    """Classify one request from the top-1 fields of its memory read
    (entry 0 of the top-k result — bit-identical to the top-1 kernel).

    ``route_weak`` is the static router's verdict as a thunk: it is only
    evaluated on a memory miss, preserving the sequential controller's
    router call pattern (oracle routers may count calls).

    ``strong_ok`` is the strong tier's availability (its circuit
    breaker's non-mutating peek). When False, every route that would
    call the strong tier degrades instead of erroring: ``memory_hard``
    serves weak-only, hard re-probes stay ``memory_hard`` (degraded —
    no point probing an unavailable tier; the cool-down clock keeps
    running so the re-probe fires once the breaker closes), and shadow
    routes carry ``degraded=True`` so the controller serves weak and
    defers the strong probe. ``strong_ok=True`` is byte-identical to
    the pre-resilience classifier.
    """
    if sim >= cfg.sim_threshold:
        if hard:
            if now - added_at < cfg.reprobe_period:
                return Route("memory_hard", degraded=not strong_ok)
            if not strong_ok:
                return Route("memory_hard", degraded=True)
            # cool-down expired → shadow path re-probes the entry
            return Route("shadow", reprobe_index=hit_index)
        if has_guide:
            return Route("memory_guide")
        return Route("memory_skill")
    if route_weak():
        return Route("router_weak")
    return Route("shadow", degraded=not strong_ok)


@dataclasses.dataclass
class Partition:
    """A microbatch partitioned into the serving groups (request indices
    in batch order; ``shadow`` carries ``(index, reprobe_index | None)``).
    ``hard_degraded`` / ``deferred`` only populate in degraded mode
    (``strong_ok=False``): requests that would have gone to ``hard`` /
    ``shadow`` but are served weak-only instead, with ``deferred``
    probes parked for replay once the strong tier returns."""
    hard: list[int] = dataclasses.field(default_factory=list)
    guide: list[int] = dataclasses.field(default_factory=list)
    skill: list[int] = dataclasses.field(default_factory=list)
    router: list[int] = dataclasses.field(default_factory=list)
    shadow: list[tuple[int, int | None]] = dataclasses.field(
        default_factory=list)
    hard_degraded: list[int] = dataclasses.field(default_factory=list)
    deferred: list[tuple[int, int | None]] = dataclasses.field(
        default_factory=list)


def partition(q, nows: Sequence[int], cfg,
              route_weak: Callable[[int], bool],
              strong_ok: bool = True) -> Partition:
    """Partition a microbatch by its batched top-k read.

    ``q`` is the host-side :class:`~repro_torch.core.memory.TopKResult` with
    leading (B, k) axes; ``nows[i]`` is request i's logical time;
    ``route_weak(i)`` is the static router's verdict for request i
    (evaluated lazily, only on memory misses). Request order is
    preserved inside every group, so downstream FM sweeps are
    deterministic. ``strong_ok=False`` routes the strong-dependent
    groups into ``hard_degraded`` / ``deferred`` instead (see
    :func:`classify`).
    """
    sims, hards = q.sim[:, 0], q.hard[:, 0]
    has_guides, added_ats = q.has_guide[:, 0], q.added_at[:, 0]
    hit_idxs = q.index[:, 0]
    part = Partition()
    for i in range(len(nows)):
        r = classify(float(sims[i]), bool(hards[i]), bool(has_guides[i]),
                     int(added_ats[i]), int(hit_idxs[i]), nows[i], cfg,
                     lambda: route_weak(i), strong_ok=strong_ok)
        if r.group == "memory_hard":
            (part.hard_degraded if r.degraded else part.hard).append(i)
        elif r.group == "memory_guide":
            part.guide.append(i)
        elif r.group == "memory_skill":
            part.skill.append(i)
        elif r.group == "router_weak":
            part.router.append(i)
        elif r.degraded:
            part.deferred.append((i, r.reprobe_index))
        else:
            part.shadow.append((i, r.reprobe_index))
    return part


# ---------------------------------------------------------------------------
# Shadow resolution: probe stage → store effects + Outcome case
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShadowResolution:
    """What a resolved shadow pass does for one request: the Outcome
    fields the user sees and the store effects the controller applies
    (insert / re-probe flag moves). Pure data — the controller decides
    *where* the writes land (direct store calls sequentially, the
    CommitBuffer on the batched drain)."""
    case: str                  # resolved Outcome.case
    guide_source: str | None   # "memory" | "fresh" | None
    record: bool               # insert a new memory entry
    has_guide: bool            # ... carrying the probe's guide block
    hard: bool                 # ... hard-flagged (Case 3)
    clear_hard: bool           # clear the re-probed entry's hard flag
    touch: bool                # refresh the re-probed entry's cool-down


def resolve_shadow_case(stage: str, reprobe: bool) -> ShadowResolution:
    """The single source of truth for Cases 1/2a/2b/3 (§III-D).

    ``stage`` ∈ :data:`SHADOW_STAGES` is the first probe stage whose weak
    answer aligned with the strong answer (``"case3"``: none did);
    ``reprobe`` says whether this shadow pass re-probes an existing hard
    entry (routing Case-3 follow-up) rather than a fresh memory miss.
    """
    if stage == "case1":       # weak alone aligned → bare skill entry
        return ShadowResolution(
            case="case1_reprobe" if reprobe else "case1", guide_source=None,
            record=True, has_guide=False, hard=False,
            clear_hard=reprobe, touch=False)
    if stage == "case2a":      # weak + memory guide(s) aligned
        return ShadowResolution(
            case="case2", guide_source="memory",
            record=True, has_guide=True, hard=False,
            clear_hard=reprobe, touch=False)
    if stage == "case2b":      # weak + fresh strong-FM guide aligned
        return ShadowResolution(
            case="case2", guide_source="fresh",
            record=True, has_guide=True, hard=False,
            clear_hard=reprobe, touch=False)
    if stage == "case3":       # weak failed even with guides
        return ShadowResolution(
            case="case3", guide_source=None,
            # a failed re-probe restarts the cool-down on the existing
            # entry instead of inserting a duplicate hard entry
            record=not reprobe, has_guide=False, hard=True,
            clear_hard=False, touch=reprobe)
    raise ValueError(f"shadow stage {stage!r} not in {SHADOW_STAGES}")


def wants_guide_probe(top_guide_sim: float, cfg) -> bool:
    """Case-2a gate: is the guide memory's best entry similar enough to
    probe the weak FM with retrieved guides?"""
    return top_guide_sim >= cfg.guide_sim_threshold


# ---------------------------------------------------------------------------
# Guide selection (with near-duplicate dedup before splicing)
# ---------------------------------------------------------------------------


def select_guides(sims, has_guide, guides, threshold: float,
                  max_guides: int) -> list[np.ndarray]:
    """Pick the guide blocks to splice from one (host) top-k result:
    entries above ``threshold`` that carry a guide, best-first, at most
    ``max_guides``.

    Near-duplicate guide blocks are skipped: the k retrieved entries can
    all come from one hot skill, and splicing the same guide text twice
    adds tokens without information. Two blocks are duplicates when their
    PAD-stripped token sequences are identical; the first (best-ranked)
    occurrence wins, so a duplicate never consumes a ``max_guides`` slot
    and the spliced context order stays deterministic — the retrieval
    order (sim desc, store row asc) minus exact repeats.
    """
    out: list[np.ndarray] = []
    seen: set[tuple[int, ...]] = set()
    for j in range(len(sims)):
        if len(out) >= max_guides:
            break
        if sims[j] >= threshold and bool(has_guide[j]):
            g = np.asarray(guides[j])
            key = tuple(int(t) for t in g[g != tk.PAD])
            if key in seen:
                continue
            seen.add(key)
            out.append(g)
    return out


# ---------------------------------------------------------------------------
# Shadow coalescing (intra-queue dedup before a drain epoch)
# ---------------------------------------------------------------------------


def coalesce_shadow_items(embs, dedup_sim: float) -> list[list[int]]:
    """Group pending shadow items whose embeddings are near-duplicates so
    one shadow pass resolves the whole group (the ROADMAP's
    dedup-as-a-coalescing-rule follow-up).

    Greedy in enqueue order: item j joins the first earlier group whose
    *leader* embedding has cosine ≥ ``dedup_sim`` with j's, else it
    founds its own group. Embeddings are the controller's L2-normalized
    request embeddings, so the dot product is the cosine. Returns groups
    as index lists; ``groups[g][0]`` is the leader, order is
    deterministic (leaders ascend, members ascend within a group), and
    the groups partition ``range(len(embs))`` exactly.
    """
    embs = np.asarray(embs, dtype=np.float32)
    groups: list[list[int]] = []
    leaders: list[int] = []
    for j in range(embs.shape[0]):
        placed = False
        for g, lead in enumerate(leaders):
            if float(embs[j] @ embs[lead]) >= dedup_sim:
                groups[g].append(j)
                placed = True
                break
        if not placed:
            groups.append([j])
            leaders.append(j)
    return groups
