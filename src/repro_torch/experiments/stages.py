"""The paper's experiment procedure (section IV-A3), the counterpart of
``src/repro/experiments/stages.py``: multi-stage sequential serving over
shuffled "failing sample" pools, plus the comparison methods of RQ1
(standalone weak/strong, weak+CoT, oracle static router).

A *stage* = one pass over the pool (RAR's memory persists across stages);
an *experiment* = ``n_stages`` stages over one shuffle; results are
reported mean±std over shuffles (:func:`aggregate_shuffles`).

Ported: the sequential stream (``RAR.process``, ``microbatch=1``) and the
batched data plane (``MicrobatchRAR.process_batch``), the
``retrieval_k``/``max_guides`` overrides, the RQ2 warm-up
(``prepopulate_from``), every shadow mode (inline, deferred, async,
adaptive), fault plans, ``progress_every`` and ``metrics_every``. Refused,
naming ROADMAP queue 1 item 5 (the serving fabrics): serve replicas,
the process transport and open-loop arrivals.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch.core.pipeline import MicrobatchRAR
from repro_torch.core.rar import RAR, RARConfig, splice_guide
from repro_torch.device import resolve_device
from repro_torch.experiments.setup import TrainedSystem

Sample = tuple[int, int, int]   # (domain, skill, operand)


@dataclasses.dataclass
class StageResult:
    n: int
    aligned: int
    strong_calls: int
    guides_from_memory: int = 0
    guides_fresh: int = 0
    cases: dict = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _prompts(system: TrainedSystem, pool: list[Sample]):
    v = system.suite.vocab
    prompts = [np.asarray(v.question(d, s, x), np.int32) for d, s, x in pool]
    greqs = [np.asarray(v.guide_request(d, s), np.int32) for d, s, _ in pool]
    return prompts, greqs


def _batched_answers(tier, prompts: list[np.ndarray]) -> np.ndarray:
    return tier.answer_batch(np.stack(prompts))


def _refuse_unported(replicas, transport, arrival_pattern) -> None:
    if replicas > 1 or transport != "thread":
        raise NotImplementedError("replicas/transport: the serving fabrics "
                                  "are not ported (ROADMAP queue 1 item 5)")
    if arrival_pattern not in (None, "closed"):
        raise NotImplementedError("open-loop arrivals: the scheduler and "
                                  "load generator are not ported (ROADMAP "
                                  "queue 1 item 5)")


# ---------------------------------------------------------------------------
# RAR experiment
# ---------------------------------------------------------------------------


def run_rar_experiment(system: TrainedSystem, pool: list[Sample], *,
                       n_stages: int = 5, seed: int = 0,
                       rar_cfg: RARConfig | None = None,
                       router_kind: str = "oracle",
                       strong_tier=None,
                       prepopulate_from: list[Sample] | None = None,
                       microbatch: int = 1,
                       replicas: int = 1,
                       transport: str = "thread",
                       retrieval_k: int | None = None,
                       max_guides: int | None = None,
                       shadow_mode: str | None = None,
                       shadow_flush_every: int | None = None,
                       shadow_dedup_sim: float | None = None,
                       fault_plan=None,
                       arrival_pattern: str | None = None,
                       verbose: bool = False,
                       progress_every: int = 0,
                       metrics_every: int = 0,
                       device="cuda"
                       ) -> tuple[list[StageResult], RAR]:
    """One experiment (one shuffle) on ``device``, where ``system`` must
    live. Returns per-stage results + the controller (memory
    inspectable).

    ``prepopulate_from``: RQ2 inter-domain setting — a silent warm-up
    experiment on another domain's pool first, so the guide memory holds
    out-of-domain guides; fresh guide generation is then switched off.

    ``microbatch``: requests served per controller step. 1 is the paper's
    sequential stream via ``RAR.process``; > 1 routes through
    ``MicrobatchRAR.process_batch`` with microbatch-commit memory
    semantics.

    ``retrieval_k``/``max_guides``/``shadow_mode``/``shadow_flush_every``/
    ``shadow_dedup_sim`` override ``rar_cfg`` as in the JAX package. A
    flush barrier runs at every stage end, so per-stage results are exact
    in every shadow mode.

    ``fault_plan``: a :class:`repro_torch.serving.faults.FaultPlan`
    threaded into the controller (tier errors and delays, drain and
    journal faults); None is a no-op. The resilience knobs (retries,
    breaker, journal) live on ``rar_cfg``.

    ``progress_every``: print a throughput/memory-occupancy line every N
    served requests (0 = off), off the controller's host-side commit
    counter (no device sync). ``metrics_every``: print a one-line summary
    of the controller's host-side ``metrics()`` every N served requests.
    """
    _refuse_unported(replicas, transport, arrival_pattern)
    dev = resolve_device(device)
    if system.weak.engine.device.type != dev.type:
        raise ValueError(f"the system lives on {system.weak.engine.device}, "
                         f"not on {dev}")
    strong = strong_tier or system.strong
    rar_cfg = rar_cfg or RARConfig(
        reprobe_period=2 * len(pool))  # re-probe roughly every other stage
    if retrieval_k is not None:
        rar_cfg = dataclasses.replace(
            rar_cfg, retrieval_k=retrieval_k,
            max_guides=max_guides if max_guides is not None
            else retrieval_k)
    elif max_guides is not None:
        rar_cfg = dataclasses.replace(rar_cfg, max_guides=max_guides)
    if shadow_mode is not None:
        rar_cfg = dataclasses.replace(
            rar_cfg, shadow_mode=shadow_mode,
            shadow_flush_every=shadow_flush_every
            if shadow_flush_every is not None
            else rar_cfg.shadow_flush_every)
    elif shadow_flush_every is not None:
        rar_cfg = dataclasses.replace(rar_cfg,
                                      shadow_flush_every=shadow_flush_every)
    if shadow_dedup_sim is not None:
        rar_cfg = dataclasses.replace(rar_cfg,
                                      shadow_dedup_sim=shadow_dedup_sim)
    prompts, greqs = _prompts(system, pool)

    # scoring reference: the strong FM's answers (quality is measured as
    # alignment with the strong tier, section III-A) — not charged.
    strong_ref = _batched_answers(strong, prompts)

    # embeddings are state-independent → compute once, look up by sample.
    embs = system.embed_many(prompts)
    current: dict = {}

    def embed_fn(prompt: np.ndarray) -> np.ndarray:
        return current["emb"]

    if router_kind == "oracle":
        weak_ref = _batched_answers(system.weak, prompts)
        weak_ok = {i for i in range(len(pool))
                   if weak_ref[i] == strong_ref[i] and weak_ref[i] >= 0}
        route_fn = lambda emb, key: key in weak_ok            # noqa: E731
    else:
        route_fn = lambda emb, key: system.router.route_weak(emb)  # noqa: E731

    controller_cls = MicrobatchRAR if microbatch > 1 else RAR
    rar = controller_cls(system.weak, strong, embed_fn, route_fn, rar_cfg,
                         fault_plan=fault_plan, device=dev)

    if prepopulate_from is not None:
        pre_prompts, pre_greqs = _prompts(system, prepopulate_from)
        pre_embs = system.embed_many(pre_prompts)
        for i in range(len(prepopulate_from)):
            current["emb"] = pre_embs[i]
            rar.process(pre_prompts[i], pre_greqs[i], key=None)
        # freeze: RQ2 only re-uses existing guides, no fresh generation
        rar.cfg = dataclasses.replace(rar.cfg, allow_fresh_guides=False)
        rar.weak.engine.calls = 0
        rar.strong.engine.calls = 0

    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pool))

    served = 0
    t_serve = time.perf_counter()

    def progress(batch: int) -> None:
        """Throttled serve-loop reporting off the host-side commit
        counter (``memory_occupancy``): no device sync."""
        nonlocal served
        before = served
        served += batch
        if not progress_every:
            return
        if served // progress_every > before // progress_every:
            dt = time.perf_counter() - t_serve
            print(f"      [{served}/{n_stages * len(pool)}] "
                  f"{1e3 * dt / served:.1f} ms/request, "
                  f"memory {rar.memory_occupancy}/"
                  f"{rar.cfg.memory.capacity}", flush=True)

    def metrics_line(batch: int) -> None:
        """Periodic one-line summary of the controller's host-side
        ``metrics()`` snapshot, at the served-counter cadence."""
        if not metrics_every or not hasattr(rar, "metrics"):
            return
        if served // metrics_every <= (served - batch) // metrics_every:
            return
        met = rar.metrics()
        commit = met.get("commit", {})
        line = (f"      [metrics] epoch {commit.get('epoch', 0)}, "
                f"entries {commit.get('entries_applied', 0)}")
        pol = met.get("drain_policy")
        if pol:
            line += (f", policy drains {pol.get('cost_drains', 0)}cost"
                     f"+{pol.get('coldstart_drains', 0)}cold")
        print(line, flush=True)

    results = []
    for stage in range(n_stages):
        t_stage = time.perf_counter()
        aligned = strong_calls = gmem = gfresh = 0
        cases: dict = {}

        def tally(i: int, out) -> None:
            nonlocal aligned, strong_calls, gmem, gfresh
            ok = int(out.response == strong_ref[i])
            aligned += ok
            strong_calls += out.strong_calls
            cases[out.case] = cases.get(out.case, 0) + 1
            # Fig. 7 accounting: aligned *guided* responses by guide source
            if ok and out.guide_source == "memory":
                gmem += 1
            elif ok and out.guide_source == "fresh":
                gfresh += 1

        if microbatch > 1:
            stage_outs: list[tuple[int, object]] = []
            for start in range(0, len(order), microbatch):
                chunk = [int(i) for i in order[start:start + microbatch]]
                outs = rar.process_batch(
                    [prompts[i] for i in chunk],
                    [greqs[i] for i in chunk],
                    keys=chunk, embs=embs[chunk])
                stage_outs += zip(chunk, outs)
                progress(len(chunk))
                metrics_line(len(chunk))
            # stage-end barrier: deferred shadow outcomes are provisional
            # until their drain; flush before tallying (no-op inline)
            rar.flush_shadow()
            for i, out in stage_outs:
                tally(i, out)
        else:
            for i in order:
                current["emb"] = embs[int(i)]
                out = rar.process(prompts[int(i)], greqs[int(i)], key=int(i))
                tally(int(i), out)
                progress(1)
                metrics_line(1)
        results.append(StageResult(
            n=len(pool), aligned=aligned, strong_calls=strong_calls,
            guides_from_memory=gmem, guides_fresh=gfresh, cases=cases))
        if verbose:
            r = results[-1]
            dt = time.perf_counter() - t_stage
            print(f"    stage {stage + 1}: aligned {r.aligned}/{r.n}, "
                  f"strong calls {r.strong_calls}, cases {r.cases}; "
                  f"{r.n / dt:.1f} requests/s", flush=True)
    return results, rar


# ---------------------------------------------------------------------------
# RQ1 baselines
# ---------------------------------------------------------------------------


def run_baselines(system: TrainedSystem, pool: list[Sample], *,
                  n_stages: int = 5, rar_cfg: RARConfig | None = None
                  ) -> dict[str, list[StageResult]]:
    """Standalone weak, weak + zero-shot CoT, standalone strong, oracle
    static router — each as per-stage results over the pool. ``rar_cfg``
    supplies the guide format (``memory.guide_len``) so the CoT comparator
    matches the configuration RAR itself runs with."""
    rar_cfg = rar_cfg or RARConfig()
    prompts, greqs = _prompts(system, pool)
    strong_ref = _batched_answers(system.strong, prompts)
    n = len(pool)
    out: dict[str, list[StageResult]] = {}

    # standalone weak
    weak_ans = _batched_answers(system.weak, prompts)
    aligned = int(np.sum((weak_ans == strong_ref) & (weak_ans >= 0)))
    out["weak"] = [StageResult(n, aligned, 0) for _ in range(n_stages)]

    # weak + zero-shot CoT: the weak FM generates its own guide, then
    # answers with it in-context (the paper's CoT comparator).
    self_guides = system.weak.generate_guides(np.stack(greqs),
                                              rar_cfg.memory.guide_len)
    guided = [splice_guide(p, g) for p, g in zip(prompts, self_guides)]
    cot_ans = _batched_answers(system.weak, guided)
    aligned = int(np.sum((cot_ans == strong_ref) & (cot_ans >= 0)))
    out["weak_cot"] = [StageResult(n, aligned, 0) for _ in range(n_stages)]

    # standalone strong: perfect alignment by definition, n strong calls
    out["strong"] = [StageResult(n, n, n) for _ in range(n_stages)]

    # oracle static router: weak serves exactly the samples it aligned on
    # during profiling; the rest go strong — static across stages.
    weak_ok = (weak_ans == strong_ref) & (weak_ans >= 0)
    strong_calls = int(np.sum(~weak_ok))
    out["oracle_router"] = [StageResult(n, n, strong_calls)
                            for _ in range(n_stages)]
    return out


# ---------------------------------------------------------------------------
# Aggregation over shuffles (the paper's mean ± std presentation)
# ---------------------------------------------------------------------------


def aggregate_shuffles(per_shuffle: list[list[StageResult]]
                       ) -> list[dict[str, float]]:
    """[shuffle][stage] → per-stage mean/std of cumulative metrics."""
    n_stages = len(per_shuffle[0])
    rows = []
    for s in range(n_stages):
        cum_aligned = [sum(r[i].aligned for i in range(s + 1))
                       for r in per_shuffle]
        cum_strong = [sum(r[i].strong_calls for i in range(s + 1))
                      for r in per_shuffle]
        rows.append({
            "stage": s + 1,
            "cum_aligned_mean": float(np.mean(cum_aligned)),
            "cum_aligned_std": float(np.std(cum_aligned)),
            "cum_strong_calls_mean": float(np.mean(cum_strong)),
            "cum_strong_calls_std": float(np.std(cum_strong)),
        })
    return rows
