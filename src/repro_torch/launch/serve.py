"""Serving launcher of the port: run the RAR layered system over a request
stream, the counterpart of ``src/repro/launch/serve.py``.

It trains (or loads from the port's cache) the synthetic-suite system on
``--device`` (the card by default), draws a weak-FM-failing pool and
serves it for ``--stages`` passes through :class:`~repro_torch.core.rar.RAR`
(``--microbatch 1``), :class:`~repro_torch.core.pipeline.MicrobatchRAR`, or
a serving fabric of ``--replicas`` serve replicas (``--transport thread``:
worker threads; ``process``: one worker process each, with its own CUDA
context on the card), closed-loop or with open-loop ``--arrival-pattern``
traffic through the continuous batcher; with the shadow plane in any mode
(``--shadow-mode async`` drains on a thread and CUDA stream of its own),
the tier-resilience stack (retries, timeouts, the circuit breaker and its
degraded routing) and the journaled, crash-consistent guide store
(``--journal-path``: a restart with the same path recovers the store and
the engine state). With the defaults the serve path is the plain one.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
        --requests 200 --stages 3 --microbatch 16 --shadow-mode async
    PYTHONPATH=src python -m repro_torch.launch.serve --device cuda \\
        --microbatch 8 --replicas 2 --transport process \\
        --arrival-pattern poisson --arrival-rate 200
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs.rar_system import make_rar_config
from repro_torch.experiments.setup import build_system, failing_pool
from repro_torch.experiments.stages import run_rar_experiment


def main(argv: list[str] | None = None):
    """Run the launcher; returns ``(stage_results, controller)``."""
    ap = argparse.ArgumentParser(
        description="Serve a request stream through the RAR layered system "
                    "(weak/strong tiers, adaptive router, guide memory) on "
                    "the port, with the shadow plane's modes, tier "
                    "resilience and a journaled crash-consistent store.")
    ap.add_argument("--device", default="cuda",
                    help="where the system runs: 'cuda' (default) or 'cpu'")
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--domain", type=int, default=0)
    ap.add_argument("--stages", type=int, default=3)
    ap.add_argument("--microbatch", type=int, default=1,
                    help="requests per controller step (1 = the paper's "
                         "sequential stream; >1 = batched data plane)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve replicas behind one commit stream, a "
                         "single learn replica draining all shadow work "
                         "(1 = the single-controller data plane)")
    ap.add_argument("--transport", default="thread",
                    choices=["thread", "process"],
                    help="how serve replicas are hosted (--replicas > 1): "
                         "'thread' = worker threads in this process; "
                         "'process' = one worker process a replica, each "
                         "with its own CUDA context on the card; a dead "
                         "worker is detected, respawned and its "
                         "microbatches redispatched (requires --router "
                         "oracle)")
    ap.add_argument("--router", default="oracle",
                    choices=["oracle", "learned"])
    ap.add_argument("--arrival-pattern", default="closed",
                    choices=["closed", "poisson", "bursty"],
                    help="traffic shape: 'closed' offers pre-partitioned "
                         "microbatches back to back; 'poisson'/'bursty' "
                         "turn each stage into a seeded open-loop arrival "
                         "trace (one stream a replica) admitted through "
                         "the continuous batcher, which reports "
                         "queueing-delay and end-to-end p50/p99 in the "
                         "metrics registry (--replicas > 1)")
    ap.add_argument("--arrival-rate", type=float, default=64.0,
                    help="offered load in requests/s for open-loop "
                         "arrivals (virtual time: it shapes batch "
                         "formation and queueing delay, not pacing)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request queueing budget in ms for open-loop "
                         "admission (priority p tightens it to "
                         "slo/(1+p)); default: batches close on size")
    ap.add_argument("--priorities", default=None,
                    help="comma-separated per-stream priorities for "
                         "open-loop admission, cycled over the streams")
    ap.add_argument("--sim-threshold", type=float, default=0.2)
    ap.add_argument("--retrieval-k", type=int, default=1,
                    help="memory entries retrieved per query (one store "
                         "pass regardless of k); >1 enables multi-guide "
                         "serving")
    ap.add_argument("--max-guides", type=int, default=None,
                    help="retrieved guides spliced into the weak FM's "
                         "prompt (default: --retrieval-k)")
    ap.add_argument("--retrieval-clusters", type=int, default=0,
                    help="two-level (IVF) retrieval plane with this many "
                         "clusters; 0 (default) = the exact scan")
    ap.add_argument("--retrieval-probes", type=int, default=4,
                    help="clusters probed per query with "
                         "--retrieval-clusters")
    ap.add_argument("--shadow-mode", default="inline",
                    choices=["inline", "deferred", "async", "adaptive"],
                    help="where shadow inference (weak probes, guide "
                         "generation, memory commits) runs: 'inline' inside "
                         "every step; 'deferred' drained on the serve "
                         "thread every --shadow-flush-every batches; "
                         "'async' by a drainer thread on its own CUDA "
                         "stream; 'adaptive' when an online drain-cost "
                         "model says so. Requires --microbatch > 1")
    ap.add_argument("--shadow-flush-every", type=int, default=1,
                    help="drain every N batches (deferred/async; 0 = only "
                         "at stage-end barriers); in adaptive mode a hard "
                         "staleness cap (0 = uncapped)")
    ap.add_argument("--shadow-dedup-sim", type=float, default=None,
                    help="coalesce queued shadow items whose embedding "
                         "cosine reaches this threshold (default off)")
    ap.add_argument("--tier-max-retries", type=int, default=0,
                    help="retries per FM tier call on transient failure "
                         "(0 = off)")
    ap.add_argument("--tier-timeout", type=float, default=None,
                    help="per-call tier timeout in seconds (default none)")
    ap.add_argument("--breaker-threshold", type=int, default=0,
                    help="consecutive tier failures that open the circuit "
                         "breaker; while the strong breaker is open routing "
                         "degrades to weak-only and shadow probes are "
                         "deferred and replayed (0 = no breaker)")
    ap.add_argument("--breaker-cooldown", type=float, default=1.0,
                    help="seconds an open breaker waits before its probe")
    ap.add_argument("--breaker-adaptive", action="store_true",
                    help="derive the breaker's effective knobs from an EWMA "
                         "of observed tier error rates")
    ap.add_argument("--breaker-ewma-alpha", type=float, default=0.2,
                    help="the error-rate EWMA's smoothing factor in (0, 1]")
    ap.add_argument("--max-redispatch", type=int, default=2,
                    help="times a crashed replica's microbatch is "
                         "redispatched to a surviving replica before its "
                         "ticket surfaces the error (fabric mode)")
    ap.add_argument("--journal-path", default=None,
                    help="directory of the guide store's write-ahead log "
                         "and snapshots; a restart with the same path "
                         "recovers the store and the engine state")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="snapshot the journaled store every N epochs")
    ap.add_argument("--log-every", type=int, default=64,
                    help="serve-loop progress every N requests (0 = off)")
    ap.add_argument("--metrics-every", type=int, default=0,
                    help="one-line metrics summary every N served requests "
                         "(0 = off); host counters only")
    ap.add_argument("--metrics-json", default=None,
                    help="write the final metrics snapshot to this JSON file")
    ap.add_argument("--metrics-prom", default=None,
                    help="write the final metrics registry in OpenMetrics "
                         "text format to this file")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    if args.shadow_mode != "inline" and args.microbatch <= 1:
        ap.error("--shadow-mode deferred/async/adaptive requires "
                 "--microbatch > 1 (the sequential reference interleaves "
                 "shadow inference per request)")
    if args.replicas < 1:
        ap.error("--replicas must be >= 1")
    if args.transport == "process":
        if args.replicas <= 1:
            ap.error("--transport process requires --replicas > 1")
        if args.router != "oracle":
            ap.error("--transport process requires --router oracle (the "
                     "learned router is not shipped to worker processes)")
    priorities = None
    if args.arrival_pattern != "closed":
        if args.replicas <= 1:
            ap.error("--arrival-pattern poisson/bursty admits through "
                     "the serving fabric; use --replicas > 1")
        if args.arrival_rate <= 0:
            ap.error("--arrival-rate must be positive")
        if args.slo_ms is not None and args.slo_ms <= 0:
            ap.error("--slo-ms must be positive")
        if args.priorities:
            try:
                priorities = [int(p) for p in args.priorities.split(",")]
            except ValueError:
                ap.error(f"--priorities must be comma-separated ints, "
                         f"got {args.priorities!r}")
    elif args.priorities or args.slo_ms is not None:
        ap.error("--priorities/--slo-ms only apply to open-loop "
                 "--arrival-pattern poisson/bursty")

    system = build_system(device=args.device)
    pool = failing_pool(system, args.domain, n=args.requests)
    print(f"[serve] {len(pool)} requests (weak-FM-failing pool, domain "
          f"{args.domain}) on {args.device}; router={args.router}, "
          f"retrieval_k={args.retrieval_k}, shadow={args.shadow_mode}, "
          f"replicas={args.replicas}", flush=True)
    cfg = make_rar_config(sim_threshold=args.sim_threshold,
                          retrieval_k=args.retrieval_k,
                          max_guides=args.max_guides,
                          retrieval_clusters=args.retrieval_clusters,
                          retrieval_probes=args.retrieval_probes,
                          shadow_mode=args.shadow_mode,
                          shadow_flush_every=args.shadow_flush_every,
                          shadow_dedup_sim=args.shadow_dedup_sim,
                          reprobe_period=2 * len(pool),
                          tier_max_retries=args.tier_max_retries,
                          tier_timeout=args.tier_timeout,
                          breaker_threshold=args.breaker_threshold,
                          breaker_cooldown=args.breaker_cooldown,
                          breaker_adaptive=args.breaker_adaptive,
                          breaker_ewma_alpha=args.breaker_ewma_alpha,
                          max_redispatch=args.max_redispatch,
                          journal_path=args.journal_path,
                          snapshot_every=args.snapshot_every)
    t0 = time.perf_counter()
    results, rar = run_rar_experiment(
        system, pool, n_stages=args.stages, rar_cfg=cfg,
        router_kind=args.router, microbatch=args.microbatch,
        replicas=args.replicas, transport=args.transport,
        arrival_pattern=args.arrival_pattern,
        arrival_rate=args.arrival_rate, slo_ms=args.slo_ms,
        priorities=priorities, verbose=True,
        progress_every=args.log_every, metrics_every=args.metrics_every,
        device=args.device)
    rar.close_shadow()
    # after the final flush: drain counters complete, nothing pending
    final_metrics = rar.metrics() if hasattr(rar, "metrics") else None
    dt = time.perf_counter() - t0

    total = args.stages * len(pool)
    aligned = sum(r.aligned for r in results)
    strong = sum(r.strong_calls for r in results)
    print(f"[serve] {total} requests in {dt:.1f}s "
          f"({1e3 * dt / total:.1f} ms/request)")
    print(f"[serve] aligned {aligned}/{total} ({100 * aligned / total:.1f}%)"
          f", strong-FM calls {strong} ({100 * strong / total:.1f}% of "
          f"requests), memory size {rar.memory.size_fast}", flush=True)
    if args.metrics_json and final_metrics is not None:
        with open(args.metrics_json, "w") as f:
            json.dump(final_metrics, f, indent=1, default=str)
        print(f"[serve] metrics snapshot -> {args.metrics_json}")
    if args.metrics_prom:
        registry = getattr(rar, "metrics_registry", None)
        if registry is not None:
            with open(args.metrics_prom, "w") as f:
                f.write(registry.to_openmetrics())
            print(f"[serve] OpenMetrics exposition -> {args.metrics_prom}")
        else:
            print("[serve] --metrics-prom skipped: controller exposes no "
                  "metrics registry")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([r.__dict__ for r in results], f, indent=1,
                      default=str)
    return results, rar


if __name__ == "__main__":
    main()
