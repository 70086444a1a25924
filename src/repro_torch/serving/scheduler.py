"""Continuous-batching admission scheduler over the fabric boundary, a
copy of ``src/repro/serving/scheduler.py`` (formation runs in virtual
time, so it has no device code).

The fabrics (:class:`~repro_torch.serving.fabric.ServingFabric`,
:class:`~repro_torch.serving.procfabric.ProcessServingFabric`) expose a
microbatch-granular boundary: ``submit`` a pre-formed batch, get a
:class:`Ticket`, ``wait`` it. Everything upstream of this module hands
them batches that were partitioned ahead of time — closed-loop load.
:class:`ContinuousBatcher` is the admission layer in between: it
accepts *single* requests from an open-loop arrival stream and decides,
per request, which forming batch it joins and when that batch stops
waiting for more traffic and dispatches.

Lifecycle: **arrival → admit → close → dispatch → resolve.**

- **admit** — each request arrives stamped with a virtual arrival
  instant, stream id, priority, and optional deadline. It joins the
  open batch for its ``(replica, length-bucket)`` slot, opening one if
  needed.
- **close** (size-or-deadline rule) — a batch closes when it reaches
  ``microbatch`` requests (*size*), or when the virtual clock reaches
  the earliest queueing-budget deadline of any member (*slo*): a
  request's budget is its explicit ``deadline_ms`` if set, else
  ``slo_ms / (1 + priority)`` — higher priority, tighter budget. With
  ``slo_ms=None`` and no explicit deadlines, only size (and the final
  flush) closes batches.
- **dispatch** — a closed batch is submitted to the fabric unchanged
  through ``submit(prompts, guide_requests, keys=, embs=, replica=)``;
  admission→dispatch queueing delay is recorded per request.
- **resolve** — tickets are waited in dispatch order and
  admission→resolve end-to-end latency recorded; outcomes return in
  admission order.

Two invariants shape batch formation:

- **Bucket-aware**: batches group requests by exact prompt length (the
  grouping ``ServingEngine.generate_bucketed`` applies anyway), so an
  admission-formed batch runs the same padded shapes as a closed-loop
  one instead of fragmenting the engine's shape variants.
- **Per-stream FIFO**: a stream's requests always target the same
  replica (``replica_fn``), and before a request opens/joins a batch
  other than the one holding the stream's previous in-flight request,
  that previous batch is closed first. At most one open batch ever
  contains a given stream, and batches containing a stream close in
  that stream's arrival order — so per-replica FIFO at the fabric
  preserves per-stream request order end to end.

Formation runs entirely in *virtual* time (the trace's timestamps), so
the batch partition — and therefore routing — is a deterministic
function of the trace alone. Wall-clock pacing (``pace=True``) only
maps dispatch instants onto real sleeps for honest end-to-end numbers;
it can never change what gets batched with what.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np

__all__ = ["Request", "ContinuousBatcher", "serve_trace"]


@dataclasses.dataclass
class Request:
    """One admitted open-loop request.

    ``arrival_s`` is virtual seconds since trace start; ``index`` is
    the admission order (outcomes are returned sorted by it). ``key`` /
    ``emb`` pass through to ``fabric.submit`` untouched.
    """
    arrival_s: float
    stream: int
    prompt: Any
    guide_request: Any
    priority: int = 0
    deadline_ms: float | None = None
    key: Any = None
    emb: Any = None
    index: int = 0
    # filled in by the batcher
    dispatch_s: float | None = None
    batch_id: int = -1


@dataclasses.dataclass
class _OpenBatch:
    id: int
    replica: int | None
    bucket: Any
    opened_s: float
    requests: list[Request] = dataclasses.field(default_factory=list)
    deadline_s: float = float("inf")


@dataclasses.dataclass
class _Dispatch:
    batch_id: int
    replica: int | None
    bucket: Any
    reason: str
    dispatch_s: float
    requests: list[Request]
    ticket: Any
    submit_wall: float


class ContinuousBatcher:
    """Admission scheduler forming microbatches from single requests.

    Drive it with ``admit`` per arrival (in trace order), ``flush`` at
    end of stream, ``resolve`` to collect outcomes. ``advance`` may be
    called explicitly to let the virtual clock close overdue batches
    without admitting anything (e.g. at the end of a lull).

    Not thread-safe: one driver loop owns it, mirroring how a front
    door drains one arrival queue.
    """

    CLOSE_SIZE = "size"        # reached ``microbatch`` requests
    CLOSE_SLO = "slo"          # oldest member's queueing budget expired
    CLOSE_STREAM = "stream"    # stream moved on to a different bucket
    CLOSE_FLUSH = "flush"      # end-of-trace flush

    def __init__(self, fabric, *, microbatch: int, slo_ms: float | None = None,
                 replica_fn: Callable[[int], int | None] | None = None,
                 bucket_fn: Callable[[Any], Any] | None = None,
                 registry=None, pace: bool = False):
        if microbatch < 1:
            raise ValueError(f"microbatch must be >= 1, got {microbatch}")
        if slo_ms is not None and slo_ms <= 0:
            raise ValueError(f"slo_ms must be positive, got {slo_ms}")
        self.fabric = fabric
        self.microbatch = int(microbatch)
        self.slo_ms = slo_ms
        self.pace = pace
        if replica_fn is None:
            n = getattr(fabric, "n_workers", None)
            if n is None:
                n = len(getattr(fabric, "replicas", ())) or 1
            replica_fn = (lambda stream, _n=n: stream % _n)
        self.replica_fn = replica_fn
        # exact prompt length is the bucket generate_bucketed groups by
        self.bucket_fn = bucket_fn if bucket_fn is not None else len
        if registry is None:
            registry = getattr(fabric, "metrics_registry", None)
        if registry is None:
            from repro_torch.serving.metrics import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        self._open: dict[tuple, _OpenBatch] = {}
        self._stream_open: dict[int, _OpenBatch] = {}
        self.dispatches: list[_Dispatch] = []
        self._next_batch = 0
        self.now_s = 0.0              # virtual clock high-water mark
        self._t0_wall: float | None = None
        self.admitted = 0
        self.dispatched = 0
        self.closes = {self.CLOSE_SIZE: 0, self.CLOSE_SLO: 0,
                       self.CLOSE_STREAM: 0, self.CLOSE_FLUSH: 0}
        m = registry
        self._m_admitted = m.counter("sched/admitted")
        self._m_dispatched = m.counter("sched/dispatched")
        self._m_batches = m.counter("sched/batches")
        self._m_open = m.gauge("sched/open_requests")
        self._m_close = {r: m.counter(f"sched/close_{r}")
                         for r in self.closes}
        self._m_qd = m.histogram("sched/queue_delay_ms")
        self._m_e2e = m.histogram("sched/e2e_ms")
        self._m_batch_fill = m.histogram("sched/batch_fill")
        self._stream_hists: dict[int, tuple] = {}

    # -- virtual-time formation ----------------------------------------
    def _budget_s(self, req: Request) -> float:
        if req.deadline_ms is not None:
            return req.deadline_ms / 1e3
        if self.slo_ms is None:
            return float("inf")
        return (self.slo_ms / 1e3) / (1 + max(0, req.priority))

    def advance(self, t: float) -> None:
        """Move the virtual clock to ``t``, closing (at their deadline
        instants, oldest deadline first) every open batch whose SLO
        budget expires on the way."""
        while True:
            due = [b for b in self._open.values() if b.deadline_s <= t]
            if not due:
                break
            b = min(due, key=lambda b: (b.deadline_s, b.id))
            self._close(b, b.deadline_s, self.CLOSE_SLO)
        self.now_s = max(self.now_s, t)

    def admit(self, req: Request) -> None:
        """Admit one arrival at its virtual instant ``req.arrival_s``
        (must be non-decreasing across calls)."""
        if req.arrival_s < self.now_s - 1e-9:
            raise ValueError(
                f"arrival at t={req.arrival_s:.6f}s is in the past "
                f"(clock at {self.now_s:.6f}s) — admit in trace order")
        self.advance(req.arrival_s)
        replica = self.replica_fn(req.stream)
        key = (replica, self.bucket_fn(req.prompt))
        batch = self._open.get(key)
        prev = self._stream_open.get(req.stream)
        if prev is not None and prev is not batch:
            # per-stream FIFO: the stream's previous request sits in a
            # different forming batch — dispatch it before this request
            # can land in a newer one
            self._close(prev, req.arrival_s, self.CLOSE_STREAM)
            batch = self._open.get(key)
        if batch is None:
            batch = _OpenBatch(id=self._next_batch, replica=replica,
                               bucket=key[1], opened_s=req.arrival_s)
            self._next_batch += 1
            self._open[key] = batch
        req.batch_id = batch.id
        batch.requests.append(req)
        batch.deadline_s = min(batch.deadline_s,
                               req.arrival_s + self._budget_s(req))
        self._stream_open[req.stream] = batch
        self.admitted += 1
        self._m_admitted.inc()
        self._m_open.set(sum(len(b.requests) for b in self._open.values()))
        if len(batch.requests) >= self.microbatch:
            self._close(batch, req.arrival_s, self.CLOSE_SIZE)

    def flush(self, t: float | None = None) -> None:
        """Close every still-open batch (end of trace), oldest first,
        at virtual instant ``t`` (default: the clock's high-water
        mark)."""
        t = self.now_s if t is None else max(t, self.now_s)
        self.advance(t)
        while self._open:
            b = min(self._open.values(), key=lambda b: b.id)
            self._close(b, t, self.CLOSE_FLUSH)

    # -- dispatch -------------------------------------------------------
    def _close(self, batch: _OpenBatch, t: float, reason: str) -> None:
        for key, b in list(self._open.items()):
            if b is batch:
                del self._open[key]
                break
        for stream, b in list(self._stream_open.items()):
            if b is batch:
                del self._stream_open[stream]
        reqs = batch.requests
        if self.pace:
            if self._t0_wall is None:
                self._t0_wall = time.monotonic()
            delay = self._t0_wall + t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
        prompts = [r.prompt for r in reqs]
        greqs = [r.guide_request for r in reqs]
        keys = [r.key for r in reqs]
        embs = None
        if all(r.emb is not None for r in reqs):
            embs = np.stack([np.asarray(r.emb) for r in reqs])
        submit_wall = time.monotonic()
        ticket = self.fabric.submit(prompts, greqs, keys=keys, embs=embs,
                                    replica=batch.replica)
        for r in reqs:
            r.dispatch_s = t
            qd_ms = max(0.0, (t - r.arrival_s) * 1e3)
            self._m_qd.observe(qd_ms)
            self._stream_hist(r.stream)[0].observe(qd_ms)
        self.dispatched += len(reqs)
        self.closes[reason] += 1
        self._m_dispatched.inc(len(reqs))
        self._m_batches.inc()
        self._m_close[reason].inc()
        self._m_batch_fill.observe(len(reqs))
        self._m_open.set(sum(len(b.requests) for b in self._open.values()))
        self.dispatches.append(_Dispatch(
            batch_id=batch.id, replica=batch.replica, bucket=batch.bucket,
            reason=reason, dispatch_s=t, requests=reqs, ticket=ticket,
            submit_wall=submit_wall))

    def _stream_hist(self, stream: int):
        h = self._stream_hists.get(stream)
        if h is None:
            h = (self.registry.histogram(f"sched/stream{stream}/queue_delay_ms"),
                 self.registry.histogram(f"sched/stream{stream}/e2e_ms"))
            self._stream_hists[stream] = h
        return h

    # -- resolve --------------------------------------------------------
    def resolve(self, timeout: float | None = None) -> list:
        """Wait every dispatched ticket (dispatch order) and return the
        outcomes in admission order, recording admission→resolve
        end-to-end latency per request.

        Paced runs measure true open-loop e2e against the shared wall
        epoch; unpaced (virtual-only) runs compose the virtual queueing
        delay with the measured wall service time of each batch.
        """
        outcomes: dict[int, Any] = {}
        for d in self.dispatches:
            outs = d.ticket.wait(timeout=timeout)
            resolved_wall = time.monotonic()
            for r, out in zip(d.requests, outs):
                if self.pace and self._t0_wall is not None:
                    e2e_ms = (resolved_wall - self._t0_wall
                              - r.arrival_s) * 1e3
                else:
                    e2e_ms = ((r.dispatch_s - r.arrival_s)
                              + (resolved_wall - d.submit_wall)) * 1e3
                e2e_ms = max(0.0, e2e_ms)
                self._m_e2e.observe(e2e_ms)
                self._stream_hist(r.stream)[1].observe(e2e_ms)
                outcomes[r.index] = out
        return [outcomes[i] for i in sorted(outcomes)]

    def stats(self) -> dict:
        """Formation counters for reports: admissions, dispatches,
        batch count, and close-reason breakdown."""
        return {
            "admitted": self.admitted,
            "dispatched": self.dispatched,
            "batches": len(self.dispatches),
            "open_requests": sum(len(b.requests)
                                 for b in self._open.values()),
            "closes": dict(self.closes),
        }


def serve_trace(fabric, trace, make_request, *, microbatch: int,
                slo_ms: float | None = None, replica_fn=None,
                bucket_fn=None, registry=None, pace: bool = False,
                timeout: float | None = None):
    """Drive a :class:`ContinuousBatcher` over a loadgen trace.

    ``make_request(event)`` maps each :class:`ArrivalEvent` to a
    ``(prompt, guide_request, key, emb)`` tuple — the caller owns the
    stream→content mapping (e.g. the k-th arrival of stream j serves
    that stream's k-th pool question). Returns ``(outcomes, batcher)``
    with outcomes in admission order.
    """
    batcher = ContinuousBatcher(
        fabric, microbatch=microbatch, slo_ms=slo_ms,
        replica_fn=replica_fn, bucket_fn=bucket_fn, registry=registry,
        pace=pace)
    for ev in trace:
        prompt, greq, key, emb = make_request(ev)
        batcher.admit(Request(
            arrival_s=ev.t, stream=ev.stream, priority=ev.priority,
            deadline_ms=ev.deadline_ms, prompt=prompt, guide_request=greq,
            key=key, emb=emb, index=ev.index))
    batcher.flush()
    outcomes = batcher.resolve(timeout=timeout)
    return outcomes, batcher
