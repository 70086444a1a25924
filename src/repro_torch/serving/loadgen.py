"""Seedable open-loop load generation for the admission scheduler, a
copy of ``src/repro/serving/loadgen.py`` (pure numpy; the port imports
nothing of the JAX package, so it keeps its own): the same seed gives the
same trace as the JAX package's, byte for byte.

Closed-loop serving (the bench's pre-partitioned microbatches) measures
*service* time only: the next batch is not offered until the previous
one resolves, so queueing delay is zero by construction. Real traffic
is open-loop — arrivals happen on their own clock whether or not the
system keeps up — and tail latency under that regime is dominated by
queueing, not service. This module generates the arrival side of that
experiment deterministically.

A *trace* is a list of :class:`ArrivalEvent`, sorted by arrival time,
with every event stamped with a virtual arrival instant (seconds since
trace start), the stream it belongs to, a priority, and an optional
per-request deadline. Three processes are provided:

- :func:`poisson_trace` — independent Poisson streams (exponential
  inter-arrival gaps) merged into one timeline;
- :func:`bursty_trace` — an on/off modulated Poisson process realised
  by *thinning* a homogeneous process at the peak rate, so the mean
  offered rate is preserved while arrivals cluster into bursts;
- :func:`trace_replay` — normalise an externally supplied trace
  (tuples, dicts, or events) into the same canonical form.

Everything is driven by ``numpy.random.default_rng(seed)``: the same
seed yields the same trace byte-for-byte, which is what makes the
scheduler's determinism pin (same trace → same routing decisions)
testable at all. Virtual timestamps decouple trace *shape* from wall
clock — the batcher forms batches in virtual time; only the bench's
pacing loop maps virtual instants onto real sleeps.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ArrivalEvent", "poisson_trace", "bursty_trace", "trace_replay"]


@dataclasses.dataclass(frozen=True)
class ArrivalEvent:
    """One open-loop arrival.

    ``t`` is the virtual arrival instant in seconds since trace start;
    ``index`` is the event's position in the merged, time-sorted trace
    (assigned by the generator — the canonical admission order).
    """
    t: float
    stream: int
    priority: int = 0
    deadline_ms: float | None = None
    index: int = 0


def _per_stream(value, streams: int, default):
    """Broadcast a scalar / cycle a sequence across ``streams``."""
    if value is None:
        return [default] * streams
    if isinstance(value, (int, float)):
        return [value] * streams
    seq = list(value)
    if not seq:
        return [default] * streams
    return [seq[j % len(seq)] for j in range(streams)]


def _counts(n, streams: int) -> list[int]:
    """Per-stream arrival counts: an int total is split round-robin
    (stream ``j`` gets arrival ``j``, ``j+streams``, … — the same shard
    rule the closed-loop bench uses), a sequence is taken verbatim."""
    if isinstance(n, (int, np.integer)):
        return [len(range(j, int(n), streams)) for j in range(streams)]
    counts = [int(c) for c in n]
    if len(counts) != streams:
        raise ValueError(
            f"per-stream counts {counts} do not match streams={streams}")
    return counts


def _merge(per_stream_times: list[np.ndarray], priorities, deadlines
           ) -> list[ArrivalEvent]:
    """Merge per-stream arrival instants into one time-sorted trace.

    Ties break by stream id then per-stream order, so the merged order
    is a pure function of the timestamps — no rng state leaks in."""
    events = []
    for j, times in enumerate(per_stream_times):
        for t in times:
            events.append((float(t), j))
    events.sort(key=lambda e: (e[0], e[1]))
    return [ArrivalEvent(t=t, stream=j, priority=int(priorities[j]),
                         deadline_ms=deadlines[j], index=i)
            for i, (t, j) in enumerate(events)]


def poisson_trace(n, rate: float, *, seed: int = 0, streams: int = 1,
                  rates=None, priorities=None, deadline_ms=None
                  ) -> list[ArrivalEvent]:
    """Merged independent Poisson arrival streams.

    ``n`` is the total arrival count (split round-robin across streams)
    or an explicit per-stream count list. ``rate`` is the *aggregate*
    offered rate in requests/second, split evenly unless ``rates``
    gives per-stream rates (cycled if shorter than ``streams``).
    ``priorities`` / ``deadline_ms`` stamp each stream's events.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    counts = _counts(n, streams)
    stream_rates = _per_stream(rates, streams, rate / streams)
    prios = _per_stream(priorities, streams, 0)
    dls = _per_stream(deadline_ms, streams, None)
    rng = np.random.default_rng(seed)
    times = []
    for j in range(streams):
        r = float(stream_rates[j])
        if r <= 0:
            raise ValueError(f"stream {j} rate must be positive, got {r}")
        gaps = rng.exponential(1.0 / r, size=counts[j])
        times.append(np.cumsum(gaps))
    return _merge(times, prios, dls)


def bursty_trace(n, rate: float, *, seed: int = 0, streams: int = 1,
                 rates=None, priorities=None, deadline_ms=None,
                 burst: float = 3.0, duty: float = 0.25,
                 period_s: float = 1.0) -> list[ArrivalEvent]:
    """On/off modulated Poisson arrivals with the same *mean* rate.

    Each period of ``period_s`` seconds spends ``duty`` of its length
    in the *on* phase at ``burst``× the stream's mean rate; the off
    phase runs at the complementary rate so the long-run offered load
    equals ``rate`` exactly (requires ``burst * duty <= 1``). Realised
    by thinning a homogeneous Poisson process at the peak rate —
    deterministic given the seed, like everything else here.
    """
    if not 0 < duty < 1:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    if burst <= 1:
        raise ValueError(f"burst must exceed 1, got {burst}")
    if burst * duty > 1:
        raise ValueError(
            f"burst*duty={burst * duty:.3f} > 1 leaves a negative off-rate")
    counts = _counts(n, streams)
    stream_rates = _per_stream(rates, streams, rate / streams)
    prios = _per_stream(priorities, streams, 0)
    dls = _per_stream(deadline_ms, streams, None)
    off_factor = (1.0 - burst * duty) / (1.0 - duty)
    rng = np.random.default_rng(seed)
    times = []
    for j in range(streams):
        r = float(stream_rates[j])
        if r <= 0:
            raise ValueError(f"stream {j} rate must be positive, got {r}")
        peak = r * burst
        accepted: list[float] = []
        t = 0.0
        while len(accepted) < counts[j]:
            t += float(rng.exponential(1.0 / peak))
            phase = (t % period_s) / period_s
            local = burst if phase < duty else off_factor
            if float(rng.random()) * burst < local:
                accepted.append(t)
        times.append(np.asarray(accepted))
    return _merge(times, prios, dls)


def trace_replay(events) -> list[ArrivalEvent]:
    """Normalise an externally supplied trace into canonical form.

    Accepts :class:`ArrivalEvent` instances, ``(t, stream[, priority
    [, deadline_ms]])`` tuples, or dicts with those keys. The result is
    time-sorted with indices reassigned and timestamps validated
    (finite, non-negative).
    """
    parsed = []
    for ev in events:
        if isinstance(ev, ArrivalEvent):
            t, s, p, d = ev.t, ev.stream, ev.priority, ev.deadline_ms
        elif isinstance(ev, dict):
            t = ev["t"]
            s = ev.get("stream", 0)
            p = ev.get("priority", 0)
            d = ev.get("deadline_ms")
        else:
            seq = tuple(ev)
            t = seq[0]
            s = seq[1] if len(seq) > 1 else 0
            p = seq[2] if len(seq) > 2 else 0
            d = seq[3] if len(seq) > 3 else None
        t = float(t)
        if not np.isfinite(t) or t < 0:
            raise ValueError(f"arrival time must be finite and >= 0: {t}")
        parsed.append((t, int(s), int(p), None if d is None else float(d)))
    parsed.sort(key=lambda e: (e[0], e[1]))
    return [ArrivalEvent(t=t, stream=s, priority=p, deadline_ms=d, index=i)
            for i, (t, s, p, d) in enumerate(parsed)]
