"""The port's own spans and counters (``repro_torch.tracing``) in a traced
run, and their join with the device trace.

Arming: a reader of the port's spans or counters calls :func:`arm` when it
is loaded. ``bench/run.py`` loads every per-layer reader of a
``--trace 1`` run before the cell's set-up (to find the kernel calls to
record) and loads none under ``--trace 0``, so the port's tracer runs
through a traced run's set-up and window and never in an untraced run.
:func:`take` collects once, turns the tracer off and keeps on the record
(``rec.program``) what the window's steps recorded. A reader loaded again
to read arms the tracer again, and its :func:`take` turns it off again.
On a port without the tracer, or where nothing was recorded in the
window, :func:`take` gives None and every such reader reads None.

The join: the CUDA profile carries each launch's runtime record (host
start, correlation id) beside the kernel, copy or memset it launched;
the two are joined by correlation id. A device op's time is put down to
the innermost span of the port that contains its launch (in none of its
children): a span's device time. In the CPU tests the profiler's
outermost CPU ops stand in for device ops, each launched at its own
start.
"""
from __future__ import annotations

import dataclasses

OUTSIDE = "host outside every span"
ENDS = "host before the first step or after the last"
UNJOINED = "launch not found"


def tracer():
    """The port's tracer module, or None where the port has none."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing


def arm() -> None:
    t = tracer()
    if t is not None and not t.enabled():
        t.enable()


@dataclasses.dataclass
class Program:
    spans: list           # repro_torch.tracing.Span of the window's steps
    counts: dict          # (name, step) -> n, the window's steps only
    wall_offset_ns: int   # time.time_ns() - perf_counter_ns() at enable
    device: dict | None = None    # span name -> device s (device_by_span)

    def seconds(self, name: str) -> float:
        """Host seconds in the spans called ``name``."""
        return sum(s.end_ns - s.start_ns for s in self.spans
                   if s.name == name) / 1e9

    def self_seconds(self, name: str, less: str) -> float:
        """Host seconds in the ``name`` spans less their ``less``
        children."""
        ids = {s.id for s in self.spans if s.name == name}
        inner = sum(s.end_ns - s.start_ns for s in self.spans
                    if s.name == less and s.parent in ids)
        return self.seconds(name) - inner / 1e9

    def count(self, prefix: str) -> int:
        """The counts of every counter whose name starts with
        ``prefix``."""
        return sum(n for (name, _), n in self.counts.items()
                   if name.startswith(prefix))


def window(got, t0_ns: int, t1_ns: int) -> Program:
    """What the steps whose root span began in [t0, t1] recorded."""
    steps = {s.id for s in got.spans
             if s.parent == 0 and t0_ns <= s.start_ns <= t1_ns}
    return Program([s for s in got.spans if s.step in steps],
                   {k: n for k, n in got.counts.items() if k[1] in steps},
                   got.wall_offset_ns)


def take(rec) -> Program | None:
    """The port's records of ``rec``'s window (collected once per run),
    or None where nothing was recorded there."""
    t = tracer()
    if t is None:
        return None
    got = t.collect()
    t.disable()
    if getattr(rec, "program", None) is None:
        rec.program = window(got, rec.t0_ns, rec.t1_ns)
    return rec.program if rec.program.spans else None


def innermost(intervals, points) -> list:
    """For each of the sorted ``points``, the label of the innermost of
    the ``intervals`` (start, end, label) containing it, or None. Nested
    intervals are exact; of two that overlap without nesting (two
    threads), the later-started one is taken while it lasts."""
    order = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(order) and order[i][0] <= p:
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        j = len(stack) - 1
        while j >= 0 and stack[j][1] <= p:   # ended under a later one
            j -= 1
        out.append(stack[j][2] if j >= 0 else None)
    return out


def launched_ops(trace) -> list[tuple[int, int, int | None]]:
    """(start_ns, end_ns, launch_ns) of each device op of ``trace`` (a
    ``bench.harness.trace.DeviceTrace``) on the profiler's wall clock;
    launch None where no launch record carries its correlation id."""
    from torch.autograd import DeviceType
    events = list(trace.prof.profiler.kineto_results.events())
    if trace.device.type != "cuda":
        ops, end = [], float("-inf")
        for e in sorted((e for e in events if e.device_type() ==
                         DeviceType.CPU and e.duration_ns() > 0),
                        key=lambda e: (e.start_ns(), -e.end_ns())):
            if e.start_ns() >= end:          # outermost ops only
                ops.append((e.start_ns(), e.end_ns(), e.start_ns()))
                end = e.end_ns()
        return ops
    launch: dict[int, int] = {}
    for e in events:
        if e.device_type() != DeviceType.CUDA and e.correlation_id():
            c = e.correlation_id()
            launch[c] = min(launch.get(c, e.start_ns()), e.start_ns())
    return [(e.start_ns(), e.end_ns(), launch.get(e.correlation_id()))
            for e in events
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]


def device_by_span(rec) -> dict | None:
    """Device seconds by the port's span that launched them (innermost):
    ``OUTSIDE`` for ops launched in none, ``UNJOINED`` for ops without a
    launch record, ``"all"`` for every device op of the trace. None
    without a trace or the port's records."""
    p = take(rec)
    if p is None or rec.trace is None:
        return None
    if p.device is None:
        ops = launched_ops(rec.trace)
        out: dict[str, float] = {"all": 0.0}
        for a, b, _ in ops:
            out["all"] += (b - a) / 1e9
        lost = [(a, b) for a, b, at in ops if at is None]
        if lost:
            out[UNJOINED] = sum(b - a for a, b in lost) / 1e9
        ops = sorted((o for o in ops if o[2] is not None),
                     key=lambda o: o[2])
        spans = [(s.start_ns + p.wall_offset_ns, s.end_ns + p.wall_offset_ns,
                  s.name) for s in p.spans]
        for (a, b, _), who in zip(ops, innermost(spans,
                                                 [o[2] for o in ops])):
            who = who or OUTSIDE
            out[who] = out.get(who, 0.0) + (b - a) / 1e9
        p.device = out
    return p.device


def breakdown(rec) -> dict:
    """``DeviceTrace.breakdown`` with the port's spans beside the
    benchmark's: each idle gap put down to the innermost span containing
    its midpoint (``ENDS`` where that lies in no span, before the
    window's first step or after its last), the device ops as there, the
    device seconds by the port's span that launched them, and each
    counter a step. Without the port's records, exactly
    ``DeviceTrace.breakdown``."""
    trace = rec.trace
    p = take(rec)
    base = trace.breakdown(rec.spans)
    if p is None:
        return base
    marks = [((a + rec.spans.wall_offset) / 1e3,
              (b + rec.spans.wall_offset) / 1e3, n)
             for n, a, b in rec.spans.events]
    marks += [((s.start_ns + p.wall_offset_ns) / 1e3,
               (s.end_ns + p.wall_offset_ns) / 1e3, s.name)
              for s in p.spans]
    gaps, end = [], trace.t0_us
    for s, t in sorted((s, t) for _, s, t in trace.events) + [
            (trace.t1_us, trace.t1_us)]:
        if s > end:
            gaps.append((end, min(s, trace.t1_us)))
        end = max(end, t)
    roots = [m for m, s in zip(marks[len(rec.spans.events):], p.spans)
             if s.parent == 0]
    first, last = min(m[0] for m in roots), max(m[1] for m in roots)
    idle: dict[str, float] = {}
    for (a, b), who in zip(gaps, innermost(marks, [(a + b) / 2
                                                   for a, b in gaps])):
        if who is None:
            who = OUTSIDE if first <= (a + b) / 2 <= last else ENDS
        idle[who] = idle.get(who, 0.0) + (b - a) / 1e6
    counts: dict[str, int] = {}
    for (n, _), v in p.counts.items():
        counts[n] = counts.get(n, 0) + v
    dev = dict(device_by_span(rec) or {})
    total = dev.pop("all", 0.0)
    inside = total - dev.get(OUTSIDE, 0.0) - dev.get(UNJOINED, 0.0)
    return {"device_ops": base["device_ops"],
            "idle_gaps": sorted(([n, v] for n, v in idle.items()),
                                key=lambda kv: -kv[1]),
            "device_by_span": sorted(([n, v] for n, v in dev.items()),
                                     key=lambda kv: -kv[1]),
            "inside_spans_share": inside / total if total else None,
            "counts_per_step": {n: v / rec.steps
                                for n, v in sorted(counts.items())}}
