"""Arithmetic the metric readers share. Each returns None where its run
has nothing to read (no trace, no launch of the kernel)."""
from __future__ import annotations

from bench.harness import peaks
from bench.harness.manifest import load_module


def per_step_ms(seconds: float, rec) -> float | None:
    return 1e3 * seconds / rec.steps if rec.steps else None


def span_ms(rec, *names: str) -> float | None:
    return per_step_ms(sum(rec.spans.total_s(n, rec.t0_ns, rec.t1_ns)
                           for n in names), rec)


def kernel_ms(rec, kernel: str) -> float | None:
    if rec.trace is None:
        return None
    k = load_module("kernels", kernel)
    n = len(rec.trace.matching(k.match))
    return per_step_ms(rec.trace.device_s(k.match), rec) if n else None


def roofline(rec, kernel: str) -> float | None:
    """The launches' least possible time over their device time, in %:
    each traced launch paired, in order, with the shapes recorded at its
    call."""
    if rec.trace is None:
        return None
    k = load_module("kernels", kernel)
    events = rec.trace.matching(k.match)
    calls = rec.kernel_calls.get(kernel, [])
    if not events or len(events) != len(calls):
        return None
    bound = sum(peaks.bound_s(k.flops(c), k.bytes_moved(c),
                              c.get("dtype", getattr(k, "DTYPE", None)))
                for c in calls)
    return 100.0 * bound / (sum(t - s for _, s, t in events) / 1e6)


def mfu(rec) -> float | None:
    if rec.trace is None or not rec.flops:
        return None
    return 100.0 * rec.flops / (rec.window_s * peaks.FLOPS[rec.peak_dtype])


def idle_share(rec) -> float | None:
    if rec.trace is None or not rec.trace.events:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
