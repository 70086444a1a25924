"""Host-side spans and call recorders the benchmark puts around the calls
it makes into the system; nothing inside the system changes."""
from __future__ import annotations

import contextlib
import time


class Spans:
    """Named host intervals on ``time.perf_counter_ns``; ``wall_offset``
    maps them onto the profiler's wall clock (``time.time_ns``)."""

    def __init__(self):
        self.events: list[tuple[str, int, int]] = []
        self.wall_offset = time.time_ns() - time.perf_counter_ns()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.events.append((name, t0, time.perf_counter_ns()))

    def total_s(self, name: str, t0_ns: int, t1_ns: int) -> float:
        """Seconds of the ``name`` spans that start within [t0, t1)."""
        return sum(b - a for n, a, b in self.events
                   if n == name and t0_ns <= a < t1_ns) / 1e9


class CallRecorder:
    """Replace ``module.attr`` by a wrapper that appends ``extract(*args,
    **kw)`` to :attr:`calls` before calling through; restored on exit."""

    def __init__(self, module, attr: str, extract):
        self.module, self.attr, self.extract = module, attr, extract
        self.calls: list = []

    def __enter__(self):
        self.orig = getattr(self.module, self.attr)
        orig, calls, extract = self.orig, self.calls, self.extract

        def wrapper(*args, **kw):
            calls.append(extract(*args, **kw))
            return orig(*args, **kw)
        setattr(self.module, self.attr, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)
