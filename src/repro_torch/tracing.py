"""The port's spans and counters: where a serving step's host time goes and
where it blocks on the card, kept in memory while tracing is on.

Off (the default), :func:`span` returns one shared null context and
:func:`count` returns after one test of a module global: no allocation,
no clock read, no device op and no sync. On, a span reads
``time.perf_counter_ns`` at its two ends and a counter adds to a dict;
still no device op and no sync. Device time is not measured here: a
device trace joins it on afterwards, by the kernel launches that fall
inside each span.

A span's record (:class:`Span`) holds its name, id, parent id (0 for a
root), step id (the id of its root span), the thread's native id, and
start and end on ``perf_counter_ns``. Each thread keeps its own stack of
open spans, so the async shadow drainer's spans nest under its own
roots. A counter is kept by step: ``counts[(name, step)]``, step 0 for
a count made outside any span. :func:`collect` hands over what was
recorded since :func:`enable`, with ``wall_offset_ns``
(``time.time_ns() - time.perf_counter_ns()`` read at :func:`enable`),
which maps the records onto a profiler's wall clock.

Nothing here touches a :class:`~repro_torch.serving.metrics.
MetricsRegistry`: the registry's keys are the same whether tracing is on
or off.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple


class Span(NamedTuple):
    name: str
    id: int
    parent: int        # 0: a root
    step: int          # the id of the root span
    thread: int        # threading.get_native_id()
    start_ns: int      # time.perf_counter_ns()
    end_ns: int


class Trace(NamedTuple):
    spans: list        # of Span, in the order they closed
    counts: dict       # (name, step) -> n
    wall_offset_ns: int


_on = False
_lock = threading.Lock()
_spans: list[Span] = []
_counts: dict[tuple[str, int], int] = {}
_ids = itertools.count(1)
_local = threading.local()
_wall_offset_ns = 0
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    return _on


def enable() -> None:
    """Start recording, with nothing recorded yet."""
    global _on, _wall_offset_ns
    with _lock:
        _spans.clear()
        _counts.clear()
        _wall_offset_ns = time.time_ns() - time.perf_counter_ns()
        _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`collect`."""
    global _on
    _on = False


def collect() -> Trace:
    """The spans and counts recorded since :func:`enable`, and clear
    them."""
    with _lock:
        out = Trace(list(_spans), dict(_counts), _wall_offset_ns)
        _spans.clear()
        _counts.clear()
    return out


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Open:
    """An open span on its thread's stack."""

    __slots__ = ("name", "id", "parent", "step", "start_ns")

    def __init__(self, name: str, start_ns: int | None):
        st = _stack()
        self.name = name
        self.id = next(_ids)
        self.parent, self.step = ((st[-1].id, st[-1].step) if st
                                  else (0, self.id))
        st.append(self)
        self.start_ns = (time.perf_counter_ns() if start_ns is None
                         else start_ns)

    def close(self, end_ns: int | None = None) -> None:
        end = time.perf_counter_ns() if end_ns is None else end_ns
        _stack().remove(self)
        rec = Span(self.name, self.id, self.parent, self.step,
                   threading.get_native_id(), self.start_ns, end)
        with _lock:
            _spans.append(rec)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def span(name: str):
    """A context manager that records ``name`` over its block."""
    if not _on:
        return _NULL
    return _Open(name, None)


def begin(name: str, start_ns: int):
    """Open ``name`` at a ``perf_counter_ns`` reading the caller already
    took (a timer of its own); :func:`end` closes it. None while off."""
    if not _on:
        return None
    return _Open(name, start_ns)


def end(opened, end_ns: int | None = None) -> None:
    """Close a span from :func:`begin` (at ``end_ns``, when the caller
    read its own clock)."""
    if opened is not None:
        opened.close(end_ns)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the current step."""
    if not _on:
        return
    st = getattr(_local, "stack", None)
    key = (name, st[-1].step if st else 0)
    with _lock:
        _counts[key] = _counts.get(key, 0) + n


def traced(name: str):
    """Decorate a function to run inside span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            if not _on:
                return fn(*args, **kw)
            with _Open(name, None):
                return fn(*args, **kw)
        return inner
    return wrap
