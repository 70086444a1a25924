"""Shadow queue: the learning plane scheduled beside the serve path, the
counterpart of ``src/repro/core/shadow.py`` in its ``inline`` and
``deferred`` modes.

The serve sweep enqueues one :class:`ShadowItem` per shadow request and
returns with a provisional ``case="shadow_pending"`` Outcome; a drain runs
the controller's batched shadow sweeps over the pending items and lands
their writes through the commit buffer, resolving each Outcome in place.

* ``"inline"`` drains inside every ``process_batch`` (the default).
* ``"deferred"`` drains on the caller's thread once ``flush_every``
  batches are pending (0 = only at :meth:`ShadowQueue.flush`); with
  ``flush_every=1`` it runs the inline schedule exactly.

A failed drain re-queues its items at the head, in seq order, before the
exception propagates, so the next barrier retries them. Not ported yet:
``"async"`` (a drainer thread, which needs its own CUDA stream) and
``"adaptive"`` (the online drain-cost policy).
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from repro_torch.core.memory import CommitBuffer
from repro_torch.core.rar import Outcome

MODES = ("inline", "deferred")
UNPORTED = ("async", "adaptive")

#: provisional case label of a shadow request's Outcome until its drain
PENDING = "shadow_pending"


@dataclasses.dataclass
class ShadowItem:
    """One shadow request in flight."""
    seq: int                      # global enqueue order
    now: int                      # the request's logical time
    prompt: np.ndarray
    guide_request: np.ndarray
    emb: np.ndarray
    strong_ans: int               # user-facing answer, already served
    outcome: Outcome              # provisional; resolved in place at drain
    reprobe_index: int | None = None   # hard entry being re-probed
    ptr_snapshot: int | None = None    # ring pointer at classification
    strong_calls: int = 1


class ShadowQueue:
    """Drain scheduler: ``runner(items)`` runs the shadow sweeps and the
    commit apply; each enqueued item reaches a successful ``runner`` call
    exactly once, in enqueue order."""

    def __init__(self, runner, mode: str = "inline", flush_every: int = 1,
                 buffer: CommitBuffer | None = None, store_lock=None,
                 fault_plan=None):
        if mode in UNPORTED:
            raise NotImplementedError(
                f"shadow mode {mode!r} is not ported yet (ROADMAP: the "
                f"async drainer needs its own CUDA stream)")
        if mode not in MODES:
            raise ValueError(f"shadow mode {mode!r} not in {MODES}")
        self.runner = runner
        self.mode = mode
        self.flush_every = flush_every
        self.buffer = buffer if buffer is not None else CommitBuffer()
        self.store_lock = (store_lock if store_lock is not None
                           else threading.RLock())
        self.fault_plan = fault_plan
        self._items: list[ShadowItem] = []
        self._batches = 0
        self._seq = 0
        self.items_enqueued = 0
        self.items_drained = 0
        self.drains = 0
        self.drain_failures = 0
        self.items_requeued = 0
        self.items_coalesced = 0
        self.reclaimed_weak_calls = 0
        self.reclaimed_strong_calls = 0
        self.probe_calls = 0          # FM calls of all successful drains
        self._probe_calls_last = 0

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    @property
    def pending(self) -> int:
        return len(self._items)

    def submit(self, items: list[ShadowItem]) -> None:
        """Enqueue one serve batch's shadow items (an empty batch still
        counts toward the flush cadence)."""
        self.items_enqueued += len(items)
        if self.mode == "inline":
            pending = self._take() + items
            if pending:
                self._drain(pending)
            return
        self._items.extend(items)
        self._batches += 1
        if self.flush_every > 0 and self._batches >= self.flush_every:
            self.flush()

    def flush(self, timeout: float | None = None) -> None:
        """Barrier: drain everything pending (``timeout`` is accepted for
        the JAX signature; a caller-thread drain never waits)."""
        items = self._take()
        if items:
            self._drain(items)

    def drain_now(self, items: list[ShadowItem]) -> None:
        """One synchronous drain epoch over externally held items (the
        deferred-probe replay path)."""
        if items:
            self.items_enqueued += len(items)
            self._drain(items)

    def close(self, timeout: float | None = None) -> None:
        self.flush()

    def note_probe_calls(self, n: int) -> None:
        self._probe_calls_last += n

    def _take(self) -> list[ShadowItem]:
        items, self._items = self._items, []
        self._batches = 0
        return items

    def _drain(self, items: list[ShadowItem]) -> None:
        self._probe_calls_last = 0
        try:
            if self.fault_plan is not None:
                self.fault_plan.fire("drain")
            self.runner(items)
        except BaseException:
            self._items = list(items) + self._items
            self._batches += 1
            self.items_requeued += len(items)
            self.drain_failures += 1
            raise
        self.items_drained += len(items)
        self.drains += 1
        self.probe_calls += self._probe_calls_last
