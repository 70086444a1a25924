"""Shadow queue: the learning plane scheduled beside the serve path, the
counterpart of ``src/repro/core/shadow.py``.

The serve sweep enqueues one :class:`ShadowItem` per shadow request and
returns with a provisional ``case="shadow_pending"`` Outcome; a drain runs
the controller's batched shadow sweeps over the pending items and lands
their writes through the commit buffer, resolving each Outcome in place.

Drain modes (``RARConfig.shadow_mode``):

* ``"inline"`` drains inside every ``process_batch`` (the default).
* ``"deferred"`` drains on the caller's thread once ``flush_every``
  batches are pending (0 = only at :meth:`ShadowQueue.flush`); with
  ``flush_every=1`` it runs the inline schedule exactly.
* ``"async"``: a daemon drainer thread wakes once ``flush_every`` batches
  are pending and drains in the background; :meth:`ShadowQueue.flush` is
  the barrier (waits for the queue to empty and every commit to apply,
  re-raising any drainer exception). On the card the drainer runs on a
  CUDA stream of its own: every kernel it launches (the shadow sweeps'
  attention, the store reads, the commit's writes) is queued there, and
  the kernel wrappers key their tickets and workspaces by that stream, so
  the drainer never shares one with the serve thread. The store is
  updated in place, so ordering across the two streams is the store
  lock's job: the drainer's apply waits for its stream before it releases
  the lock, and the drainer's stream waits for the serve thread's when it
  takes the lock (:class:`repro_torch.core.memory.StoreLock`,
  :func:`repro_torch.core.memory.settle`).
* ``"adaptive"``: caller-thread drains whose timing a :class:`DrainPolicy`
  decides (default :class:`AdaptiveDrainPolicy`, a cost model fitted
  online from the drains' ``(items, seconds)``), with ``flush_every``
  demoted to a hard staleness cap. A drain's seconds include its device
  work: the sweeps end on host transfers, and on the card a drain that a
  policy times ends on a sync of its stream.

A failed drain re-queues its items at the head, in seq order, before the
exception propagates, so the next barrier retries them; the async worker
holds a failed epoch back until a new submit or an explicit flush instead
of retrying in a loop. Coalescing (``RARConfig.shadow_dedup_sim``) merges
near-duplicate pending items into one shadow pass.

Metrics: the queue mirrors its stats into a
:class:`repro_torch.serving.metrics.MetricsRegistry` (a private one unless
the owner injects one and a name prefix): depth and staleness gauges,
enqueue/drain/requeue counters and drain-cost histograms, all host
numbers. ``drain_delay`` sleeps before each drain (a stress-test hook;
keep it 0 in production).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.memory import CommitBuffer, StoreLock
from repro_torch.core.rar import Outcome
from repro_torch.serving.metrics import MetricsRegistry

MODES = ("inline", "deferred", "async", "adaptive")

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


class DrainPolicy:
    """Base drain policy: **always drain**, so ``adaptive`` runs the exact
    ``deferred`` flush-every-batch schedule. Subclasses override
    :meth:`due` with a cost model."""

    def __init__(self):
        self.queues: list["ShadowQueue"] = []
        self.decisions = 0            # times due() was consulted

    def register(self, q: "ShadowQueue") -> None:
        """Attach a queue to this policy's drain group; a decision to
        drain flushes the whole group."""
        if q not in self.queues:
            self.queues.append(q)

    def pending_items(self) -> int:
        return sum(len(q._items) for q in self.queues)

    def staleness_batches(self) -> int:
        return max((q._batches for q in self.queues), default=0)

    def note_drain(self, n_items: int, seconds: float) -> None:
        """Observed cost of one successful drain epoch."""

    def due(self) -> bool:
        self.decisions += 1
        return True

    def stats(self) -> dict:
        return {"policy": type(self).__name__,
                "decisions": self.decisions}


class AdaptiveDrainPolicy(DrainPolicy):
    """Staleness cost against drain cost, fitted online.

    One drain over ``n`` items costs about ``overhead + n * per_item``
    seconds, both fitted by exponentially decayed least squares over the
    observed ``(n_items, seconds)`` drains. Holding the pending set one
    more batch risks re-shadow work, ``pending * p_reshadow * per_item``,
    with ``p_reshadow`` the group's duplicate rate
    (``items_coalesced / items_drained``, smoothed by ``reshadow_prior``).
    Drain when that reaches ``overhead``. Until the regression is well
    posed (two drains of distinct sizes) every decision is "drain".
    """

    def __init__(self, decay: float = 0.95,
                 reshadow_prior: tuple[float, float] = (1.0, 9.0)):
        super().__init__()
        if not 0.0 < decay <= 1.0:
            raise ValueError(f"decay={decay} must be in (0, 1]")
        self.decay = decay
        self.reshadow_prior = reshadow_prior
        self._lock = threading.Lock()
        # decayed normal-equation sums for seconds = a + b * items
        self._s1 = self._sn = self._st = 0.0
        self._snn = self._snt = 0.0
        self.cost_drains = 0          # drains the cost model asked for
        self.coldstart_drains = 0     # drains forced while under-fit

    def note_drain(self, n_items: int, seconds: float) -> None:
        with self._lock:
            d = self.decay
            self._s1 = self._s1 * d + 1.0
            self._sn = self._sn * d + n_items
            self._st = self._st * d + seconds
            self._snn = self._snn * d + n_items * n_items
            self._snt = self._snt * d + n_items * seconds

    def model(self) -> tuple[float, float] | None:
        """``(overhead_secs, per_item_secs)``, or None while the decayed
        regression is singular."""
        with self._lock:
            det = self._s1 * self._snn - self._sn * self._sn
            if self._s1 < 2.0 or det <= 1e-12:
                return None
            b = (self._s1 * self._snt - self._sn * self._st) / det
            a = (self._st * self._snn - self._sn * self._snt) / det
            return max(a, 0.0), max(b, 0.0)

    def reshadow_prob(self) -> float:
        pa, pb = self.reshadow_prior
        coal = sum(q.items_coalesced for q in self.queues)
        drained = sum(q.items_drained for q in self.queues)
        return (coal + pa) / (drained + pa + pb)

    def due(self) -> bool:
        self.decisions += 1
        pending = self.pending_items()
        if pending == 0:
            return False
        m = self.model()
        if m is None:
            self.coldstart_drains += 1
            return True
        overhead, per_item = m
        if pending * self.reshadow_prob() * per_item >= overhead:
            self.cost_drains += 1
            return True
        return False

    def stats(self) -> dict:
        out = super().stats()
        m = self.model()
        out.update({"cost_drains": self.cost_drains,
                    "coldstart_drains": self.coldstart_drains,
                    "reshadow_prob": self.reshadow_prob(),
                    "overhead_secs": m[0] if m else None,
                    "per_item_secs": m[1] if m else None})
        return out


class ShadowQueue:
    """Drain scheduler: ``runner(items)`` runs the shadow sweeps and the
    commit apply; each enqueued item reaches a successful ``runner`` call
    exactly once, in enqueue order. ``device`` is where the runner's work
    runs: on a CUDA device the async drainer gets a stream of its own."""

    def __init__(self, runner, mode: str = "inline", flush_every: int = 1,
                 buffer: CommitBuffer | None = None,
                 drain_delay: float = 0.0, store_lock=None,
                 fault_plan=None, metrics: MetricsRegistry | None = None,
                 metrics_prefix: str = "",
                 drain_policy: DrainPolicy | None = None, device=None):
        if mode not in MODES:
            raise ValueError(f"shadow mode {mode!r} not in {MODES}")
        self.runner = runner
        self.mode = mode
        self.flush_every = flush_every
        self.buffer = buffer if buffer is not None else CommitBuffer()
        self.drain_delay = drain_delay
        self.fault_plan = fault_plan
        self.store_lock = (store_lock if store_lock is not None
                           else StoreLock())
        self.device = None if device is None else torch.device(device)
        self.stream = None            # the drainer's CUDA stream
        self._cv = threading.Condition()
        self._items: list[ShadowItem] = []
        self._batches = 0             # batches pending since last drain
        self._seq = 0
        self._flush_requested = False
        self._draining = False
        self._stop = False
        self._worker: threading.Thread | None = None
        self._error: BaseException | None = None
        # a failed async drain is held back until a new submit or flush
        self._retry_holdback = False
        self.items_enqueued = 0
        self.items_drained = 0
        self.drains = 0
        self.drain_failures = 0
        self.items_requeued = 0
        self.items_coalesced = 0
        self.reclaimed_weak_calls = 0
        self.reclaimed_strong_calls = 0
        # staleness (host logical time)
        self.newest_now = 0           # max ``now`` ever enqueued
        self.last_drain_now = 0       # max ``now`` drained successfully
        self._staleness_at_take = 0
        self._probe_calls_last = 0
        if mode == "adaptive" and drain_policy is None:
            drain_policy = AdaptiveDrainPolicy()
        self.drain_policy = drain_policy
        if self.drain_policy is not None:
            self.drain_policy.register(self)
        if metrics is None:
            metrics = MetricsRegistry()
        self.metrics = metrics
        p = metrics_prefix
        self._m_enq = metrics.counter(p + "items_enqueued")
        self._m_drained = metrics.counter(p + "items_drained")
        self._m_drains = metrics.counter(p + "drains")
        self._m_failures = metrics.counter(p + "drain_failures")
        self._m_requeued = metrics.counter(p + "items_requeued")
        self._m_depth = metrics.gauge(p + "depth_items")
        self._m_stale_b = metrics.gauge(p + "staleness_batches")
        self._m_stale_t = metrics.gauge(p + "staleness_logical")
        self._m_h_items = metrics.histogram(p + "drain_items")
        self._m_h_secs = metrics.histogram(p + "drain_seconds")
        self._m_h_probes = metrics.histogram(p + "drain_probe_calls")
        self._m_h_stale = metrics.histogram(p + "drain_staleness_batches")

    # -- enqueue --------------------------------------------------------
    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    @property
    def staleness_logical(self) -> int:
        """Logical time between the newest enqueued item and the last
        successful drain; 0 when fully drained."""
        if not self._items:
            return 0
        return max(0, self.newest_now - self.last_drain_now)

    def _sync_gauges_locked(self) -> None:
        """Mirror depth and staleness under one registry lock hold."""
        with self.metrics.lock:
            self._m_depth.set(len(self._items))
            self._m_stale_b.set(self._batches)
            self._m_stale_t.set(self.staleness_logical)

    def submit(self, items: list[ShadowItem]) -> None:
        """Enqueue one serve batch's shadow items (an empty batch still
        counts toward the flush cadence)."""
        self._reraise()
        if items:
            self.newest_now = max(self.newest_now, self._max_now(items))
        if self.mode == "inline":
            self.items_enqueued += len(items)
            self._m_enq.inc(len(items))
            # a failed epoch's re-queued items retry ahead of this batch
            pending = self._take() + items
            if pending:
                self._staleness_at_take = 1
                self._drain(pending)
            return
        with self._cv:
            self._items.extend(items)
            self.items_enqueued += len(items)
            self._m_enq.inc(len(items))
            self._batches += 1
            self._retry_holdback = False
            due = self.flush_every > 0 and self._batches >= self.flush_every
            self._sync_gauges_locked()
            if self.mode == "async":
                if due:
                    self._ensure_worker()
                    self._cv.notify_all()
                return
        if self.mode == "adaptive":
            # the cadence cap or the cost model
            if due or self.drain_policy.due():
                self._drain_group()
        elif due:
            self.flush()

    # -- barriers -------------------------------------------------------
    def flush(self, timeout: float | None = None) -> None:
        """Barrier: drain everything pending and apply every commit before
        returning. In async mode it waits for the worker (re-raising any
        exception it hit); on ``timeout`` a :class:`TimeoutError` is
        raised and the pending work stays queued."""
        if self.mode == "async" and self._worker is not None \
                and self._worker.is_alive():
            with self._cv:
                self._flush_requested = True
                self._retry_holdback = False
                self._cv.notify_all()
                done = self._cv.wait_for(
                    lambda: (not self._items and not self._draining)
                    or self._error is not None, timeout=timeout)
                self._flush_requested = False
            if not done:
                raise TimeoutError(
                    f"shadow flush timed out after {timeout}s "
                    f"(drainer still busy)")
            self._reraise()
            return
        items = self._take()
        if items:
            self._drain(items)

    def _drain_group(self) -> None:
        """Flush every queue of the drain policy's group."""
        for q in self.drain_policy.queues:
            q.flush()

    def drain_now(self, items: list[ShadowItem]) -> None:
        """One synchronous drain epoch over externally held items (the
        deferred-probe replay path), counted in the enqueue/drain stats."""
        if not items:
            return
        self._reraise()
        self.items_enqueued += len(items)
        self._m_enq.inc(len(items))
        self.newest_now = max(self.newest_now, self._max_now(items))
        self._staleness_at_take = 1
        self._drain(items)

    def close(self, timeout: float | None = 60) -> None:
        """Flush, then stop the worker thread (a later async submit starts
        it again). A wedged drainer raises instead of being orphaned: a
        :class:`TimeoutError` if the flush cannot complete, a
        :class:`RuntimeError` if the worker does not exit within
        ``timeout``; the worker reference is kept either way."""
        self.flush(timeout=timeout)
        if self._worker is not None:
            with self._cv:
                self._stop = True
                self._cv.notify_all()
            self._worker.join(timeout=timeout)
            if self._worker.is_alive():
                raise RuntimeError(
                    f"shadow drainer did not stop within {timeout}s: the "
                    f"store is NOT quiesced (a live drainer may still "
                    f"apply commits); retry close() once it unwedges")
            self._worker = None
            self._stop = False

    def note_probe_calls(self, n: int) -> None:
        """The FM calls one drain epoch spent (the runner reports them)."""
        self._probe_calls_last += n

    # -- internals ------------------------------------------------------
    @staticmethod
    def _max_now(items) -> int:
        return max((getattr(it, "now", 0) or 0 for it in items), default=0)

    def _take(self) -> list[ShadowItem]:
        with self._cv:
            items, self._items = self._items, []
            self._staleness_at_take = self._batches
            self._batches = 0
            self._sync_gauges_locked()
            return items

    def _requeue(self, items: list[ShadowItem]) -> None:
        """A drain failed: put its items back at the head and restore one
        pending batch, so cadence-based drains still trigger."""
        with self._cv:
            self._items = list(items) + self._items
            self._batches += 1
            self.items_requeued += len(items)
            self._m_requeued.inc(len(items))
            self.drain_failures += 1
            self._m_failures.inc()
            self._sync_gauges_locked()

    def _drain(self, items: list[ShadowItem]) -> None:
        stale_batches = max(1, self._staleness_at_take)
        self._probe_calls_last = 0
        t0 = time.perf_counter_ns()
        opened = tracing.begin("shadow.drain", t0)
        try:
            if self.fault_plan is not None:
                self.fault_plan.fire("drain")
            if self.drain_delay:
                time.sleep(self.drain_delay)
            self.runner(items)
            if self.drain_policy is not None and self.device is not None \
                    and self.device.type == "cuda":
                # the policy fits seconds of device work, not of launches
                tracing.count("host_sync.drain_policy")
                torch.cuda.current_stream(self.device).synchronize()
        except BaseException:
            tracing.end(opened)
            self._requeue(items)
            raise
        t1 = time.perf_counter_ns()
        tracing.end(opened, t1)
        dt = (t1 - t0) / 1e9
        self.items_drained += len(items)
        self.drains += 1
        self.last_drain_now = max(self.last_drain_now, self._max_now(items))
        with self.metrics.lock:
            self._m_drained.inc(len(items))
            self._m_drains.inc()
            self._m_h_items.observe(len(items))
            self._m_h_secs.observe(dt)
            self._m_h_probes.observe(self._probe_calls_last)
            self._m_h_stale.observe(stale_batches)
            self._m_stale_t.set(self.staleness_logical)
        if self.drain_policy is not None:
            self.drain_policy.note_drain(len(items), dt)

    def _reraise(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("shadow drainer failed") from err

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            if self.stream is None and self.device is not None and \
                    self.device.type == "cuda":
                self.stream = torch.cuda.Stream(self.device)
            self._worker = threading.Thread(target=self._loop,
                                            name="shadow-drainer",
                                            daemon=True)
            self._worker.start()

    def _due_locked(self) -> bool:
        if not self._items:
            return False
        if self._error is not None:
            # the failed epoch's error is not consumed yet: hold its items
            return False
        if self._retry_holdback and not self._flush_requested:
            return False
        return self._flush_requested or (
            self.flush_every > 0 and self._batches >= self.flush_every)

    def _loop(self) -> None:
        if self.stream is None:
            return self._serve_loop()
        # the current stream is per thread: this one holds for every
        # kernel the drainer launches
        with torch.cuda.stream(self.stream):
            return self._serve_loop()

    def _serve_loop(self) -> None:
        while True:
            with self._cv:
                self._cv.wait_for(lambda: self._stop or self._due_locked())
                if self._stop and not self._items:
                    return
                items, self._items = self._items, []
                self._staleness_at_take = self._batches
                self._batches = 0
                self._draining = True
                self._sync_gauges_locked()
            try:
                if items:
                    self._drain(items)
            except BaseException as e:   # surfaced at the next barrier;
                self._error = e          # _drain already re-queued items
                with self._cv:
                    self._retry_holdback = True
            finally:
                with self._cv:
                    self._draining = False
                    self._cv.notify_all()
