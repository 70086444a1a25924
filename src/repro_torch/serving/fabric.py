"""Replicated serving fabric, the counterpart of
``src/repro/serving/fabric.py``: N serve replicas behind one admission
point, one learn replica, one commit stream.

* **Serve plane**: N replicas, each a
  :class:`repro_torch.core.pipeline.MicrobatchRAR` with a worker thread of
  its own. Microbatches dispatch round-robin (or to a given replica); a
  replica serves its queue in FIFO order. The serve threads launch on the
  device's default stream, as the JAX package's threads share one device,
  so their kernels queue there in launch order.
* **Learn plane**: every replica's :class:`~repro_torch.core.shadow.
  ShadowQueue` keeps its own schedule (inline, deferred, async, adaptive),
  but its runner is :meth:`ServingFabric._drain`, which serializes the
  drains and runs them on the learn replica (replica 0). In ``async`` mode
  each replica's drainer thread has a CUDA stream of its own, so N side
  streams write the one store; the store lock orders them
  (:class:`repro_torch.core.memory.StoreLock`: a side-stream holder waits
  for the default stream; :func:`repro_torch.core.memory.settle`: a
  side-stream write ends with a sync of its stream).
* **Commit stream**: one :class:`repro_torch.core.memory.CommitStream`;
  every drain stages into its buffer, applies in place under its lock and
  hands the store to every replica's view in the same step, so every
  replica reads a whole number of drain epochs and the commit counter has
  one owner (``memory_occupancy`` is exact at any replica count).

Replicas draw logical time from one shared clock (the commit buffer keys
staged ops by it). With ``replicas=1`` the synchronous
:meth:`ServingFabric.process_batch` is ``MicrobatchRAR.process_batch``
exactly (``tests/test_torch_fabric.py`` holds it, and the fabric, to the
JAX package's).

Recovery plane, as in the JAX package: replica health (``healthy``,
``suspect``, ``dead``, ``retired``); a worker killed by a
:class:`~repro_torch.serving.faults.ReplicaCrash` (fired before any side
effect of its microbatch) is restarted and its microbatch redispatched to
a survivor, at most ``RARConfig.max_redispatch`` times; other exceptions
surface on the :class:`Ticket`. The tiers share one
:class:`~repro_torch.core.fm.ResilientTier` (one breaker) when a
resilience knob is on; ``RARConfig.journal_path`` journals the shared
stream and recovers the store and the fabric's engine state at
construction; :meth:`join`/:meth:`flush_shadow` take a timeout;
:meth:`scale_to`, :meth:`autoscale` and :class:`QueueLatencyAutoscaler`
resize the fleet.
"""
from __future__ import annotations

import dataclasses
import queue as _queue
import sys
import threading
import time

from repro_torch.core import decisions
from repro_torch.core import memory as mem
from repro_torch.core.fm import ResilientTier
from repro_torch.core.memory_ivf import wrap_store
from repro_torch.core.pipeline import MicrobatchRAR
from repro_torch.core.rar import Outcome, RARConfig, retry_policy
from repro_torch.core.shadow import AdaptiveDrainPolicy
from repro_torch.device import resolve_device
from repro_torch.serving.faults import ReplicaCrash
from repro_torch.serving.metrics import MetricsRegistry

#: replica health states (supervision). ``retired`` is terminal for a
#: slot: an autoscale-down drained its queue and stopped its worker;
#: dispatch skips it and its health is never overwritten.
HEALTH = ("healthy", "suspect", "dead", "retired")


class _SharedClock:
    """Thread-safe logical-time allocator shared by all replicas."""

    def __init__(self):
        self._now = 0
        self._lock = threading.Lock()

    def advance(self, n: int) -> list[int]:
        with self._lock:
            base = self._now
            self._now = base + n
        return list(range(base + 1, base + n + 1))

    def restore(self, now: int) -> None:
        """Resume logical time after a crash recovery (manifest)."""
        with self._lock:
            self._now = int(now)

    @property
    def now(self) -> int:
        return self._now


class _FabricReplica(MicrobatchRAR):
    """One serve replica: a ``MicrobatchRAR`` wired into the fabric's
    shared pieces — the commit stream (store views + single counter),
    the logical clock, and the learn-replica drain."""

    def __init__(self, fabric: "ServingFabric", index: int, *args,
                 **kwargs):
        self._fabric = fabric
        self.index = index
        super().__init__(*args, **kwargs)

    def _advance_now(self, n: int) -> list[int]:
        nows = self._fabric.clock.advance(n)
        self.now = nows[-1]               # diagnostic mirror
        return nows

    def _shadow_runner(self):
        # per-replica queue (own drain schedule + stats), but the runner
        # funnels into the fabric so the single learn replica executes
        # every drain against the shared commit stream
        return self._fabric._drain

    def _metrics_registry(self):
        # ONE fabric-wide registry: every replica's queue mirrors into
        # it under a per-replica prefix, so a single snapshot covers the
        # whole fabric consistently
        return self._fabric.metrics_registry

    def _metrics_prefix(self) -> str:
        return f"replica{self.index}/shadow/"

    def _drain_policy(self):
        # in adaptive mode the fabric shares ONE policy across all
        # replicas' queues — a drain decision sees the global pending
        # set and flushes the whole group (None for the other modes)
        return self._fabric.drain_policy


@dataclasses.dataclass
class Ticket:
    """Handle for one dispatched microbatch: resolves to the Outcome list
    once the owning replica's serve sweep completes (shadow outcomes may
    still be provisional until a :meth:`ServingFabric.flush_shadow`
    barrier, exactly as with a standalone ``MicrobatchRAR``).

    ``redispatches`` counts supervisor re-runs after a replica crash
    (``replica`` is rewritten to the surviving replica each time); a
    timed-out :meth:`wait` leaves the ticket fully waitable — the batch
    is still in flight, not abandoned."""
    replica: int
    outcomes: list[Outcome] | None = None
    error: BaseException | None = None
    redispatches: int = 0
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event)

    def wait(self, timeout: float | None = None) -> list[Outcome]:
        if not self._done.wait(timeout):
            raise TimeoutError("microbatch still in flight")
        if self.error is not None:
            raise RuntimeError(
                f"serve replica {self.replica} failed") from self.error
        return self.outcomes


class ServingFabric:
    """Admit → dispatch → serve across N replicas; learn on one."""

    def __init__(self, weak, strong, embed_fn, route_weak_fn,
                 cfg: RARConfig | None = None, *, replicas: int = 1,
                 memory=None, aligned_fn=None, fault_plan=None,
                 device="cuda"):
        if replicas < 1:
            raise ValueError(f"replicas={replicas} must be >= 1")
        cfg = cfg if cfg is not None else RARConfig()
        self.cfg = cfg
        self.fault_plan = fault_plan
        self.device = resolve_device(device)
        # crash-consistent memory: a journal_path attaches a WAL +
        # snapshot journal to the shared stream and recovers the
        # pre-crash store before any replica is built
        recovered, manifest = None, None
        if cfg.journal_path is not None:
            self.commit_stream, recovered, manifest = \
                mem.open_journaled_stream(
                    cfg.journal_path, cfg.memory,
                    snapshot_every=cfg.snapshot_every,
                    fault_plan=fault_plan, device=self.device)
        else:
            self.commit_stream = mem.CommitStream(fault_plan=fault_plan)
        # tier resilience is fabric-level: ONE shared wrapper (and
        # breaker) across replicas, so an outage seen by any replica
        # degrades routing on all of them. RAR.__init__'s isinstance
        # check makes replica construction a no-op re-wrap.
        if cfg.tier_resilience:
            policy = retry_policy(cfg)
            if not isinstance(weak, ResilientTier):
                weak = ResilientTier(weak, policy, name="weak",
                                     fault_plan=fault_plan, seed=1)
            if not isinstance(strong, ResilientTier):
                strong = ResilientTier(strong, policy, name="strong",
                                       fault_plan=fault_plan, seed=2)
        self.clock = _SharedClock()
        self._drain_lock = threading.Lock()
        # metrics plane: one registry for the whole fabric — replicas'
        # shadow queues mirror into it (per-replica prefixes), the
        # commit stream bumps its epoch counters, and ``metrics()``
        # snapshots everything consistently
        self.metrics_registry = MetricsRegistry()
        self.commit_stream.metrics = self.metrics_registry
        # global adaptive cadence: one shared policy across every
        # replica's queue (None unless shadow_mode == "adaptive")
        self.drain_policy = (AdaptiveDrainPolicy()
                             if cfg.shadow_mode == "adaptive" else None)
        # one store, N views: the store (a MemoryState or an injected
        # ShardedMemory) is written in place, every commit apply hands the
        # same object to every replica's view, and the stream's lock makes
        # it reader-atomic
        if memory is not None:
            store = memory
        elif recovered is not None:
            store = recovered
        else:
            store = mem.init_memory(cfg.memory, device=self.device)
        # two-level retrieval: wrap the shared store in the IVF plane
        # once, before the replicas are built, so every replica shares
        # one index (the per-replica wrap is then a no-op)
        store = wrap_store(store, cfg)
        # construction args kept (post-ResilientTier-wrap) so the
        # autoscaler can spawn additional replicas sharing the exact
        # same tiers/breaker/commit stream
        self._replica_args = (weak, strong, embed_fn, route_weak_fn)
        self._aligned_fn = aligned_fn
        self.replicas = [
            _FabricReplica(self, i, weak, strong, embed_fn, route_weak_fn,
                           cfg, aligned_fn=aligned_fn, memory=store,
                           commit_stream=self.commit_stream,
                           fault_plan=fault_plan, device=self.device)
            for i in range(replicas)]
        #: the learn replica: owns every shadow drain (and therefore the
        #: RQ2 guide counters)
        self.learn = self.replicas[0]
        self._rr = 0
        self._dispatch_lock = threading.Lock()
        self._queues: list[_queue.Queue] | None = None
        # indexed parallel to ``replicas`` so a supervisor restart
        # replaces exactly its slot
        self._threads: list[threading.Thread | None] = []
        self._tickets: list[Ticket] = []
        #: supervision state, one entry per replica (∈ :data:`HEALTH`)
        self.health: list[str] = ["healthy"] * replicas
        self.deaths = 0        # worker threads lost to a ReplicaCrash
        self.restarts = 0      # supervisor restarts
        self.redispatches = 0  # microbatches re-run on a survivor
        # autoscaling (policy callable, no-op default): maps a metrics
        # snapshot to a target active-replica count; ``autoscale()``
        # applies it behind a health gate
        self.autoscale_policy = None
        self.autoscale_ticks = 0   # supervisor ticks that ran autoscale()
        self._autoscale_thread: threading.Thread | None = None
        self._autoscale_stop = threading.Event()
        self.spawned = 0       # replicas added by scale-up
        self.retired = 0       # replicas retired by scale-down
        # full-state crash consistency: the fabric-wide engine state
        # (shared clock, learn-plane counters, parked deferred probes,
        # shared breaker/engine counters) rides inside every journaled
        # WAL epoch as the recovery manifest; a rebuilt fabric on the
        # same journal path resumes serving byte-identically to an
        # unkilled one (held in the fault and process-fabric tests)
        if self.commit_stream.journal is not None:
            self.commit_stream.state_provider = self._manifest_state
            if manifest is not None:
                self._restore_manifest(manifest)

    # -- full-state crash consistency (recovery manifest) ----------------
    def _manifest_state(self) -> dict:
        """Fabric-wide engine state journaled with every WAL epoch
        (called by the commit stream under its lock). Counters are the
        fabric-level aggregates; restore re-homes them on the learn
        replica (which owns every drain), so the aggregate views are
        exact after recovery."""
        man = {"now": self.clock.now,
               "guides_from_memory": self.guides_from_memory,
               "guides_generated": self.guides_generated,
               "probes_deferred": sum(r.probes_deferred
                                      for r in self.replicas),
               "probes_replayed": sum(r.probes_replayed
                                      for r in self.replicas),
               "deferred_probes": [it for r in self.replicas
                                   for it in r.deferred_probes],
               "tiers": {}, "engines": {}}
        for name, tier in (("weak", self.learn.weak),
                           ("strong", self.learn.strong)):
            if isinstance(tier, ResilientTier):
                man["tiers"][name] = tier.export_state()
            engine = getattr(tier, "engine", None)
            if hasattr(engine, "export_counters"):
                man["engines"][name] = engine.export_counters()
        return man

    def _restore_manifest(self, man: dict) -> None:
        self.clock.restore(man["now"])
        learn = self.learn
        learn.now = man["now"]
        learn.guides_from_memory = man["guides_from_memory"]
        learn.guides_generated = man["guides_generated"]
        learn.probes_deferred = man["probes_deferred"]
        learn.probes_replayed = man["probes_replayed"]
        learn.deferred_probes = list(man["deferred_probes"])
        for name, tier in (("weak", learn.weak),
                           ("strong", learn.strong)):
            if isinstance(tier, ResilientTier) and \
                    name in man.get("tiers", {}):
                tier.restore_state(man["tiers"][name])
            engine = getattr(tier, "engine", None)
            if hasattr(engine, "restore_counters") and \
                    name in man.get("engines", {}):
                engine.restore_counters(man["engines"][name])

    # -- learn plane ----------------------------------------------------
    def _drain(self, items) -> None:
        """Every replica queue's runner: serialize drains and execute
        them on the learn replica. The commit stream broadcasts the
        applied store to every replica view, so a drain triggered by any
        replica updates all of them atomically."""
        with self._drain_lock:
            self.learn._drain_shadow(items)

    # -- synchronous dispatch -------------------------------------------
    def _pick(self, replica: int | None) -> _FabricReplica:
        if replica is not None:
            return self.replicas[replica]
        with self._dispatch_lock:
            for _ in range(len(self.replicas)):
                i = self._rr % len(self.replicas)
                self._rr += 1
                if self.health[i] != "retired":
                    return self.replicas[i]
            return self.learn        # replica 0 never retires

    def process_batch(self, prompts, guide_requests, keys=None, embs=None,
                      replica: int | None = None) -> list[Outcome]:
        """Serve one microbatch synchronously on the caller's thread
        through one replica (round-robin by default). With ``replicas=1``
        this is bit-identical to calling
        ``MicrobatchRAR.process_batch`` directly (pinned in
        ``tests/test_torch_fabric.py``)."""
        return self._pick(replica).process_batch(prompts, guide_requests,
                                                 keys=keys, embs=embs)

    # -- threaded dispatch ----------------------------------------------
    def _ensure_workers(self) -> None:
        # check-and-create under the dispatch lock: concurrent first
        # submits must not spawn duplicate worker sets (orphaned queues
        # would never receive the shutdown sentinel)
        with self._dispatch_lock:
            if self._queues is not None:
                return
            queues = [_queue.Queue() for _ in self.replicas]
            self._queues = queues
            self._threads = [None] * len(self.replicas)
            for i in range(len(self.replicas)):
                self._spawn_worker_locked(i)

    def _spawn_worker_locked(self, i: int) -> None:
        t = threading.Thread(target=self._worker, args=(i,),
                             name=f"serve-replica-{i}", daemon=True)
        self._threads[i] = t
        t.start()

    def _worker(self, i: int) -> None:
        q = self._queues[i]
        while True:
            task = q.get()
            if task is None:
                return
            ticket = task[0]
            try:
                if self.fault_plan is not None:
                    # the injection point is BEFORE the replica touches
                    # the batch — no clock advance, no FM call, no store
                    # write has happened — so a redispatched re-run is
                    # byte-identical to a no-fault run
                    self.fault_plan.fire("replica_serve", replica=i)
                ticket.outcomes = self.replicas[i].process_batch(
                    task[1], task[2], keys=task[3], embs=task[4])
            except ReplicaCrash as e:
                # worker dies; the supervisor restarts the slot and
                # redispatches the (side-effect-free) microbatch
                self._on_replica_crash(i, task, e)
                return
            except BaseException as e:    # surfaced at wait()/join();
                ticket.error = e          # NOT redispatched — the batch's
                ticket._done.set()        # side effects may have landed
                continue
            # supervision bookkeeping: a batch served entirely weak-only
            # because the strong tier shed marks the replica suspect
            # (strong plane impaired), a clean serve clears it. A slot
            # retired mid-flight keeps its terminal state while it
            # drains the rest of its FIFO.
            degraded = any(o.case in decisions.DEGRADED_CASES
                           for o in ticket.outcomes)
            if self.health[i] != "retired":
                self.health[i] = "suspect" if degraded else "healthy"
            ticket._done.set()

    # -- supervision -----------------------------------------------------
    def _on_replica_crash(self, i: int, task, err: BaseException) -> None:
        """Supervisor: the worker for replica ``i`` died mid-dispatch.
        Mark it dead, restart the slot against the shared commit-stream
        view (its queue — and FIFO order — survives intact), and
        redispatch the failed microbatch to a surviving replica, bounded
        by ``cfg.max_redispatch`` re-runs per ticket."""
        ticket = task[0]
        with self._dispatch_lock:
            self.health[i] = "dead"
            self.deaths += 1
            self._restart_locked(i)
            if ticket.redispatches < self.cfg.max_redispatch:
                ticket.redispatches += 1
                self.redispatches += 1
                target = self._pick_healthy_locked(exclude=i)
                ticket.replica = target
                self._queues[target].put((ticket,) + tuple(task[1:]))
            else:
                # retries exhausted: surface exactly like an
                # unsupervised failure
                ticket.error = err
                ticket._done.set()

    def _restart_locked(self, i: int) -> None:
        """Replace replica ``i``'s dead worker thread with a fresh one on
        the same queue. The replica object itself needs no rebuild: its
        store view is the shared commit stream's broadcast, so the new
        worker picks up exactly where the crash left off."""
        self._spawn_worker_locked(i)
        self.health[i] = "healthy"
        self.restarts += 1

    def _pick_healthy_locked(self, exclude: int) -> int:
        """First non-dead replica other than ``exclude`` (round-robin
        from it); falls back to ``exclude`` itself — by the time we pick,
        its slot has been restarted — so a 1-replica fabric still
        recovers."""
        n = len(self.replicas)
        for off in range(1, n):
            j = (exclude + off) % n
            if self.health[j] not in ("dead", "retired"):
                return j
        return exclude

    def _route_locked(self) -> int:
        """Round-robin over live (non-dead, non-retired) replicas. When
        every active slot is transiently marked dead — the crash window
        between a death and its supervisor restart — do NOT enqueue onto
        a dead slot (the old fall-through bug: the batch could land on a
        queue whose worker is gone and never serve). Instead pick the
        next active slot and revive it under the dispatch lock we
        already hold: if its worker thread is live the "dead" mark is
        stale (supervision already restarted it) and just clears; if the
        worker is really gone, restart it here — by the time the put
        happens the slot has a live worker either way."""
        for _ in range(len(self.replicas)):
            i = self._rr % len(self.replicas)
            self._rr += 1
            if self.health[i] not in ("dead", "retired"):
                return i
        for _ in range(len(self.replicas)):
            i = self._rr % len(self.replicas)
            self._rr += 1
            if self.health[i] == "retired":
                continue
            t = self._threads[i] if i < len(self._threads) else None
            if t is None or not t.is_alive():
                self._restart_locked(i)
            else:
                self.health[i] = "healthy"
            return i
        raise RuntimeError("no active replicas (all retired)")

    def submit(self, prompts, guide_requests, keys=None, embs=None,
               replica: int | None = None) -> Ticket:
        """Dispatch one microbatch to a replica's worker thread and
        return immediately with a :class:`Ticket`. Microbatches sent to
        the same replica serve in submission order (FIFO queue), so a
        caller that shards its stream by replica keeps per-stream
        request order — the property the throughput bench's
        replica-scaling rows rely on for identical routing."""
        self._ensure_workers()
        # one lock hold covers replica choice, ticket registration AND
        # the queue put: concurrent submitters to the same replica keep
        # lock-acquisition order = queue order (the per-replica FIFO
        # guarantee above)
        with self._dispatch_lock:
            if replica is None:
                replica = self._route_locked()
            ticket = Ticket(replica=replica)
            self._tickets.append(ticket)
            self._queues[replica].put((ticket, prompts, guide_requests,
                                       keys, embs))
        return ticket

    def join(self, timeout: float | None = None) -> None:
        """Barrier: every dispatched microbatch has served. Waits
        everything out first, then re-raises the first worker error —
        one dead microbatch cannot strand the others' tickets.

        ``timeout`` bounds the whole barrier: on expiry the not-yet-done
        tickets are re-registered (the barrier can be retried) and a
        :class:`TimeoutError` is raised."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        err: BaseException | None = None
        while True:
            with self._dispatch_lock:
                if not self._tickets:
                    break
                tickets, self._tickets = self._tickets, []
            for n, t in enumerate(tickets):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                try:
                    t.wait(timeout=remaining)
                except TimeoutError:
                    with self._dispatch_lock:
                        self._tickets.extend(tickets[n:])
                    raise TimeoutError(
                        f"fabric join timed out after {timeout}s "
                        f"({len(tickets) - n} microbatch(es) still in "
                        f"flight; tickets stay registered — retry "
                        f"join())") from None
                except BaseException as e:
                    if err is None:
                        err = e
        if err is not None:
            raise err

    # -- barriers / lifecycle -------------------------------------------
    def flush_shadow(self, timeout: float | None = None) -> None:
        """Full barrier: all dispatched microbatches served AND every
        replica's shadow queue drained — all outstanding Outcomes final.
        ``timeout`` bounds the join leg and each replica's drain barrier
        (per-leg, not cumulative)."""
        self.join(timeout=timeout)
        for r in self.replicas:
            r.flush_shadow(timeout=timeout)

    def close_shadow(self) -> None:
        """Flush, then stop the replica workers and the replicas' shadow
        worker threads. A journaled fabric also checkpoints its manifest
        so a clean shutdown recovers byte-identically. Idempotent.

        Teardown runs in a ``finally``: a flush that raises (drainer
        error, barrier timeout) must still sentinel/join every worker
        thread and close every replica's drainer — otherwise the threads
        leak and a retried close would double-spawn. The flush error
        stays the primary exception; teardown errors surface only when
        the flush itself succeeded."""
        self.stop_autoscaler()
        try:
            self.flush_shadow()
            self.commit_stream.checkpoint()
        finally:
            teardown_err: BaseException | None = None
            if self._queues is not None:
                for q in self._queues:
                    q.put(None)
                for t in self._threads:
                    if t is not None:
                        t.join(timeout=60)
                self._queues, self._threads = None, []
            for r in self.replicas:
                try:
                    r.close_shadow()
                except BaseException as e:
                    if teardown_err is None:
                        teardown_err = e
            if teardown_err is not None and sys.exc_info()[0] is None:
                raise teardown_err

    close = close_shadow

    # -- autoscaling ----------------------------------------------------
    def set_autoscaler(self, policy) -> None:
        """Install the autoscaling policy: a callable mapping one
        ``metrics()`` snapshot to a target active-replica count (int).
        ``None`` (the default) makes :meth:`autoscale` a no-op."""
        self.autoscale_policy = policy

    @property
    def active_replicas(self) -> int:
        return sum(1 for h in self.health if h != "retired")

    def autoscale(self) -> int:
        """One autoscaling step: ask the policy for a target count from
        the current metrics and apply it behind a **health gate** — no
        resize while any slot is dead/mid-restart (supervision first,
        capacity second; a crash storm must not race fresh spawns).
        Returns the applied delta (+spawned / -retired / 0)."""
        if self.autoscale_policy is None:
            return 0
        target = int(self.autoscale_policy(self.metrics()))
        with self._dispatch_lock:
            if any(h == "dead" for h in self.health):
                return 0
            return self._scale_to_locked(target)

    def start_autoscaler(self, interval_s: float = 1.0,
                         policy=None) -> None:
        """Run :meth:`autoscale` on a supervisor tick (daemon thread)
        every ``interval_s`` seconds until :meth:`stop_autoscaler` or
        :meth:`close_shadow`. ``policy`` installs a specific policy;
        with none given and none installed, the default
        :class:`QueueLatencyAutoscaler` is used — the tick is what
        turns the policy object into an actual control loop."""
        if policy is not None:
            self.set_autoscaler(policy)
        elif self.autoscale_policy is None:
            self.set_autoscaler(QueueLatencyAutoscaler())
        if self._autoscale_thread is not None \
                and self._autoscale_thread.is_alive():
            return
        self._autoscale_stop.clear()

        def tick():
            while not self._autoscale_stop.wait(interval_s):
                # counted before the resize, so a reader that sees the
                # resize also sees the tick that made it
                self.autoscale_ticks += 1
                try:
                    self.autoscale()
                except Exception:
                    # supervision owns replica health; a racing resize
                    # (e.g. mid-crash-storm) is skipped, not fatal
                    pass

        self._autoscale_thread = threading.Thread(
            target=tick, name="fabric-autoscaler", daemon=True)
        self._autoscale_thread.start()

    def stop_autoscaler(self) -> None:
        """Stop the supervisor tick (idempotent; keeps the policy
        installed for manual :meth:`autoscale` calls)."""
        self._autoscale_stop.set()
        t = self._autoscale_thread
        if t is not None:
            t.join(timeout=10)
        self._autoscale_thread = None

    def scale_to(self, n: int) -> int:
        """Resize to ``n`` active replicas (spawn or retire); returns
        the applied delta."""
        with self._dispatch_lock:
            return self._scale_to_locked(n)

    def _scale_to_locked(self, n: int) -> int:
        if n < 1:
            raise ValueError(f"target replicas={n} must be >= 1 "
                             f"(the learn replica always serves)")
        delta = 0
        while self.active_replicas < n:
            self._spawn_replica_locked()
            delta += 1
        while self.active_replicas > n:
            self._retire_replica_locked()
            delta -= 1
        return delta

    def _spawn_replica_locked(self) -> None:
        """Append a fresh replica sharing the fabric's tiers (and
        breaker), commit stream, clock and metrics registry. Its store
        view starts at the stream's current broadcast; if the threaded
        workers are up, the slot gets its own queue + worker
        immediately, otherwise it joins the synchronous round-robin."""
        weak, strong, embed_fn, route_weak_fn = self._replica_args
        i = len(self.replicas)
        r = _FabricReplica(self, i, weak, strong, embed_fn,
                           route_weak_fn, self.cfg,
                           aligned_fn=self._aligned_fn,
                           memory=self.learn.memory,
                           commit_stream=self.commit_stream,
                           fault_plan=self.fault_plan, device=self.device)
        self.replicas.append(r)
        self.health.append("healthy")
        self.spawned += 1
        if self._queues is not None:
            self._queues.append(_queue.Queue())
            self._threads.append(None)
            self._spawn_worker_locked(i)

    def _retire_replica_locked(self) -> None:
        """Retire the highest-index active slot (never the learn
        replica at index 0 — it owns every drain). The mark is terminal:
        dispatch skips the slot immediately; its worker finishes the
        FIFO already queued, then exits on the sentinel — queued work is
        never dropped."""
        for i in range(len(self.replicas) - 1, 0, -1):
            if self.health[i] != "retired":
                self.health[i] = "retired"
                self.retired += 1
                if self._queues is not None:
                    self._queues[i].put(None)
                return
        raise RuntimeError("only the learn replica remains; "
                           "cannot retire it")

    # -- metrics plane ---------------------------------------------------
    def metrics(self) -> dict:
        """One host-side observability snapshot (zero device syncs —
        every number is a Python int/float already on the host):
        per-replica queue depth / health / shadow staleness + drain
        counters + commit-stream lag, commit progress, engine and
        breaker counters, supervision + autoscaling events, the adaptive
        drain policy's fitted cost model, and the raw registry snapshot
        (drain-cost histograms live there, under
        ``replica{i}/shadow/...`` names)."""
        with self._dispatch_lock:
            queues = self._queues
            health = list(self.health)
        epoch = self.commit_stream.buffer.epoch
        per = []
        for i, r in enumerate(self.replicas):
            sq = r.shadow
            per.append({
                "replica": i,
                "health": health[i] if i < len(health) else "healthy",
                "queue_depth": (queues[i].qsize()
                                if queues is not None and i < len(queues)
                                else 0),
                "shadow_pending": len(sq._items),
                "shadow_staleness_batches": sq._batches,
                "shadow_staleness_logical": sq.staleness_logical,
                "items_enqueued": sq.items_enqueued,
                "items_drained": sq.items_drained,
                "items_requeued": sq.items_requeued,
                "drain_failures": sq.drain_failures,
                "drains": sq.drains,
                # epochs applied fabric-wide vs seen by this replica's
                # store view (0 in the thread fabric's atomic broadcast;
                # the process fabric's worker mirrors can lag)
                "commit_epoch_lag":
                    epoch - getattr(r, "commit_epoch_seen", epoch),
            })
        out = {
            "replicas": per,
            "commit": {"epoch": epoch,
                       "entries_applied":
                           self.commit_stream.buffer.entries_applied,
                       "commits": self.commit_stream.commits},
            "engines": {"weak": _engine_stats(self.learn.weak),
                        "strong": _engine_stats(self.learn.strong)},
            "resilience": {"weak": _tier_stats(self.learn.weak),
                           "strong": _tier_stats(self.learn.strong)},
            "supervision": {"health": health,
                            "deaths": self.deaths,
                            "restarts": self.restarts,
                            "redispatches": self.redispatches,
                            "spawned": self.spawned,
                            "retired": self.retired,
                            "active_replicas":
                                sum(1 for h in health if h != "retired")},
            "drain_policy": (self.drain_policy.stats()
                             if self.drain_policy is not None else None),
            "autoscaler": {
                "ticks": self.autoscale_ticks,
                "policy": (self.autoscale_policy.stats()
                           if hasattr(self.autoscale_policy, "stats")
                           else None),
            },
            "registry": self.metrics_registry.snapshot(),
        }
        return out

    # -- views / accounting ---------------------------------------------
    @property
    def memory(self):
        """The (shared) store, read through the learn replica's view."""
        return self.learn.memory

    @property
    def memory_occupancy(self) -> int:
        """Exact at any replica count: the commit stream owns the single
        host-side counter every replica's occupancy derives from."""
        return self.learn.memory_occupancy

    @property
    def now(self) -> int:
        return self.clock.now

    @property
    def guides_from_memory(self) -> int:
        # drains run on the learn replica only; summing keeps this
        # correct even if a subclass re-homes the drain
        return sum(r.guides_from_memory for r in self.replicas)

    @property
    def guides_generated(self) -> int:
        return sum(r.guides_generated for r in self.replicas)

    def stats(self) -> dict:
        """Host-side fabric counters (no device syncs)."""
        return {
            "replicas": len(self.replicas),
            "now": self.clock.now,
            "memory_occupancy": self.memory_occupancy,
            "commits": self.commit_stream.commits,
            "epochs": self.commit_stream.buffer.epoch,
            "items_enqueued": sum(r.shadow.items_enqueued
                                  for r in self.replicas),
            "items_drained": sum(r.shadow.items_drained
                                 for r in self.replicas),
            "items_coalesced": sum(r.shadow.items_coalesced
                                   for r in self.replicas),
            "reclaimed_weak_calls": sum(r.shadow.reclaimed_weak_calls
                                        for r in self.replicas),
            "reclaimed_strong_calls": sum(r.shadow.reclaimed_strong_calls
                                          for r in self.replicas),
            "weak": _engine_stats(self.learn.weak),
            "strong": _engine_stats(self.learn.strong),
            # recovery plane: supervision, degraded routing, tier
            # resilience, journal — all host counters
            "health": list(self.health),
            "deaths": self.deaths,
            "restarts": self.restarts,
            "redispatches": self.redispatches,
            "spawned": self.spawned,
            "retired": self.retired,
            "probes_deferred": sum(r.probes_deferred
                                   for r in self.replicas),
            "probes_replayed": sum(r.probes_replayed
                                   for r in self.replicas),
            "weak_resilience": _tier_stats(self.learn.weak),
            "strong_resilience": _tier_stats(self.learn.strong),
            "journal": (self.commit_stream.journal.stats()
                        if self.commit_stream.journal is not None
                        else None),
            "faults": (self.fault_plan.stats()
                       if self.fault_plan is not None else None),
        }


class QueueLatencyAutoscaler:
    """Default autoscaling policy: queue depth and latency SLO →
    target active-replica count.

    Consumes one ``fabric.metrics()`` snapshot per call (the contract
    of :meth:`ServingFabric.set_autoscaler`). Scale **up** one replica
    when the mean dispatch-queue depth per active replica exceeds
    ``high_depth``, or — when an SLO is configured and the admission
    scheduler's queueing-delay histogram has samples — its p99 breaches
    ``slo_ms``. Scale **down** one replica when depth sits below
    ``low_depth`` and the p99 (if observable) is comfortably inside the
    SLO (≤ half). Targets clamp to ``[min_replicas, max_replicas]`` and
    move one step per tick: resizes are serialized through the fabric's
    dispatch lock, and a one-step policy cannot oscillate faster than
    the supervisor tick that drives it.
    """

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 8,
                 slo_ms: float | None = None, high_depth: float = 2.0,
                 low_depth: float = 0.25,
                 delay_metric: str = "sched/queue_delay_ms"):
        if min_replicas < 1 or max_replicas < min_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"[{min_replicas}, {max_replicas}]")
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.slo_ms = slo_ms
        self.high_depth = high_depth
        self.low_depth = low_depth
        self.delay_metric = delay_metric
        self.decisions = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.last_target = None
        self.last_depth = None
        self.last_p99 = None

    def _p99(self, metrics: dict) -> float | None:
        hist = (metrics.get("registry") or {}).get(self.delay_metric)
        if isinstance(hist, dict) and hist.get("count", 0) > 0:
            return hist.get("p99")
        return None

    def __call__(self, metrics: dict) -> int:
        sup = metrics.get("supervision", {})
        active = max(1, sup.get("active_replicas", 1))
        depth = sum(r.get("queue_depth", 0)
                    for r in metrics.get("replicas", ())
                    if r.get("health") != "retired")
        mean_depth = depth / active
        p99 = self._p99(metrics)
        slo_breach = (self.slo_ms is not None and p99 is not None
                      and p99 > self.slo_ms)
        target = active
        if mean_depth > self.high_depth or slo_breach:
            target = active + 1
        elif mean_depth < self.low_depth and (
                self.slo_ms is None or p99 is None
                or p99 <= self.slo_ms / 2):
            target = active - 1
        target = max(self.min_replicas, min(self.max_replicas, target))
        self.decisions += 1
        if target > active:
            self.scale_ups += 1
        elif target < active:
            self.scale_downs += 1
        self.last_target = target
        self.last_depth = mean_depth
        self.last_p99 = p99
        return target

    def stats(self) -> dict:
        return {
            "policy": type(self).__name__,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "slo_ms": self.slo_ms,
            "decisions": self.decisions,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "last_target": self.last_target,
            "last_depth": self.last_depth,
            "last_p99": self.last_p99,
        }


def _tier_stats(tier) -> dict | None:
    """A tier's resilience counters, when wrapped in a
    :class:`~repro_torch.core.fm.ResilientTier` (retries / failures / shed /
    breaker state)."""
    return tier.stats() if isinstance(tier, ResilientTier) else None


def _engine_stats(tier) -> dict | None:
    """A tier's engine counters, when it exposes them (real
    ``ServingEngine``s do; rule-based test doubles need not)."""
    fn = getattr(getattr(tier, "engine", None), "stats", None)
    return fn() if fn is not None else None
