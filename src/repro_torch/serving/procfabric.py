"""Process-per-replica serving fabric, the counterpart of
``src/repro/serving/procfabric.py``: OS-process isolation behind the same
``Ticket``/``submit``/``join`` boundary as the thread fabric.

The parent process keeps everything authoritative: the shared
:class:`repro_torch.core.memory.CommitStream` (store, journal, recovery
manifest), the learn replica that runs every shadow drain, the logical
clock and the supervision plane. Each **worker** is a process of its own
holding a serve-only :class:`repro_torch.core.pipeline.MicrobatchRAR`
built from a picklable ``replica_factory``: its own interpreter, its own
tiers and, on the card, its own CUDA context and kernel library. Workers
start with ``"spawn"`` (CUDA cannot be forked: ``start_method="fork"`` on
a CUDA device raises), and a worker builds its replica before it reports
``ready``, so that start-up does not count against its lease. The parent
builds the kernel library before it spawns anything, so N workers never
run ``nvcc`` at once.

Worker and parent speak the framed pickle protocol of
:mod:`repro_torch.serving.transport` over a duplex pipe, FIFO per channel.
Frames carry host values only, never a tensor: the store snapshot a
worker starts from and every epoch's ops cross as numpy, and each side
rebuilds its tensors on its own device.

* parent to worker: ``("init", payload)`` first (the store snapshot, the
  factory, the config, the epoch counters, the fault plan),
  ``("serve", dispatch_id, nows, prompts, guide_requests, keys, embs)``, ``("epoch", epoch, records, soft_clears,
  touches, n)`` (a commit epoch, the cross-process view update),
  ``("ack", dispatch_id)`` and ``("stop",)``;
* worker to parent: ``("ready", pid)``, ``("fail", reason)`` (the replica
  could not be built), ``("hb", seq, epoch)``, ``("done", dispatch_id,
  outcomes, shadow_items, deferred_items, engine_delta, launch_delta)``
  and ``("err", dispatch_id, exc)``.

The **"done" message is the commit point**: a worker has no
authoritative side effect before it (store writes happen in the parent's
drain, the clock advances at submit, engine counters and kernel launch
counts ride in "done" as deltas), so a death before "done" (SIGKILL
included) leaves the system as if the batch was never dispatched, and its
redispatch with the same pre-allocated stamps serves it byte for byte.
After each "done" the worker waits for the parent's ``"ack"``, sent once
that batch's drain has run and its epochs are on the wire: the next serve
then sees its predecessors' commits (the serve-after-drain order a thread
replica gets by draining inline). Every "done" is acked, stale ones too.

Supervision: EOF on the pipe (exit, SIGKILL) and lease expiry (no
heartbeat for ``lease_timeout``, read through
:meth:`FaultPlan.take_skew` so injected skew expires leases
deterministically) feed one death path: mark dead, respawn against the
current store (without a fault plan), redispatch in-flight tickets within
``RARConfig.max_redispatch``, and drop a late "done" of a redispatched
batch (``stale_drops``). A worker that dies before it was ever ready (its
factory raised, or it could not reach its device) is not respawned: its
tickets go to a live worker within the budget, or fail with
:class:`WorkerDied`, so a broken factory cannot respawn forever.
``RARConfig.journal_path`` gives the parent the thread fabric's journal
and recovery manifest (which also carries the workers' engine deltas).
"""
from __future__ import annotations

import collections
import dataclasses
import multiprocessing as mp
import os
import threading
import time

import numpy as np
import torch

from repro_torch.core import decisions
from repro_torch.core import memory as mem
from repro_torch.core.memory_ivf import IVFMemory
from repro_torch.core.pipeline import MicrobatchRAR
from repro_torch.core.shadow import AdaptiveDrainPolicy
from repro_torch.kernels import _build, ops
from repro_torch.serving import transport
from repro_torch.serving.fabric import ServingFabric, Ticket
from repro_torch.serving.faults import InjectedFault, ReplicaCrash
from repro_torch.serving.transport import ChannelClosed, FramedChannel

#: the store fields a worker's snapshot carries
_STORE_FIELDS = ("emb", "mask", "guide", "hard", "added_at")


class WorkerDied(RuntimeError):
    """A worker process died and the ticket's redispatch budget is
    exhausted — surfaced at :meth:`Ticket.wait` like any worker error."""


# ---------------------------------------------------------------------------
# Worker side (runs in the child process)
# ---------------------------------------------------------------------------


class _WorkerReplica(MicrobatchRAR):
    """Serve-only controller for one worker process: shadow items are
    *collected* instead of drained (the parent's learn replica owns the
    authoritative drain), and the queue's drain fault site is disabled —
    it fires on the parent's real drain, not the worker's collector."""

    def __init__(self, *args, **kwargs):
        self.collected: list = []
        super().__init__(*args, **kwargs)

    def _shadow_runner(self):
        return self.collected.extend

    def _make_shadow_queue(self):
        q = super()._make_shadow_queue()
        q.fault_plan = None
        return q


def _engine_counters(rep) -> dict:
    """Host-side cost counters of the worker's tiers, for delta
    shipping."""
    out = {}
    for name, tier in (("weak", rep.weak), ("strong", rep.strong)):
        engine = getattr(tier, "engine", None)
        if hasattr(engine, "export_counters"):
            out[name] = engine.export_counters()
    return out


def _counter_delta(cur: dict, prev: dict) -> dict:
    return {name: {k: cur[name][k] - prev.get(name, {}).get(k, 0)
                   for k in cur[name]} for name in cur}


def _host_store(store) -> dict:
    """A plain store as host values (an IVF store ships its backing
    store; the worker's controller re-wraps and re-indexes it)."""
    if isinstance(store, IVFMemory):
        store = store.store
    out = {f: mem._host(getattr(store, f)) for f in _STORE_FIELDS}
    out["ptr"] = int(store.ptr)
    return out


def _device_store(host: dict, device) -> mem.MemoryState:
    return mem.MemoryState(
        **{f: torch.from_numpy(host[f]).to(device) for f in _STORE_FIELDS},
        ptr=host["ptr"])


def _worker_main(conn, index: int) -> None:
    """Child-process entry point: take the "init" message, build the
    serve-only replica from the factory, report ``ready`` (or ``fail``),
    then loop on the channel until "stop" (or the parent disappears)."""
    channel = FramedChannel(conn, end="worker", replica=index)
    try:
        _, init = channel.recv()
        channel.fault_plan = init["fault_plan"]
        try:
            rep, stream = _build_replica(init)
        except Exception as e:        # noqa: BLE001 — reported, then exit
            channel.send(("fail", f"{type(e).__name__}: {e}"))
            return
        _worker_loop(channel, init, rep, stream)
    except ChannelClosed:
        pass                          # parent gone — nothing to report to
    finally:
        channel.close()


def _build_replica(init: dict):
    """The worker's replica on its device (and, on the card, its CUDA
    context and the kernel library the parent built), and its mirror of
    the parent's commit stream."""
    # N workers share the host's cores: one intra-op thread each
    torch.set_num_threads(1)
    device = torch.device(init["device"])
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the fabric serves on CUDA but this worker "
                               "sees no card")
        _build.lib()
    parts = init["factory"]()
    store = _device_store(init["store"], device)
    # local mirror of the parent's commit stream: epoch numbering resumes
    # where the snapshot left off, but ``commits`` restarts at 0 — the
    # snapshot's ring pointer already folds every prior commit into
    # ``_ptr_base`` (counting them again would double ``ptr_snap``)
    stream = mem.CommitStream()
    stream.buffer.epoch = init["epoch"]
    stream.buffer.entries_applied = init["entries"]
    rep = _WorkerReplica(parts["weak"], parts["strong"],
                         parts["embed_fn"], parts["route_weak_fn"],
                         init["cfg"], aligned_fn=parts.get("aligned_fn"),
                         memory=store, commit_stream=stream,
                         fault_plan=init["fault_plan"], device=device)
    return rep, stream


def _worker_loop(channel: FramedChannel, init: dict, rep,
                 stream: mem.CommitStream) -> None:
    index = init["index"]
    plan = init["fault_plan"]

    stop_beat = threading.Event()

    def _beat() -> None:
        seq = 0
        while not stop_beat.is_set():
            if plan is not None:
                try:
                    # a "crash" here kills only this thread: the worker
                    # keeps serving but its lease expires — the
                    # hung-worker case
                    plan.fire("heartbeat", replica=index)
                except InjectedFault:
                    return
            seq += 1
            try:
                # epoch rides along: a plain int read of the mirror's
                # counter — staleness-tolerant (it is a gauge), no lock
                channel.send(("hb", seq, stream.buffer.epoch))
            except ChannelClosed:
                return
            stop_beat.wait(init["lease_interval"])

    channel.send(("ready", os.getpid()))
    threading.Thread(target=_beat, name=f"hb-{index}",
                     daemon=True).start()
    last = _engine_counters(rep)
    last_launches = ops.launch_counts()

    backlog: collections.deque = collections.deque()
    while True:
        msg = backlog.popleft() if backlog else channel.recv()
        kind = msg[0]
        if kind == "stop":
            stop_beat.set()
            return
        if kind == "epoch":
            # broadcast drain epochs, coalesced: every epoch frame
            # already queued behind this one folds into a single
            # apply_ops call. Records sort by logical time inside
            # apply_ops and flag ops carry their own pointer snapshots,
            # so the batched apply is byte-identical to applying the
            # epochs one at a time — the same path live drains and WAL
            # recovery use — while amortizing the per-apply dispatch
            # cost across a drain burst.
            _, epoch, records, soft_clears, touches, n = msg
            records = list(records)
            soft_clears = list(soft_clears)
            touches = list(touches)
            while True:
                if backlog:
                    nxt = backlog.popleft()
                elif channel.poll():
                    nxt = channel.recv()
                else:
                    break
                if nxt[0] != "epoch":
                    backlog.appendleft(nxt)
                    break
                _, epoch, more_r, more_s, more_t, m = nxt
                records += more_r
                soft_clears += more_s
                touches += more_t
                n += m
            with stream.lock:
                rep.memory, _ = stream.buffer.apply_ops(
                    rep.memory, records, soft_clears, touches)
                stream.buffer.epoch = epoch
                stream.commits += n
            continue
        # ("serve", dispatch_id, nows, prompts, greqs, keys, embs)
        _, dispatch_id, nows, prompts, greqs, keys, embs = msg
        try:
            if plan is not None:
                # before ANY side effect — a "kill" (SIGKILL) or "crash"
                # (hard exit) here leaves a batch the parent can
                # redispatch byte-identically
                plan.fire("replica_serve", replica=index)
            outcomes = rep.process_batch(prompts, greqs, keys=keys,
                                         embs=embs, nows=nows)
        except ReplicaCrash:
            os._exit(13)              # abrupt death: EOF at the parent
        except BaseException as e:    # noqa: BLE001 — shipped verbatim
            rep.collected.clear()
            rep.deferred_probes = []
            try:
                channel.send(("err", dispatch_id, e))
            except ChannelClosed:
                return
            except Exception:         # unpicklable exception: ship repr
                channel.send(("err", dispatch_id, RuntimeError(repr(e))))
            continue
        # outcome objects are shared between the outcomes list and the
        # shadow/deferred items; ship list indices instead and let the
        # parent rebind, so pickling cannot fork object identity
        out_idx = {id(o): j for j, o in enumerate(outcomes)}
        shadow_items = []
        for it in rep.collected:
            j = out_idx[id(it.outcome)]
            it.outcome = None
            shadow_items.append((j, it))
        # in place: the queue's runner is a bound method of THIS list
        rep.collected.clear()
        deferred_items = []
        for it in rep.deferred_probes:
            j = out_idx.get(id(it.outcome), -1)
            it.outcome = None
            deferred_items.append((j, it))
        rep.deferred_probes = []
        cur = _engine_counters(rep)
        delta, last = _counter_delta(cur, last), cur
        # the kernels this worker launched for the batch (its own
        # process's counters), summed by the parent
        now_launches = ops.launch_counts()
        launch_delta = {k: v - last_launches.get(k, 0)
                        for k, v in now_launches.items()
                        if v != last_launches.get(k, 0)}
        last_launches = now_launches
        channel.send(("done", dispatch_id, outcomes, shadow_items,
                      deferred_items, delta, launch_delta))
        # serve-after-drain gate: block until the parent acks this
        # batch's drain. Every epoch frame received before the ack is
        # part of (or prior to) that drain, so apply them HERE — serve
        # frames that were already queued ahead of those epochs in the
        # pipe get backlogged and must not run against a stale mirror.
        # The epochs coalesce into one apply, same as the main loop.
        acc_r, acc_s, acc_t = [], [], []
        acc_n, acc_epoch = 0, None
        while True:
            nxt = channel.recv()
            gate_kind = nxt[0]
            if gate_kind == "epoch":
                _, acc_epoch, more_r, more_s, more_t, m = nxt
                acc_r += more_r
                acc_s += more_s
                acc_t += more_t
                acc_n += m
                continue
            if gate_kind == "ack":
                break
            if gate_kind == "stop":
                stop_beat.set()
                return
            backlog.append(nxt)       # serves keep their FIFO order
        if acc_epoch is not None:
            with stream.lock:
                rep.memory, _ = stream.buffer.apply_ops(
                    rep.memory, acc_r, acc_s, acc_t)
                stream.buffer.epoch = acc_epoch
                stream.commits += acc_n


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------


class _WorkerHandle:
    """Parent-side bookkeeping for one worker process."""

    def __init__(self, index: int):
        self.index = index
        self.proc = None
        self.channel: FramedChannel | None = None
        self.reader: threading.Thread | None = None
        self.inflight: dict[int, tuple] = {}   # dispatch_id -> (ticket,
        #                                        payload)
        self.last_beat = time.monotonic()
        self.ready = threading.Event()
        self.alive = False
        self.fail_reason: str | None = None   # why its replica failed
        self.death_reason: str | None = None  # as its tickets were told
        # a worker that died before it was ready has failed a ticket: one
        # was in flight at its death, or was submitted to its dead slot
        self.failure_seen = False
        self.pid: int | None = None
        self.epoch: int | None = None  # last commit epoch the worker
        #                                reported (via heartbeat)


class EpochLagDrainPolicy(AdaptiveDrainPolicy):
    """Adaptive drain cadence for the process fabric's parent learn
    plane, driven by the per-worker **commit-epoch lag** the heartbeats
    already ship (``("hb", seq, epoch)`` → ``_WorkerHandle.epoch``).

    In the process fabric every drain's commits must rebroadcast to the
    worker mirrors, so the broadcast plane's state is the signal that
    matters — not just the global pending count the base policy sees:

    - lag ``0`` (every live worker has applied the authoritative
      epoch): the broadcast plane is idle, a drain ships its epoch at
      minimum staleness — drain **eagerly**;
    - lag ``>= defer_lag`` batches behind: workers are still chewing on
      earlier broadcasts; piling another epoch on the wire only grows
      the mirror gap — **defer** (the queue-level ``shadow_flush_every``
      hard cap still bounds staleness independently of this policy);
    - in between: fall through to the fitted drain-cost model.

    The lag read is a lock-free heuristic over heartbeat state: a torn
    read can only skew one cadence decision, never correctness — the
    drain itself serializes on the parent's locks as always.
    """

    def __init__(self, lag_fn, *, defer_lag: int = 4, **kwargs):
        super().__init__(**kwargs)
        if defer_lag < 1:
            raise ValueError(f"defer_lag must be >= 1, got {defer_lag}")
        self._lag_fn = lag_fn
        self.defer_lag = defer_lag
        self.lag_eager_drains = 0
        self.lag_deferrals = 0

    def due(self) -> bool:
        if self.pending_items() == 0:
            self.decisions += 1
            return False
        lag = self._lag_fn()
        if lag >= self.defer_lag:
            self.decisions += 1
            self.lag_deferrals += 1
            return False
        if lag == 0:
            self.decisions += 1
            self.lag_eager_drains += 1
            return True
        return super().due()

    def stats(self) -> dict:
        s = super().stats()
        s.update({
            "worker_epoch_lag": self._lag_fn(),
            "defer_lag": self.defer_lag,
            "lag_eager_drains": self.lag_eager_drains,
            "lag_deferrals": self.lag_deferrals,
        })
        return s


class ProcessServingFabric(ServingFabric):
    """Process-per-replica fabric (see module doc).

    ``replica_factory`` must be picklable (a module-level function or a
    ``functools.partial`` of one) and return a dict with keys ``weak``,
    ``strong``, ``embed_fn``, ``route_weak_fn`` and optionally
    ``aligned_fn`` — it is called once in the parent (learn plane) and
    once inside every worker process (serve plane), so a deterministic
    factory yields identical tiers on both sides.
    """

    def __init__(self, replica_factory, cfg=None, *, workers: int = 1,
                 fault_plan=None, lease_interval: float = 0.25,
                 lease_timeout: float = 5.0, start_method: str = "spawn",
                 device="cuda"):
        if workers < 1:
            raise ValueError(f"workers={workers} must be >= 1")
        if lease_timeout <= lease_interval:
            raise ValueError(
                f"lease_timeout={lease_timeout} must exceed "
                f"lease_interval={lease_interval}")
        if torch.device(device).type == "cuda" and start_method == "fork":
            raise ValueError("start_method='fork' cannot serve on CUDA: a "
                             "forked child cannot use the parent's CUDA "
                             "context; use 'spawn' or 'forkserver'")
        # referenced by the _manifest_state/_restore_manifest overrides,
        # which super().__init__ may call during journal recovery
        self._remote_engine: dict[str, dict] = {}
        #: kernel launches of every worker ever alive, by kernel
        self._remote_launches: dict[str, int] = {}
        self.stale_drops = 0
        self.lease_expiries = 0
        self.startup_failures = 0
        parts = replica_factory()
        super().__init__(parts["weak"], parts["strong"],
                         parts["embed_fn"], parts["route_weak_fn"],
                         cfg, replicas=1,
                         aligned_fn=parts.get("aligned_fn"),
                         fault_plan=fault_plan, device=device)
        if self.device.type == "cuda":
            _build.build()
        self.replica_factory = replica_factory
        # re-entrant: _on_done holds it across the learn-plane rebind
        # AND the inline drain it may trigger (which re-acquires it via
        # ServingFabric._drain)
        self._drain_lock = threading.RLock()
        self.n_workers = workers
        self.lease_interval = lease_interval
        self.lease_timeout = lease_timeout
        self._ctx = mp.get_context(start_method)
        # workers must never journal, never drain, never defer drains:
        # the parent owns every authoritative effect
        self._worker_cfg = dataclasses.replace(
            self.cfg, journal_path=None, shadow_mode="inline",
            shadow_flush_every=1, shadow_dedup_sim=None)
        self.health = ["healthy"] * workers
        self._handles: list[_WorkerHandle] = []
        if self.cfg.shadow_mode == "adaptive":
            # the parent learn plane is the only drainer here, and every
            # drain's commits must rebroadcast to the workers — so the
            # cadence decision should see the broadcast plane's state
            # (per-worker commit-epoch lag from heartbeats), not just
            # the global pending count the thread fabric looks at
            policy = EpochLagDrainPolicy(self._max_worker_epoch_lag)
            policy.register(self.learn.shadow)
            self.learn.shadow.drain_policy = policy
            self.drain_policy = policy
        self._did = 0                 # dispatch-id allocator
        self._closed = False
        self.commit_stream.ops_listener = self._broadcast_ops
        with self._dispatch_lock:
            for i in range(workers):
                self._handles.append(self._spawn_locked(i, fault_plan))
        self._stop_monitor = threading.Event()
        self._monitor_thread = threading.Thread(
            target=self._monitor, name="lease-monitor", daemon=True)
        self._monitor_thread.start()

    # -- spawning ---------------------------------------------------------
    def _spawn_locked(self, index: int, fault_plan) -> _WorkerHandle:
        """Start worker ``index`` against the current authoritative store
        (snapshot + epoch counters — the folded equivalent of a full
        CommitStream replay). Called under ``_dispatch_lock``."""
        handle = _WorkerHandle(index)
        parent_conn, worker_conn = transport.channel_pair(self._ctx)
        handle.channel = FramedChannel(parent_conn,
                                       fault_plan=self.fault_plan,
                                       end="parent", replica=index)
        with self.commit_stream.lock:
            init = {
                "index": index,
                "factory": self.replica_factory,
                "cfg": self._worker_cfg,
                "device": str(self.device),
                "store": _host_store(self.learn.memory),
                "epoch": self.commit_stream.buffer.epoch,
                "entries": self.commit_stream.buffer.entries_applied,
                "fault_plan": fault_plan,
                "lease_interval": self.lease_interval,
            }
        # the start payload holds the store and the factory (megabytes
        # on the card's workloads): passed as a Process argument, the
        # parent's write of it would wait for each child's imports in turn;
        # as the channel's first frame, sent in the background, N workers
        # start at once
        handle.proc = self._ctx.Process(
            target=_worker_main, args=(worker_conn, index),
            name=f"serve-worker-{index}", daemon=True)
        handle.proc.start()
        worker_conn.close()           # parent drops its copy: EOF works
        handle.channel.send_first(("init", init))
        handle.alive = True
        handle.epoch = init["epoch"]  # mirror starts at the snapshot
        handle.last_beat = time.monotonic()
        handle.reader = threading.Thread(
            target=self._reader, args=(handle,),
            name=f"reader-{index}", daemon=True)
        handle.reader.start()
        return handle

    # -- epoch broadcast --------------------------------------------------
    def _broadcast_ops(self, epoch, records, soft_clears, touches,
                       n) -> None:
        """Commit-stream tap (called under the stream lock after every
        applied epoch): forward the epoch's ops to every live worker —
        the cross-process analog of the in-process view broadcast. FIFO
        channel ordering guarantees a worker applies epoch k before any
        serve dispatched after k."""
        host_records = [(now, mem._host(e), mem._host(g).astype(np.int32),
                         bool(hg), bool(hard))
                        for now, e, g, hg, hard in records]
        msg = ("epoch", epoch, host_records, list(soft_clears),
               list(touches), n)
        data = transport.frame_message(msg)   # pickle once, fan out bytes
        for handle in self._handles:
            if handle.alive:
                try:
                    handle.channel.send_raw(data)
                except ChannelClosed:
                    pass              # the reader declares the death

    # -- dispatch ---------------------------------------------------------
    def submit(self, prompts, guide_requests, keys=None, embs=None,
               replica: int | None = None) -> Ticket:
        """Dispatch one microbatch to a worker process. Logical time is
        allocated *here*, at admission — a redispatch after a worker
        death reuses the same stamps, which is the byte-identity
        anchor."""
        if self._closed:
            raise RuntimeError("fabric is closed")
        if embs is not None:
            embs = mem._host(embs)     # frames carry host values only
        with self._dispatch_lock:
            nows = self.clock.advance(len(prompts))
            if replica is None:
                for _ in range(self.n_workers):
                    replica = self._rr % self.n_workers
                    self._rr += 1
                    if self.health[replica] != "dead":
                        break
                if self.health[replica] == "dead":
                    # every slot is transiently marked dead: the old
                    # fall-through dispatched to whichever dead slot the
                    # pointer stopped on, orphaning the ticket on a
                    # handle the death path had already drained. Prefer
                    # a slot whose handle is live (just respawned);
                    # revive the chosen slot under the held dispatch
                    # lock if none is.
                    for off in range(self.n_workers):
                        j = (replica + off) % self.n_workers
                        if self._handles[j].alive:
                            replica = j
                            break
                    dead = self._handles[replica]
                    if not dead.alive and not dead.ready.is_set() and \
                            not dead.failure_seen:
                        # its replica could not be built, and no ticket
                        # has failed on it yet: this one fails as it
                        # would have had it reached the worker before the
                        # failure was seen, so the counts do not depend on
                        # which came first; the next submit respawns
                        dead.failure_seen = True
                        ticket = Ticket(replica=replica)
                        self._tickets.append(ticket)
                        self._redispatch_locked(
                            replica, ticket,
                            (nows, prompts, guide_requests, keys, embs),
                            dead.death_reason)
                        return ticket
                    if not dead.alive:
                        self._handles[replica] = self._spawn_locked(
                            replica, None)
                        self.restarts += 1
                    self.health[replica] = "healthy"
            ticket = Ticket(replica=replica)
            self._tickets.append(ticket)
            payload = (nows, prompts, guide_requests, keys, embs)
            self._dispatch_locked(self._handles[replica], ticket, payload)
        return ticket

    def _dispatch_locked(self, handle: _WorkerHandle, ticket: Ticket,
                         payload) -> None:
        self._did += 1
        handle.inflight[self._did] = (ticket, payload)
        try:
            handle.channel.send(("serve", self._did) + payload)
        except ChannelClosed:
            pass    # stays inflight; the death path redispatches it

    # -- reader / completion ----------------------------------------------
    def _reader(self, handle: _WorkerHandle) -> None:
        while True:
            try:
                msg = handle.channel.recv()
            except transport.ChannelError:
                if handle.alive:
                    self._on_worker_death(handle, "channel closed")
                return
            kind = msg[0]
            if kind == "ready":
                handle.pid = msg[1]
                handle.last_beat = time.monotonic()
                handle.ready.set()
            elif kind == "hb":
                handle.last_beat = time.monotonic()
                if len(msg) > 2:      # epoch-carrying heartbeat
                    handle.epoch = msg[2]
            elif kind == "done":
                handle.last_beat = time.monotonic()
                self._on_done(handle, *msg[1:])
            elif kind == "err":
                self._on_err(handle, msg[1], msg[2])
            elif kind == "fail":
                handle.fail_reason = msg[1]

    def _on_done(self, handle: _WorkerHandle, dispatch_id: int,
                 outcomes, shadow_items, deferred_items,
                 engine_delta, launch_delta=None) -> None:
        """The batch's atomic commit point: rebind its shadow/deferred
        items into the learn plane, account the worker's engine delta,
        resolve the ticket. A dispatch id the handle no longer carries
        means the supervisor already redispatched the batch (lease-
        expired-but-alive worker) — dropped, never double-applied. The
        kernel launches count either way: the worker ran them."""
        with self._dispatch_lock:
            for name, n in (launch_delta or {}).items():
                self._remote_launches[name] = \
                    self._remote_launches.get(name, 0) + n
            entry = handle.inflight.pop(dispatch_id, None)
            if entry is None:
                self.stale_drops += 1
            else:
                ticket, _ = entry
                for name, delta in engine_delta.items():
                    acc = self._remote_engine.setdefault(
                        name, {"calls": 0, "tokens_processed": 0})
                    for k, v in delta.items():
                        acc[k] = acc.get(k, 0) + v
        if entry is None:
            # stale (already redispatched) — still ack: the sender, if
            # it is somehow alive on this channel, must not wait forever
            self._ack(handle, dispatch_id)
            return
        learn = self.learn
        ticket.outcomes = outcomes
        try:
            # the drain lock (re-entrant) serializes concurrent readers
            # across seq allocation AND the inline drain submit may run
            with self._drain_lock:
                items = []
                for idx, it in shadow_items:
                    it.outcome = outcomes[idx]
                    it.seq = learn.shadow.next_seq()
                    items.append(it)
                for idx, it in deferred_items:
                    if idx >= 0:
                        it.outcome = outcomes[idx]
                    it.seq = learn.shadow.next_seq()
                    learn.deferred_probes.append(it)
                    learn.probes_deferred += 1
                # always submitted (even empty) so deferred/async flush
                # cadence counts batches exactly like the threaded fabric
                learn.shadow.submit(items)
        except BaseException as e:    # drain faults surface on the ticket
            ticket.error = e
            self._ack(handle, dispatch_id)
            ticket._done.set()
            return
        degraded = any(o.case in decisions.DEGRADED_CASES
                       for o in outcomes)
        if self.health[handle.index] != "dead":
            self.health[handle.index] = ("suspect" if degraded
                                         else "healthy")
        # ack AFTER the drain (and its epoch broadcasts): FIFO delivery
        # of epochs-then-ack is the worker's serve-after-drain gate
        self._ack(handle, dispatch_id)
        ticket._done.set()

    def _ack(self, handle: _WorkerHandle, dispatch_id: int) -> None:
        """Release the worker's serve-after-drain gate. Sent on *every*
        done path — commit, drain error, stale drop — so a worker never
        blocks on an ack that will not come."""
        try:
            handle.channel.send(("ack", dispatch_id))
        except ChannelClosed:
            pass                      # the reader declares the death

    def _on_err(self, handle: _WorkerHandle, dispatch_id: int,
                exc: BaseException) -> None:
        """An application error inside the worker's serve — surfaced at
        the ticket, NOT redispatched (parity with the threaded fabric:
        only crashes known to precede all side effects are re-run)."""
        with self._dispatch_lock:
            entry = handle.inflight.pop(dispatch_id, None)
        if entry is None:
            self.stale_drops += 1
            return
        ticket, _ = entry
        ticket.error = exc
        ticket._done.set()

    # -- supervision ------------------------------------------------------
    def _on_worker_death(self, handle: _WorkerHandle,
                         reason: str) -> None:
        """First detector (EOF reader or lease monitor) wins; the rest
        no-op. Mark dead, respawn the slot against the current
        authoritative store, redispatch in-flight work under the budget,
        then reap the corpse outside the lock. A worker that never became
        ready (its replica could not be built) is not respawned: its
        tickets go to a live worker within the budget, or fail, and so
        does the first ticket submitted to its slot if none was in flight
        (:meth:`submit`)."""
        with self._dispatch_lock:
            if not handle.alive or self._closed:
                return
            handle.alive = False
            i = handle.index
            self.health[i] = "dead"
            self.deaths += 1
            inflight = sorted(handle.inflight.items())
            handle.inflight = {}
            reason = handle.fail_reason or reason
            handle.death_reason = reason
            handle.failure_seen = bool(inflight)
            if handle.ready.is_set():
                # fresh worker, no fault plan: a spent kill spec must not
                # re-fire on the replacement
                self._handles[i] = self._spawn_locked(i, None)
                self.health[i] = "healthy"
                self.restarts += 1
            else:
                self.startup_failures += 1
            for _, (ticket, payload) in inflight:
                self._redispatch_locked(i, ticket, payload, reason)
        if handle.proc is not None and handle.proc.is_alive():
            handle.proc.kill()
            handle.proc.join(timeout=5)
        handle.channel.close()

    def _redispatch_locked(self, i: int, ticket: Ticket, payload,
                           reason: str) -> None:
        """A ticket of dead worker ``i``: to a live worker within the
        redispatch budget, else failed with :class:`WorkerDied`."""
        target = self._pick_live_locked(exclude=i)
        if ticket.redispatches < self.cfg.max_redispatch and \
                self._handles[target].alive:
            ticket.redispatches += 1
            self.redispatches += 1
            ticket.replica = target
            self._dispatch_locked(self._handles[target], ticket, payload)
        else:
            ticket.error = WorkerDied(
                f"worker {i} died ({reason}); no live worker within the "
                f"redispatch budget ({self.cfg.max_redispatch})")
            ticket._done.set()

    def _pick_live_locked(self, exclude: int) -> int:
        n = self.n_workers
        for off in range(1, n):
            j = (exclude + off) % n
            if self.health[j] != "dead":
                return j
        return exclude                # its slot was just respawned

    def _monitor(self) -> None:
        while not self._stop_monitor.wait(self.lease_interval / 2):
            ready = [h for h in list(self._handles)
                     if h.alive and h.ready.is_set()]
            if not ready:
                continue
            skew = 0.0
            if self.fault_plan is not None:
                # a transient spike in the monitor's view of time for
                # THIS sample (sampled only once a worker is beating, so
                # a planned spike always lands on live lease math)
                skew = self.fault_plan.take_skew("clock_skew")
            now = time.monotonic() + skew
            for handle in ready:
                overdue = now - handle.last_beat
                if overdue > self.lease_timeout:
                    self.lease_expiries += 1
                    self._on_worker_death(
                        handle, f"lease expired ({overdue:.2f}s without "
                                f"a heartbeat)")
                elif overdue > 2 * self.lease_interval and \
                        self.health[handle.index] == "healthy":
                    self.health[handle.index] = "suspect"

    # -- lifecycle --------------------------------------------------------
    def close_shadow(self) -> None:
        """Flush, stop the workers cleanly, close the learn plane, then
        checkpoint the manifest (after the final replay's epochs).
        Idempotent."""
        if self._closed:
            return
        self.flush_shadow()
        self._stop_monitor.set()
        with self._dispatch_lock:
            self._closed = True
            live = [h for h in self._handles if h.alive]
            for handle in live:
                handle.alive = False
        for handle in live:
            try:
                handle.channel.send(("stop",))
            except transport.ChannelError:
                pass
        for handle in live:
            if handle.proc is not None:
                handle.proc.join(timeout=30)
                if handle.proc.is_alive():
                    handle.proc.kill()
                    handle.proc.join(timeout=5)
            handle.channel.close()
        self.learn.close_shadow()
        self.commit_stream.checkpoint()

    close = close_shadow

    def kill(self) -> None:
        """Abandon everything without flushing or checkpointing — the
        whole-fabric crash the recovery tests simulate. The journal's
        per-epoch fsyncs are already durable; recovery rebuilds from
        them."""
        self._stop_monitor.set()
        with self._dispatch_lock:
            self._closed = True
            handles = [h for h in self._handles if h.alive]
            for handle in handles:
                handle.alive = False
        for handle in handles:
            if handle.proc is not None and handle.proc.is_alive():
                handle.proc.kill()
                handle.proc.join(timeout=5)
            handle.channel.close()
        if self.commit_stream.journal is not None:
            self.commit_stream.journal.close()

    # -- manifest / accounting --------------------------------------------
    def _manifest_state(self) -> dict:
        man = super()._manifest_state()
        man["remote_engines"] = {name: dict(acc) for name, acc
                                 in self._remote_engine.items()}
        return man

    def _restore_manifest(self, man: dict) -> None:
        super()._restore_manifest(man)
        self._remote_engine = {name: dict(acc) for name, acc
                               in man.get("remote_engines", {}).items()}

    def engine_calls(self, name: str) -> int:
        """Total inference calls of one tier across the parent (drain
        plane) and every worker ever alive (serve plane, via shipped
        deltas) — the fabric-wide RAR cost metric."""
        tier = {"weak": self.learn.weak,
                "strong": self.learn.strong}[name]
        engine = getattr(tier, "engine", None)
        local = getattr(engine, "calls", 0) if engine is not None else 0
        return local + self._remote_engine.get(name, {}).get("calls", 0)

    def worker_launches(self) -> dict[str, int]:
        """Kernel launches of every worker ever alive, by kernel (each
        worker's own counters, shipped in its "done" messages)."""
        with self._dispatch_lock:
            return dict(self._remote_launches)

    def _max_worker_epoch_lag(self) -> int:
        """Worst-case commit-epoch lag across live workers (0 until the
        first heartbeat reports an epoch). Lock-free: heartbeat state is
        monotone per worker and a stale read only skews one drain-
        cadence decision."""
        epoch = self.commit_stream.buffer.epoch
        lag = 0
        for h in self._handles:
            if h.alive and h.epoch is not None:
                lag = max(lag, epoch - h.epoch)
        return lag

    def metrics(self) -> dict:
        """Parent-plane metrics plus the worker plane: per-worker health,
        in-flight depth and commit-epoch lag (authoritative epoch minus
        the worker mirror's last heartbeat-reported epoch), transport
        frame counters, stale drops and lease expiries. Host-side
        counters only — no device syncs."""
        m = super().metrics()
        epoch = self.commit_stream.buffer.epoch
        with self._dispatch_lock:
            m["workers"] = [{
                "worker": h.index,
                "health": self.health[h.index],
                "alive": h.alive,
                "inflight": len(h.inflight),
                "commit_epoch_seen": h.epoch,
                "commit_epoch_lag": (max(0, epoch - h.epoch)
                                     if h.epoch is not None else None),
            } for h in self._handles]
            m["transport"] = {
                "frames_sent": sum(h.channel.sent
                                   for h in self._handles),
                "frames_received": sum(h.channel.received
                                       for h in self._handles),
            }
            m["stale_drops"] = self.stale_drops
            m["lease_expiries"] = self.lease_expiries
        return m

    def stats(self) -> dict:
        s = super().stats()
        s.update({
            "workers": self.n_workers,
            "transport": {
                "frames_sent": sum(h.channel.sent
                                   for h in self._handles),
                "frames_received": sum(h.channel.received
                                       for h in self._handles),
            },
            "stale_drops": self.stale_drops,
            "lease_expiries": self.lease_expiries,
            "startup_failures": self.startup_failures,
            "remote_engines": {name: dict(acc) for name, acc
                               in self._remote_engine.items()},
            "worker_launches": self.worker_launches(),
        })
        return s
