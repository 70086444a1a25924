"""Deterministic fault injection, the counterpart of
``src/repro/serving/faults.py``: one seedable :class:`FaultPlan` drives
every failure mode the recovery plane handles, so each scenario fires the
same faults at the same logical points run after run. With no plan (the
default everywhere) every site is a no-op.

Sites the single-controller path fires (the rest belong to the serving
fabrics and stay in :data:`SITES` for plan compatibility):

* ``"tier_call"``: :class:`repro_torch.core.fm.ResilientTier` before each
  FM call. ``"error"`` raises :class:`repro_torch.core.fm.InjectedTierError`
  (transient, retryable); ``"delay"`` injects a latency spike, or raises
  :class:`repro_torch.core.fm.TierTimeout` at once when it exceeds the
  caller's cooperative ``timeout``. Ids: ``tier``, ``op``.
* ``"drain"``: the shadow queue at the start of a drain epoch.
  ``"error"`` raises :class:`InjectedFault`, surfaced at the next barrier
  like any drainer exception. No ids.
* ``"wal_write"``: :class:`repro_torch.core.memory.MemoryJournal` before an
  epoch's write-ahead record is durable; a ``"crash"`` loses the epoch
  (recovery lands on the one before). Ids: ``epoch``.
* ``"commit_apply"``: :class:`repro_torch.core.memory.CommitStream` after
  the record is durable, before the in-memory apply; a ``"crash"`` recovers
  one epoch ahead of the dead process's store. Ids: ``epoch``.
* ``"replica_serve"``, ``"heartbeat"``, ``"transport_frame"``,
  ``"clock_skew"``: the fabrics' sites (``replica_serve`` raises
  :class:`ReplicaCrash`).

Actions: ``"crash"``, ``"error"``, ``"delay"`` and ``"kill"`` (SIGKILL of
the calling process). A spec fires when its ``site`` matches and every key
of ``spec.match`` equals the id the site fired with; it acts on its
matching hits ``at .. at + count - 1`` (1-based).

:func:`random_plan` draws a reproducible schedule from a seed.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np

#: the sites components fire, and what actions make sense at each
SITES = ("replica_serve", "tier_call", "drain", "wal_write",
         "commit_apply", "heartbeat", "transport_frame", "clock_skew")
ACTIONS = ("crash", "error", "delay", "kill")


class InjectedFault(RuntimeError):
    """Base of every exception raised by a :class:`FaultPlan`."""


class ReplicaCrash(InjectedFault):
    """A fabric worker died before executing its queued microbatch. The
    supervisor treats this (and only this) as redispatchable: the batch
    had no side effects yet, so re-running it elsewhere is exact."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One planned fault: fire ``action`` at matching events number
    ``at .. at + count - 1`` (1-based) of ``site``."""
    site: str
    action: str
    match: tuple = ()          # ((key, value), ...) — ids that must match
    at: int = 1
    count: int = 1
    delay: float = 0.0         # seconds, for action="delay"

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"fault site {self.site!r} not in {SITES}")
        if self.action not in ACTIONS:
            raise ValueError(f"fault action {self.action!r} not in "
                             f"{ACTIONS}")
        if self.at < 1 or self.count < 1:
            raise ValueError(f"at={self.at}/count={self.count} must be "
                             f">= 1 (hit numbers are 1-based)")
        object.__setattr__(self, "match", tuple(sorted(
            dict(self.match).items())))

    def matches(self, site: str, ids: dict) -> bool:
        return site == self.site and all(
            k in ids and ids[k] == v for k, v in self.match)


class FaultPlan:
    """A deterministic schedule of injected faults (see module doc).

    Thread-safe: fabric workers, the shadow drainer and the serve thread
    may all fire concurrently; per-spec hit counters are kept under one
    lock so a spec fires exactly ``count`` times no matter which thread
    reaches it. ``fired`` records every fault actually raised/injected
    (site, action, ids) in firing order — the reproducibility probe the
    tests assert on.
    """

    def __init__(self, specs: list[FaultSpec] | tuple = (),
                 sleep_fn=time.sleep):
        self.specs = list(specs)
        self._hits = [0] * len(self.specs)
        self._lock = threading.Lock()
        self._sleep = sleep_fn
        self.fired: list[tuple[str, str, tuple]] = []

    # Plans cross the process boundary (each fabric worker carries its
    # own copy, with independent hit counters from the pickling point
    # on). Locks and bound sleep functions don't pickle — rebuild them.
    def __getstate__(self) -> dict:
        with self._lock:
            return {"specs": self.specs, "_hits": list(self._hits),
                    "fired": list(self.fired)}

    def __setstate__(self, state: dict) -> None:
        self.specs = state["specs"]
        self._hits = state["_hits"]
        self.fired = state["fired"]
        self._lock = threading.Lock()
        self._sleep = time.sleep

    # -- plan construction helpers --------------------------------------
    @staticmethod
    def replica_crash(replica: int, at: int = 1,
                      count: int = 1) -> FaultSpec:
        return FaultSpec("replica_serve", "crash",
                         (("replica", replica),), at=at, count=count)

    @staticmethod
    def tier_error(tier: str, at: int = 1, count: int = 1) -> FaultSpec:
        return FaultSpec("tier_call", "error", (("tier", tier),), at=at,
                         count=count)

    @staticmethod
    def tier_delay(tier: str, delay: float, at: int = 1,
                   count: int = 1) -> FaultSpec:
        return FaultSpec("tier_call", "delay", (("tier", tier),), at=at,
                         count=count, delay=delay)

    @staticmethod
    def drain_error(at: int = 1, count: int = 1) -> FaultSpec:
        return FaultSpec("drain", "error", at=at, count=count)

    @staticmethod
    def wal_crash(at: int = 1) -> FaultSpec:
        """Die before epoch number ``at``'s WAL record is durable."""
        return FaultSpec("wal_write", "crash", at=at)

    @staticmethod
    def apply_crash(at: int = 1) -> FaultSpec:
        """Die after epoch number ``at``'s WAL record, mid-apply."""
        return FaultSpec("commit_apply", "crash", at=at)

    @staticmethod
    def replica_kill(replica: int, at: int = 1) -> FaultSpec:
        """SIGKILL the worker *process* as it picks up its ``at``-th
        microbatch — the hard-death analog of :meth:`replica_crash`."""
        return FaultSpec("replica_serve", "kill",
                         (("replica", replica),), at=at)

    @staticmethod
    def heartbeat_crash(replica: int, at: int = 1) -> FaultSpec:
        """Kill a worker's heartbeat thread at its ``at``-th beat: the
        worker hangs from the lease monitor's point of view."""
        return FaultSpec("heartbeat", "crash", (("replica", replica),),
                         at=at)

    @staticmethod
    def transport_delay(delay: float, at: int = 1, count: int = 1,
                        end: str | None = None,
                        replica: int | None = None) -> FaultSpec:
        """Wire-latency spike on frame sends (optionally one end / one
        replica's channel only)."""
        match = []
        if end is not None:
            match.append(("end", end))
        if replica is not None:
            match.append(("replica", replica))
        return FaultSpec("transport_frame", "delay", tuple(match),
                         at=at, count=count, delay=delay)

    @staticmethod
    def clock_skew(skew: float, at: int = 1, count: int = 1) -> FaultSpec:
        """Advance the lease monitor's clock by ``skew`` seconds at its
        ``at``-th sample (see :meth:`take_skew`)."""
        return FaultSpec("clock_skew", "delay", at=at, count=count,
                         delay=skew)

    # -- firing ---------------------------------------------------------
    def fire(self, site: str, timeout: float | None = None,
             **ids) -> None:
        """Called by an instrumented component at one of its injection
        sites. Raises / sleeps according to the first matching due spec;
        a site with no matching due spec is a no-op."""
        due: FaultSpec | None = None
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.matches(site, ids):
                    self._hits[i] += 1
                    if due is None and \
                            spec.at <= self._hits[i] < spec.at + spec.count:
                        due = spec
            if due is not None:
                self.fired.append((site, due.action,
                                   tuple(sorted(ids.items()))))
        if due is None:
            return
        if due.action == "kill":
            # hard machine-level death: no exception, no cleanup. The
            # fired record above lives only in this process's copy of
            # the plan and dies with it — the *supervisor's* counters
            # (deaths/restarts) are what tests assert on.
            import os
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
        if due.action == "crash":
            if site == "replica_serve":
                raise ReplicaCrash(f"injected crash at {site} {ids}")
            raise InjectedFault(f"injected crash at {site} {ids}")
        if due.action == "error":
            if site == "tier_call":
                from repro_torch.core.fm import InjectedTierError
                raise InjectedTierError(
                    f"injected tier error at {site} {ids}")
            raise InjectedFault(f"injected error at {site} {ids}")
        # action == "delay": a latency spike. Cooperative timeout: a
        # caller with a deadline shorter than the spike times out
        # immediately instead of sleeping it through.
        if timeout is not None and due.delay > timeout:
            from repro_torch.core.fm import TierTimeout
            raise TierTimeout(
                f"injected {due.delay}s latency spike exceeds the "
                f"{timeout}s call timeout at {site} {ids}")
        if due.delay:
            self._sleep(due.delay)

    def take_skew(self, site: str = "clock_skew", **ids) -> float:
        """Sum of due ``"delay"`` spec delays at ``site`` for this
        sample, *without sleeping* — the lease monitor adds the result
        to its monotonic clock, so injected skew perturbs lease math
        deterministically instead of stalling the monitor thread. Every
        matching spec's hit counter advances, and due specs are
        recorded in ``fired`` like any other injection."""
        total = 0.0
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.action == "delay" and spec.matches(site, ids) \
                        and spec.delay:
                    self._hits[i] += 1
                    if spec.at <= self._hits[i] < spec.at + spec.count:
                        total += spec.delay
                        self.fired.append((site, "delay",
                                           tuple(sorted(ids.items()))))
        return total

    # -- inspection -----------------------------------------------------
    @property
    def n_fired(self) -> int:
        with self._lock:
            return len(self.fired)

    def stats(self) -> dict:
        with self._lock:
            by_site: dict[str, int] = {}
            for site, _, _ in self.fired:
                by_site[site] = by_site.get(site, 0) + 1
            return {"specs": len(self.specs), "fired": len(self.fired),
                    "fired_by_site": by_site}


def random_plan(seed: int, *, replicas: int = 0, crashes: int = 0,
                tier_errors: int = 0, drain_errors: int = 0,
                wal_crashes: int = 0, apply_crashes: int = 0,
                kills: int = 0, transport_delays: int = 0,
                clock_skews: int = 0, max_jitter: float = 0.05,
                horizon: int = 50, tiers=("strong",)) -> FaultPlan:
    """A reproducible random fault schedule — the soak test's
    crash/recover generator. Draws fault positions in ``[1, horizon]``
    from a seeded generator; the same seed always yields the same plan
    (and therefore, against a deterministic stream, the same run).

    Beyond crashes/brownouts, the schedule can now cover the journal's
    kill points (``wal_crashes``/``apply_crashes``), process-level
    SIGKILLs (``kills``), and timing perturbation: seeded wire-latency
    jitter (``transport_delays``) and lease-monitor clock skew
    (``clock_skews``), each spike drawn in ``(0, max_jitter]``."""
    rng = np.random.default_rng(seed)
    specs: list[FaultSpec] = []
    for _ in range(crashes):
        specs.append(FaultPlan.replica_crash(
            int(rng.integers(0, max(replicas, 1))),
            at=int(rng.integers(1, horizon + 1))))
    for _ in range(tier_errors):
        specs.append(FaultPlan.tier_error(
            str(rng.choice(list(tiers))),
            at=int(rng.integers(1, horizon + 1))))
    for _ in range(drain_errors):
        specs.append(FaultPlan.drain_error(
            at=int(rng.integers(1, horizon + 1))))
    for _ in range(wal_crashes):
        specs.append(FaultPlan.wal_crash(
            at=int(rng.integers(1, horizon + 1))))
    for _ in range(apply_crashes):
        specs.append(FaultPlan.apply_crash(
            at=int(rng.integers(1, horizon + 1))))
    for _ in range(kills):
        specs.append(FaultPlan.replica_kill(
            int(rng.integers(0, max(replicas, 1))),
            at=int(rng.integers(1, horizon + 1))))
    for _ in range(transport_delays):
        specs.append(FaultPlan.transport_delay(
            float(rng.uniform(0.0, max_jitter)) or max_jitter,
            at=int(rng.integers(1, horizon + 1)),
            count=int(rng.integers(1, 4))))
    for _ in range(clock_skews):
        specs.append(FaultPlan.clock_skew(
            float(rng.uniform(0.0, max_jitter)) or max_jitter,
            at=int(rng.integers(1, horizon + 1)),
            count=int(rng.integers(1, 4))))
    return FaultPlan(specs)
