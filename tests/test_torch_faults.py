"""The port's fault-tolerance plane against the JAX package's: the twin of
``tests/test_faults.py``: fault plans, tier retries and the circuit
breaker (static and adaptive), sequential and batched brownouts with their
replay, the drain fault at the async barrier, every journal case
(recovery, WAL crash, apply crash, torn tail, bit flip, truncated frame,
resumed serving, the sequential manifest), and the thread fabric's
recovery plane (its brownout, crash redispatch, bounded redispatch,
bounded barriers, journal and soak; JAX's lines 447-597 and 853 on).

Plans are compared with JAX's spec for spec; runs that do not depend on
the wall clock are compared with JAX's run on the same stream (Outcome
streams, stores and counters exact). The port's store is updated in
place, so a run keeps a copy of it after every epoch.
"""
import copy
import os
import threading
import time

import numpy as np
import pytest
import torch
from test_pipeline import make_stream
from test_rar_controller import FakeTier, greq, make_cfg, prompt, skill_emb
from test_torch_pipeline import _host, _plain, _port_cfg, _same_store

from repro.core import memory as jmem
from repro.core.rar import RAR as JRAR
from repro.serving import faults as jfaults
from repro_torch.core import memory as mem
from repro_torch.core.decisions import DEGRADED_CASES
from repro_torch.core.fm import (CircuitBreaker, InjectedTierError,
                                 ResilientTier, RetryPolicy, TierTimeout,
                                 TierUnavailableError)
from repro_torch.core.pipeline import MicrobatchRAR
from repro_torch.core.rar import RAR, retry_policy
from repro_torch.core.shadow import ShadowQueue
from repro_torch.serving.faults import (FaultPlan, FaultSpec, InjectedFault,
                                        ReplicaCrash, random_plan)

WAIT = 60.0


def cfg(**kw):
    """The port's RARConfig of ``make_cfg(**kw)``."""
    return _port_cfg(make_cfg(**kw))


# ---------------------------------------------------------------------------
# FaultPlan mechanics
# ---------------------------------------------------------------------------


def test_fault_spec_validation():
    with pytest.raises(ValueError):
        FaultSpec("nope", "crash")
    with pytest.raises(ValueError):
        FaultSpec("drain", "explode")
    with pytest.raises(ValueError):
        FaultSpec("drain", "error", at=0)


def test_fault_plan_fires_at_exact_hit_numbers():
    plan = FaultPlan([FaultPlan.replica_crash(1, at=2, count=2)])
    plan.fire("replica_serve", replica=1)
    plan.fire("replica_serve", replica=0)
    for _ in range(2):
        with pytest.raises(ReplicaCrash):
            plan.fire("replica_serve", replica=1)
    plan.fire("replica_serve", replica=1)
    assert plan.n_fired == 2
    assert all(site == "replica_serve" for site, _, _ in plan.fired)


def test_fault_plan_reproducible_and_off_is_noop():
    def drive(plan):
        log = []
        for _ in range(6):
            try:
                plan.fire("tier_call", tier="strong", op="answer_batch")
                log.append("ok")
            except InjectedTierError:
                log.append("err")
        return log

    a = drive(FaultPlan([FaultPlan.tier_error("strong", at=3, count=2)]))
    b = drive(FaultPlan([FaultPlan.tier_error("strong", at=3, count=2)]))
    assert a == b == ["ok", "ok", "err", "err", "ok", "ok"]
    assert drive(FaultPlan()) == ["ok"] * 6


@pytest.mark.parametrize("seed", [7, 8, 123])
def test_random_plan_matches_jax(seed):
    """test_faults.py::test_random_plan_is_seed_deterministic, and the
    port's plan is JAX's spec for spec for the same seed."""
    kw = dict(replicas=3, crashes=2, tier_errors=2, drain_errors=1,
              wal_crashes=1, apply_crashes=1, kills=2,
              transport_delays=2, clock_skews=2, max_jitter=0.04)
    a = random_plan(seed, **kw)
    assert a.specs == random_plan(seed, **kw).specs
    assert a.specs != random_plan(seed + 1, **kw).specs
    assert [tuple(vars(s).values()) for s in a.specs] == \
        [tuple(vars(s).values())
         for s in jfaults.random_plan(seed, **kw).specs]
    assert {s.site for s in a.specs} == {
        "replica_serve", "tier_call", "drain", "wal_write",
        "commit_apply", "transport_frame", "clock_skew"}
    assert sum(s.action == "kill" for s in a.specs) == 2
    for s in a.specs:
        if s.site in ("transport_frame", "clock_skew"):
            assert 0.0 < s.delay <= 0.04


# ---------------------------------------------------------------------------
# Tier resilience: retry, backoff, timeout, breaker
# ---------------------------------------------------------------------------


def make_resilient(policy, plan=None, seed=1, **kw):
    inner = FakeTier(known=range(10_000), can_guide=True, name="strong")
    sleeps = []
    rt = ResilientTier(inner, policy, name="strong", fault_plan=plan,
                       seed=seed, sleep_fn=sleeps.append, **kw)
    return rt, inner, sleeps


def test_retry_recovers_from_transient_errors():
    plan = FaultPlan([FaultPlan.tier_error("strong", at=1, count=2)])
    rt, inner, slept = make_resilient(RetryPolicy(max_retries=3), plan)
    assert rt.answer_batch([prompt(3, 1)])[0] == (3 + 1) % 4
    assert rt.retries == 2 and rt.failures == 2
    assert slept == rt.sleeps and len(slept) == 2
    assert inner.engine.calls == 1


def test_retry_backoff_matches_jax():
    """test_faults.py::test_retry_backoff_is_seeded_and_deterministic: the
    port's seeded jitter draws JAX's sleeps exactly."""
    from repro.core.fm import ResilientTier as JResilient
    from repro.core.fm import RetryPolicy as JPolicy

    def sleeps_for(seed, jax=False):
        inner = FakeTier(known=range(10_000), can_guide=True, name="strong")
        slept = []
        if jax:
            plan = jfaults.FaultPlan([jfaults.FaultPlan.tier_error(
                "strong", count=3)])
            rt = JResilient(inner, JPolicy(max_retries=3, backoff_base=0.1),
                            name="strong", fault_plan=plan, seed=seed,
                            sleep_fn=slept.append)
        else:
            plan = FaultPlan([FaultPlan.tier_error("strong", count=3)])
            rt = ResilientTier(inner, RetryPolicy(max_retries=3,
                                                  backoff_base=0.1),
                               name="strong", fault_plan=plan, seed=seed,
                               sleep_fn=slept.append)
        rt.answer_batch([prompt(0, 0)])
        return slept

    a = sleeps_for(5)
    assert a == sleeps_for(5) == sleeps_for(5, jax=True) and len(a) == 3
    for i, s in enumerate(a):
        assert 0.5 * 0.1 * 2 ** i <= s < 1.5 * 0.1 * 2 ** i
    assert sleeps_for(6) != a


def test_exhausted_retries_raise_unavailable():
    plan = FaultPlan([FaultPlan.tier_error("strong", count=10)])
    rt, inner, _ = make_resilient(RetryPolicy(max_retries=2), plan)
    with pytest.raises(TierUnavailableError):
        rt.answer_batch([prompt(0, 0)])
    assert rt.failures == 3
    assert inner.engine.calls == 0


def test_latency_spike_beyond_timeout_raises_tier_timeout():
    plan = FaultPlan([FaultPlan.tier_delay("strong", delay=30.0)])
    rt, _, _ = make_resilient(RetryPolicy(timeout=0.05), plan)
    with pytest.raises(TierUnavailableError) as ei:
        rt.answer_batch([prompt(0, 0)])
    assert isinstance(ei.value.__cause__, TierTimeout)


def test_wrapper_preserves_inner_capability_surface():
    rt, inner, _ = make_resilient(RetryPolicy())
    assert getattr(rt, "answer_many", None) is None
    assert rt.engine is inner.engine
    assert rt.name == "strong"
    with pytest.raises(AttributeError):
        rt.no_such_method


def test_circuit_breaker_lifecycle():
    clock = [0.0]
    br = CircuitBreaker(threshold=2, cooldown=10.0, now_fn=lambda: clock[0])
    assert br.state == "closed" and br.available()
    br.record_failure()
    assert br.state == "closed"
    br.record_failure()
    assert br.state == "open" and br.opens == 1
    assert not br.available()
    with pytest.raises(TierUnavailableError):
        br.before_call()
    assert br.shed == 1
    clock[0] = 11.0
    assert br.available()
    br.before_call()
    assert br.state == "half_open"
    with pytest.raises(TierUnavailableError):
        br.before_call()
    br.record_success()
    assert br.state == "closed" and br.available()


def test_breaker_reopens_on_failed_probe():
    clock = [0.0]
    br = CircuitBreaker(threshold=1, cooldown=5.0, now_fn=lambda: clock[0])
    br.record_failure()
    clock[0] = 6.0
    br.before_call()
    br.record_failure()
    assert br.state == "open" and br.opens == 2
    assert not br.available()


def test_adaptive_breaker_tightens_threshold_and_stretches_cooldown():
    clock = [0.0]
    br = CircuitBreaker(threshold=4, cooldown=10.0, now_fn=lambda: clock[0],
                        adaptive=True, ewma_alpha=0.5)
    st = br.stats()
    assert (st["error_ewma"], st["effective_threshold"],
            st["effective_cooldown"]) == (0.0, 4, 10.0)
    br.record_failure()
    assert br.state == "closed"
    assert br.stats()["effective_threshold"] == 2
    br.record_failure()
    assert br.state == "open" and br.opens == 1
    st = br.stats()
    assert st["error_ewma"] == pytest.approx(0.75)
    assert st["effective_cooldown"] == pytest.approx(17.5)
    clock[0] = 10.5
    assert not br.available()
    clock[0] = 17.5
    assert br.available()


def test_adaptive_breaker_relaxes_back_on_successes():
    clock = [0.0]
    br = CircuitBreaker(threshold=2, cooldown=10.0, now_fn=lambda: clock[0],
                        adaptive=True, ewma_alpha=1.0)
    br.record_failure()
    assert br.state == "open" and br.opens == 1
    clock[0] = 20.0
    assert br.available()
    br.before_call()
    br.record_success()
    assert br.state == "closed"
    st = br.stats()
    assert (st["error_ewma"], st["effective_threshold"],
            st["effective_cooldown"]) == (0.0, 2, 10.0)


def test_adaptive_breaker_default_off_keeps_static_knobs():
    clock = [0.0]
    br = CircuitBreaker(threshold=3, cooldown=5.0, now_fn=lambda: clock[0])
    br.record_failure()
    br.record_failure()
    assert br.error_ewma == 0.0 and br.state == "closed"
    assert br._effective_threshold_locked() == 3
    assert br._effective_cooldown_locked() == 5.0
    assert "error_ewma" not in br.stats()
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=1, cooldown=1.0, ewma_alpha=0.0)
    with pytest.raises(ValueError):
        CircuitBreaker(threshold=1, cooldown=1.0, ewma_alpha=1.5)


def test_adaptive_breaker_state_survives_export_restore():
    clock = [0.0]
    mk = lambda: CircuitBreaker(threshold=4, cooldown=10.0,  # noqa: E731
                                now_fn=lambda: clock[0], adaptive=True,
                                ewma_alpha=0.5)
    br = mk()
    br.record_failure()
    br.record_failure()
    st = br.export_state()
    assert st["error_ewma"] == pytest.approx(0.75)
    br2 = mk()
    br2.restore_state(st)
    assert br2.state == "open" and br2.opens == 1
    assert br2.stats()["effective_cooldown"] == pytest.approx(17.5)
    legacy = dict(st)
    legacy.pop("error_ewma")
    br2.restore_state(legacy)
    assert br2.error_ewma == 0.0


def test_adaptive_knobs_flow_through_config():
    rt, _, _ = make_resilient(RetryPolicy(breaker_threshold=3,
                                          breaker_adaptive=True,
                                          breaker_ewma_alpha=0.5))
    assert rt.breaker.adaptive and rt.breaker.ewma_alpha == 0.5
    pol = retry_policy(cfg(breaker_threshold=2, breaker_adaptive=True,
                           breaker_ewma_alpha=0.3))
    assert pol.breaker_adaptive and pol.breaker_ewma_alpha == 0.3
    with pytest.raises(ValueError):
        cfg(breaker_ewma_alpha=0.0)


def test_default_policy_wrapper_is_pass_through():
    rt, inner, slept = make_resilient(RetryPolicy())
    ref = FakeTier(known=range(10_000), can_guide=True)
    ps = [prompt(s, x) for s in range(4) for x in range(2)]
    np.testing.assert_array_equal(rt.answer_batch(ps), ref.answer_batch(ps))
    np.testing.assert_array_equal(rt.generate_guides([greq(1)], 8),
                                  ref.generate_guides([greq(1)], 8))
    assert inner.engine.calls == ref.engine.calls
    assert rt.breaker is None and not slept


# ---------------------------------------------------------------------------
# Degraded-mode routing: brownout -> weak-only, deferred probes replay
# ---------------------------------------------------------------------------


def brownout_cfg(**kw):
    base = dict(tier_max_retries=0, breaker_threshold=1,
                breaker_cooldown=0.05)
    base.update(kw)
    return cfg(**base)


def test_sequential_brownout_serves_weak_only_and_replays():
    plan = FaultPlan([FaultPlan.tier_error("strong", at=1, count=1)])
    holder = {}
    rar = RAR(FakeTier(known={5, 6}, name="weak"),
              FakeTier(known=range(10_000), can_guide=True, name="strong"),
              lambda p: holder["emb"], lambda e, k: False,
              brownout_cfg(), fault_plan=plan, device="cpu")

    def go(s, x):
        holder["emb"] = skill_emb(s)
        return rar.process(prompt(s, x), greq(s), key=(s, x))

    out = go(5, 1)
    assert out.case == "shadow_deferred" and out.served_by == "weak"
    assert out.strong_calls == 0 and out.response == (5 + 1) % 4
    assert rar.probes_deferred == 1 and len(rar.deferred_probes) == 1
    out2 = go(6, 2)
    assert out2.case == "shadow_deferred" and out2.strong_calls == 0
    assert rar.probes_deferred == 2
    assert rar.memory_occupancy == 0
    time.sleep(0.08)
    assert rar.replay_deferred() == 2
    assert rar.probes_replayed == 2 and not rar.deferred_probes
    assert out.case == "case1" and out.strong_calls == 1
    assert out.served_by == "weak"
    assert rar.memory_occupancy == 2
    out3 = go(5, 3)
    assert out3.case == "memory_skill" and out3.strong_calls == 0


def test_sequential_brownout_memory_hard_degraded():
    plan = FaultPlan([FaultPlan.tier_error("strong", at=4, count=1)])
    holder = {}
    weak = FakeTier(known=set(), name="weak")
    weak.answer_batch = lambda ps: np.asarray([-1] * len(ps))
    rar = RAR(weak,
              FakeTier(known=range(10_000), can_guide=True, name="strong"),
              lambda p: holder["emb"], lambda e, k: False,
              brownout_cfg(reprobe_period=100), fault_plan=plan,
              device="cpu")

    def go(s, x):
        holder["emb"] = skill_emb(s)
        return rar.process(prompt(s, x), greq(s), key=(s, x))

    assert go(3, 1).case == "case3"
    assert go(3, 2).case == "memory_hard"
    out = go(3, 3)
    assert out.case == "memory_hard_degraded" and out.served_by == "weak"
    assert out.strong_calls == 0
    assert rar.probes_deferred == 0


@pytest.mark.parametrize("batch", [1, 4])
def test_batched_brownout_weak_only_and_flush_replays(batch):
    plan = FaultPlan([FaultPlan.tier_error("strong", at=1, count=1)])
    ctrl = MicrobatchRAR(
        FakeTier(known={0, 1}, name="weak"),
        FakeTier(known=range(10_000), can_guide=True, name="strong"),
        lambda p: None, lambda e, k: False, brownout_cfg(),
        fault_plan=plan, device="cpu")
    stream = make_stream()
    outs = []
    for start in range(0, len(stream), batch):
        chunk = stream[start:start + batch]
        outs += ctrl.process_batch(
            [prompt(s, x) for s, x in chunk], [greq(s) for s, _ in chunk],
            keys=chunk, embs=np.stack([skill_emb(s) for s, _ in chunk]))
    assert len(outs) == len(stream)
    assert all(o.response is not None for o in outs)
    degraded = [o for o in outs if o.case in DEGRADED_CASES]
    assert degraded and all(o.strong_calls == 0 for o in degraded)
    assert ctrl.probes_deferred == len(ctrl.deferred_probes) > 0
    time.sleep(0.08)
    ctrl.flush_shadow()
    assert ctrl.probes_replayed == ctrl.probes_deferred
    assert not ctrl.deferred_probes
    assert all(o.case != "shadow_deferred" for o in outs)
    assert ctrl.shadow.items_enqueued == ctrl.shadow.items_drained
    ctrl.close_shadow()


# ---------------------------------------------------------------------------
# The drainer: wedged close, injected drain error at the barrier
# ---------------------------------------------------------------------------


def test_shadow_close_raises_on_wedged_drainer_instead_of_orphaning():
    release = threading.Event()

    def slow_runner(items):
        release.wait()

    q = ShadowQueue(slow_runner, mode="async", flush_every=1)
    q.submit([None])
    with pytest.raises(TimeoutError):
        q.close(timeout=0.05)
    assert q._worker is not None
    release.set()
    q.close(timeout=WAIT)
    assert q._worker is None


def test_injected_drain_error_surfaces_at_barrier():
    plan = FaultPlan([FaultPlan.drain_error(at=1)])
    ctrl = MicrobatchRAR(
        FakeTier(known=set(), name="weak"),
        FakeTier(known=range(10_000), can_guide=True, name="strong"),
        lambda p: None, lambda e, k: False,
        cfg(shadow_mode="async", shadow_flush_every=1), fault_plan=plan,
        device="cpu")
    ctrl.process_batch([prompt(2, 1)], [greq(2)], embs=skill_emb(2)[None])
    with pytest.raises(RuntimeError, match="shadow drainer failed") as ei:
        for _ in range(100):
            ctrl.flush_shadow(timeout=WAIT)
            time.sleep(0.01)
    assert isinstance(ei.value.__cause__, InjectedFault)
    ctrl.close_shadow(timeout=WAIT)
    assert ctrl.shadow.items_enqueued == ctrl.shadow.items_drained == 1


# ---------------------------------------------------------------------------
# Crash-consistent journal: WAL + snapshot recovery
# ---------------------------------------------------------------------------


def _copy(state):
    return copy.deepcopy(state)


def run_journaled(stream, path, fault_plan=None, snapshot_every=8, jax=False,
                  **cfg_kw):
    """A journaled sequential run of ``stream`` (the port's, or JAX's
    without faults with ``jax``). Returns the controller and the store
    after every epoch (a copy: the port's store is updated in place)."""
    holder = {}
    tiers = (FakeTier(known={0, 1}, name="weak"),
             FakeTier(known=range(10_000), can_guide=True, name="strong"))
    jcfg = make_cfg(journal_path=path, snapshot_every=snapshot_every,
                    **cfg_kw)
    if jax:
        rar = JRAR(*tiers, lambda p: holder["emb"], lambda e, k: False,
                   jcfg)
    else:
        rar = RAR(*tiers, lambda p: holder["emb"], lambda e, k: False,
                  _port_cfg(jcfg), fault_plan=fault_plan, device="cpu")
    snapshots = {0: _copy(rar.memory)}
    for s, x in stream:
        holder["emb"] = skill_emb(s)
        rar.process(prompt(s, x), greq(s), key=(s, x))
        snapshots[rar.commit_stream.buffer.epoch] = _copy(rar.memory)
    return rar, snapshots


def _reopen(path, snapshot_every=3, **kw):
    holder = {}
    rar = RAR(FakeTier(known={0, 1}, name="weak"),
              FakeTier(known=range(10_000), can_guide=True, name="strong"),
              lambda p: holder["emb"], lambda e, k: False,
              cfg(journal_path=path, snapshot_every=snapshot_every, **kw),
              device="cpu")
    return rar, holder


@pytest.mark.parametrize("snapshot_every", [1, 3, 100])
def test_journal_recovery_is_byte_identical(tmp_path, snapshot_every):
    """test_faults.py::test_journal_recovery_is_byte_identical, and the
    recovered store is the one JAX recovers from its own run."""
    path = str(tmp_path / "journal")
    rar, _ = run_journaled(make_stream(), path, snapshot_every=snapshot_every)
    state, epoch, applied, _ = mem.MemoryJournal.recover(
        path, rar.cfg.memory, device="cpu")
    _same_store(rar.memory, state)
    assert epoch == rar.commit_stream.buffer.epoch
    assert applied == rar.commit_stream.buffer.entries_applied
    jpath = str(tmp_path / "jax")
    jrar, _ = run_journaled(make_stream(), jpath,
                            snapshot_every=snapshot_every, jax=True)
    jstate, jepoch, japplied, _ = jmem.MemoryJournal.recover(
        jpath, jrar.cfg.memory)
    _same_store(jstate, state)
    assert (jepoch, japplied) == (epoch, applied)


def test_journaled_run_matches_unjournaled_run(tmp_path):
    stream = make_stream()
    holder = {}

    def build(**kw):
        return RAR(FakeTier(known={0, 1}, name="weak"),
                   FakeTier(known=range(10_000), can_guide=True,
                            name="strong"),
                   lambda p: holder["emb"], lambda e, k: False, cfg(**kw),
                   device="cpu")

    ref, jr = build(), build(journal_path=str(tmp_path / "journal"))
    ref_outs, jr_outs = [], []
    for s, x in stream:
        holder["emb"] = skill_emb(s)
        ref_outs.append(ref.process(prompt(s, x), greq(s), key=(s, x)))
        jr_outs.append(jr.process(prompt(s, x), greq(s), key=(s, x)))
    assert _plain(ref_outs) == _plain(jr_outs)
    _same_store(ref.memory, jr.memory)
    assert (ref.now, ref.guides_from_memory, ref.guides_generated) == \
        (jr.now, jr.guides_from_memory, jr.guides_generated)
    assert ref.weak.engine.calls == jr.weak.engine.calls
    assert ref.strong.engine.calls == jr.strong.engine.calls


@pytest.mark.parametrize("kind,crash_at,landing",
                         [("wal", 4, 3), ("apply", 4, 4)])
def test_crash_recovers_previous_or_next_epoch(tmp_path, kind, crash_at,
                                               landing):
    """test_faults.py::test_wal_crash_recovers_previous_epoch (a kill
    before the WAL write: the epoch before) and ::test_apply_crash_
    recovers_one_epoch_ahead (after it, before the apply: that epoch)."""
    path = str(tmp_path / "journal")
    spec = (FaultPlan.wal_crash if kind == "wal" else
            FaultPlan.apply_crash)(at=crash_at)
    with pytest.raises(InjectedFault):
        run_journaled(make_stream(), path, fault_plan=FaultPlan([spec]),
                      snapshot_every=100)
    _, ref = run_journaled(make_stream(), str(tmp_path / "ref"),
                           snapshot_every=100)
    state, epoch, _, _ = mem.MemoryJournal.recover(
        path, cfg().memory, device="cpu")
    assert epoch == landing
    _same_store(state, ref[landing])


def test_recovery_tolerates_torn_wal_tail(tmp_path):
    path = str(tmp_path / "journal")
    rar, _ = run_journaled(make_stream(), path, snapshot_every=100)
    with open(os.path.join(path, "wal.log"), "ab") as f:
        f.write(b"\x07\x00\x00\x00garbage-torn-frame")
    with pytest.warns(mem.JournalCorruptionWarning, match="crc mismatch"):
        state, epoch, _, _ = mem.MemoryJournal.recover(
            path, rar.cfg.memory, device="cpu")
    _same_store(state, rar.memory)
    assert epoch == rar.commit_stream.buffer.epoch


def test_wal_bit_flip_stops_replay_at_corrupt_frame(tmp_path):
    path = str(tmp_path / "journal")
    rar, snapshots = run_journaled(make_stream(), path, snapshot_every=100)
    wal = os.path.join(path, "wal.log")
    with open(wal, "rb") as f:
        data = bytearray(f.read())
    data[12] ^= 0x40
    with open(wal, "wb") as f:
        f.write(bytes(data))
    with pytest.warns(mem.JournalCorruptionWarning) as rec:
        state, epoch, applied, _ = mem.MemoryJournal.recover(
            path, rar.cfg.memory, device="cpu")
    w = next(r.message for r in rec
             if isinstance(r.message, mem.JournalCorruptionWarning))
    assert w.path == wal and w.offset == 0 and w.reason == "crc mismatch"
    assert epoch == 0 and applied == 0
    _same_store(state, snapshots[0])


def test_wal_truncated_frame_recovers_prefix_with_warning(tmp_path):
    path = str(tmp_path / "journal")
    rar, snapshots = run_journaled(make_stream(), path, snapshot_every=100)
    wal = os.path.join(path, "wal.log")
    with open(wal, "rb") as f:
        data = f.read()
    with open(wal, "wb") as f:
        f.write(data[:len(data) - 3])
    with pytest.warns(mem.JournalCorruptionWarning,
                      match="torn payload") as rec:
        state, epoch, _, _ = mem.MemoryJournal.recover(
            path, rar.cfg.memory, device="cpu")
    w = next(r.message for r in rec
             if isinstance(r.message, mem.JournalCorruptionWarning))
    assert w.offset > 0
    assert epoch == rar.commit_stream.buffer.epoch - 1
    _same_store(state, snapshots[epoch])


def test_recovered_store_resumes_serving(tmp_path):
    """test_faults.py::test_recovered_store_resumes_serving."""
    path = str(tmp_path / "journal")
    stream = make_stream()
    rar, _ = run_journaled(stream, path, snapshot_every=3)
    epoch0 = rar.commit_stream.buffer.epoch
    occupancy0 = rar.memory_occupancy
    rar2, holder = _reopen(path)
    _same_store(rar2.memory, rar.memory)
    assert rar2.commit_stream.buffer.epoch == epoch0
    holder["emb"] = skill_emb(stream[0][0])
    out = rar2.process(prompt(stream[0][0], 7), greq(stream[0][0]), key=None)
    assert out.strong_calls == 0
    assert rar2.memory_occupancy == occupancy0
    holder["emb"] = skill_emb(40)
    rar2.process(prompt(40, 1), greq(40), key=None)
    _, epoch2, _, _ = mem.MemoryJournal.recover(path, rar2.cfg.memory,
                                                device="cpu")
    assert epoch2 == rar2.commit_stream.buffer.epoch > epoch0


def test_sequential_manifest_restores_engine_state(tmp_path):
    """test_faults.py::test_sequential_manifest_restores_engine_state."""
    path = str(tmp_path / "journal")
    stream = make_stream()
    rar, _ = run_journaled(stream, path, snapshot_every=3,
                           breaker_threshold=2)
    rar.close_shadow()
    rar2, holder = _reopen(path, breaker_threshold=2)
    assert rar2.now == rar.now
    assert rar2.guides_from_memory == rar.guides_from_memory
    assert rar2.guides_generated == rar.guides_generated
    assert rar2.probes_deferred == rar.probes_deferred
    assert rar2.strong.breaker.state == rar.strong.breaker.state
    holder["emb"] = skill_emb(stream[0][0])
    rar2.process(prompt(stream[0][0], 5), greq(stream[0][0]), key=None)
    assert rar2.now == rar.now + 1


def test_journal_refuses_the_ivf_plane_and_frames_hold_no_tensor(tmp_path):
    """The IVF plane and a journal do not combine (as in JAX); and a WAL
    record holds host values only, whatever device the store is on."""
    with pytest.raises(ValueError, match="incompatible with journal_path"):
        cfg(journal_path=str(tmp_path / "j"), retrieval_clusters=4)
    path = str(tmp_path / "journal")
    run_journaled(make_stream()[:4], path, snapshot_every=100)
    recs = list(mem.MemoryJournal._read_records(
        os.path.join(path, "wal.log")))
    assert recs

    def walk(x):
        assert not torch.is_tensor(x)
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(recs)
    assert isinstance(recs[0]["records"][0][1], np.ndarray)
    assert _host(recs[0]["records"][0][1]).dtype == np.float32


# ---------------------------------------------------------------------------
# The fabric's recovery plane (tests/test_faults.py lines 447-597 and 853)
# ---------------------------------------------------------------------------


def _serve_serialized(fab, stream, batch):
    """``test_faults.serve_serialized``: one ticket at a time, so the
    serve order is deterministic across a crash and its redispatch."""
    outs = []
    for start in range(0, len(stream), batch):
        chunk = stream[start:start + batch]
        t = fab.submit([prompt(s, x) for s, x in chunk],
                       [greq(s) for s, _ in chunk], keys=chunk,
                       embs=np.stack([skill_emb(s) for s, _ in chunk]))
        outs += t.wait(timeout=WAIT)
    fab.flush_shadow(timeout=WAIT)
    return outs


def _fabric_pair(replicas, weak_known, jplan=None, tplan=None, **cfg_kw):
    """A JAX and a port thread fabric over the same FakeTier rules."""
    from test_faults import build_fabric as jbuild
    from test_torch_fabric import build_fabric as tbuild
    return (jbuild(replicas, weak_known=weak_known, fault_plan=jplan,
                   **cfg_kw),
            tbuild(replicas, weak_known=weak_known, fault_plan=tplan,
                   **cfg_kw))


def _same_fabric(j, jouts, t, touts):
    assert _plain(touts) == _plain(jouts)
    _same_store(j.memory, t.memory)
    assert (t.now, t.guides_from_memory, t.guides_generated) == \
        (j.now, j.guides_from_memory, j.guides_generated)
    assert t.learn.weak.engine.calls == j.learn.weak.engine.calls
    assert t.learn.strong.engine.calls == j.learn.strong.engine.calls


def test_fabric_brownout_zero_errored_tickets():
    """test_faults.py::test_fabric_brownout_zero_errored_tickets: one
    shared breaker across replicas; no ticket errors; the deferred probes
    replay once it closes."""
    from test_torch_fabric import build_fabric
    plan = FaultPlan([FaultPlan.tier_error("strong", at=1, count=1)])
    fab = build_fabric(2, weak_known={0, 1}, fault_plan=plan,
                       tier_max_retries=0, breaker_threshold=1,
                       breaker_cooldown=0.05)
    assert isinstance(fab.learn.strong, ResilientTier)
    assert all(r.strong is fab.learn.strong for r in fab.replicas)
    outs = _serve_serialized(fab, make_stream(), 4)
    assert all(o.response is not None for o in outs)
    stats = fab.stats()
    assert stats["probes_deferred"] > 0
    assert stats["strong_resilience"]["failures"] == 1
    time.sleep(0.08)
    fab.flush_shadow(timeout=WAIT)
    stats = fab.stats()
    assert stats["probes_replayed"] == stats["probes_deferred"]
    assert fab.learn.strong.breaker.state == "closed"
    fab.close_shadow()


@pytest.mark.parametrize("replicas,crash_at", [(2, 2), (1, 3)])
def test_replica_crash_redispatch_matches_no_fault_run_and_jax(replicas,
                                                               crash_at):
    """test_faults.py::test_replica_crash_redispatch_byte_identical_to_no_
    fault_run (2 replicas) and ::test_single_replica_crash_restarts_and_
    recovers (1): the redispatched run equals the port's no-fault
    ``MicrobatchRAR`` run and JAX's fabric under the same crash."""
    from test_torch_shadow import assert_same, build, serve_stream
    stream = make_stream()
    ref, _ = build("torch", weak_known={0, 1})
    ref_outs = serve_stream(ref, stream, 4)
    j, t = _fabric_pair(
        replicas, {0, 1},
        jplan=jfaults.FaultPlan([jfaults.FaultPlan.replica_crash(
            0, at=crash_at)]),
        tplan=FaultPlan([FaultPlan.replica_crash(0, at=crash_at)]))
    touts = _serve_serialized(t, stream, 4)
    assert_same(ref, ref_outs, t.learn, touts)
    _same_fabric(j, _serve_serialized(j, stream, 4), t, touts)
    assert t.deaths == 1 and t.restarts == 1
    assert t.redispatches == j.redispatches == 1
    assert t.health == ["healthy"] * replicas
    j.close_shadow()
    t.close_shadow()


def test_bounded_redispatch_exhaustion_surfaces_crash():
    from test_torch_fabric import build_fabric
    plan = FaultPlan([FaultPlan.replica_crash(0, count=100),
                      FaultPlan.replica_crash(1, count=100)])
    fab = build_fabric(2, weak_known={0}, fault_plan=plan, max_redispatch=2)
    t = fab.submit([prompt(0, 1)], [greq(0)], embs=skill_emb(0)[None],
                   replica=0)
    with pytest.raises(RuntimeError) as ei:
        t.wait(timeout=WAIT)
    assert isinstance(ei.value.__cause__, ReplicaCrash)
    assert t.redispatches == 2
    assert fab.deaths == 3 and fab.restarts == 3
    with pytest.raises(RuntimeError):
        fab.join(timeout=WAIT)
    plan.specs.clear()
    assert len(_serve_serialized(fab, [(0, 2), (1, 3)], 2)) == 2
    fab.close_shadow()


def test_app_level_error_is_not_redispatched():
    from test_torch_fabric import build_fabric
    fab = build_fabric(2, weak_known={0})
    boom = RuntimeError("app bug")

    def dying(prompts):
        raise boom

    fab.replicas[1].strong = FakeTier(known=range(10_000), can_guide=True)
    fab.replicas[1].strong.answer_batch = dying
    t = fab.submit([prompt(5, 1)], [greq(5)], embs=skill_emb(5)[None],
                   replica=1)
    with pytest.raises(RuntimeError) as ei:
        t.wait(timeout=WAIT)
    assert ei.value.__cause__ is boom
    assert t.redispatches == 0 and fab.redispatches == 0
    with pytest.raises(RuntimeError):
        fab.join(timeout=WAIT)
    fab.close_shadow()


def test_ticket_wait_timeout_and_error_chain():
    """test_faults.py::test_ticket_wait_timeout_then_still_waitable and
    ::test_ticket_wait_chains_worker_error."""
    from repro_torch.serving.fabric import Ticket
    t = Ticket(replica=0)
    with pytest.raises(TimeoutError):
        t.wait(timeout=0.01)
    t.outcomes = ["ok"]
    t._done.set()
    assert t.wait(timeout=1) == ["ok"]
    t = Ticket(replica=3)
    cause = ValueError("inner")
    t.error = cause
    t._done.set()
    with pytest.raises(RuntimeError) as ei:
        t.wait()
    assert ei.value.__cause__ is cause
    assert "replica 3" in str(ei.value)


def test_fabric_join_timeout_keeps_tickets_registered():
    from test_torch_fabric import build_fabric
    fab = build_fabric(1, weak_known={0})
    gate = threading.Event()
    orig = fab.replicas[0].process_batch

    def gated(*a, **kw):
        gate.wait(WAIT)
        return orig(*a, **kw)

    fab.replicas[0].process_batch = gated
    fab.submit([prompt(0, 1)], [greq(0)], embs=skill_emb(0)[None])
    with pytest.raises(TimeoutError):
        fab.join(timeout=0.05)
    assert fab._tickets
    gate.set()
    fab.join(timeout=WAIT)
    gate.clear()
    fab.submit([prompt(0, 2)], [greq(0)], embs=skill_emb(0)[None])
    with pytest.raises(TimeoutError):
        fab.flush_shadow(timeout=0.05)
    gate.set()
    fab.flush_shadow(timeout=WAIT)
    fab.close_shadow()


def test_fabric_with_journal_recovers_across_restart_as_jax(tmp_path):
    """test_faults.py::test_fabric_with_journal_recovers_across_restart: a
    journaled 2-replica fabric served serialized, closed and rebuilt on
    the same path recovers its store and epoch, equal to JAX's doing the
    same (each package on a journal of its own), and serves from it."""
    from test_faults import build_fabric as jbuild
    from test_torch_fabric import build_fabric as tbuild
    stores = {}
    for pkg, build in (("jax", jbuild), ("torch", tbuild)):
        kw = dict(weak_known={0, 1}, journal_path=str(tmp_path / pkg),
                  snapshot_every=2)
        fab = build(2, **kw)
        _serve_serialized(fab, make_stream(), 4)
        fab.close_shadow()
        ref_epoch = fab.commit_stream.buffer.epoch
        fab2 = build(2, **kw)
        _same_store(fab.memory, fab2.memory)
        assert fab2.commit_stream.buffer.epoch == ref_epoch
        out = fab2.process_batch([prompt(0, 7)], [greq(0)],
                                 embs=skill_emb(0)[None])[0]
        assert out.strong_calls == 0
        stores[pkg] = (fab2.memory, ref_epoch)
        fab2.close_shadow()
    _same_store(stores["jax"][0], stores["torch"][0])
    assert stores["jax"][1] == stores["torch"][1]


def test_soak_random_fault_schedule():
    """test_faults.py::test_soak_random_fault_schedule on the port."""
    from test_torch_fabric import build_fabric
    plan = random_plan(int(os.environ.get("REPRO_SOAK_SEED", "0")),
                       replicas=3, crashes=3, tier_errors=2, horizon=30)
    fab = build_fabric(3, weak_known={0, 1}, fault_plan=plan,
                       tier_max_retries=1, breaker_threshold=2,
                       breaker_cooldown=0.05)
    rng = np.random.default_rng(0)
    tickets, n = [], 0
    for _ in range(40):
        chunk = [(int(rng.integers(0, 10)), int(rng.integers(0, 8)))
                 for _ in range(int(rng.integers(1, 4)))]
        n += len(chunk)
        tickets.append(fab.submit(
            [prompt(s, x) for s, x in chunk], [greq(s) for s, _ in chunk],
            embs=np.stack([skill_emb(s) for s, _ in chunk])))
    time.sleep(0.08)
    fab.flush_shadow(timeout=WAIT)
    outs = [o for t in tickets for o in t.wait(timeout=WAIT)]
    assert len(outs) == n
    assert all(o.response is not None for o in outs)
    assert fab.restarts == fab.deaths
    assert fab.commit_stream.buffer.entries_applied == fab.memory.ptr
    stats = fab.stats()
    assert stats["items_enqueued"] == stats["items_drained"]
    assert plan.n_fired > 0
    fab.close_shadow()
