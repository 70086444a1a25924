"""The port's process fabric (``repro_torch.serving.procfabric``) against
the JAX package's fabrics: the twin of ``tests/test_procfabric.py``, on
the CPU.

Where JAX pins bytes (process == thread fabric, pipelined == serialized,
SIGKILL and hard-exit redispatch, whole-fabric kill and recovery), the
port's process fabric is held to the port's thread fabric and to JAX's
thread fabric on the same stream (JAX holds its process fabric to that):
Outcome streams, store fields, FM calls (the workers' shipped deltas
included) and the RQ2 counters exact. The lease cases are driven by the
fault plan's clock skew, not the wall clock. The workers' factories live
in ``tests/_torch_fabric_parts.py``, which imports torch and the port
only, so no worker loads JAX; they fork from a fork server here (on the
card they are spawned, ``tests/test_torch_cuda.py``).
"""
import functools
import multiprocessing
import os
import time

import numpy as np
import pytest
from _torch_fabric_parts import factory, failing_parts, make_parts
from test_fabric import build_fabric as jbuild_fabric
from test_fabric import serve_fabric as jserve_fabric
from test_pipeline import make_stream
from test_rar_controller import greq, make_cfg, prompt, skill_emb
from test_torch_fabric import build_fabric, serve_fabric
from test_torch_pipeline import _plain, _port_cfg, _same_store

from repro_torch.serving.faults import FaultPlan, FaultSpec, random_plan
from repro_torch.serving.procfabric import (EpochLagDrainPolicy,
                                            ProcessServingFabric, WorkerDied)

WAIT = 120.0                    # seconds any ticket or barrier may take


#: modules the fork server imports once, so a worker starts in
#: milliseconds instead of importing torch (the suite runs these tests
#: beside others on a busy host); no CUDA context exists on the CPU, so
#: forking is safe here, while the card takes "spawn"
PRELOAD = ["torch", "repro_torch.serving.procfabric", "_torch_fabric_parts"]


def build_proc(workers=1, weak_known=(), fault_plan=None,
               lease_interval=0.25, lease_timeout=60.0, parts=make_parts,
               **cfg_kw):
    """``test_procfabric.build_proc`` on the port, on the CPU, its workers
    forked from a fork server. The lease timeout is long: the lease cases
    expire leases by injected skew."""
    multiprocessing.get_context("forkserver").set_forkserver_preload(PRELOAD)
    return ProcessServingFabric(factory(parts, weak_known),
                                _port_cfg(make_cfg(**cfg_kw)),
                                workers=workers, fault_plan=fault_plan,
                                lease_interval=lease_interval,
                                lease_timeout=lease_timeout,
                                start_method="forkserver", device="cpu")


def serve_proc(fab, stream, batch):
    """Serialized: wait out each ticket before the next submit."""
    outs = []
    for start in range(0, len(stream), batch):
        chunk = stream[start:start + batch]
        t = fab.submit([prompt(s, x) for s, x in chunk],
                       [greq(s) for s, _ in chunk], keys=chunk,
                       embs=np.stack([skill_emb(s) for s, _ in chunk]))
        outs += t.wait(timeout=WAIT)
    fab.flush_shadow(timeout=WAIT)
    return outs


def one(fab, skill, x, replica=None):
    t = fab.submit([prompt(skill, x)], [greq(skill)], keys=[(skill, x)],
                   embs=np.stack([skill_emb(skill)]), replica=replica)
    return t.wait(timeout=WAIT)[0]


def _calls(fab, name):
    if hasattr(fab, "engine_calls"):
        return fab.engine_calls(name)
    tier = {"weak": fab.learn.weak, "strong": fab.learn.strong}[name]
    return tier.engine.calls


def assert_proc_equivalent(ref, ref_outs, fab, outs):
    """``test_procfabric.assert_proc_equivalent`` across the packages:
    ``ref`` is a thread fabric of either package."""
    assert _plain(outs) == _plain(ref_outs)
    _same_store(ref.memory, fab.memory)
    assert ref.now == fab.now
    assert _calls(ref, "weak") == _calls(fab, "weak")
    assert _calls(ref, "strong") == _calls(fab, "strong")
    assert ref.guides_from_memory == fab.guides_from_memory
    assert ref.guides_generated == fab.guides_generated


@pytest.fixture(scope="module")
def refs():
    """The thread-fabric references, by ``weak_known``: the port's
    synchronous 1-replica fabric over ``make_stream()`` at batch 4, held
    to JAX's here once."""
    out = {}
    for known in ((0, 1), ()):
        stream = make_stream()
        ref = build_fabric(1, weak_known=set(known))
        ref_outs = serve_fabric(ref, stream, 4)
        jref = jbuild_fabric(1, weak_known=set(known))
        assert_proc_equivalent(jref, jserve_fabric(jref, stream, 4), ref,
                               ref_outs)
        ref.close_shadow()
        jref.close_shadow()
        out[known] = (ref, ref_outs)
    return out


# ---------------------------------------------------------------------------
# Equivalence: process fabric == thread fabric
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("known", [(0, 1), ()])
def test_one_worker_proc_fabric_matches_thread_fabric(refs, known):
    """test_procfabric.py::test_one_worker_proc_fabric_identical_to_thread_
    fabric: a worker process (pickle transport, epoch broadcasts, "done"
    funnels) gives the thread fabric's bytes, the port's and JAX's."""
    ref, ref_outs = refs[known]
    fab = build_proc(1, weak_known=set(known))
    outs = serve_proc(fab, make_stream(), 4)
    assert_proc_equivalent(ref, ref_outs, fab, outs)
    assert fab.stats()["transport"]["frames_sent"] > 0
    fab.close_shadow()


def test_two_worker_proc_fabric_serialized_matches(refs):
    ref, ref_outs = refs[(0, 1)]
    fab = build_proc(2, weak_known={0, 1})
    outs = serve_proc(fab, make_stream(), 4)
    assert_proc_equivalent(ref, ref_outs, fab, outs)
    fab.close_shadow()


def test_pipelined_submission_matches_serialized(refs):
    """test_procfabric.py::test_pipelined_submission_identical_to_
    serialized: every microbatch submitted up front; the ack gate keeps
    serve-after-drain."""
    ref, ref_outs = refs[(0, 1)]
    stream = make_stream()
    fab = build_proc(1, weak_known={0, 1})
    tickets = []
    for start in range(0, len(stream), 4):
        chunk = stream[start:start + 4]
        tickets.append(fab.submit(
            [prompt(s, x) for s, x in chunk],
            [greq(s) for s, _ in chunk], keys=chunk,
            embs=np.stack([skill_emb(s) for s, _ in chunk])))
    outs = []
    for t in tickets:
        outs += t.wait(timeout=WAIT)
    fab.flush_shadow(timeout=WAIT)
    assert_proc_equivalent(ref, ref_outs, fab, outs)
    fab.close_shadow()


def test_epoch_broadcast_reaches_idle_worker():
    fab = build_proc(2, weak_known={0})
    assert one(fab, 0, 1, replica=0).case == "case1"
    o2 = one(fab, 0, 2, replica=1)
    assert o2.case == "memory_skill" and o2.strong_calls == 0
    assert o2.response == (0 + 2) % 4
    fab.close_shadow()


# ---------------------------------------------------------------------------
# Supervision: SIGKILL, hard exit, leases, redispatch
# ---------------------------------------------------------------------------


def test_sigkill_mid_run_redispatch_matches(refs):
    ref, ref_outs = refs[(0, 1)]
    plan = FaultPlan([FaultPlan.replica_kill(1, at=2)])
    fab = build_proc(2, fault_plan=plan, weak_known={0, 1})
    outs = serve_proc(fab, make_stream(), 4)
    assert_proc_equivalent(ref, ref_outs, fab, outs)
    assert fab.deaths == 1 and fab.restarts == 1
    assert fab.redispatches == 1
    assert fab.stats()["health"] == ["healthy", "healthy"]
    fab.close_shadow()


def test_worker_hard_exit_redispatch_matches(refs):
    ref, ref_outs = refs[(0, 1)]
    plan = FaultPlan([FaultPlan.replica_crash(0, at=1)])
    fab = build_proc(1, fault_plan=plan, weak_known={0, 1})
    outs = serve_proc(fab, make_stream(), 4)
    assert_proc_equivalent(ref, ref_outs, fab, outs)
    assert fab.deaths == 1 and fab.restarts == 1
    assert fab.redispatches == 1
    fab.close_shadow()


def test_redispatch_budget_exhausted_surfaces_worker_died():
    plan = FaultPlan([FaultPlan.replica_kill(0, at=1)])
    fab = build_proc(1, fault_plan=plan, weak_known={0, 1},
                     max_redispatch=0)
    t = fab.submit([prompt(0, 1)], [greq(0)], keys=[(0, 1)],
                   embs=np.stack([skill_emb(0)]))
    with pytest.raises(RuntimeError) as ei:
        t.wait(timeout=WAIT)
    assert isinstance(ei.value.__cause__, WorkerDied)
    with pytest.raises(RuntimeError):
        fab.join(timeout=WAIT)
    assert fab.deaths == 1 and fab.restarts == 1
    assert fab.redispatches == 0
    assert one(fab, 0, 2).case == "case1"          # respawned worker serves
    fab.close_shadow()


def test_worker_that_cannot_build_fails_its_ticket_without_respawning():
    """A worker whose factory raises reports ``fail`` and exits before it
    is ready: it is not respawned (a broken factory would respawn
    forever), its tickets fail with :class:`WorkerDied` within the
    redispatch budget, and the next submit spawns one worker for it, no
    more."""
    fab = build_proc(1, weak_known={0, 1}, parts=failing_parts,
                     max_redispatch=2)
    t = fab.submit([prompt(0, 1)], [greq(0)], keys=[(0, 1)],
                   embs=np.stack([skill_emb(0)]))
    with pytest.raises(RuntimeError) as ei:
        t.wait(timeout=WAIT)
    assert isinstance(ei.value.__cause__, WorkerDied)
    assert "cannot build its replica" in str(ei.value.__cause__)
    assert t.redispatches == 0
    with pytest.raises(RuntimeError):
        fab.join(timeout=WAIT)
    assert fab.deaths == fab.startup_failures == 1 and fab.restarts == 0
    assert fab.health == ["dead"]
    t2 = fab.submit([prompt(0, 2)], [greq(0)], keys=[(0, 2)],
                    embs=np.stack([skill_emb(0)]))
    with pytest.raises(RuntimeError):
        t2.wait(timeout=WAIT)
    assert fab.deaths == fab.startup_failures == 2
    assert fab.restarts == 1 and fab.redispatches == 0
    with pytest.raises(RuntimeError):
        fab.join(timeout=WAIT)
    time.sleep(0.5)
    assert fab.deaths == 2                          # nothing respawned since
    fab.close_shadow()


def _wait_for_restart(fab):
    """Until the supervisor has respawned a slot (the lease counter moves
    before the death path runs, the restart count at its end)."""
    deadline = time.monotonic() + WAIT
    while fab.restarts == 0 and time.monotonic() < deadline:
        time.sleep(0.02)


def test_lease_expiry_detects_hung_worker():
    """test_procfabric.py::test_lease_expiry_detects_hung_worker, driven
    deterministically: the worker's heartbeat thread dies (it keeps
    serving), and the lease clock runs ahead by the plan's injected skew
    instead of the wall clock; the monitor declares it dead, respawns the
    slot, and the replacement beats and serves."""
    plan = FaultPlan([FaultPlan.heartbeat_crash(0, at=1),
                      FaultPlan.clock_skew(3600.0, at=1)])
    fab = build_proc(1, fault_plan=plan, weak_known={0, 1},
                     lease_interval=0.1)
    assert one(fab, 0, 1).case == "case1"
    _wait_for_restart(fab)
    assert fab.lease_expiries == 1
    assert fab.deaths == 1 and fab.restarts == 1
    assert one(fab, 0, 2).case == "memory_skill"   # the respawned worker
    beat = fab._handles[0].last_beat
    deadline = time.monotonic() + WAIT
    while fab._handles[0].last_beat == beat and \
            time.monotonic() < deadline:
        time.sleep(0.02)
    assert fab._handles[0].last_beat > beat        # it beats
    assert fab.lease_expiries == 1
    fab.close_shadow()


def test_injected_clock_skew_expires_lease_without_waiting():
    plan = FaultPlan([FaultPlan.clock_skew(3600.0, at=1)])
    fab = build_proc(1, fault_plan=plan, weak_known={0, 1},
                     lease_interval=0.2)
    _wait_for_restart(fab)
    assert fab.lease_expiries == 1 and fab.deaths == 1
    assert one(fab, 0, 1).case == "case1"
    fab.close_shadow()


def test_stale_done_is_dropped_not_double_applied():
    fab = build_proc(1, weak_known={0, 1})
    before = fab.learn.shadow.items_enqueued
    fab._on_done(fab._handles[0], 999_999, [], [], [], {}, {})
    assert fab.stale_drops == 1
    assert fab.learn.shadow.items_enqueued == before
    assert one(fab, 0, 1).case == "case1"
    fab.close_shadow()


def test_app_error_in_worker_surfaces_without_redispatch():
    plan = FaultPlan([FaultSpec("replica_serve", "error",
                                (("replica", 0),), at=1)])
    fab = build_proc(1, fault_plan=plan, weak_known={0, 1})
    t = fab.submit([prompt(0, 1)], [greq(0)], keys=[(0, 1)],
                   embs=np.stack([skill_emb(0)]))
    with pytest.raises(RuntimeError):
        t.wait(timeout=WAIT)
    with pytest.raises(RuntimeError):
        fab.join(timeout=WAIT)
    assert fab.deaths == 0 and fab.redispatches == 0
    assert one(fab, 0, 2).case == "case1"
    fab.close_shadow()


def test_ticket_timeout_stays_waitable_across_process_boundary():
    plan = FaultPlan([FaultSpec("replica_serve", "delay",
                                (("replica", 0),), at=1, delay=2.0)])
    fab = build_proc(1, fault_plan=plan, weak_known={0, 1},
                     lease_interval=0.1)
    t = fab.submit([prompt(0, 1)], [greq(0)], keys=[(0, 1)],
                   embs=np.stack([skill_emb(0)]))
    with pytest.raises(TimeoutError):
        t.wait(timeout=0.2)
    with pytest.raises(TimeoutError):
        fab.join(timeout=0.2)
    outs = t.wait(timeout=WAIT)
    assert len(outs) == 1 and outs[0].case == "case1"
    fab.join(timeout=WAIT)
    assert fab.redispatches == 0 and fab.deaths == 0
    assert fab.stale_drops == 0
    fab.close_shadow()


# ---------------------------------------------------------------------------
# Whole-fabric crash recovery
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stop", ["kill", "close"])
def test_whole_fabric_stop_recovers_to_the_same_bytes(refs, tmp_path, stop):
    """test_procfabric.py::test_whole_fabric_kill_recovers_byte_identical
    (``kill``) and ::test_clean_shutdown_checkpoint_recovers_full_state
    (``close``): a journaled fabric stopped after 8 requests and rebuilt
    on the same path serves the rest to the unstopped run's bytes."""
    ref, ref_outs = refs[(0, 1)]
    stream = make_stream()
    path = str(tmp_path / "wal")
    fab = build_proc(1, weak_known={0, 1}, journal_path=path,
                     snapshot_every=3)
    outs = serve_proc(fab, stream[:8], 4)
    if stop == "kill":
        fab.kill()
    else:
        fab.close_shadow()
    fab2 = build_proc(1, weak_known={0, 1}, journal_path=path,
                      snapshot_every=3)
    outs += serve_proc(fab2, stream[8:], 4)
    assert_proc_equivalent(ref, ref_outs, fab2, outs)
    assert fab2.commit_stream.buffer.entries_applied == fab2.memory.ptr
    fab2.close_shadow()


# ---------------------------------------------------------------------------
# Soak: seeded SIGKILLs, wire jitter and clock skew
# ---------------------------------------------------------------------------


def test_proc_soak_random_kills_jitter_and_skew():
    seed = int(os.environ.get("REPRO_SOAK_SEED", "0"))
    plan = random_plan(seed, replicas=2, kills=2, transport_delays=2,
                       clock_skews=2, max_jitter=0.03, horizon=12)
    fab = build_proc(2, fault_plan=plan, weak_known={0, 1},
                     lease_interval=0.1, lease_timeout=8.0)
    rng = np.random.default_rng(seed)
    tickets, total = [], 0
    for _ in range(14):
        chunk = [(int(rng.integers(0, 8)), int(rng.integers(0, 8)))
                 for _ in range(int(rng.integers(1, 4)))]
        total += len(chunk)
        tickets.append(fab.submit(
            [prompt(s, x) for s, x in chunk],
            [greq(s) for s, _ in chunk], keys=chunk,
            embs=np.stack([skill_emb(s) for s, _ in chunk])))
    fab.flush_shadow(timeout=WAIT)
    outs = []
    for t in tickets:
        outs += t.wait(timeout=WAIT)
    assert len(outs) == total
    assert all(o.case for o in outs)
    assert fab.deaths == fab.restarts
    assert fab.commit_stream.buffer.entries_applied == fab.memory.ptr
    fab.close_shadow()


# ---------------------------------------------------------------------------
# Construction and the epoch-lag drain cadence
# ---------------------------------------------------------------------------


def test_first_frame_does_not_hold_later_senders():
    """``FramedChannel.send_first``: a start payload larger than the pipe
    holds no sender while the peer has not read it (a worker still
    starting up): frames sent meanwhile queue behind it, and the peer
    reads them all, in order."""
    import threading

    from repro_torch.serving.transport import FramedChannel, channel_pair
    a, b = channel_pair()
    parent, worker = FramedChannel(a, end="parent"), FramedChannel(b)
    payload = np.arange(1 << 20, dtype=np.int32)          # 4 MB
    parent.send_first(("init", payload))
    done = threading.Event()

    def later():
        for i in range(3):
            parent.send(("epoch", i))
        done.set()
    threading.Thread(target=later, daemon=True).start()
    assert done.wait(WAIT)                       # nobody has read yet
    kind, got = worker.recv()
    assert kind == "init" and np.array_equal(got, payload)
    assert [worker.recv() for _ in range(3)] == [("epoch", i)
                                                 for i in range(3)]
    deadline = time.monotonic() + WAIT
    while parent._backlog is not None and time.monotonic() < deadline:
        time.sleep(0.01)                         # the queue drained
    parent.send(("ack", 7))                      # written directly now
    assert worker.recv() == ("ack", 7)
    assert parent.sent == 5 and worker.received == 5
    parent.close()
    worker.close()


def test_constructor_validation():
    fac = functools.partial(make_parts, ())
    cfg = _port_cfg(make_cfg())
    with pytest.raises(ValueError, match="workers"):
        ProcessServingFabric(fac, cfg, workers=0, device="cpu")
    with pytest.raises(ValueError, match="lease_timeout"):
        ProcessServingFabric(fac, cfg, workers=1, lease_interval=1.0,
                             lease_timeout=0.5, device="cpu")
    # checked before any device is touched: no card is needed to refuse
    with pytest.raises(ValueError, match="fork"):
        ProcessServingFabric(fac, cfg, workers=1, start_method="fork",
                             device="cuda")


def test_epoch_lag_drain_policy_decisions():
    from types import SimpleNamespace
    lag = {"v": 0}
    pol = EpochLagDrainPolicy(lambda: lag["v"], defer_lag=4)
    q = SimpleNamespace(_items=[], _batches=0, items_coalesced=0,
                        items_drained=0)
    pol.register(q)
    assert pol.due() is False
    q._items = [1, 2]
    assert pol.due() is True
    assert pol.lag_eager_drains == 1
    lag["v"] = 4
    assert pol.due() is False
    assert pol.lag_deferrals == 1
    lag["v"] = 2
    assert pol.due() is True
    assert pol.coldstart_drains == 1
    s = pol.stats()
    assert s["worker_epoch_lag"] == 2
    assert s["defer_lag"] == 4
    assert s["lag_eager_drains"] == 1 and s["lag_deferrals"] == 1
    with pytest.raises(ValueError):
        EpochLagDrainPolicy(lambda: 0, defer_lag=0)


def test_proc_adaptive_installs_epoch_lag_policy_and_matches(refs):
    """test_procfabric.py::test_proc_adaptive_mode_installs_epoch_lag_policy
    and ::test_proc_adaptive_identical_to_thread_adaptive_outcomes: the
    lag-aware policy drives the parent's learn queue, and the cadence
    changes when drains run, never what they produce (serialized, one
    worker: the thread fabric's bytes)."""
    ref, ref_outs = refs[(0, 1)]
    fab = build_proc(1, weak_known={0, 1}, shadow_mode="adaptive",
                     shadow_flush_every=4)
    try:
        assert isinstance(fab.drain_policy, EpochLagDrainPolicy)
        assert fab.learn.shadow.drain_policy is fab.drain_policy
        outs = serve_proc(fab, make_stream(), 4)
        assert_proc_equivalent(ref, ref_outs, fab, outs)
        learn = fab.metrics()["replicas"][0]
        assert learn["items_enqueued"] == learn["items_drained"]
        pol = fab.metrics()["drain_policy"]
        assert pol["decisions"] > 0
        assert "worker_epoch_lag" in pol and "lag_eager_drains" in pol
    finally:
        fab.close_shadow()
