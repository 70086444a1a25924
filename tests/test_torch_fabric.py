"""The port's thread fabric (``repro_torch.serving.fabric``) against the
JAX package's: the twin of ``tests/test_fabric.py``, on the CPU.

Where JAX pins bytes (the 1-replica fabric against ``MicrobatchRAR``,
synchronous or through the worker thread, in each drain mode), the port's
fabric is held to the port's own controller and to JAX's fabric on the
same stream and the same rule-based tiers: Outcome streams, store fields,
FM calls and the RQ2 counters exact. The N-replica cases are concurrent,
so they hold the port to JAX's invariants (every request answered once,
``ptr == entries_applied``, one store in every view, unique logical
times). Every wait passes a timeout.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import numpy as np
import pytest
from test_fabric import build_fabric as jbuild_fabric
from test_fabric import serve_fabric as jserve_fabric
from test_pipeline import SCENARIOS, make_stream
from test_rar_controller import greq, make_cfg, prompt, skill_emb
from test_torch_pipeline import _fake_tiers, _port_cfg
from test_torch_shadow import WAIT, _split, assert_same, build, serve_stream

from repro_torch.core import ShardedMemory
from repro_torch.core import memory as mem
from repro_torch.core.shadow import PENDING
from repro_torch.serving.fabric import ServingFabric


def build_fabric(replicas=1, weak_known=(), weak_follows_guides=True,
                 fault_plan=None, shards=0, **cfg_kw):
    """``test_fabric.build_fabric`` on the port (``memory=`` in
    ``cfg_kw`` is a JAX ``MemoryConfig``, as in ``make_cfg``); ``shards``
    > 0 injects one ``ShardedMemory`` of that many shards."""
    weak, strong = _fake_tiers(weak_known, weak_follows_guides)
    cfg = _port_cfg(make_cfg(**cfg_kw))
    store = (ShardedMemory(cfg.memory, shards=shards, device="cpu")
             if shards else None)
    return ServingFabric(weak, strong, lambda p: None, lambda e, k: False,
                         cfg, replicas=replicas, memory=store,
                         fault_plan=fault_plan, device="cpu")


def serve_fabric(fab, stream, batch, submit=False):
    """``test_fabric.serve_fabric``: synchronous ``process_batch`` or
    threaded ``submit``, then a barrier."""
    outs, tickets = [], []
    for start in range(0, len(stream), batch):
        chunk = stream[start:start + batch]
        args = ([prompt(s, x) for s, x in chunk],
                [greq(s) for s, _ in chunk])
        kw = dict(keys=chunk,
                  embs=np.stack([skill_emb(s) for s, _ in chunk]))
        if submit:
            tickets.append(fab.submit(*args, **kw))
        else:
            outs += fab.process_batch(*args, **kw)
    fab.flush_shadow(timeout=WAIT)
    for t in tickets:
        outs += t.wait(timeout=WAIT)
    return outs


def assert_fabric_same(j, jouts, t, touts):
    """A port fabric against a JAX fabric (or controller): ``assert_same``
    on the learn replicas."""
    assert_same(getattr(j, "learn", j), jouts, t.learn, touts)


# ---------------------------------------------------------------------------
# Equivalence: the 1-replica fabric == MicrobatchRAR, and == JAX's fabric
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", SCENARIOS)
@pytest.mark.parametrize("batch", [1, 4])
def test_one_replica_inline_fabric_matches_microbatch_and_jax(kw, batch):
    """test_fabric.py::test_one_replica_inline_fabric_identical_to_
    microbatch: the port's fabric against the port's ``MicrobatchRAR`` and
    JAX's fabric."""
    tiers, cfg_kw = _split(kw)
    stream = make_stream()
    ref, _ = build("torch", **tiers, **cfg_kw)
    ref_outs = serve_stream(ref, stream, batch)
    fab = build_fabric(1, **kw)
    outs = serve_fabric(fab, stream, batch)
    assert_same(ref, ref_outs, fab.learn, outs)
    jfab = jbuild_fabric(1, **kw)
    assert_fabric_same(jfab, jserve_fabric(jfab, stream, batch), fab, outs)
    fab.close_shadow()
    jfab.close_shadow()


@pytest.mark.parametrize("kw", SCENARIOS[:3])
def test_one_replica_threaded_fabric_matches_microbatch_and_jax(kw):
    """test_fabric.py::test_one_replica_threaded_fabric_identical_to_
    microbatch: one replica worker serves the submitted microbatches in
    FIFO order."""
    tiers, cfg_kw = _split(kw)
    stream = make_stream()
    ref, _ = build("torch", **tiers, **cfg_kw)
    ref_outs = serve_stream(ref, stream, 4)
    fab = build_fabric(1, **kw)
    outs = serve_fabric(fab, stream, 4, submit=True)
    assert_same(ref, ref_outs, fab.learn, outs)
    jfab = jbuild_fabric(1, **kw)
    assert_fabric_same(jfab, jserve_fabric(jfab, stream, 4, submit=True),
                       fab, outs)
    fab.close_shadow()
    jfab.close_shadow()


@pytest.mark.parametrize("shadow_mode", ["deferred", "async"])
def test_one_replica_fabric_shadow_modes_match_inline_and_jax(shadow_mode):
    """test_fabric.py::test_one_replica_fabric_shadow_modes_identical_to_
    inline: deferred/1, and async behind a barrier after every batch,
    through the fabric equal the inline fabric, and JAX's."""
    kw = dict(weak_known={0, 1})
    stream = make_stream()
    a = build_fabric(1, **kw)
    a_outs = serve_fabric(a, stream, 4)
    b = build_fabric(1, shadow_mode=shadow_mode, shadow_flush_every=1, **kw)
    jb = jbuild_fabric(1, shadow_mode=shadow_mode, shadow_flush_every=1,
                       **kw)
    b_outs, jb_outs = [], []
    for start in range(0, len(stream), 4):
        chunk = stream[start:start + 4]
        for fab, outs in ((b, b_outs), (jb, jb_outs)):
            outs += fab.process_batch(
                [prompt(s, x) for s, x in chunk],
                [greq(s) for s, _ in chunk], keys=chunk,
                embs=np.stack([skill_emb(s) for s, _ in chunk]))
            fab.flush_shadow(timeout=WAIT)        # per-batch barrier
    assert_same(a.learn, a_outs, b.learn, b_outs)
    assert_fabric_same(jb, jb_outs, b, b_outs)
    for fab in (a, b, jb):
        fab.close_shadow()


def test_serialized_replicas_on_one_sharded_store_match_jax():
    """Two replicas over one 4-shard ``ShardedMemory``, one ticket at a
    time: the store is one object in every view (the IVF wrap too, made
    once before the replicas), and the run equals the same fabric on a
    ``MemoryState`` and JAX's fabric on its own, field for field."""
    kw = dict(weak_known={0, 1})
    stream = make_stream()
    runs = []
    for fab in (build_fabric(2, shards=4, **kw), build_fabric(2, **kw),
                jbuild_fabric(2, **kw)):
        outs = []
        for start in range(0, len(stream), 4):
            chunk = stream[start:start + 4]
            outs += fab.submit(
                [prompt(s, x) for s, x in chunk],
                [greq(s) for s, _ in chunk], keys=chunk,
                embs=np.stack([skill_emb(s) for s, _ in chunk])
            ).wait(timeout=WAIT)
        fab.flush_shadow(timeout=WAIT)
        runs.append((fab, outs))
    (sh, sh_outs), (single, single_outs), (jfab, jouts) = runs
    assert all(r.memory is sh.learn.memory for r in sh.replicas)
    assert isinstance(sh.memory, ShardedMemory)
    assert_fabric_same(single, single_outs, sh, sh_outs)
    assert_fabric_same(jfab, jouts, sh, sh_outs)
    for fab, _ in runs:
        fab.close_shadow()

    wrapped = build_fabric(2, shards=4, retrieval_clusters=4,
                           retrieval_probes=1, **kw)
    assert all(r.memory is wrapped.learn.memory for r in wrapped.replicas)
    assert isinstance(wrapped.memory.store, ShardedMemory)
    wrapped.close_shadow()


# ---------------------------------------------------------------------------
# Commit-stream broadcast and the one occupancy counter
# ---------------------------------------------------------------------------


def test_commit_broadcast_keeps_replica_views_identical():
    """test_fabric.py::test_commit_broadcast_keeps_replica_views_identical
    on the port's in-place store: every view is the learn replica's store
    object, and a replica that never served routes off what the others
    learned."""
    fab = build_fabric(3, weak_known={0, 1})
    stream = [(s, x) for s in range(6) for x in range(2)]
    serve_fabric(fab, stream, 3, submit=True)
    assert all(r.memory is fab.learn.memory for r in fab.replicas)
    out = fab.process_batch([prompt(0, 5)], [greq(0)],
                            embs=skill_emb(0)[None], replica=2)[0]
    assert out.case in ("memory_skill", "memory_guide")
    assert out.strong_calls == 0
    fab.close_shadow()


def test_occupancy_single_counter_exact_across_replicas():
    """test_fabric.py::test_occupancy_single_counter_exact_across_replicas:
    three replicas commit to one ring of 8 that wraps."""
    cap = 8
    fab = build_fabric(3, weak_known=set(),
                       memory=mem.MemoryConfig(capacity=cap, embed_dim=16,
                                               guide_len=8))
    for rep in range(2):
        serve_fabric(fab, [(s, rep) for s in range(12)], 2, submit=True)
    assert fab.memory_occupancy == fab.memory.size_fast == cap
    for r in fab.replicas:
        assert r.memory_occupancy == fab.memory_occupancy
    assert fab.commit_stream.commits == \
        fab.commit_stream.buffer.entries_applied == fab.memory.ptr
    fab.close_shadow()


# ---------------------------------------------------------------------------
# N-replica threaded stress
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shadow_mode,flush_every", [("inline", 1),
                                                     ("deferred", 2),
                                                     ("async", 2)])
def test_fabric_threaded_stress(shadow_mode, flush_every):
    """test_fabric.py::test_fabric_threaded_stress: concurrent replicas in
    every drain mode (in async, three drainer threads funnel into the
    learn replica): every request resolves once, nothing is lost or
    doubled in the commit stream, one store in every view."""
    cap = 8
    fab = build_fabric(3, weak_known={0, 1}, shadow_mode=shadow_mode,
                       shadow_flush_every=flush_every,
                       memory=mem.MemoryConfig(capacity=cap, embed_dim=16,
                                               guide_len=8))
    rng = np.random.default_rng(0)
    tickets, n_requests = [], 0
    for _ in range(60):
        B = int(rng.integers(1, 5))
        chunk = [(int(rng.integers(0, 12)), int(rng.integers(0, 8)))
                 for _ in range(B)]
        n_requests += B
        tickets.append(fab.submit(
            [prompt(s, x) for s, x in chunk],
            [greq(s) for s, _ in chunk],
            embs=np.stack([skill_emb(s) for s, _ in chunk])))
    fab.flush_shadow(timeout=WAIT)
    outs = [o for t in tickets for o in t.wait(timeout=WAIT)]
    assert len(outs) == n_requests
    assert all(o.case != PENDING for o in outs)
    stats = fab.stats()
    assert stats["items_enqueued"] == stats["items_drained"]
    assert fab.commit_stream.buffer.entries_applied == fab.memory.ptr
    assert fab.memory_occupancy == fab.memory.size_fast
    assert fab.memory.ptr > cap                       # wrapped the ring
    assert all(r.memory is fab.learn.memory for r in fab.replicas)
    assert fab.now == n_requests
    fab.close_shadow()


def test_worker_error_surfaces_at_wait_and_join():
    """test_fabric.py::test_worker_error_surfaces_at_wait_and_join."""
    fab = build_fabric(2, weak_known={0})
    boom = RuntimeError("replica died")

    def dying(prompts):
        raise boom

    fab.replicas[1].strong = _fake_tiers()[1]
    fab.replicas[1].strong.answer_batch = dying
    fab.submit([prompt(5, 1)], [greq(5)], embs=skill_emb(5)[None],
               replica=1)
    with pytest.raises(RuntimeError):
        fab.join(timeout=WAIT)
    ok = fab.submit([prompt(0, 2)], [greq(0)], embs=skill_emb(0)[None],
                    replica=0)
    assert ok.wait(timeout=WAIT)[0].response >= -1
    fab.close_shadow()


def test_fabric_validation():
    with pytest.raises(ValueError):
        build_fabric(0)


# ---------------------------------------------------------------------------
# Lifecycle and routing robustness
# ---------------------------------------------------------------------------


def test_close_shadow_joins_workers_when_flush_raises():
    """test_fabric.py::test_close_shadow_joins_workers_when_flush_raises:
    teardown runs in a finally, the failed epoch is kept, and a retried
    close drains it."""
    fab = build_fabric(2, weak_known=set(), shadow_mode="deferred",
                       shadow_flush_every=0)
    stream = make_stream()[:6]
    tickets = [fab.submit([prompt(s, x)], [greq(s)],
                          embs=skill_emb(s)[None], replica=0)
               for s, x in stream]
    for t in tickets:
        t.wait(timeout=WAIT)
    assert len(fab.learn.shadow._items) == len(stream)
    threads = [t for t in fab._threads if t is not None]
    assert threads and all(t.is_alive() for t in threads)
    real_runner = fab.learn.shadow.runner

    def dying(items):
        raise RuntimeError("drain broken")

    fab.learn.shadow.runner = dying
    with pytest.raises(RuntimeError, match="drain broken"):
        fab.close_shadow()
    assert all(not t.is_alive() for t in threads)
    assert fab._queues is None
    assert fab.learn.shadow.drain_failures == 2
    assert fab.learn.shadow.items_requeued == 2 * len(stream)
    assert len(fab.learn.shadow._items) == len(stream)
    fab.learn.shadow.runner = real_runner
    fab.close_shadow()
    assert fab.learn.shadow.items_enqueued == fab.learn.shadow.items_drained
    assert all(o.case != PENDING for t in tickets for o in t.wait())


def test_submit_serves_when_all_replicas_marked_dead():
    """test_fabric.py::test_submit_serves_when_all_replicas_marked_dead:
    a stale dead mark clears, a really dead worker restarts."""
    fab = build_fabric(2, weak_known={0, 1})
    first = fab.submit([prompt(0, 1)], [greq(0)], embs=skill_emb(0)[None])
    assert first.wait(timeout=WAIT)[0].response == 1
    fab.health = ["dead", "dead"]
    t = fab.submit([prompt(1, 2)], [greq(1)], embs=skill_emb(1)[None])
    assert t.wait(timeout=WAIT)[0].response == 3
    assert fab.health[t.replica] == "healthy"
    with fab._dispatch_lock:
        for q in fab._queues:
            q.put(None)
    for th in fab._threads:
        th.join(timeout=WAIT)
    assert all(not th.is_alive() for th in fab._threads)
    fab.health = ["dead", "dead"]
    restarts = fab.restarts
    t2 = fab.submit([prompt(0, 3)], [greq(0)], embs=skill_emb(0)[None])
    assert t2.wait(timeout=WAIT)[0].response == 3
    assert fab.restarts == restarts + 1
    fab.close_shadow()


def test_autoscale_spawn_and_retire():
    """test_fabric.py::test_autoscale_spawn_and_retire."""
    fab = build_fabric(1, weak_known={0, 1})
    fab.submit([prompt(0, 1)], [greq(0)],
               embs=skill_emb(0)[None]).wait(timeout=WAIT)
    assert fab.scale_to(3) == 2
    assert fab.active_replicas == 3 and len(fab.replicas) == 3
    assert all(r.memory is fab.learn.memory for r in fab.replicas)
    stream = make_stream()
    outs = serve_fabric(fab, stream, 2, submit=True)
    assert len(outs) == len(stream)
    assert all(o.case != PENDING for o in outs)
    assert fab.scale_to(1) == -2
    assert fab.active_replicas == 1
    assert fab.health[1] == fab.health[2] == "retired"
    t = fab.submit([prompt(1, 1)], [greq(1)], embs=skill_emb(1)[None])
    assert t.replica == 0
    t.wait(timeout=WAIT)
    with pytest.raises(ValueError):
        fab.scale_to(0)
    fab.set_autoscaler(lambda m: 2)
    assert fab.autoscale() == 1
    assert fab.active_replicas == 2
    fab.health[0] = "dead"
    assert fab.autoscale() == 0
    fab.health[0] = "healthy"
    m = fab.metrics()
    assert m["supervision"]["spawned"] == 3
    assert m["supervision"]["retired"] == 2
    assert m["supervision"]["active_replicas"] == 2
    fab.close_shadow()


def test_serve_threads_share_one_store_lock_with_the_drainers():
    """The lock the serve threads snapshot under is the one every replica's
    drainer applies under (the commit stream's), and the fabric's drain
    serializes the learn replica's epochs: two threads draining at once
    never overlap inside ``_drain_shadow``."""
    fab = build_fabric(2, weak_known={0, 1}, shadow_mode="async",
                       shadow_flush_every=1)
    assert all(r.shadow.store_lock is fab.commit_stream.lock
               for r in fab.replicas)
    inside, overlaps = [0], []
    real = fab.learn._drain_shadow

    def counted(items):
        inside[0] += 1
        overlaps.append(inside[0])
        try:
            real(items)
        finally:
            inside[0] -= 1
    fab.learn._drain_shadow = counted
    outs = serve_fabric(fab, make_stream() * 2, 2, submit=True)
    assert len(outs) == 2 * len(make_stream())
    assert overlaps and max(overlaps) == 1
    assert sum(r.shadow.drains for r in fab.replicas) == len(overlaps)
    fab.close_shadow()


# ---------------------------------------------------------------------------
# Helpers for the fabric modes of the launcher and the experiment driver
# (tests/test_torch_serve_launch.py, tests/test_torch_system.py)
# ---------------------------------------------------------------------------

#: the three fabric modes the launcher and ``run_rar_experiment`` take
FABRIC_MODES = {
    "replicas": dict(replicas=2),
    "process": dict(replicas=2, transport="process"),
    "poisson": dict(replicas=2, arrival_pattern="poisson")}


def record_tickets(monkeypatch):
    """Keep every ticket the two fabrics hand out (closed and open loop
    both submit through ``submit``)."""
    from repro_torch.serving.procfabric import ProcessServingFabric
    tickets = []
    for cls in (ServingFabric, ProcessServingFabric):
        def submit(self, *a, _base=cls.submit, **kw):
            t = _base(self, *a, **kw)
            tickets.append(t)
            return t
        monkeypatch.setattr(cls, "submit", submit)
    return tickets


def check_fabric_run(results, fab, tickets, n, open_loop):
    """What the JAX package's tests check of a fabric mode's staged run:
    one answer a request a stage, the stage totals equal the tickets'
    sums, the ring advanced once per committed entry, and (open loop) one
    queueing-delay sample a request."""
    outs = [o for t in tickets for o in t.wait(timeout=WAIT)]
    assert [r.n for r in results] == [n] * len(results)
    assert len(outs) == n * len(results)
    assert all(o.case != PENDING for o in outs)
    assert sum(r.strong_calls for r in results) == \
        sum(o.strong_calls for o in outs)
    assert sum(sum(r.cases.values()) for r in results) == len(outs)
    assert fab.commit_stream.buffer.entries_applied == fab.memory.ptr
    if open_loop:
        reg = fab.metrics()["registry"]
        assert reg["sched/queue_delay_ms"]["count"] == len(outs)
        assert reg["sched/admitted"] == len(outs)
