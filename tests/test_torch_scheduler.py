"""The port's admission scheduler and load generator
(``repro_torch.serving.{scheduler,loadgen}``) against the JAX package's:
the twin of ``tests/test_scheduler.py``, on the CPU.

The traces of every generator equal JAX's for the same seeds, event for
event. Batch formation runs in virtual time, so the port's batcher forms
JAX's batches on the same requests. The open-loop pins hold the port to
its own closed-loop reference (per-stream Outcome streams and FM calls)
and to JAX's open-loop run of the same trace, through the thread fabric
and through the process fabric (whose workers import no JAX).
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses
import os

import numpy as np
import pytest
from test_fabric import build_fabric as jbuild_fabric
from test_rar_controller import greq, prompt, skill_emb
from test_scheduler import _serve_closed as _jserve_closed
from test_scheduler import _serve_open as _jserve_open
from test_scheduler import _stream_seqs
from test_torch_fabric import build_fabric
from test_torch_pipeline import _plain
from test_torch_procfabric import _calls, build_proc

from repro.serving import loadgen as jloadgen
from repro.serving.scheduler import ContinuousBatcher as JBatcher
from repro.serving.scheduler import Request as JRequest
from repro_torch.serving import loadgen as tloadgen
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.loadgen import (ArrivalEvent, bursty_trace,
                                         poisson_trace, trace_replay)
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.scheduler import (ContinuousBatcher, Request,
                                           serve_trace)

WAIT = 120.0
MICROBATCH = 4


def _events(trace):
    return [dataclasses.astuple(e) for e in trace]


# ---------------------------------------------------------------------------
# Load generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gen,args,kw", [
    ("poisson_trace", (40, 25.0), dict(seed=7, streams=4, priorities=[0, 1],
                                       deadline_ms=80.0)),
    ("poisson_trace", ([3, 5], 10.0), dict(seed=0, streams=2,
                                           rates=[5.0, 50.0])),
    ("poisson_trace", ([18, 18], 300.0), dict(seed=11, streams=2,
                                              priorities=[0, 2])),
    ("bursty_trace", (2000, 100.0), dict(seed=3, burst=3.0, duty=0.25)),
    ("bursty_trace", ([18, 18], 200.0), dict(seed=5, streams=2))])
def test_traces_equal_jax_for_the_same_seed(gen, args, kw):
    assert _events(getattr(jloadgen, gen)(*args, **kw)) == \
        _events(getattr(tloadgen, gen)(*args, **kw))


def test_poisson_trace_deterministic_and_well_formed():
    a = poisson_trace(40, 25.0, seed=7, streams=4, priorities=[0, 1],
                      deadline_ms=80.0)
    b = poisson_trace(40, 25.0, seed=7, streams=4, priorities=[0, 1],
                      deadline_ms=80.0)
    assert a == b
    assert a != poisson_trace(40, 25.0, seed=8, streams=4,
                              priorities=[0, 1], deadline_ms=80.0)
    assert [e.index for e in a] == list(range(40))
    assert all(a[i].t <= a[i + 1].t for i in range(len(a) - 1))
    assert all(e.t > 0 for e in a)
    per = [sum(1 for e in a if e.stream == j) for j in range(4)]
    assert per == [10, 10, 10, 10]
    assert all(e.priority == e.stream % 2 for e in a)
    assert all(e.deadline_ms == 80.0 for e in a)


def test_poisson_trace_per_stream_counts_and_rates():
    t = poisson_trace([3, 5], 10.0, seed=0, streams=2, rates=[5.0, 50.0])
    assert [sum(1 for e in t if e.stream == j) for j in range(2)] == [3, 5]
    big = poisson_trace([500, 500], 10.0, seed=1, streams=2,
                        rates=[5.0, 50.0])
    last = [max(e.t for e in big if e.stream == j) for j in range(2)]
    assert last[1] < last[0]


def test_bursty_trace_mean_rate_preserved_and_clustered():
    n, rate = 2000, 100.0
    t = bursty_trace(n, rate, seed=3, burst=3.0, duty=0.25)
    assert t == bursty_trace(n, rate, seed=3, burst=3.0, duty=0.25)
    realized = n / t[-1].t
    assert 0.8 * rate < realized < 1.25 * rate
    gaps = np.diff([e.t for e in t])
    assert float(np.var(gaps) / np.mean(gaps) ** 2) > 1.2


def test_bursty_trace_rejects_impossible_duty_cycle():
    with pytest.raises(ValueError):
        bursty_trace(10, 5.0, burst=5.0, duty=0.5)


def test_trace_replay_normalises_validates_and_matches_jax():
    raw = [(0.5, 1), {"t": 0.1, "stream": 0, "priority": 2,
                      "deadline_ms": 9.0}]
    r = trace_replay(raw + [ArrivalEvent(t=0.3, stream=2)])
    assert [e.t for e in r] == [0.1, 0.3, 0.5]
    assert [e.index for e in r] == [0, 1, 2]
    assert r[0].priority == 2 and r[0].deadline_ms == 9.0
    assert r[2].stream == 1
    assert _events(r) == _events(jloadgen.trace_replay(
        raw + [jloadgen.ArrivalEvent(t=0.3, stream=2)]))
    with pytest.raises(ValueError):
        trace_replay([(-1.0, 0)])


# ---------------------------------------------------------------------------
# Batch formation (a recording fake fabric, no controller)
# ---------------------------------------------------------------------------


class _FakeTicket:
    def __init__(self, n):
        self.n = n

    def wait(self, timeout=None):
        return [None] * self.n


class _FakeFabric:
    replicas = [0, 1]

    def __init__(self):
        self.submits = []

    def submit(self, prompts, guide_requests, keys=None, embs=None,
               replica=None):
        self.submits.append({"keys": list(keys), "replica": replica,
                             "lens": [len(p) for p in prompts]})
        return _FakeTicket(len(prompts))


def _random_requests(rng, n, streams, lengths=(3,), deadline_frac=0.0):
    reqs, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.01))
        reqs.append(dict(
            arrival_s=t, stream=int(rng.integers(0, streams)),
            prompt=[0] * int(rng.choice(lengths)), guide_request=None,
            priority=int(rng.integers(0, 3)),
            deadline_ms=(float(rng.uniform(5, 50))
                         if rng.random() < deadline_frac else None),
            key=i, index=i))
    return reqs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("slo_ms", [None, 4.0, 40.0])
def test_batcher_properties_random_traces(seed, slo_ms):
    """test_scheduler.py::test_batcher_properties_random_traces, and the
    port's batches are JAX's batches (same submits, reasons, instants)."""
    rng = np.random.default_rng(seed)
    reqs = _random_requests(rng, 80, streams=3, lengths=(3, 5),
                            deadline_frac=0.25)
    runs = []
    for batcher_cls, req_cls in ((ContinuousBatcher, Request),
                                 (JBatcher, JRequest)):
        fab = _FakeFabric()
        bat = batcher_cls(fab, microbatch=4, slo_ms=slo_ms,
                          registry=MetricsRegistry())
        for r in reqs:
            bat.admit(req_cls(**r))
        bat.flush()
        runs.append((fab, bat))
    (fab, bat), (jfab, jbat) = runs
    assert fab.submits == jfab.submits
    assert [(d.batch_id, d.reason, d.dispatch_s) for d in bat.dispatches] \
        == [(d.batch_id, d.reason, d.dispatch_s) for d in jbat.dispatches]
    dispatched = [k for s in fab.submits for k in s["keys"]]
    assert sorted(dispatched) == list(range(80))
    for s in fab.submits:
        assert 1 <= len(s["keys"]) <= 4
        assert len(set(s["lens"])) == 1
    ids = [d.batch_id for d in bat.dispatches]
    assert len(ids) == len(set(ids))
    for d in bat.dispatches:
        assert all(r.batch_id == d.batch_id for r in d.requests)
    for j in range(3):
        seq = [r.index for d in bat.dispatches for r in d.requests
               if r.stream == j]
        assert seq == sorted(seq)
        assert len({d.replica for d in bat.dispatches
                    for r in d.requests if r.stream == j}) == 1
    for d in bat.dispatches:
        for r in d.requests:
            budget = (r.deadline_ms / 1e3 if r.deadline_ms is not None
                      else (slo_ms / 1e3) / (1 + r.priority)
                      if slo_ms is not None else float("inf"))
            assert r.dispatch_s - r.arrival_s <= budget + 1e-9


def _req(t, key, n=3, **kw):
    return Request(arrival_s=t, stream=kw.pop("stream", 0), prompt=[0] * n,
                   guide_request=None, key=key, index=key, **kw)


def test_slo_close_fires_at_the_oldest_members_deadline():
    fab = _FakeFabric()
    bat = ContinuousBatcher(fab, microbatch=8, slo_ms=20.0,
                            registry=MetricsRegistry())
    bat.admit(_req(0.0, 0))
    bat.admit(_req(0.015, 1))
    assert not fab.submits
    bat.admit(_req(0.05, 2))
    assert len(fab.submits) == 1
    assert fab.submits[0]["keys"] == [0, 1]
    d = bat.dispatches[0]
    assert d.reason == ContinuousBatcher.CLOSE_SLO
    assert d.dispatch_s == pytest.approx(0.020)
    assert bat.closes["slo"] == 1


def test_priority_tightens_the_queueing_budget():
    fab = _FakeFabric()
    bat = ContinuousBatcher(fab, microbatch=8, slo_ms=40.0,
                            registry=MetricsRegistry())
    bat.admit(_req(0.0, 0, priority=3))
    bat.advance(0.011)
    assert len(fab.submits) == 1
    assert bat.dispatches[0].dispatch_s == pytest.approx(0.010)


def test_bucket_switch_closes_the_streams_previous_batch():
    fab = _FakeFabric()
    bat = ContinuousBatcher(fab, microbatch=8, slo_ms=None,
                            registry=MetricsRegistry())
    bat.admit(_req(0.0, 0))
    bat.admit(_req(0.001, 1, n=7))
    assert len(fab.submits) == 1
    assert fab.submits[0]["keys"] == [0]
    assert bat.dispatches[0].reason == ContinuousBatcher.CLOSE_STREAM
    bat.flush()
    assert [s["keys"] for s in fab.submits] == [[0], [1]]


def test_admit_rejects_time_travel():
    bat = ContinuousBatcher(_FakeFabric(), microbatch=4,
                            registry=MetricsRegistry())
    bat.admit(_req(1.0, 0))
    with pytest.raises(ValueError):
        bat.admit(_req(0.5, 1))


# ---------------------------------------------------------------------------
# Determinism pins: open loop == closed loop, thread and process fabrics
# ---------------------------------------------------------------------------


def _serve_closed(fab, seqs, replicas):
    """``test_scheduler._serve_closed`` with bounded waits."""
    tickets = []
    for j, seq in enumerate(seqs):
        for start in range(0, len(seq), MICROBATCH):
            chunk = seq[start:start + MICROBATCH]
            tickets.append((j, fab.submit(
                [prompt(s, x) for s, x in chunk],
                [greq(s) for s, _ in chunk], keys=chunk,
                embs=np.stack([skill_emb(s) for s, _ in chunk]),
                replica=j % replicas)))
    fab.flush_shadow(timeout=WAIT)
    by_stream = [[] for _ in seqs]
    for j, t in tickets:
        by_stream[j] += t.wait(timeout=WAIT)
    return by_stream


def _serve_open(fab, seqs, trace, replicas, slo_ms):
    """``test_scheduler._serve_open`` on the port's ``serve_trace``."""
    cursors = [0] * len(seqs)
    admitted = []

    def make_request(ev):
        s, x = seqs[ev.stream][cursors[ev.stream]]
        cursors[ev.stream] += 1
        admitted.append(ev.stream)
        return prompt(s, x), greq(s), (s, x), skill_emb(s)

    outs, batcher = serve_trace(
        fab, trace, make_request, microbatch=MICROBATCH, slo_ms=slo_ms,
        replica_fn=lambda s: s % replicas, timeout=WAIT)
    fab.flush_shadow(timeout=WAIT)
    by_stream = [[] for _ in seqs]
    for j, out in zip(admitted, outs):
        by_stream[j].append(out)
    return by_stream, batcher


def _plain_streams(by_stream):
    return [_plain(s) for s in by_stream]


@pytest.mark.parametrize("slo_ms", [None, 3.0, 500.0])
@pytest.mark.parametrize("priorities", [None, [0, 2]])
def test_openloop_pin_thread_fabric(slo_ms, priorities):
    """test_scheduler.py::test_openloop_pin_thread_fabric: the same seeded
    trace gives the closed-loop reference's per-stream Outcomes and FM
    calls, and JAX's open-loop Outcomes and batches."""
    streams = replicas = 2
    seqs = _stream_seqs(streams)
    ref = build_fabric(replicas, weak_known={0, 1})
    ref_outs = _serve_closed(ref, seqs, replicas)
    trace = poisson_trace([len(s) for s in seqs], 300.0, seed=11,
                          streams=streams, priorities=priorities)
    fab = build_fabric(replicas, weak_known={0, 1})
    outs, batcher = _serve_open(fab, seqs, trace, replicas, slo_ms)
    assert outs == ref_outs
    assert fab.learn.weak.engine.calls == ref.learn.weak.engine.calls
    assert fab.learn.strong.engine.calls == ref.learn.strong.engine.calls
    assert batcher.stats()["dispatched"] == sum(len(s) for s in seqs)
    snap = fab.metrics()["registry"]
    assert snap["sched/queue_delay_ms"]["count"] == \
        sum(len(s) for s in seqs)
    assert "sched/stream1/e2e_ms" in snap
    jfab = jbuild_fabric(replicas, weak_known={0, 1})
    jtrace = jloadgen.poisson_trace([len(s) for s in seqs], 300.0, seed=11,
                                    streams=streams, priorities=priorities)
    jouts, jbatcher = _jserve_open(jfab, seqs, jtrace, replicas, slo_ms)
    assert _plain_streams(outs) == _plain_streams(jouts)
    assert batcher.stats() == jbatcher.stats()
    assert fab.learn.strong.engine.calls == jfab.learn.strong.engine.calls
    for f in (ref, fab, jfab):
        f.close_shadow()


def test_openloop_same_trace_same_bytes_across_runs():
    streams = replicas = 2
    seqs = _stream_seqs(streams)
    runs = []
    for _ in range(2):
        fab = build_fabric(replicas, weak_known={0, 1})
        trace = bursty_trace([len(s) for s in seqs], 200.0, seed=5,
                             streams=streams)
        outs, batcher = _serve_open(fab, seqs, trace, replicas, 15.0)
        runs.append((_plain_streams(outs),
                     [d.batch_id for d in batcher.dispatches],
                     [len(d.requests) for d in batcher.dispatches],
                     batcher.closes.copy()))
        fab.close_shadow()
    assert runs[0] == runs[1]


@pytest.mark.parametrize("slo_ms", [None, 10.0])
def test_openloop_pin_process_fabric(slo_ms):
    """test_scheduler.py::test_openloop_pin_process_fabric: open loop
    through the port's process fabric equals the port's and JAX's thread
    fabric closed-loop, Outcome for Outcome and call for call."""
    streams = workers = 2
    seqs = _stream_seqs(streams, reps=2)
    ref = build_fabric(workers, weak_known={0, 1})
    ref_outs = _serve_closed(ref, seqs, workers)
    jref = jbuild_fabric(workers, weak_known={0, 1})
    assert _plain_streams(_jserve_closed(jref, seqs, workers)) == \
        _plain_streams(ref_outs)
    trace = poisson_trace([len(s) for s in seqs], 400.0, seed=23,
                          streams=streams, priorities=[0, 1])
    fab = build_proc(workers, weak_known={0, 1})
    try:
        outs, _ = _serve_open(fab, seqs, trace, workers, slo_ms)
        assert outs == ref_outs
        assert _calls(fab, "weak") == ref.learn.weak.engine.calls
        assert _calls(fab, "strong") == ref.learn.strong.engine.calls
    finally:
        fab.close_shadow()
        ref.close_shadow()
        jref.close_shadow()


def test_openloop_soak_survives_worker_kill():
    """test_scheduler.py::test_openloop_soak_survives_worker_kill: a
    SIGKILL of worker 1 mid-trace changes neither the Outcomes nor the
    batch formation."""
    seed = int(os.environ.get("REPRO_SOAK_SEED", "0"))
    streams = workers = 2
    seqs = _stream_seqs(streams, reps=2)
    trace = poisson_trace([len(s) for s in seqs], 250.0, seed=seed,
                          streams=streams)

    def run(fault_plan):
        fab = build_proc(workers, weak_known={0, 1},
                         fault_plan=fault_plan, lease_interval=0.1,
                         lease_timeout=8.0)
        try:
            outs, batcher = _serve_open(fab, seqs, trace, workers, 10.0)
            return outs, batcher.stats(), fab.deaths, fab.restarts
        finally:
            fab.close_shadow()

    clean_outs, clean_stats, _, _ = run(None)
    plan = FaultPlan([FaultPlan.replica_kill(1, at=2)])
    kill_outs, kill_stats, deaths, restarts = run(plan)
    assert kill_outs == clean_outs
    assert kill_stats == clean_stats
    assert deaths >= 1 and deaths == restarts
    assert sum(len(o) for o in kill_outs) == sum(len(s) for s in seqs)
