"""The port's metrics plane and adaptive drain cadence against the JAX
package's: the twin of ``tests/test_metrics.py``.

* the registry, its reservoir and its OpenMetrics exposition, which must
  be byte-equal to JAX's for the same calls;
* adaptive under an always-drain policy == deferred flush-every-1 (port
  against JAX), the cold start, and ``flush_every`` as a staleness cap;
* the cost model fitted from fixed ``note_drain`` inputs, equal to JAX's
  ``(overhead, per_item)`` within 1e-9;
* registry snapshots stay consistent while the async drainer runs;
* the fabric's metrics (consistent under three replicas' drainers, JAX's
  shape), its shared adaptive policy, the autoscaling policy (decision for
  decision JAX's) and the supervisor tick, counted before its resize.
"""
import threading
import time

import numpy as np
import pytest
from test_pipeline import SCENARIOS, make_stream
from test_torch_shadow import WAIT, _split, assert_same, build, serve_stream

from repro.core.shadow import AdaptiveDrainPolicy as JAdaptive
from repro.serving.metrics import MetricsRegistry as JRegistry
from repro_torch.core.shadow import AdaptiveDrainPolicy, DrainPolicy
from repro_torch.serving.metrics import MetricsRegistry


def _drive(reg, rng):
    """The same random calls on any registry."""
    for i in range(int(rng.integers(20, 200))):
        kind = int(rng.integers(0, 3))
        name = (f"p{int(rng.integers(0, 3))}/"
                f"{'cgh'[kind]}{int(rng.integers(0, 4))}")
        if kind == 0:
            reg.counter(name).inc(int(rng.integers(1, 5)))
        elif kind == 1:
            reg.gauge(name).set(float(rng.normal()) if i % 2 else
                                int(rng.integers(0, 9)))
        else:
            reg.histogram(name).observe(float(rng.exponential()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_openmetrics_match_jax(seed):
    """The same calls give JAX's snapshot and, byte for byte, its
    OpenMetrics exposition."""
    t, j = MetricsRegistry(), JRegistry()
    _drive(t, np.random.default_rng(seed))
    _drive(j, np.random.default_rng(seed))
    assert t.snapshot() == j.snapshot()
    assert t.to_openmetrics() == j.to_openmetrics()


def test_registry_instruments_and_snapshot():
    """test_metrics.py::test_registry_instruments_and_snapshot."""
    reg = MetricsRegistry()
    reg.counter("a/n").inc()
    reg.counter("a/n").inc(4)
    reg.gauge("a/depth").set(7)
    for v in (1.0, 2.0, 3.0, 4.0):
        reg.histogram("a/cost").observe(v)
    snap = reg.snapshot()
    assert snap["a/n"] == 5 and snap["a/depth"] == 7
    h = snap["a/cost"]
    assert h["count"] == 4 and h["total"] == 10.0 and h["mean"] == 2.5
    assert h["p50"] in (2.0, 3.0) and h["p99"] == 4.0
    with pytest.raises(TypeError):
        reg.gauge("a/n")
    with pytest.raises(TypeError):
        reg.histogram("a/depth")


def test_histogram_reservoir_bounded_but_counts_exact():
    """test_metrics.py::test_histogram_reservoir_bounded_but_counts_exact,
    and the decimated summary is JAX's."""
    t, j = MetricsRegistry().histogram("h"), JRegistry().histogram("h")
    n = 10_000
    for v in range(n):
        t.observe(float(v))
        j.observe(float(v))
    assert t.count == n and t.total == float(sum(range(n)))
    assert len(t._samples) <= 2048
    s = t.summary()
    assert 0.2 * n < s["p50"] < 0.8 * n
    assert s == j.summary()


# ---------------------------------------------------------------------------
# Adaptive cadence
# ---------------------------------------------------------------------------


def _force_policy(ctrl, policy):
    policy.register(ctrl.shadow)
    ctrl.shadow.drain_policy = policy
    return policy


@pytest.mark.parametrize("kw", SCENARIOS[:3])
@pytest.mark.parametrize("batch", [1, 4])
def test_adaptive_always_drain_policy_matches_jax_deferred(kw, batch):
    """test_metrics.py::test_adaptive_always_drain_policy_identical_to_
    deferred: the port's adaptive under the always-drain policy against
    JAX's deferred/1."""
    tiers, kw = _split(kw)
    stream = make_stream()
    j, _ = build("jax", shadow_mode="deferred", shadow_flush_every=1,
                 **tiers, **kw)
    t, _ = build("torch", shadow_mode="adaptive", shadow_flush_every=0,
                 **tiers, **kw)
    pol = _force_policy(t, DrainPolicy())
    assert_same(j, serve_stream(j, stream, batch),
                t, serve_stream(t, stream, batch))
    assert pol.decisions > 0


def test_adaptive_cold_start_drains_like_deferred():
    """test_metrics.py::test_adaptive_cold_start_drains_like_deferred."""
    kw = dict(weak_known=set())
    stream = make_stream()[:4]
    j, _ = build("jax", shadow_mode="deferred", shadow_flush_every=1, **kw)
    t, _ = build("torch", shadow_mode="adaptive", shadow_flush_every=0, **kw)
    assert_same(j, serve_stream(j, stream, 2), t, serve_stream(t, stream, 2))
    assert t.shadow.drain_policy.stats()["coldstart_drains"] >= 1


def test_adaptive_flush_every_is_a_hard_staleness_cap():
    """test_metrics.py::test_adaptive_flush_every_is_a_hard_staleness_cap."""

    class NeverDrain(DrainPolicy):
        def due(self):
            self.decisions += 1
            return False

    t, _ = build("torch", shadow_mode="adaptive", shadow_flush_every=2,
                 weak_known=set())
    _force_policy(t, NeverDrain())
    serve_stream(t, make_stream()[:6], 1)
    assert t.shadow.drains >= 3
    assert t.shadow.items_enqueued == t.shadow.items_drained


def test_adaptive_policy_learns_cost_model():
    """test_metrics.py::test_adaptive_policy_learns_cost_model."""
    pol = AdaptiveDrainPolicy(decay=1.0)
    for n, secs in ((1, 1.0), (2, 1.5), (4, 2.5), (8, 4.5)):
        pol.note_drain(n, secs)
    a, b = pol.model()
    assert a == pytest.approx(0.5, abs=1e-6)
    assert b == pytest.approx(0.5, abs=1e-6)
    st = pol.stats()
    assert st["overhead_secs"] == pytest.approx(0.5, abs=1e-6)
    assert st["per_item_secs"] == pytest.approx(0.5, abs=1e-6)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("decay", [1.0, 0.95, 0.7])
def test_cost_model_matches_jax(seed, decay):
    """Fixed ``note_drain`` inputs: the port's fitted ``(overhead,
    per_item)`` equals JAX's within 1e-9 after every drain."""
    rng = np.random.default_rng(seed)
    t, j = AdaptiveDrainPolicy(decay=decay), JAdaptive(decay=decay)
    for _ in range(int(rng.integers(2, 40))):
        n = int(rng.integers(1, 33))
        secs = 1e-3 * (2.0 + 0.3 * n) * float(rng.uniform(0.8, 1.2))
        t.note_drain(n, secs)
        j.note_drain(n, secs)
        mt, mj = t.model(), j.model()
        assert (mt is None) == (mj is None)
        if mt is not None:
            assert mt == pytest.approx(mj, abs=1e-9, rel=0)
    assert t.stats()["reshadow_prob"] == j.stats()["reshadow_prob"]


# ---------------------------------------------------------------------------
# Snapshot consistency under the async drainer
# ---------------------------------------------------------------------------

_COUNTERS = ("items_enqueued", "items_drained", "drains",
             "drain_failures", "items_requeued", "epochs_applied",
             "entries_applied")


def _check_snapshot(snap, prev):
    for name, val in snap.items():
        v = val["count"] if isinstance(val, dict) else val
        if isinstance(val, dict) or name.endswith(_COUNTERS):
            assert v >= prev.get(name, 0), f"{name} went backwards"
            prev[name] = v
    by_prefix = {}
    for name, val in snap.items():
        for suffix in ("items_enqueued", "items_drained"):
            if name.endswith(suffix):
                by_prefix.setdefault(name[: -len(suffix)], {})[suffix] = val
    for prefix, d in by_prefix.items():
        assert d["items_drained"] <= d["items_enqueued"], prefix


def test_metrics_consistent_under_async_drainer():
    """test_metrics.py::test_metrics_consistent_under_async_drainer."""
    ctrl, _ = build("torch", weak_known=set(), shadow_mode="async",
                    shadow_flush_every=2)
    stop, failures, prev = threading.Event(), [], {}

    def sampler():
        while not stop.is_set():
            try:
                _check_snapshot(ctrl.metrics_registry.snapshot(), prev)
            except AssertionError as e:
                failures.append(e)
                return
            time.sleep(0.0005)

    th = threading.Thread(target=sampler)
    th.start()
    try:
        serve_stream(ctrl, make_stream() * 2, 4)
    finally:
        stop.set()
        th.join(timeout=WAIT)
        ctrl.close_shadow(timeout=WAIT)
    assert not failures, failures[0]
    snap = ctrl.metrics_registry.snapshot()
    assert snap["shadow/items_enqueued"] == snap["shadow/items_drained"]
    assert snap["shadow/depth_items"] == 0
    met = ctrl.metrics()
    assert met["commit"]["epoch"] == ctrl.shadow.buffer.epoch
    assert met["registry"]["shadow/drains"] == ctrl.shadow.drains


# ---------------------------------------------------------------------------
# OpenMetrics text exposition
# ---------------------------------------------------------------------------


def test_to_openmetrics_exposition_format():
    """test_metrics.py::test_to_openmetrics_exposition_format, byte-equal
    to JAX's exposition of the same calls."""
    regs = []
    for reg in (MetricsRegistry(), JRegistry()):
        reg.counter("sched/admitted").inc(5)
        reg.gauge("replica0/shadow/depth_items").set(3)
        for v in (1.0, 2.0, 3.0, 4.0):
            reg.histogram("sched/queue_delay_ms").observe(v)
        regs.append(reg.to_openmetrics())
    text = regs[0]
    assert text == regs[1]
    lines = text.splitlines()
    assert "# TYPE sched_admitted counter" in lines
    assert "sched_admitted_total 5" in lines
    assert "# TYPE replica0_shadow_depth_items gauge" in lines
    assert "replica0_shadow_depth_items 3" in lines
    assert "# TYPE sched_queue_delay_ms summary" in lines
    assert 'sched_queue_delay_ms{quantile="0.99"} 4' in lines
    assert "sched_queue_delay_ms_sum 10" in lines
    assert "sched_queue_delay_ms_count 4" in lines
    assert lines[-1] == "# EOF" and text.endswith("# EOF\n")
    declared = {ln.split()[2] for ln in lines if ln.startswith("# TYPE")}
    for ln in lines:
        if ln.startswith("#"):
            continue
        name = ln.split()[0].split("{")[0]
        for suffix in ("_total", "_sum", "_count"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
                break
        assert name in declared, ln


def test_to_openmetrics_empty_registry_is_just_eof():
    assert MetricsRegistry().to_openmetrics() == "# EOF\n"


# ---------------------------------------------------------------------------
# The fabric's metrics plane and autoscaling (tests/test_metrics.py lines
# 209-444)
# ---------------------------------------------------------------------------


def _fabric(replicas, **kw):
    from test_torch_fabric import build_fabric
    return build_fabric(replicas, **kw)


def _serve_fabric(fab, stream, batch):
    from test_torch_fabric import serve_fabric
    return serve_fabric(fab, stream, batch, submit=True)


def test_fabric_metrics_consistent_under_threaded_stress():
    """test_metrics.py::test_fabric_metrics_consistent_under_threaded_
    stress: three replicas (three async drainers) serving while a sampler
    reads ``fabric.metrics()``: no torn snapshot, counters monotone."""
    fab = _fabric(3, weak_known=set(), shadow_mode="async",
                  shadow_flush_every=2)
    stop, failures, prev = threading.Event(), [], {}

    def sampler():
        while not stop.is_set():
            try:
                m = fab.metrics()
                for rep in m["replicas"]:
                    assert 0 <= rep["items_drained"] <= rep["items_enqueued"]
                    assert rep["commit_epoch_lag"] >= 0
                    assert rep["shadow_pending"] >= 0
                _check_snapshot(m["registry"], prev)
                assert m["commit"]["epoch"] >= prev.get("__epoch", 0)
                prev["__epoch"] = m["commit"]["epoch"]
            except AssertionError as e:
                failures.append(e)
                return
            time.sleep(0.0005)

    th = threading.Thread(target=sampler)
    th.start()
    try:
        outs = _serve_fabric(fab, make_stream() * 3, 4)
    finally:
        stop.set()
        th.join(timeout=WAIT)
    assert not failures, failures[0]
    assert len(outs) == len(make_stream()) * 3
    learn = fab.metrics()["replicas"][0]
    assert learn["items_enqueued"] == learn["items_drained"]
    assert learn["shadow_pending"] == 0
    fab.close_shadow()


def test_fabric_metrics_shape_matches_jax():
    """test_metrics.py::test_fabric_metrics_shape, and the port's snapshot
    has JAX's keys and, for this deterministic run, its numbers (the
    registry's drain-second histograms aside: wall time)."""
    from test_fabric import build_fabric as jbuild
    from test_fabric import serve_fabric as jserve
    stream = make_stream()
    fab = _fabric(2, weak_known={0, 1})
    outs = _serve_fabric(fab, stream, 4)
    assert all(o.case != "shadow_pending" for o in outs)
    m = fab.metrics()
    assert len(m["replicas"]) == 2
    for rep in m["replicas"]:
        assert rep["queue_depth"] == 0
        assert rep["shadow_pending"] == 0
        assert rep["commit_epoch_lag"] == 0
    assert m["commit"]["epoch"] >= 1
    assert m["commit"]["entries_applied"] >= 1
    assert set(m["engines"]) == {"weak", "strong"}
    assert m["supervision"]["deaths"] == 0
    assert m["supervision"]["active_replicas"] == 2
    assert m["registry"]["replica0/shadow/drain_items"]["count"] >= 1
    assert m["registry"]["replica0/shadow/drain_staleness_batches"][
        "count"] >= 1
    jfab = jbuild(2, weak_known={0, 1})
    jserve(jfab, stream, 4)
    jm = jfab.metrics()
    assert set(m) == set(jm)
    assert [set(r) for r in m["replicas"]] == \
        [set(r) for r in jm["replicas"]]
    assert set(m["registry"]) == set(jm["registry"])
    assert m["supervision"] == jm["supervision"]
    assert m["autoscaler"] == jm["autoscaler"]
    fab.close_shadow()
    jfab.close_shadow()


def test_fabric_adaptive_shares_one_policy_across_replicas():
    fab = _fabric(2, weak_known=set(), shadow_mode="adaptive",
                  shadow_flush_every=0)
    assert isinstance(fab.drain_policy, AdaptiveDrainPolicy)
    for r in fab.replicas:
        assert r.shadow.drain_policy is fab.drain_policy
    assert fab.metrics()["drain_policy"] is not None
    outs = _serve_fabric(fab, make_stream(), 4)
    assert all(o.case != "shadow_pending" for o in outs)
    m = fab.metrics()
    assert m["drain_policy"]["decisions"] > 0
    learn = m["replicas"][0]
    assert learn["items_enqueued"] == learn["items_drained"]
    fab.close_shadow()


def test_fabric_exports_openmetrics():
    fab = _fabric(2, weak_known={0, 1})
    _serve_fabric(fab, make_stream(), 4)
    text = fab.metrics_registry.to_openmetrics()
    assert "replica0_shadow_items_enqueued_total" in text
    assert text.endswith("# EOF\n")
    fab.close_shadow()


def _synthetic_metrics(active, depths, p99=None, count=100):
    m = {"replicas": [{"replica": i, "health": "healthy", "queue_depth": d}
                      for i, d in enumerate(depths)],
         "supervision": {"active_replicas": active}, "registry": {}}
    if p99 is not None:
        m["registry"]["sched/queue_delay_ms"] = {
            "count": count, "total": p99 * count, "mean": p99,
            "p50": p99 / 2, "p99": p99}
    return m


def test_queue_latency_autoscaler_decisions_match_jax():
    """test_metrics.py::test_queue_latency_autoscaler_policy_decisions and
    ::test_autoscaler_latency_signal_without_slo_ignored, each decision
    and the stats equal to JAX's policy's."""
    from repro.serving.fabric import QueueLatencyAutoscaler as JPolicy
    from repro_torch.serving.fabric import QueueLatencyAutoscaler
    cases = [((2, [5, 6]), 3), ((2, [0, 1], 80.0), 3),
             ((3, [0, 0, 0], 5.0), 2), ((2, [1, 1], 30.0), 2),
             ((1, [0]), 1), ((4, [9, 9, 9, 9]), 4),
             ((2, [0, 0], 999.0, 0), None)]
    pol = QueueLatencyAutoscaler(min_replicas=1, max_replicas=4,
                                 slo_ms=50.0)
    jpol = JPolicy(min_replicas=1, max_replicas=4, slo_ms=50.0)
    for args, want in cases:
        got = pol(_synthetic_metrics(*args))
        assert got == jpol(_synthetic_metrics(*args))
        assert got == want if want is not None else got in (1, 2)
    s = pol.stats()
    assert s == jpol.stats()
    assert s["decisions"] == 7
    assert s["scale_ups"] >= 2 and s["scale_downs"] >= 1
    with pytest.raises(ValueError):
        QueueLatencyAutoscaler(min_replicas=3, max_replicas=2)
    pol = QueueLatencyAutoscaler(slo_ms=None)
    assert pol(_synthetic_metrics(2, [0, 0], p99=1e9)) == 1
    assert pol(_synthetic_metrics(2, [9, 9], p99=0.0)) == 3


def test_supervisor_tick_drives_health_gated_autoscale():
    """test_metrics.py::test_supervisor_tick_drives_health_gated_autoscale,
    deterministically: the port counts a tick before its resize, so once
    the fleet shows 3 replicas the tick that made it is counted (JAX's
    twin races there)."""
    fab = _fabric(1, weak_known={0, 1})
    _serve_fabric(fab, make_stream(), 4)
    fab.start_autoscaler(interval_s=0.02, policy=lambda m: 3)
    deadline = time.monotonic() + WAIT
    while fab.active_replicas < 3 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fab.active_replicas == 3
    assert fab.autoscale_ticks >= 1
    assert fab.metrics()["autoscaler"]["ticks"] >= 1
    fab.close_shadow()
    assert fab._autoscale_thread is None
    ticks_at_close = fab.autoscale_ticks
    time.sleep(0.1)
    assert fab.autoscale_ticks == ticks_at_close


def test_default_policy_installed_by_start_autoscaler():
    from repro_torch.serving.fabric import QueueLatencyAutoscaler
    fab = _fabric(2, weak_known={0, 1})
    fab.start_autoscaler(interval_s=30.0)
    assert isinstance(fab.autoscale_policy, QueueLatencyAutoscaler)
    assert fab.metrics()["autoscaler"]["policy"]["policy"] == \
        "QueueLatencyAutoscaler"
    assert fab.autoscale() <= 0
    fab.close_shadow()
