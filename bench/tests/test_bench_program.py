"""The port's own spans and counters as the benchmark reads them: the five
readers in traced runs of the two cells on the CPU, the port's tracer
never enabled by an untraced run, the launch join, and the breakdown that
puts each idle gap on the innermost span."""
import types

import _bench_path  # noqa: F401
import pytest
from _bench_cells import lm_cell, rar_cell, run_cell

from bench import run
from bench.harness import program
from bench.harness.probes import Spans
from bench.harness.record import Record
from bench.harness.trace import DeviceTrace

SEED = 2_147_483_693
RAR_METRICS = ("host_syncs_per_step.rar", "partition_ms.rar",
               "engine_issue_ms.rar")
LM_METRICS = ("moe_dispatch_ms.tier", "moe_experts_ms.tier")


def _traced(monkeypatch, cell, steps):
    """A traced run of ``cell``, its result line and its record."""
    kept = {}
    plain = run.result

    def result(cell, rec, trace, info):
        kept["rec"] = rec
        return plain(cell, rec, trace, info)
    monkeypatch.setattr(run, "result", result)
    return run_cell(cell, SEED, steps=steps, trace=1), kept["rec"]


def test_traced_rar_run_reads_the_port_spans(monkeypatch):
    out, rec = _traced(monkeypatch, rar_cell(), steps=3)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(RAR_METRICS) <= set(m)
    assert m["host_syncs_per_step.rar"] >= 2
    assert m["partition_ms.rar"] > 0 and m["engine_issue_ms.rar"] > 0
    window_ms = 1e3 * rec.window_s / rec.steps
    assert m["partition_ms.rar"] + m["engine_issue_ms.rar"] < window_ms
    spans = rec.program.spans
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent == 0]
    assert len(roots) == rec.steps == 3
    assert {s.name for s in roots} == {"pipeline.step"}
    for s in spans:
        top = s
        while top.parent:
            top = by_id[top.parent]
        assert top.name == "pipeline.step" and top.id == s.step
    assert {"pipeline.partition", "engine.call", "engine.fetch"} <= {
        s.name for s in spans}
    from repro_torch import tracing
    assert not tracing.enabled()


def test_untraced_run_leaves_the_tracer_off(monkeypatch):
    from repro_torch import tracing
    tracing.disable()
    enabled = []
    monkeypatch.setattr(tracing, "enable", lambda: enabled.append(1))
    out = run_cell(rar_cell(), SEED, steps=2)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"requests_per_s", "setup_s"}
    assert not enabled and not tracing.enabled()
    assert tracing.collect().spans == []


def test_traced_lm_run_reads_the_moe_split(monkeypatch):
    out, rec = _traced(monkeypatch, lm_cell(), steps=2)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    call_ms = 1e3 * out["device"]["window_s"] / rec.steps
    for name in LM_METRICS:
        assert 0 < m[name] < call_ms, (name, m[name], call_ms)
    assert m["moe_dispatch_ms.tier"] + m["moe_experts_ms.tier"] < call_ms
    assert {s.name for s in rec.program.spans if s.parent == 0} == \
        {"engine.call"}
    b = program.breakdown(rec)
    assert b["inside_spans_share"] > 0.9
    assert {"moe.experts", "moe.dispatch"} <= {n for n, _ in
                                               b["device_by_span"]}


def test_readers_read_none_without_the_port_records():
    rec = Record(steps=3, t0_ns=0, t1_ns=10)
    rec.program = program.Program([], {}, 0)
    from bench.harness.manifest import load_module
    for name in RAR_METRICS + LM_METRICS:
        assert load_module("metrics", name).read(rec) is None, name
    program.tracer().disable()


def _span(name, id_, parent, step, a, b):
    from repro_torch.tracing import Span
    return Span(name, id_, parent, step, 1, a, b)


def _synthetic():
    """A window of 0-100 us: device ops at 0-10, 40-50 and 90-100, the
    benchmark's span ``outer`` over 5-95 and the port's ``step`` 10-90
    holding ``a`` 12-30 (holding ``a1`` 14-20) and ``b`` 52-60."""
    trace = DeviceTrace(types.SimpleNamespace(type="cpu"))
    trace.t0_us, trace.t1_us = 0.0, 100.0
    trace.events = [("k0", 0.0, 10.0), ("k1", 40.0, 50.0),
                    ("k2", 90.0, 100.0)]
    spans = Spans()
    spans.wall_offset = 0
    spans.events = [("outer", 5_000, 95_000)]
    rec = Record(trace=trace, spans=spans, steps=1, t0_ns=0, t1_ns=100_000)
    return rec


def test_breakdown_without_port_spans_is_todays():
    rec = _synthetic()
    rec.program = program.Program([], {}, 0)
    assert program.breakdown(rec) == rec.trace.breakdown(rec.spans)
    program.tracer().disable()


def test_breakdown_puts_each_gap_on_the_innermost_span(monkeypatch):
    rec = _synthetic()
    rec.program = program.Program([
        _span("a1", 3, 2, 1, 14_000, 20_000),
        _span("a", 2, 1, 1, 12_000, 30_000),
        _span("b", 4, 1, 1, 52_000, 60_000),
        _span("step", 1, 0, 1, 10_000, 90_000)], {}, 0)
    monkeypatch.setattr(program, "device_by_span", lambda rec: None)
    got = dict(program.breakdown(rec)["idle_gaps"])
    # gaps 10-40 (midpoint 25: in a, after a1) and 50-90 (midpoint 70:
    # in step, after b); the benchmark's spans alone put both on outer
    assert got == pytest.approx({"a": 30e-6, "step": 40e-6})
    today = dict(rec.trace.breakdown(rec.spans)["idle_gaps"])
    assert today == pytest.approx({"outer": 70e-6})
    program.tracer().disable()


def test_breakdown_names_the_window_ends_and_counts_a_step(monkeypatch):
    rec = _synthetic()
    rec.spans.events = []
    rec.program = program.Program([_span("step", 1, 0, 1, 10_000, 40_000)],
                                  {("host_sync.a", 1): 3,
                                   ("host_sync.ab", 1): 1}, 0)
    monkeypatch.setattr(program, "device_by_span", lambda rec: None)
    got = program.breakdown(rec)
    # 10-40 within the step; 50-90 after the last step
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"step": 30e-6, program.ENDS: 40e-6})
    assert got["counts_per_step"] == {"host_sync.a": 3, "host_sync.ab": 1}
    program.tracer().disable()


def test_innermost_over_nested_and_overlapping_intervals():
    ivs = [(0, 100, "r"), (10, 40, "a"), (20, 30, "a1"), (50, 60, "b"),
           (55, 80, "t")]           # t overlaps b without nesting
    got = program.innermost(ivs, [5, 15, 25, 35, 45, 52, 58, 65, 90, 100])
    assert got == ["r", "a", "a1", "a", "r", "b", "t", "t", "r", None]


class _Event:
    def __init__(self, name, dev, cid, a, b):
        from torch.autograd import DeviceType
        self._n, self._c, self._a, self._b = name, cid, a, b
        self._d = DeviceType.CUDA if dev else DeviceType.CPU

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def duration_ns(self):
        return self._b - self._a


def test_launch_join_by_correlation_id():
    events = [_Event("cudaLaunchKernel", False, 7, 100, 110),
              _Event("Lazy Function Loading", False, 7, 105, 108),
              _Event("cuLaunchKernelEx", False, 9, 200, 205),
              _Event("gemm", True, 7, 300, 400),
              _Event("nvjet", True, 9, 400, 450),
              _Event("orphan", True, 11, 450, 460),
              _Event("Memset", True, 12, 460, 460)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    trace = types.SimpleNamespace(device=types.SimpleNamespace(type="cuda"),
                                  prof=prof)
    assert program.launched_ops(trace) == [(300, 400, 100), (400, 450, 200),
                                           (450, 460, None)]


@pytest.mark.parametrize("steps", [1, 2])
def test_window_keeps_the_steps_begun_inside(steps):
    from repro_torch.tracing import Trace
    spans = [_span("pipeline.step", 1, 0, 1, 0, 10),
             _span("pipeline.read", 2, 1, 1, 2, 4),
             _span("pipeline.step", 3, 0, 3, 20, 30),
             _span("pipeline.step", 4, 0, 4, 40, 50)]
    counts = {("host_sync.a", 1): 2, ("host_sync.a", 3): 1,
              ("host_sync.a", 4): 5, ("host_sync.a", 0): 9}
    t1 = 30 if steps == 1 else 45
    p = program.window(Trace(spans, counts, 7), 15, t1)
    assert [s.id for s in p.spans] == [3, 4][:steps]
    assert p.count("host_sync.") == [1, 6][steps - 1]
    assert p.wall_offset_ns == 7
