"""The port's tracer (``repro_torch.tracing``): off by default at no cost,
spans that nest by thread, counters by step, ``collect`` that clears,
and the spans and host-sync counters of a controller step, an engine
call and the MoE layer. The metrics registry reads the same with the
tracer on."""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import threading

import numpy as np
import pytest
import torch
from test_torch_shadow import build, serve_stream

from repro_torch import configs, tracing
from repro_torch.models import init_params
from repro_torch.models import layers as L
from repro_torch.serving.engine import ServingEngine

WAIT = 30.0


def _totals(got) -> dict:
    """Each counter of ``got`` summed over its steps."""
    out = {}
    for (name, _), n in got.counts.items():
        out[name] = out.get(name, 0) + n
    return out


@pytest.fixture(autouse=True)
def _off():
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


def test_off_is_the_shared_null_context_and_records_nothing():
    assert not tracing.enabled()
    a, b = tracing.span("a"), tracing.span("b")
    assert a is b
    with a:
        tracing.count("host_sync.x")
    tracing.end(tracing.begin("c", 0), 5)
    got = tracing.collect()
    assert got.spans == [] and got.counts == {}


def test_off_reads_no_clock_and_runs_no_device_op(monkeypatch):
    class NoClock:
        def __getattr__(self, name):
            raise AssertionError(f"clock read while off: {name}")
    monkeypatch.setattr(tracing, "time", NoClock())
    monkeypatch.setattr(torch.cuda, "synchronize", NoClock)

    @tracing.traced("f")
    def f(x):
        return x + 1
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with tracing.span("s"):
                tracing.count("host_sync.x", 2)
            tracing.end(tracing.begin("b", 0))
    assert not [e for e in prof.events() if e.name.startswith("aten::")]
    assert f(1) == 2


def test_on_adds_no_device_op():
    from torch.profiler import ProfilerActivity, profile
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("s"):
            tracing.count("host_sync.x")
    assert not [e for e in prof.events() if e.name.startswith("aten::")]
    assert len(tracing.collect().spans) == 1


def test_parents_and_steps_nest():
    tracing.enable()
    with tracing.span("root") as r:
        with tracing.span("a") as a:
            with tracing.span("a1"):
                pass
        with tracing.span("b"):
            pass
    with tracing.span("root2") as r2:
        pass
    got = {s.name: s for s in tracing.collect().spans}
    assert got["root"].parent == 0 and got["root"].step == r.id
    assert got["a"].parent == r.id and got["a1"].parent == a.id
    assert got["b"].parent == r.id
    assert {got[n].step for n in ("root", "a", "a1", "b")} == {r.id}
    assert got["root2"].step == r2.id != r.id
    for n in ("a", "a1", "b"):
        assert got["root"].start_ns <= got[n].start_ns <= got[n].end_ns \
            <= got["root"].end_ns


def test_begin_and_end_keep_the_callers_readings():
    tracing.enable()
    opened = tracing.begin("timed", 100)
    with tracing.span("inside") as inner:
        pass
    tracing.end(opened, 250)
    got = {s.name: s for s in tracing.collect().spans}
    assert (got["timed"].start_ns, got["timed"].end_ns) == (100, 250)
    assert got["inside"].parent == inner.parent == got["timed"].id


def test_two_threads_keep_their_own_stacks():
    tracing.enable()
    gate = threading.Barrier(2, timeout=WAIT)
    ids = {}

    def work(tag):
        with tracing.span(f"{tag}.root") as r:
            gate.wait()             # both roots open at once
            with tracing.span(f"{tag}.child"):
                gate.wait()
                tracing.count(f"host_sync.{tag}")
        ids[tag] = (r.id, threading.get_native_id())
    threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert not any(t.is_alive() for t in threads)
    got = tracing.collect()
    by = {s.name: s for s in got.spans}
    for tag in "xy":
        root, tid = ids[tag]
        assert by[f"{tag}.root"].parent == 0
        assert by[f"{tag}.child"].parent == root == by[f"{tag}.child"].step
        assert by[f"{tag}.child"].thread == tid
        assert got.counts[(f"host_sync.{tag}", root)] == 1


def test_counters_add_by_step():
    tracing.enable()
    tracing.count("host_sync.a")
    with tracing.span("step") as s:
        tracing.count("host_sync.a")
        with tracing.span("inner"):
            tracing.count("host_sync.a", 2)
        tracing.count("host_sync.b")
    got = tracing.collect()
    assert got.counts == {("host_sync.a", 0): 1, ("host_sync.a", s.id): 3,
                          ("host_sync.b", s.id): 1}
    assert _totals(got) == {"host_sync.a": 4, "host_sync.b": 1}


def test_collect_clears_and_enable_starts_empty():
    tracing.enable()
    with tracing.span("a"):
        tracing.count("c")
    assert len(tracing.collect().spans) == 1
    got = tracing.collect()
    assert got.spans == [] and got.counts == {}
    with tracing.span("b"):
        pass
    tracing.enable()
    assert tracing.collect().spans == []


def _serve(traced: bool):
    ctrl, _ = build("torch", weak_known={0, 1})
    if traced:
        tracing.enable()
    rng = np.random.default_rng(0)
    stream = [(int(s), int(x)) for s, x in zip(rng.integers(0, 6, 24),
                                               rng.integers(0, 8, 24))]
    outs = serve_stream(ctrl, stream, 4)
    return ctrl, outs


def test_registry_reads_the_same_with_the_tracer_on():
    off, off_outs = _serve(False)
    on, on_outs = _serve(True)
    got = tracing.collect()
    assert got.spans
    snap_off = off.metrics()["registry"]
    snap_on = on.metrics()["registry"]
    assert list(snap_on) == list(snap_off)
    for name, v in snap_off.items():
        if isinstance(v, dict):             # a histogram's summary
            assert snap_on[name].keys() == v.keys()
            assert snap_on[name]["count"] == v["count"]
        else:
            assert snap_on[name] == v, name
    assert [(o.response, o.case) for o in on_outs] == \
        [(o.response, o.case) for o in off_outs]


def test_a_controller_step_has_its_phases_under_one_root():
    _serve(True)
    got = tracing.collect()
    roots = {s.id: s for s in got.spans if s.parent == 0}
    assert {s.name for s in roots.values()} == {"pipeline.step"}
    assert len(roots) == 6
    phases = {"pipeline.embed", "pipeline.read", "pipeline.partition",
              "pipeline.strong", "pipeline.weak", "pipeline.shadow"}
    for rid in roots:
        kids = [s for s in got.spans if s.parent == rid]
        assert {s.name for s in kids} == phases
        assert all(s.step == rid for s in got.spans if s.parent == rid)
    drains = [s for s in got.spans if s.name == "shadow.drain"]
    assert drains and {by.name for by in got.spans
                       if by.id in {d.parent for d in drains}} == \
        {"pipeline.shadow"}
    reads = _totals(got)["host_sync.memory_read"]
    assert reads >= 6                  # one a step, one a guide probe


@pytest.mark.parametrize("dispatch", ["scatter", "dense"])
def test_an_engine_call_nests_the_moe_phases(dispatch):
    import dataclasses
    cfg = dataclasses.replace(configs.get_smoke("olmoe-1b-7b"),
                              moe_dispatch=dispatch)
    eng = ServingEngine(cfg, init_params(cfg, seed=0, device="cpu"))
    prompts = [np.arange(5, dtype=np.int32) + i for i in range(3)] + \
        [np.arange(7, dtype=np.int32)]
    off = eng.generate_bucketed(prompts, 2)
    tracing.enable()
    on = eng.generate_bucketed(prompts, 2)
    got = tracing.collect()
    np.testing.assert_array_equal(on, off)
    calls = [s for s in got.spans if s.name == "engine.call"]
    fetches = [s for s in got.spans if s.name == "engine.fetch"]
    assert len(calls) == len(fetches) == 2          # one a length group
    assert all(s.parent == 0 for s in calls + fetches)
    ids = {s.id for s in calls}
    moe = [s for s in got.spans if s.name.startswith("moe.")]
    # prefill and one decode step, two layers, four phases each
    assert len(moe) == 2 * 2 * 2 * 4
    assert {s.name for s in moe} == {"moe.route", "moe.dispatch",
                                     "moe.experts", "moe.combine"}
    assert all(s.parent in ids for s in moe)
    c = _totals(got)
    assert c["host_sync.engine"] == c["host_sync.engine_upload"] == 2
    assert c["host_sync.model"] == 2 * 2


def test_moe_output_is_the_same_traced():
    cfg = configs.get_smoke("olmoe-1b-7b")
    params = init_params(cfg, seed=1, device="cpu")["layers"]
    lp = {k: v[0] for k, v in params["moe"].items()}
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, cfg.d_model, generator=gen)
    off = L.moe(lp, x, experts_per_token=2, capacity_factor=8.0)
    tracing.enable()
    on = L.moe(lp, x, experts_per_token=2, capacity_factor=8.0)
    assert [s.name for s in tracing.collect().spans] == [
        "moe.route", "moe.dispatch", "moe.experts", "moe.combine"]
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
