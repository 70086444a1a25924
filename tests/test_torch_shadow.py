"""The port's shadow queue against the JAX package's: the twin of
``tests/test_shadow.py``. Its sharded-store stress case is a reference
fault (JAX's ``ShardedMemory`` raises under JAX 0.9); the port's twin runs
the same invariants on the port's ``ShardedMemory``.

Each case runs the JAX controller and the port's (on the CPU) over the same
stream with the same rule-based FakeTier tiers. The equivalence chain
sequential == microbatch B=1 == deferred flush-every-1 == async with a
barrier after every batch holds port against JAX: Outcome streams, store
fields, FM calls and counters exact. Every wait in an async case passes a
timeout, so a hang fails the case instead of eating the suite's time.
"""
import time

import numpy as np
import pytest
from _hyp import given, settings, strategies as st
from test_pipeline import SCENARIOS, make_stream
from test_rar_controller import FakeTier, greq, make_cfg, prompt, skill_emb
from test_torch_pipeline import _fake_tiers, _plain, _port_cfg, _same_store

from repro.core import memory as jmem
from repro.core.decisions import coalesce_shadow_items as jcoalesce
from repro.core.pipeline import MicrobatchRAR as JMicro
from repro.core.rar import RAR as JRAR
from repro_torch.core import ShardedMemory
from repro_torch.core import memory as tmem
from repro_torch.core.decisions import coalesce_shadow_items as tcoalesce
from repro_torch.core.pipeline import MicrobatchRAR as TMicro
from repro_torch.core.rar import RARConfig as TConfig
from repro_torch.core.shadow import PENDING, ShadowQueue
from repro_torch.serving.faults import FaultPlan

WAIT = 60.0                     # seconds any async barrier may take


def build(pkg, cls=None, weak_known=(), weak_follows_guides=True,
          fault_plan=None, **cfg_kw):
    """A controller of ``pkg`` ("jax" or "torch") over fresh FakeTiers;
    returns it and the holder its ``embed_fn`` reads."""
    jcfg = make_cfg(**cfg_kw)
    holder = {}
    tiers = _fake_tiers(weak_known, weak_follows_guides)
    if pkg == "jax":
        cls = cls or JMicro
        return cls(*tiers, lambda p: holder["emb"], lambda e, k: False, jcfg,
                   fault_plan=fault_plan), holder
    cls = cls or TMicro
    return cls(*tiers, lambda p: holder["emb"], lambda e, k: False,
               _port_cfg(jcfg), fault_plan=fault_plan, device="cpu"), holder


def serve_stream(ctrl, stream, batch, flush_each=False):
    outs = []
    for start in range(0, len(stream), batch):
        chunk = stream[start:start + batch]
        outs += ctrl.process_batch(
            [prompt(s, x) for s, x in chunk], [greq(s) for s, _ in chunk],
            keys=chunk, embs=np.stack([skill_emb(s) for s, _ in chunk]))
        if flush_each:
            ctrl.flush_shadow(timeout=WAIT)
    ctrl.flush_shadow(timeout=WAIT)
    return outs


def serve_sequential(ctrl, holder, stream):
    outs = []
    for s, x in stream:
        holder["emb"] = skill_emb(s)
        outs.append(ctrl.process(prompt(s, x), greq(s), key=(s, x)))
    return outs


def assert_same(j, jouts, t, touts):
    """Port == JAX: Outcome stream, store, clock, FM calls, RQ2 counters."""
    assert _plain(touts) == _plain(jouts)
    _same_store(j.memory, t.memory)
    assert (t.now, t.guides_from_memory, t.guides_generated) == \
        (j.now, j.guides_from_memory, j.guides_generated)
    assert t.weak.engine.calls == j.weak.engine.calls
    assert t.strong.engine.calls == j.strong.engine.calls
    assert t.memory_occupancy == j.memory_occupancy


def _split(kw):
    kw = dict(kw)
    tiers = {k: kw.pop(k) for k in ("weak_known", "weak_follows_guides")
             if k in kw}
    return tiers, kw


# ---------------------------------------------------------------------------
# The equivalence chain, port against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", SCENARIOS)
@pytest.mark.parametrize("batch", [1, 4])
def test_deferred_flush_every_batch_matches_jax_inline(kw, batch):
    """test_shadow.py::test_deferred_flush_every_batch_identical_to_inline:
    the port's deferred/1 against JAX's inline."""
    tiers, kw = _split(kw)
    stream = make_stream()
    j, _ = build("jax", **tiers, **kw)
    t, _ = build("torch", shadow_mode="deferred", shadow_flush_every=1,
                 **tiers, **kw)
    assert_same(j, serve_stream(j, stream, batch),
                t, serve_stream(t, stream, batch))


@pytest.mark.parametrize("kw", SCENARIOS[:3])
def test_deferred_batch1_matches_jax_sequential(kw):
    """test_shadow.py::test_deferred_batch1_identical_to_sequential."""
    tiers, kw = _split(kw)
    stream = make_stream()
    j, holder = build("jax", cls=JRAR, **tiers, **kw)
    jouts = serve_sequential(j, holder, stream)
    t, _ = build("torch", shadow_mode="deferred", shadow_flush_every=1,
                 **tiers, **kw)
    assert_same(j, jouts, t, serve_stream(t, stream, 1))


@pytest.mark.parametrize("kw", SCENARIOS[:4])
def test_async_with_per_batch_barrier_matches_jax(kw):
    """test_shadow.py::test_async_with_per_batch_barrier_identical_to_inline:
    the drainer thread, held to the inline schedule by a barrier after
    every batch, against JAX's async run under the same barriers and
    against JAX's inline run."""
    tiers, kw = _split(kw)
    stream = make_stream()
    j_inline, _ = build("jax", **tiers, **kw)
    j, _ = build("jax", shadow_mode="async", shadow_flush_every=1,
                 **tiers, **kw)
    t, _ = build("torch", shadow_mode="async", shadow_flush_every=1,
                 **tiers, **kw)
    jouts = serve_stream(j, stream, 4, flush_each=True)
    touts = serve_stream(t, stream, 4, flush_each=True)
    j.close_shadow()
    t.close_shadow(timeout=WAIT)
    assert t.shadow._worker is None and t.shadow.drains > 0
    assert_same(j, jouts, t, touts)
    assert_same(j_inline, serve_stream(j_inline, stream, 4), t, touts)


def run_mini_experiment(pkg, shadow_mode, flush_every=1, n_stages=3,
                        n_skills=10, batch=4, seed=7, **kw):
    """test_shadow.py's fig4-shaped run: stages over one shuffled pool,
    memory kept, per-stage (strong calls, aligned) after a barrier."""
    ctrl, _ = build(pkg, shadow_mode=shadow_mode,
                    shadow_flush_every=flush_every, **kw)
    rng = np.random.default_rng(seed)
    pool = [(s, int(rng.integers(0, 8))) for s in range(n_skills)]
    order = rng.permutation(len(pool))
    per_stage, all_outs = [], []
    for _ in range(n_stages):
        stream = [pool[i] for i in order]
        outs = serve_stream(ctrl, stream, batch)
        per_stage.append((sum(o.strong_calls for o in outs),
                          sum(o.response == (s + x) % 4
                              for o, (s, x) in zip(outs, stream))))
        all_outs += outs
    ctrl.close_shadow()
    return ctrl, all_outs, per_stage


@pytest.mark.parametrize("mode", ["deferred", "async"])
def test_fig4_mini_suite_matches_jax(mode):
    """test_shadow.py::test_fig4_mini_suite_deferred_identical_to_inline,
    per-stage tallies included: the port's deferred/1 against JAX's
    inline. The port's async at flush-every-2 with a barrier at each stage
    end only is an unbarriered run, held to the queue's invariants."""
    kw = dict(weak_known={0, 1})
    j, jouts, jstages = run_mini_experiment("jax", "inline", **kw)
    if mode == "deferred":
        t, touts, tstages = run_mini_experiment("torch", "deferred", **kw)
        assert_same(j, jouts, t, touts)
        assert tstages == jstages
        assert jstages[-1][0] <= jstages[0][0]
    else:
        t, touts, _ = run_mini_experiment("torch", "async", flush_every=2,
                                          **kw)
        q = t.shadow
        assert q.items_enqueued == q.items_drained
        assert all(o.case != PENDING for o in touts)
        assert q.buffer.entries_applied == t.memory.ptr


def test_fig7_mini_suite_guide_counters_match_jax():
    """test_shadow.py::test_fig7_mini_suite_guide_counters_identical."""
    kw = dict(weak_known=set())
    j, jouts, _ = run_mini_experiment("jax", "inline", n_stages=2, **kw)
    t, touts, _ = run_mini_experiment("torch", "deferred", n_stages=2, **kw)
    assert_same(j, jouts, t, touts)
    assert t.guides_generated > 0
    assert all(o.case == "memory_guide" for o in touts[len(touts) // 2:])


def test_deferred_staleness_and_flush_barrier():
    """test_shadow.py::test_deferred_staleness_and_flush_barrier, the
    port's outcomes beside JAX's at each step."""
    runs = {}
    for pkg in ("jax", "torch"):
        ctrl, _ = build(pkg, weak_known={3}, shadow_mode="deferred",
                        shadow_flush_every=0)
        one = lambda x: ctrl.process_batch(   # noqa: E731
            [prompt(3, x)], [greq(3)], embs=skill_emb(3)[None])[0]
        out1, out2 = one(1), one(2)
        assert out1.case == PENDING and out2.case == PENDING
        assert ctrl.shadow.buffer.epoch == 0 and ctrl.memory.size_fast == 0
        ctrl.flush_shadow()
        assert ctrl.shadow.buffer.epoch == 1
        assert int(ctrl.memory.size_fast) == 2
        out3 = one(3)
        assert out3.case == "memory_skill" and out3.strong_calls == 0
        runs[pkg] = (ctrl, [out1, out2, out3])
    assert_same(*runs["jax"], *runs["torch"])


def test_occupancy_counter_matches_store():
    """test_shadow.py::test_occupancy_counter_matches_store."""
    cap = 8
    for pkg in ("jax", "torch"):
        ctrl, _ = build(pkg, weak_known=set(), shadow_mode="deferred",
                        shadow_flush_every=2,
                        memory=jmem.MemoryConfig(capacity=cap, embed_dim=16,
                                                 guide_len=8))
        for rep in range(3):
            for s in range(0, 12, 2):
                serve_stream(ctrl, [(s, rep), (s + 1, rep)], 2)
        assert ctrl.memory_occupancy == int(ctrl.memory.size_fast) == cap


def test_shadow_config_validation():
    """test_shadow.py::test_shadow_config_validation."""
    with pytest.raises(ValueError):
        TConfig(shadow_mode="background")
    with pytest.raises(ValueError):
        TConfig(shadow_mode="deferred", shadow_flush_every=-1)
    with pytest.raises(ValueError):
        TConfig(shadow_mode="inline", shadow_flush_every=4)
    with pytest.raises(ValueError):
        ShadowQueue(runner=lambda items: None, mode="nope")
    for mode in ("async", "adaptive"):
        assert TConfig(shadow_mode=mode).shadow_mode == mode


# ---------------------------------------------------------------------------
# Failures: surfaced at the barrier, never lossy
# ---------------------------------------------------------------------------


def test_async_drainer_error_surfaces_at_barrier():
    """test_shadow.py::test_async_drainer_error_surfaces_at_barrier."""
    ctrl, _ = build("torch", weak_known=set(), shadow_mode="async",
                    shadow_flush_every=1)

    def boom(items):
        raise RuntimeError("drain failed")

    real_runner = ctrl.shadow.runner
    ctrl.shadow.runner = boom
    out = ctrl.process_batch([prompt(2, 1)], [greq(2)],
                             embs=skill_emb(2)[None])[0]
    with pytest.raises(RuntimeError, match="shadow drainer failed"):
        ctrl.flush_shadow(timeout=WAIT)
    assert out.case == PENDING
    assert ctrl.shadow.items_requeued == 1
    assert ctrl.shadow.items_drained == 0
    ctrl.shadow.runner = real_runner
    ctrl.flush_shadow(timeout=WAIT)
    assert out.case != PENDING
    assert ctrl.shadow.items_enqueued == ctrl.shadow.items_drained == 1
    ctrl.close_shadow(timeout=WAIT)


@pytest.mark.parametrize("mode", ["inline", "deferred", "async",
                                  "adaptive"])
def test_injected_drain_fault_does_not_lose_items(mode):
    """test_shadow.py::test_injected_drain_fault_does_not_lose_items, with
    the port's FaultPlan, and the run's end state against JAX's."""
    runs = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            from repro.serving.faults import FaultPlan as JPlan
            plan = JPlan([JPlan.drain_error(at=1)])
        else:
            plan = FaultPlan([FaultPlan.drain_error(at=1)])
        ctrl, _ = build(pkg, weak_known=set(), shadow_mode=mode,
                        shadow_flush_every=1, fault_plan=plan)
        with pytest.raises(RuntimeError):
            ctrl.process_batch([prompt(2, 1)], [greq(2)],
                               embs=skill_emb(2)[None])
            ctrl.flush_shadow(timeout=WAIT)
        assert [it.seq for it in ctrl.shadow._items] == [1]
        out = ctrl.shadow._items[0].outcome
        assert out.case == PENDING
        assert ctrl.shadow.items_requeued == 1
        assert ctrl.shadow.items_drained == 0
        assert ctrl.shadow.drain_failures == 1
        assert ctrl.shadow.buffer.pending == 0
        ctrl.flush_shadow(timeout=WAIT)
        assert out.case == "case2" and out.guide_source == "fresh"
        assert ctrl.shadow.items_enqueued == ctrl.shadow.items_drained == 1
        assert not ctrl.shadow._items
        assert int(ctrl.memory.size_fast) == 1
        assert ctrl.guides_generated == 1
        ctrl.close_shadow()
        runs[pkg] = (ctrl, [out])
    assert_same(*runs["jax"], *runs["torch"])


def test_requeued_epoch_retries_ahead_of_new_items():
    """test_shadow.py::test_requeued_epoch_retries_ahead_of_new_items."""
    drained: list[int] = []

    class Flaky:
        fail = True

        def __call__(self, items):
            if self.fail:
                self.fail = False
                raise RuntimeError("transient")
            drained.extend(it.seq for it in items)

    q = ShadowQueue(Flaky(), mode="deferred", flush_every=0)
    mk = lambda seq: type("It", (), {"seq": seq, "now": seq})()  # noqa
    q.submit([mk(1), mk(2)])
    with pytest.raises(RuntimeError):
        q.flush()
    q.submit([mk(3)])
    q.flush()
    assert drained == [1, 2, 3]
    assert q.items_enqueued == q.items_drained == 3
    assert q.items_requeued == 2 and q.drain_failures == 1


# ---------------------------------------------------------------------------
# Commit buffer, port against JAX
# ---------------------------------------------------------------------------


def _unit(rng, d=8):
    v = rng.normal(size=d).astype(np.float32)
    return v / np.linalg.norm(v)


def _stage(buf, op):
    if op[0] == "add":
        buf.stage_add(*op[1])
    elif op[0] == "soft":
        buf.stage_soft_clear(op[1], op[2])
    else:
        buf.stage_touch(op[1], op[2])


FIELDS = ("emb", "mask", "guide", "hard", "added_at", "ptr")


def _fields(s):
    return [np.asarray(getattr(s, f)) if not hasattr(getattr(s, f), "cpu")
            else getattr(s, f).cpu().numpy() for f in FIELDS]


@settings(max_examples=15, deadline=None)
@given(st.integers(0, 10_000), st.sampled_from([4, 8, 16]),
       st.sampled_from([1, 2, 5]), st.integers(8, 30))
def test_property_commit_buffer_matches_jax(seed, cap, cadence, n_ops):
    """test_shadow.py::test_property_commit_buffer_atomic_and_order_
    independent: random stage/drain interleavings over ring sizes and
    cadences; every epoch boundary, the port's in-place store (staged ops
    applied in a permuted order) equals JAX's functional one, and staged
    ops change nothing before their apply."""
    rng = np.random.default_rng(seed)
    jcfg = jmem.MemoryConfig(capacity=cap, embed_dim=8, guide_len=4)
    j, jbuf = jmem.init_memory(jcfg), jmem.CommitBuffer()
    t = tmem.init_memory(tmem.MemoryConfig(capacity=cap, embed_dim=8,
                                           guide_len=4), device="cpu")
    tbuf = tmem.CommitBuffer()
    staged, now = [], 0

    def drain():
        nonlocal j, t, staged
        for op in staged:
            _stage(jbuf, op)
        for k in rng.permutation(len(staged)):
            _stage(tbuf, staged[int(k)])
        j, nj = jbuf.apply(j)
        before = _fields(t)
        t, nt = tbuf.apply(t)
        assert nj == nt and jbuf.epoch == tbuf.epoch
        for a, b, name in zip(_fields(j), _fields(t), FIELDS):
            np.testing.assert_array_equal(a, b, name)
        staged = []
        return before

    for i in range(n_ops):
        now += 1
        r = rng.random()
        if r < 0.55:
            staged.append(("add", (_unit(rng),
                                   rng.integers(0, 50, 4).astype(np.int32),
                                   bool(rng.random() < 0.5),
                                   bool(rng.random() < 0.3), now)))
        elif r < 0.7:
            staged.append(("soft", int(rng.integers(0, cap)), now))
        else:
            staged.append(("touch", int(rng.integers(0, cap)), now))
        if (i + 1) % cadence == 0:
            drain()
    if staged:
        drain()
    assert tbuf.entries_applied == t.ptr


def test_commit_buffer_drops_flag_update_across_epochs():
    """test_shadow.py::test_commit_buffer_drops_flag_update_across_epochs."""
    cfg = tmem.MemoryConfig(capacity=2, embed_dim=8, guide_len=4)
    rng = np.random.default_rng(0)
    state = tmem.init_memory(cfg, device="cpu")
    for now in (1, 2):
        state = tmem.add(state, _unit(rng), np.zeros(4, np.int32),
                         np.asarray(False), np.asarray(True), np.int32(now))
    snap = state.ptr
    buf = tmem.CommitBuffer()
    for now in (3, 4):
        buf.stage_add(_unit(rng), np.zeros(4, np.int32), False, True, now)
    state, _ = buf.apply(state)
    assert bool(state.hard[0])
    buf.stage_soft_clear(0, 5, ptr_snapshot=snap)
    buf.stage_touch(0, 5, ptr_snapshot=snap)
    state, _ = buf.apply(state)
    assert bool(state.hard[0])
    assert int(state.added_at[0]) == 3
    buf.stage_soft_clear(0, 6, ptr_snapshot=state.ptr)
    state, _ = buf.apply(state)
    assert not bool(state.hard[0])


# ---------------------------------------------------------------------------
# Dedup coalescing
# ---------------------------------------------------------------------------


def test_dedup_coalesces_duplicate_skills_in_one_drain():
    """test_shadow.py::test_dedup_coalesces_duplicate_skills_in_one_drain,
    with the port's counters beside JAX's."""
    runs = {}
    for pkg in ("jax", "torch"):
        ctrl, _ = build(pkg, weak_known=set(), shadow_mode="deferred",
                        shadow_flush_every=0, shadow_dedup_sim=0.99)
        outs = []
        for x in (1, 2, 3):
            outs += ctrl.process_batch([prompt(4, x)], [greq(4)],
                                       embs=skill_emb(4)[None])
        weak0, strong0 = ctrl.weak.engine.calls, ctrl.strong.engine.calls
        ctrl.flush_shadow()
        assert ctrl.weak.engine.calls - weak0 == 2
        assert ctrl.strong.engine.calls - strong0 == 1
        assert int(ctrl.memory.size_fast) == 1
        q = ctrl.shadow
        assert (q.items_coalesced, q.reclaimed_strong_calls,
                q.reclaimed_weak_calls) == (2, 2, 4)
        ctrl.close_shadow()
        runs[pkg] = (ctrl, outs)
    assert_same(*runs["jax"], *runs["torch"])


def test_dedup_followers_resolve_like_leader_distinct_skills_split():
    """test_shadow.py::test_dedup_followers_resolve_like_leader_..."""
    runs = {}
    for pkg in ("jax", "torch"):
        ctrl, _ = build(pkg, weak_known={3}, shadow_mode="deferred",
                        shadow_flush_every=0, shadow_dedup_sim=0.99)
        outs = []
        for s, x in ((3, 1), (3, 2), (7, 1)):
            outs += ctrl.process_batch([prompt(s, x)], [greq(s)],
                                       embs=skill_emb(s)[None])
        ctrl.flush_shadow()
        assert [o.case for o in outs] == ["case1", "case1", "case2"]
        assert [o.strong_calls for o in outs] == [1, 1, 2]
        assert int(ctrl.memory.size_fast) == 2
        assert ctrl.shadow.items_coalesced == 1
        ctrl.close_shadow()
        runs[pkg] = (ctrl, outs)
    assert_same(*runs["jax"], *runs["torch"])


def test_dedup_off_is_default_and_validated():
    assert TConfig().shadow_dedup_sim is None
    with pytest.raises(ValueError):
        TConfig(shadow_dedup_sim=0.0)
    with pytest.raises(ValueError):
        TConfig(shadow_dedup_sim=1.5)


@settings(max_examples=25, deadline=None)
@given(st.integers(0, 10_000), st.integers(1, 24),
       st.sampled_from([0.5, 0.9, 0.999]))
def test_property_coalesce_groups_match_jax(seed, n, thresh):
    """test_shadow.py::test_property_coalesce_groups_partition_and_cohere:
    the port's groups are JAX's, and partition the items."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(4, 16)).astype(np.float32)
    embs = []
    for _ in range(n):
        v = centers[rng.integers(0, 4)] + \
            0.01 * rng.normal(size=16).astype(np.float32)
        embs.append(v / np.linalg.norm(v))
    embs = np.stack(embs).astype(np.float32)
    groups = tcoalesce(embs, thresh)
    assert groups == jcoalesce(embs, thresh)
    assert sorted(j for g in groups for j in g) == list(range(n))
    leaders = [g[0] for g in groups]
    assert leaders == sorted(leaders)


# ---------------------------------------------------------------------------
# Async stress (single and sharded store)
# ---------------------------------------------------------------------------


def _stress(sharded: bool = False, drain_delay: float = 0.002):
    """test_shadow.py::_stress (1.2 s, and at least 40 batches): the
    drainer under injected drain delays and ring wraparound. Every item
    drains exactly once in seq order, every Outcome resolves, and the ring
    pointer advanced once per applied entry. Returns the controller and
    its Outcomes."""
    cap, flush_every = 8, 2
    weak = FakeTier(known={0, 1}, name="weak")
    strong = FakeTier(known=range(10_000), can_guide=True, name="strong")
    cfg = _port_cfg(make_cfg(shadow_mode="async",
                             shadow_flush_every=flush_every,
                             memory=jmem.MemoryConfig(capacity=cap,
                                                      embed_dim=16,
                                                      guide_len=8)))
    memory = (ShardedMemory(cfg.memory, shards=4, device="cpu") if sharded
              else None)
    ctrl = TMicro(weak, strong, lambda p: None, lambda e, k: False, cfg,
                  memory=memory, device="cpu")
    ctrl.shadow.drain_delay = drain_delay
    drained: list[int] = []
    orig = ctrl._drain_shadow

    def traced(items):
        drained.extend(it.seq for it in items)
        orig(items)

    ctrl.shadow.runner = traced
    rng = np.random.default_rng(0)
    outs, t_end, batches = [], time.time() + 1.2, 0
    while time.time() < t_end or batches < 40:
        batches += 1
        chunk = [(int(rng.integers(0, 12)), int(rng.integers(0, 8)))
                 for _ in range(int(rng.integers(1, 5)))]
        outs += ctrl.process_batch(
            [prompt(s, x) for s, x in chunk], [greq(s) for s, _ in chunk],
            embs=np.stack([skill_emb(s) for s, _ in chunk]))
    ctrl.flush_shadow(timeout=WAIT)
    ctrl.close_shadow(timeout=WAIT)
    q = ctrl.shadow
    assert q.items_enqueued == q.items_drained == len(drained)
    assert drained == list(range(1, len(drained) + 1))
    assert all(o.case != PENDING for o in outs)
    assert q.buffer.entries_applied == ctrl.memory.ptr
    assert ctrl.memory_occupancy == ctrl.memory.size_fast
    assert ctrl.memory.ptr > cap
    assert q.drains >= 1
    return ctrl, outs


def test_async_stress_single_store():
    """test_shadow.py::test_async_stress_single_store."""
    _stress()


def test_async_stress_sharded_store():
    """test_shadow.py::test_async_stress_sharded_store on the port's
    ShardedMemory (4 shards of 2 rows): the same invariants, and every
    slot of the wrapped ring valid in ``to_single_device``."""
    ctrl, outs = _stress(sharded=True, drain_delay=0.005)
    assert isinstance(ctrl.memory, ShardedMemory) and outs
    assert int(ctrl.memory.to_single_device().valid.sum()) == 8
