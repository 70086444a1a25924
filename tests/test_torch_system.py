"""The port's staged experiment against the JAX package's on the trained
RAR system (the twin of ``tests/test_system.py``, its async-shadow case
included).

The JAX system comes from ``repro.experiments.setup.build_system`` — the
cache ``tests/test_system.py`` uses (the first run trains it) — and is
bridged into the port on the CPU. On the same pool the port must give the
JAX package's failing pool, ``StageResult`` s and baselines exactly:
equal tallies, cases and guide counters. The paper's claims are then
asserted on the port's runs with the twin's thresholds. A last case
trains a tiny system with the port alone (a few steps of every part) to
cover ``build_system``'s training path and its cache.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_torch_fabric import FABRIC_MODES, check_fabric_run, record_tickets

from repro.experiments import setup as jsetup
from repro.experiments import stages as jstages
from repro_torch import bridge
from repro_torch.experiments import setup as tsetup
from repro_torch.experiments import stages as tstages

pytestmark = pytest.mark.slow

RUNS = {"seq": dict(),
        "mb16": dict(microbatch=16),
        "mb16_learned": dict(microbatch=16, router_kind="learned")}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's CPU training and serving: the
    suite runs in parallel workers, where more threads only contend, and a
    fixed count keeps the CPU reductions in one order on any host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(results):
    return [dataclasses.astuple(r) for r in results]


@pytest.fixture(scope="module")
def jsys():
    return jsetup.build_system(verbose=False)


@pytest.fixture(scope="module")
def system(jsys):
    blob = jax.tree.map(np.asarray, {
        "weak": jsys.weak.engine.params, "strong": jsys.strong.engine.params,
        "embedder": jsys.embedder_params, "router_w": jsys.router.w,
        "router_b": jsys.router.b})
    return tsetup.build_system(device="cpu", verbose=False,
                               params=bridge.system(blob, device="cpu"))


@pytest.fixture(scope="module")
def pool(jsys):
    return jsetup.failing_pool(jsys, domain=0, n=120)


@pytest.fixture(scope="module")
def runs(system, pool):
    """The port's experiments, (results, controller) by ``RUNS`` key."""
    return {k: tstages.run_rar_experiment(system, pool, n_stages=3, seed=0,
                                          device="cpu", **kw)
            for k, kw in RUNS.items()}


@pytest.fixture(scope="module")
def base(system, pool):
    return tstages.run_baselines(system, pool, n_stages=3)


# ---------------------------------------------------------------------------
# the port == the JAX package
# ---------------------------------------------------------------------------


def test_failing_pool_matches_jax(system, pool):
    assert tsetup.failing_pool(system, domain=0, n=120) == pool
    assert tsetup.POOL_SIZES == jsetup.POOL_SIZES
    assert tsetup.POOL_NAMES == jsetup.POOL_NAMES


@pytest.mark.parametrize("run", list(RUNS))
def test_rar_experiment_matches_jax(jsys, pool, runs, run):
    want, _ = jstages.run_rar_experiment(jsys, pool, n_stages=3, seed=0,
                                         **RUNS[run])
    assert _rows(runs[run][0]) == _rows(want)


def test_baselines_match_jax(jsys, pool, base):
    want = jstages.run_baselines(jsys, pool, n_stages=3)
    assert {k: _rows(v) for k, v in base.items()} == \
        {k: _rows(v) for k, v in want.items()}
    assert jstages.aggregate_shuffles([want["weak"], want["strong"]]) == \
        tstages.aggregate_shuffles([base["weak"], base["strong"]])


def test_unported_modes_refused(system, pool, monkeypatch):
    """No mode of ``run_rar_experiment`` is refused any more: each option
    runs on ``pool[:16]``, one stage at microbatch 8 (the shadow modes, a
    fault plan, ``metrics_every``, and the serving fabrics' modes: serve
    replicas, the process transport, open-loop arrivals), each fabric run
    held to what the JAX package's tests check of it."""
    from repro_torch.serving.faults import FaultPlan
    modes = {"fault_plan": dict(fault_plan=FaultPlan()),
             "metrics_every": dict(metrics_every=8),
             "async": dict(shadow_mode="async"),
             "adaptive": dict(shadow_mode="adaptive"), **FABRIC_MODES}
    for mode, kw in modes.items():
        tickets = record_tickets(monkeypatch)
        results, rar = tstages.run_rar_experiment(
            system, pool[:16], n_stages=1, microbatch=8, device="cpu", **kw)
        rar.close_shadow()
        assert len(results) == 1 and results[0].n == 16, mode
        if mode in FABRIC_MODES:
            check_fabric_run(results, rar, tickets, 16, mode == "poisson")
        monkeypatch.undo()


@pytest.mark.parametrize("kw", [
    dict(transport="carrier-pigeon"),
    dict(transport="process"),
    dict(replicas=2, transport="process", router_kind="learned"),
    dict(arrival_pattern="poisson"),
    dict(replicas=2, arrival_pattern="uniform"),
    dict(replicas=2, arrival_pattern="poisson", arrival_rate=0.0),
    dict(replicas=2, prepopulate="pool")])
def test_fabric_options_refused_as_jax_refuses(system, jsys, pool, kw):
    """``run_rar_experiment``'s fabric options refuse what the JAX
    package's refuse (``src/repro/experiments/stages.py:376-405``), with a
    ValueError, before serving anything."""
    kw = dict(kw)
    if kw.pop("prepopulate", None):
        kw["prepopulate_from"] = pool[:4]
    with pytest.raises(ValueError):
        jstages.run_rar_experiment(jsys, pool[:8], n_stages=1, **kw)
    with pytest.raises(ValueError):
        tstages.run_rar_experiment(system, pool[:8], n_stages=1,
                                   device="cpu", **kw)


# ---------------------------------------------------------------------------
# the paper's claims on the port's runs (the twin's thresholds)
# ---------------------------------------------------------------------------


def test_trained_capability_structure(system):
    """Weak fails unknown skills / strong solves everything / guides lift
    the weak FM — the premise the paper's method needs."""
    suite = system.suite
    rng = np.random.default_rng(0)

    def acc(tier, skills, guided=False, n=80):
        prompts, truth = [], []
        for _ in range(n):
            s = int(rng.choice(skills))
            d, x = suite.domain_of(s), int(rng.integers(0, 100))
            g = suite.guide(s) if guided else None
            prompts.append(np.asarray(suite.vocab.question(d, s, x, g),
                                      np.int32))
            truth.append(suite.answer(s, x))
        ans = tier.answer_batch(np.stack(prompts))
        return float((ans == np.asarray(truth)).mean())

    all_sk = np.arange(suite.cfg.total_skills)
    unknown = np.setdiff1d(all_sk, suite.weak_known)
    assert acc(system.strong, all_sk) > 0.9
    assert acc(system.weak, suite.weak_known) > 0.75
    assert acc(system.weak, unknown) < 0.55
    assert acc(system.weak, unknown, guided=True) > \
        acc(system.weak, unknown) + 0.25


def test_rar_reduces_strong_calls_over_stages(runs, pool):
    results, _ = runs["seq"]
    first, last = results[0], results[-1]
    assert last.strong_calls < 0.6 * first.strong_calls, \
        [r.strong_calls for r in results]
    assert last.strong_calls < 0.6 * len(pool)


def test_rar_quality_maintained(runs, pool):
    results, _ = runs["seq"]
    assert sum(r.aligned for r in results) / (3 * len(pool)) > 0.75


def test_rar_beats_weak_baselines(runs, base):
    results, _ = runs["seq"]
    rar_aligned = sum(r.aligned for r in results)
    assert rar_aligned > sum(r.aligned for r in base["weak"])
    assert rar_aligned > sum(r.aligned for r in base["weak_cot"])
    assert sum(r.strong_calls for r in results) < \
        sum(r.strong_calls for r in base["oracle_router"])


def test_guide_memory_populates(runs):
    _, rar = runs["seq"]
    valid = rar.memory.valid.cpu().numpy()
    assert valid.sum() > 0
    assert rar.memory.size_fast == valid.sum()
    assert rar.memory.has_guide.cpu().numpy()[valid].any()


def test_microbatched_experiment_preserves_claims(runs, pool):
    results_mb, rar = runs["mb16"]
    first, last = results_mb[0], results_mb[-1]
    assert last.strong_calls < 0.6 * first.strong_calls, \
        [r.strong_calls for r in results_mb]
    n = 3 * len(pool)
    mb_quality = sum(r.aligned for r in results_mb) / n
    seq_quality = sum(r.aligned for r in runs["seq"][0]) / n
    assert mb_quality > seq_quality - 0.1, (mb_quality, seq_quality)
    assert rar.memory.size_fast > 0


# ---------------------------------------------------------------------------
# the port trains and caches a system of its own
# ---------------------------------------------------------------------------


def test_build_system_trains_and_caches(tmp_path, monkeypatch):
    """A few steps of every part on the CPU: the training path, the
    router's profiling, the cache (the port's own format and directory)
    and a reload that gives the same system."""
    monkeypatch.setattr(tsetup, "CACHE_DIR", str(tmp_path))
    kw = dict(weak_steps=3, strong_steps=2, embedder_steps=2, batch_size=8,
              device="cpu", verbose=False)
    built = tsetup.build_system(**kw)
    assert set(built.train_stats) == {"weak", "strong", "embedder",
                                      "router"}
    assert built.train_stats["weak"]["steps"] == 3
    files = list(tmp_path.iterdir())
    assert [f.name for f in files] == ["sys_0_0.8_3_2_0.npz"]
    loaded = tsetup.build_system(**kw)
    assert loaded.train_stats == {}
    prompts = [np.asarray(built.suite.vocab.question(0, 1, x), np.int32)
               for x in range(4)]
    np.testing.assert_array_equal(built.embed_many(prompts),
                                  loaded.embed_many(prompts))
    np.testing.assert_array_equal(built.weak.answer_batch(np.stack(prompts)),
                                  loaded.weak.answer_batch(
                                      np.stack(prompts)))
    assert float(built.router.b) == float(loaded.router.b)


def test_async_shadow_experiment_preserves_claims(system, pool):
    """test_system.py::test_async_shadow_experiment_preserves_claims on the
    port: the drainer thread at flush-every 4 keeps the cross-stage
    collapse in strong calls and the quality, and the host occupancy
    counter agrees with the store."""
    results, rar = tstages.run_rar_experiment(
        system, pool, n_stages=3, seed=0, microbatch=16, shadow_mode="async",
        shadow_flush_every=4, device="cpu")
    rar.close_shadow(timeout=60)
    first, last = results[0], results[-1]
    assert last.strong_calls < 0.7 * first.strong_calls, \
        [r.strong_calls for r in results]
    assert sum(r.aligned for r in results) / (3 * len(pool)) > 0.7
    assert rar.memory_occupancy == rar.memory.size_fast > 0
