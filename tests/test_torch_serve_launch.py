"""The port's serving launcher (``repro_torch.launch.serve``) against the
JAX package's ``run_rar_experiment``, on the CPU.

``build_system`` is replaced by the JAX-trained system bridged into the
port (as ``tests/test_torch_system.py`` gets it), so the launcher serves
the weights JAX serves. Its per-stage strong calls and aligned answers
must equal JAX's ``run_rar_experiment`` with the same flags: inline, and
async at ``--shadow-flush-every 1`` with a barrier after every batch on
both sides (an unbarriered async run is not deterministic). A journaled
run restarts to the same store and manifest, and the fabric options
(serve replicas, the process transport, open-loop arrivals) serve every
request.
"""
import copy
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
from test_torch_fabric import check_fabric_run, record_tickets

from repro.configs.rar_system import make_rar_config as jmake_cfg
from repro.experiments import setup as jsetup
from repro.experiments import stages as jstages
from repro_torch import bridge
from repro_torch.core import memory as mem
from repro_torch.experiments import setup as tsetup
from repro_torch.experiments import stages as tstages
from repro_torch.launch import serve

pytestmark = pytest.mark.slow

ARGS = ["--device", "cpu", "--requests", "40", "--stages", "2",
        "--microbatch", "8", "--log-every", "0"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture()
def launch(system, monkeypatch):
    """``serve.main`` on the bridged system."""
    monkeypatch.setattr(serve, "build_system", lambda device: system)
    return serve.main


def _barrier_each_batch(module, monkeypatch):
    """Make ``module.MicrobatchRAR`` flush after every batch: the async
    drainer then runs the inline schedule."""
    base = module.MicrobatchRAR

    class Barriered(base):
        def process_batch(self, *a, **kw):
            outs = super().process_batch(*a, **kw)
            self.flush_shadow(timeout=60)
            return outs

    monkeypatch.setattr(module, "MicrobatchRAR", Barriered)


def _copy_store(st):
    return mem.MemoryState(**{f: getattr(st, f).clone() for f in
                              ("emb", "mask", "guide", "hard", "added_at")},
                           ptr=st.ptr)


def _rows(results):
    return [(r.strong_calls, r.aligned) for r in results]


@pytest.mark.parametrize("mode", ["inline", "async"])
def test_launcher_matches_jax_experiment(launch, jsys, mode, monkeypatch):
    extra = ["--shadow-mode", mode, "--shadow-flush-every", "1"]
    if mode == "async":
        _barrier_each_batch(tstages, monkeypatch)
        _barrier_each_batch(jstages, monkeypatch)
    results, rar = launch(ARGS + extra)
    pool = jsetup.failing_pool(jsys, 0, n=40)
    cfg = jmake_cfg(sim_threshold=0.2, shadow_mode=mode,
                    shadow_flush_every=1, reprobe_period=2 * len(pool))
    want, jrar = jstages.run_rar_experiment(jsys, pool, n_stages=2,
                                            rar_cfg=cfg, microbatch=8)
    jrar.close_shadow()
    assert _rows(results) == _rows(want)
    assert [dataclasses.astuple(r) for r in results] == \
        [dataclasses.astuple(r) for r in want]
    assert rar.shadow.mode == mode and rar.shadow._worker is None


def test_journaled_launcher_restarts_to_the_same_store(launch, tmp_path,
                                                      monkeypatch):
    """Run, then run again on the same journal: the restart's controller
    starts from the first run's final store, field for field, and from the
    last manifest the first run journaled; the metrics JSON closes with
    every item drained."""
    started = []

    class Recorded(tstages.MicrobatchRAR):
        """Keeps the store and manifest it starts from, and every manifest
        its commit stream journals."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            started.append((_copy_store(self.memory), self._manifest_state()))
            self.journaled, provider = [], self.commit_stream.state_provider

            def journal_manifest():
                man = provider()
                self.journaled.append(copy.deepcopy(man))
                return man
            self.commit_stream.state_provider = journal_manifest

    monkeypatch.setattr(tstages, "MicrobatchRAR", Recorded)
    path, mjson = str(tmp_path / "journal"), str(tmp_path / "m.json")
    prom = str(tmp_path / "m.prom")
    args = ARGS + ["--shadow-mode", "async", "--shadow-flush-every", "2",
                   "--journal-path", path, "--snapshot-every", "3",
                   "--metrics-json", mjson, "--metrics-prom", prom,
                   "--metrics-every", "16"]
    first, rar = launch(args)
    met = json.load(open(mjson))
    reg = met["registry"]
    assert reg["shadow/items_enqueued"] == reg["shadow/items_drained"] > 0
    assert open(prom).read().endswith("# EOF\n")
    state, epoch, applied, man = mem.MemoryJournal.recover(
        path, rar.cfg.memory, device="cpu")
    for f in ("emb", "mask", "guide", "hard", "added_at"):
        assert torch.equal(getattr(state, f), getattr(rar.memory, f)), f
    assert (state.ptr, epoch) == (rar.memory.ptr,
                                  rar.commit_stream.buffer.epoch)
    assert rar.journaled and man == rar.journaled[-1]
    again, rar2 = launch(args)
    assert len(started) == 2
    store, man2 = started[1]
    for f in ("emb", "mask", "guide", "hard", "added_at"):
        assert torch.equal(getattr(store, f), getattr(rar.memory, f)), f
    assert store.ptr == rar.memory.ptr
    assert man2 == rar.journaled[-1]
    assert again[0].strong_calls <= first[-1].strong_calls


@pytest.mark.parametrize("flag", [["--replicas", "2"],
                                  ["--replicas", "2", "--transport",
                                   "process"],
                                  ["--replicas", "2", "--arrival-pattern",
                                   "poisson"]])
def test_fabric_options_raise(launch, flag, monkeypatch, tmp_path):
    """The fabric options no longer raise: ``--replicas 2`` (the thread
    fabric), with ``--transport process`` and with ``--arrival-pattern
    poisson`` serve every request once a stage, the stage totals are the
    tickets' sums, the ring pointer is at the entries applied, and (open
    loop) the metrics JSON carries the scheduler's entries, one
    queueing-delay sample a request."""
    process, poisson = "process" in flag, "poisson" in flag
    tickets = record_tickets(monkeypatch)
    mjson = str(tmp_path / "m.json")
    results, rar = launch(ARGS + flag + ["--metrics-json", mjson])
    check_fabric_run(results, rar, tickets, 40, poisson)
    met = json.load(open(mjson))
    assert len(met["replicas"]) == (1 if process else 2)
    assert "replica0/shadow/items_enqueued" in met["registry"]
    if process:
        assert len(met["workers"]) == 2
    if poisson:
        assert met["registry"]["sched/admitted"] == 80


@pytest.mark.parametrize("flags", [
    ["--replicas", "0"],
    ["--transport", "process"],
    ["--replicas", "2", "--transport", "process", "--router", "learned"],
    ["--arrival-pattern", "poisson"],
    ["--replicas", "2", "--arrival-pattern", "bursty", "--arrival-rate", "0"],
    ["--replicas", "2", "--arrival-pattern", "poisson", "--slo-ms", "0"],
    ["--replicas", "2", "--arrival-pattern", "poisson", "--priorities",
     "0,x"],
    ["--replicas", "2", "--priorities", "0,1"],
    ["--replicas", "2", "--slo-ms", "5"],
    ["--shadow-mode", "async", "--microbatch", "1"]])
def test_launcher_rejects_what_jax_rejects(flags, monkeypatch):
    """The fabric flags' validation taken over from the JAX launcher
    (``src/repro/launch/serve.py:237-262``): each combination it refuses
    exits with a usage error before any system is built."""
    def no_build(device):
        raise AssertionError("the launcher built a system for bad flags")
    monkeypatch.setattr(serve, "build_system", no_build)
    with pytest.raises(SystemExit) as ei:
        serve.main(["--device", "cpu", "--log-every", "0"] + flags)
    assert ei.value.code == 2
