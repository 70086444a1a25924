"""The RAR cell driven end to end on the CPU at a small store: the plain
controller agrees with the measured one, and a run whose timed path is
broken underneath comes out not correct."""
import _bench_path  # noqa: F401
import numpy as np
import pytest
import torch
from _bench_cells import rar_cell, run_cell

from bench import controls
from bench.harness.checks import held, passed
from bench.reference.tasks import Universe

SEED = 2_147_483_659


def test_universe_renders_the_task_suite():
    from repro_torch.data.tasks import TaskSuite, TaskSuiteConfig
    cell = rar_cell()
    u = Universe(cell.config)
    suite = TaskSuite(TaskSuiteConfig(max_operand=8))
    assert len(u) == 3 * 53 * 8
    for q in (0, 7, 400, len(u) - 1):
        d, s, x = u.triples[q]
        assert s in suite.domain_skills[d]
        assert u.prompts[q].tolist() == suite.vocab.question(d, s, x)
        assert u.guide_requests[q].tolist() == suite.vocab.guide_request(d, s)


def test_reference_agrees_with_the_port():
    out = run_cell(rar_cell(), SEED, steps=3)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 48 and out["failed"] == 0
    assert set(out["metrics"]) == {"requests_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_traced_run_reads_the_layers():
    out = run_cell(rar_cell(), SEED + 1, steps=2, trace=1)
    assert out["correct"], out["checks"]
    for m in ("strong_calls_per_request.rar", "embed_ms.rar", "tier_ms.rar",
              "drain_ms.rar", "mfu.rar", "idle_share.rar"):
        assert m in out["metrics"]
    assert len(out["breakdown"]["device_ops"]) <= 10


def _alter_first_token(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.ServingEngine.generate_bucketed

    def altered(self, prompts, max_new):
        out = orig(self, prompts, max_new)
        out[0, 0] = (out[0, 0] + 1) % self.cfg.vocab_size
        return out
    monkeypatch.setattr(engine.ServingEngine, "generate_bucketed", altered)


def _drop_commits(monkeypatch):
    from repro_torch.core import memory
    monkeypatch.setattr(memory.CommitBuffer, "apply_ops",
                        lambda self, state, *ops: (state, 0))


def _serve_half(monkeypatch):
    from repro_torch.core import pipeline
    orig = pipeline.MicrobatchRAR.process_batch

    def half(self, prompts, greqs, *a, **kw):
        n = len(prompts) // 2
        return orig(self, prompts[:n], greqs[:n]) + [None] * (len(prompts) - n)
    monkeypatch.setattr(pipeline.MicrobatchRAR, "process_batch", half)


@pytest.mark.parametrize("fault", [_alter_first_token, _drop_commits,
                                   _serve_half])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell(rar_cell(), SEED + 2, steps=3)
    assert not out["correct"]


def test_the_tf32_control_fails_a_limit():
    cell = rar_cell()
    got = controls.rar_control(cell, SEED + 3, 3, torch.device("cpu"))
    checks = held(cell.name, got)
    assert not passed(checks), checks
    assert np.isfinite(got["embed_err"])
