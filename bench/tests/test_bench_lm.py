"""The LM cell driven end to end on the CPU at a small size: the plain
forward agrees with the served logits, and a broken timed path, or the
fp8 control, comes out not correct."""
import _bench_path  # noqa: F401
import pytest
import torch
from _bench_cells import lm_cell, run_cell

from bench import controls
from bench.harness import traffic
from bench.harness.checks import held, passed

SEED = 2_147_483_671


def test_reference_agrees_with_the_port():
    cell = lm_cell()
    out = run_cell(cell, SEED, steps=3)
    assert out["correct"], out["checks"]
    stream = traffic.make(cell.traffic, cell.config, SEED)
    assert out["attempted"] == sum(len(stream.next()) for _ in range(3))
    assert out["failed"] == 0
    assert set(out["metrics"]) == {"tokens_per_s", "answer_ms_p95",
                                   "setup_s"}


def test_traced_run_reads_the_layers():
    out = run_cell(lm_cell(), SEED + 1, steps=2, trace=1)
    assert out["correct"], out["checks"]
    assert {"launches_per_call.tier", "mfu.tier",
            "idle_share.tier"} <= set(out["metrics"])
    assert out["device"]["window_s"] > 0


def _alter_token(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.greedy_generate
    monkeypatch.setattr(engine, "greedy_generate",
                        lambda *a: (orig(*a) + 1) % 512)


def _skip_a_layer(monkeypatch):
    from repro_torch.models import model
    orig = model._attn_block_seq

    def unchanged(cfg, lp, x, *a, **kw):
        out = orig(cfg, lp, x, *a, **kw)
        return (x,) + tuple(out[1:])
    monkeypatch.setattr(model, "_attn_block_seq", unchanged)


def _half_batch(monkeypatch):
    from repro_torch.serving import engine
    orig = engine.prefill

    def half(cfg, params, batch, max_len):
        logits, cache, pos = orig(cfg, params, batch, max_len)
        n = logits.shape[0] // 2
        logits = torch.cat([logits[:n], logits[:n]])
        return logits, cache, pos
    monkeypatch.setattr(engine, "prefill", half)


@pytest.mark.parametrize("fault", [_alter_token, _skip_a_layer, _half_batch])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    out = run_cell(lm_cell(), SEED + 2, steps=2)
    assert not out["correct"]


def test_the_fp8_control_fails_a_limit():
    cell = lm_cell()
    got = controls.lm_control(cell, SEED + 3, torch.device("cpu"))
    assert not passed(held(cell.name, got)), got
