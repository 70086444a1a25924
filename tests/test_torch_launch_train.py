"""The port's zoo trainer (``repro_torch.launch.train``) against the JAX
package's (``repro.launch.train``): the twin of the launcher the JAX
examples drive.

``synthetic_lm_batch`` gives the JAX function's arrays byte for byte for
the same generator state and config (tokens, labels, and the vlm and
audio families' frontend input). ``train`` runs 5 steps of a dense, a vlm
and an audio smoke config (f32) from JAX's own initial weights, bridged
(the port's ``init_params`` is replaced by them), on the same seeded
batches: every final metric within 1e-4 relative of JAX's ``train``. The
CLI trains on the CPU with ``--device cpu`` and writes a checkpoint that
reloads with the config's name.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.models import init_params as jinit
from repro_torch import bridge, configs
from repro_torch.launch import train as ttrain
from repro_torch.training import load_checkpoint
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = ("olmo-1b", "phi-3-vision-4.2b", "whisper-medium")
STEPS, BATCH, SEQ = 5, 4, 32


@pytest.mark.parametrize("arch", FAMILIES)
def test_synthetic_batch_is_jax_byte_for_byte(arch):
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    for seed in (0, 7):
        got = ttrain.synthetic_lm_batch(np.random.default_rng(seed),
                                        cfg.vocab_size, 3, 10, cfg)
        want = jtrain.synthetic_lm_batch(np.random.default_rng(seed),
                                         jcfg.vocab_size, 3, 10, jcfg)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_matches_jax_on_bridged_weights(arch, monkeypatch, capsys):
    cfg = configs.get_smoke(arch)
    jp = jax.jit(jinit, static_argnums=0)(jconfigs.get_smoke(arch),
                                          jax.random.PRNGKey(0))
    tp = bridge.lm_params(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    monkeypatch.setattr(ttrain, "init_params",
                        lambda c, seed, device: tp)
    kw = dict(smoke=True, steps=STEPS, batch=BATCH, seq=SEQ, lr=1e-3,
              ckpt=None, log_every=1)
    want = jtrain.train(arch, **kw)
    got = ttrain.train(arch, device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4 * max(abs(want[k]), 1e-6), \
            (k, got[k], want[k])
    lines = capsys.readouterr().out.splitlines()
    assert sum(l.startswith("  step ") for l in lines) == 2 * STEPS
    assert any(l.startswith(f"[train] {cfg.name}: ") for l in lines)


def test_cli_trains_on_the_cpu_and_writes_a_checkpoint(tmp_path):
    ck = tmp_path / "olmo.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmo-1b", "--smoke", "--steps", "3", "--batch", "2", "--seq",
         "16", "--device", "cpu", "--ckpt", str(ck)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "step 1/3" in out.stdout and str(ck) in out.stdout
    tree = load_checkpoint(str(ck), device="cpu")
    assert ttrain.tensor_name(tree["cfg_name"]) == \
        configs.get_smoke("olmo-1b").name
    init = ttrain.init_params(configs.get_smoke("olmo-1b"), 0, device="cpu")
    assert [t.shape for t in leaves(tree["params"])] == \
        [t.shape for t in leaves(init)]


def test_train_weak_fm_example_runs_on_the_cpu(tmp_path):
    """``examples/train_weak_fm_torch.py`` at 60 steps (its default 200
    cut to the test's time): the loss falls, and below the example's own
    bound of 4.0 (llama3-8b's smoke config; olmo-1b's tied embedding
    starts near 110 and needs the 200 steps)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_weak_fm_torch.py"),
         "--arch", "llama3-8b", "--steps", "60", "--device", "cpu",
         "--ckpt", str(tmp_path / "ex.npz")],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    losses = [float(l.split("loss=")[1].split()[0])
              for l in out.stdout.splitlines() if l.startswith("  step ")]
    assert len(losses) == 7 and losses[-1] < losses[0]
    assert "final metrics" in out.stdout
