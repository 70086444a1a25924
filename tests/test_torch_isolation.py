"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither JAX nor the JAX package, and neither does
a process fabric's spawned worker or an example twin; entry points refuse
to run without CUDA unless asked for the CPU; ``chip_smoke.py`` fails and
prints no result on a machine without a card."""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import rar_system as trar
from repro_torch.core import ShardedMemory, embedder, memory
from repro_torch.core.pipeline import MicrobatchRAR
from repro_torch.core.router import train_router
from repro_torch.experiments import build_system, run_rar_experiment
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.models import init_cache, init_params

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_no_jax_or_reference_package_in_sys_modules():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))
    assert "repro_torch.core.pipeline" in mods and len(mods) >= 20
    for m in ("repro_torch.training.optimizer",
              "repro_torch.training.train_step",
              "repro_torch.training.checkpoint", "repro_torch.core.router",
              "repro_torch.experiments.setup",
              "repro_torch.experiments.stages",
              "repro_torch.serving.metrics", "repro_torch.serving.faults",
              "repro_torch.serving.transport", "repro_torch.core.shadow",
              "repro_torch.launch.serve", "repro_torch.serving.fabric",
              "repro_torch.serving.procfabric",
              "repro_torch.serving.scheduler",
              "repro_torch.serving.loadgen",
              "repro_torch.core.memory_sharded",
              "repro_torch.launch.train", "repro_torch.launch.mesh",
              "repro_torch.launch.specs", "repro_torch.launch.analytic",
              "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
              "repro_torch.models.sharding",
              *(f"repro_torch.configs.{m}" for m in (
                  "olmo_1b", "gemma3_27b", "deepseek_coder_33b",
                  "olmoe_1b_7b", "granite_moe_3b_a800m", "mamba2_2p7b",
                  "recurrentgemma_2b", "phi3_vision_4p2b",
                  "whisper_medium"))):
        assert m in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "sys.path.insert(0, sys.argv[1])\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(trar.WEAK, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        memory.init_memory(memory.MemoryConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ShardedMemory(memory.MemoryConfig(), shards=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embedder.init_params(trar.EMBEDDER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(trar.WEAK, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MicrobatchRAR(None, None, None, None, trar.make_rar_config())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_system(cache=False, verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_rar_experiment(None, [])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_router([[1.0]], [1.0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        memory.open_journaled_stream(str(tmp_path / "j"),
                                     memory.MemoryConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--requests", "4"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--arch", "olmo-1b", "--smoke", "--steps", "1"])
    assert init_params(trar.WEAK, seed=0, device="cpu")["embed"].device.type \
        == "cpu"


def test_dry_run_loads_no_jax(tmp_path):
    """A dry-run subprocess (the fake process group, DTensors, one pair's
    step) loads neither JAX nor the JAX package, and importing the launch
    plane starts no process group."""
    code = ("import sys, runpy\n"
            "import torch.distributed as dist\n"
            "import repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized()\n"
            f"sys.argv = ['dryrun', '--arch', 'mamba2-2.7b', '--shape', "
            f"'long_500k', '--out', {str(tmp_path / 'dr.json')!r}]\n"
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print('BAD', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout
    assert "1 ok, 0 skipped, 0 failed" in out.stdout


def test_examples_load_no_jax(tmp_path):
    """The port's example twins, run without a card, import all they need,
    refuse to start (no ``--device cpu``), and load neither JAX nor the
    JAX package."""
    code = ("import runpy, sys\n"
            "for ex in sys.argv[1:]:\n"
            "    sys.argv = [ex]\n"
            "    try:\n"
            "        runpy.run_path(ex, run_name='__main__')\n"
            "    except RuntimeError as e:\n"
            "        assert \"device='cpu'\" in str(e), e\n"
            "    else:\n"
            "        raise AssertionError(ex + ' ran without a card')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "print('BAD', bad)\n")
    examples = [str(ROOT / "examples" / f"{n}_torch.py") for n in (
        "quickstart", "serve_rar", "continual_learning_demo")]
    env = _env()
    env["REPRO_TORCH_CACHE"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code, *examples],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "BAD []" in out.stdout


def test_chip_smoke_fails_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=_env(),
                         timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    # alone in a directory, without the rest of the repository
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, env=env,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_spawned_worker_loads_no_jax():
    """A process fabric's worker builds its replica from a factory that
    raises if any JAX or JAX-package module is loaded in the worker: the
    worker comes up and serves, so none is."""
    import numpy as np
    from _torch_fabric_parts import factory, jax_free_parts

    from repro_torch.core.rar import RARConfig
    from repro_torch.data import tokenizer as tk
    from repro_torch.serving.procfabric import ProcessServingFabric
    cfg = RARConfig(memory=memory.MemoryConfig(capacity=8, embed_dim=16,
                                               guide_len=8))
    fab = ProcessServingFabric(factory(jax_free_parts, (0,)), cfg,
                               workers=1, device="cpu")
    try:
        t = fab.submit([np.asarray([tk.BOS, 0, 1], np.int32)],
                       [np.asarray([tk.GUIDE_REQ, 0], np.int32)],
                       keys=[(0, 1)],
                       embs=np.full((1, 16), 0.25, np.float32))
        assert t.wait(timeout=120)[0].case == "case1"
        assert fab.startup_failures == 0 and fab.deaths == 0
    finally:
        fab.close_shadow()
