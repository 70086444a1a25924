"""The port stands alone: importing every ``repro_torch`` module (and
``chip_smoke.py``) loads neither JAX nor the JAX package; entry points
refuse to run without CUDA unless asked for the CPU; ``chip_smoke.py``
fails and prints no result on a machine without a card."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import rar_system as trar
from repro_torch.core import embedder, memory
from repro_torch.core.pipeline import MicrobatchRAR
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


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(trar.WEAK, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        memory.init_memory(memory.MemoryConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        embedder.init_params(trar.EMBEDDER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(trar.WEAK, 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MicrobatchRAR(None, None, None, None, trar.make_rar_config())
    assert init_params(trar.WEAK, seed=0, device="cpu")["embed"].device.type \
        == "cpu"


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
