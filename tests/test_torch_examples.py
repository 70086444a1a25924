"""The port's three example twins against the JAX package's examples on the
exported reference system (``reference/jax_rar_system.npz``): each pair
runs as subprocesses on the CPU, the JAX example reading the export from a
``REPRO_CACHE`` in its own checkpoint format, the port's from a
``REPRO_TORCH_CACHE`` in the port's (``bridge.system``'s output) with
``--device cpu``. Every line but the timing ones and the cache path is
equal. Without a card and without ``--device cpu`` each port example
refuses to start."""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.data.tasks import TaskSuiteConfig
from repro.training import save_checkpoint as jax_save_checkpoint
from repro_torch import bridge
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
EXPORT = ROOT / "reference" / "jax_rar_system.npz"
EXAMPLES = {"quickstart": [],
            "serve_rar": ["--requests", "40", "--stages", "2"],
            "continual_learning_demo": []}
TIMEOUT_S = 240


def cache_name() -> str:
    """The file name both packages' ``build_system`` reads at its defaults."""
    s = TaskSuiteConfig()
    return f"sys_{s.seed}_{s.guide_train_frac}_900_1100_0.npz"


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    env.pop("PYTEST_XDIST_WORKER_COUNT", None)
    env.update(extra)
    return env


def _decisions(out: str) -> list[str]:
    """The lines a pair must share: all but the cache path, the served-in
    timing line and the port's requests/s after a stage line."""
    keep = []
    for line in out.splitlines():
        if line.startswith("[setup]") or line.startswith("served "):
            continue
        if line.startswith("    stage "):
            line = line.split(";")[0]
        keep.append(line)
    return keep


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Every example and its twin, started together: {name: (jax, port)}."""
    blob = load_checkpoint(str(EXPORT), device="cpu")
    jdir = tmp_path_factory.mktemp("jax_cache")
    tdir = tmp_path_factory.mktemp("torch_cache")
    jax_save_checkpoint(str(jdir / cache_name()),
                        tree_map(lambda t: t.numpy(), blob))
    save_checkpoint(str(tdir / cache_name()),
                    bridge.system(blob, device="cpu"))
    procs = {}
    for name, args in EXAMPLES.items():
        procs[name] = (
            subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / f"{name}.py"),
                 *args], cwd=ROOT, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                env=_env(REPRO_CACHE=str(jdir), JAX_PLATFORMS="cpu")),
            subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
                 *args, "--device", "cpu"], cwd=ROOT, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=_env(REPRO_TORCH_CACHE=str(tdir), OMP_NUM_THREADS="1")))
    out = {}
    try:
        for name, pair in procs.items():
            res = []
            for p in pair:
                stdout, stderr = p.communicate(timeout=TIMEOUT_S)
                res.append((p.returncode, stdout, stderr[-3000:]))
            out[name] = tuple(res)
    finally:
        for pair in procs.values():
            for p in pair:
                p.kill()
    return out


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_twin_prints_the_jax_lines(outputs, name):
    (jrc, jout, jerr), (trc, tout, terr) = outputs[name]
    assert jrc == 0, jerr
    assert trc == 0, terr
    want, got = _decisions(jout), _decisions(tout)
    assert len(want) >= 5
    assert got == want


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_refuses_without_a_card(name, tmp_path):
    """No card, no ``--device cpu``: the port's example raises before it
    trains or loads anything (an empty cache, so a fallback would train)."""
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}_torch.py"),
         *EXAMPLES[name]], cwd=ROOT, capture_output=True, text=True,
        env=_env(REPRO_TORCH_CACHE=str(tmp_path)), timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert list(tmp_path.iterdir()) == []
