"""The command's own refusals: no card, or a directory holding only the
benchmark's files, exits non-zero with no result line; the forbidden
module check names whole top-level modules."""
import os
import shutil
import subprocess
import sys

import _bench_path  # noqa: F401

from bench import run
from bench.harness.manifest import ROOT

ARGS = ["--workload", "rar.store21m.mb256", "--seed", "2147483700",
        "--seconds", "1", "--trace", "0"]


def _run(cwd) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_no_card_no_result():
    p = _run(ROOT)
    assert p.returncode == 2 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_compared_whole():
    """``repro_torch`` is not ``repro``."""
    assert run.loaded_forbidden(["repro_torch", "repro_torch.core",
                                 "reprox", "jaxtyping", "numpy"]) == []
    assert run.loaded_forbidden(["repro.core", "jax.numpy", "jaxlib",
                                 "flax.linen"]) == ["flax", "jax", "jaxlib",
                                                    "repro"]
