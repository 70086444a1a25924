"""The exported reference (``reference/``): the JAX package's trained RAR
system and its recorded fig4/fig7 runs, the record the card is held to in
``chip_smoke.py``'s Phase P, where JAX cannot run.

The weights load through the port's ``load_checkpoint`` alone (a
subprocess that imports no JAX) and bridge into the port. The JAX
package's system is assembled from the same export (its cache pointed at a
temporary copy, so nothing trains); on it the port's failing pool equals
JAX's and the record's, and on the record's small case (the pool's first
120 questions, 2 stages, microbatch 16, ``retrieval_k=4``) the port's
``StageResult`` s equal JAX's, run here, and the record's.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_examples import cache_name

from repro.experiments import setup as jsetup
from repro.experiments import stages as jstages
from repro.training import save_checkpoint as jax_save_checkpoint
from repro_torch import bridge
from repro_torch.experiments import setup as tsetup
from repro_torch.experiments import stages as tstages
from repro_torch.training.checkpoint import load_checkpoint
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
from export_jax_reference import (RUNS, fig4_summary,  # noqa: E402
                                  fig7_split, weights_digest)

EXPORT = ROOT / "reference" / "jax_rar_system.npz"
RECORD = ROOT / "reference" / "jax_fig4_fig7.json"
SMALL = "small_mb16_seed0_k4"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as ``tests/test_torch_system.py`` serves: a
    fixed count keeps the CPU reductions in one order on any host."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(results):
    return [dataclasses.asdict(r) for r in results]


def _kwargs(run):
    k = run["retrieval_k"]
    return dict(n_stages=run["n_stages"], seed=run["seed"],
                microbatch=run["microbatch"],
                retrieval_k=None if k == 1 else k)


@pytest.fixture(scope="module")
def record():
    return json.loads(RECORD.read_text())


@pytest.fixture(scope="module")
def blob():
    return load_checkpoint(str(EXPORT), device="cpu")


@pytest.fixture(scope="module")
def jsys(blob, tmp_path_factory):
    """The JAX package's system from the export: the tree written in its
    checkpoint format where ``build_system`` looks, training refused."""
    d = tmp_path_factory.mktemp("jax_cache")
    jax_save_checkpoint(str(d / cache_name()),
                        tree_map(lambda t: t.numpy(), blob))
    mp = pytest.MonkeyPatch()
    mp.setattr(jsetup, "CACHE_DIR", str(d))
    mp.setattr(jsetup, "_train_lm", None)       # loading must not train
    try:
        return jsetup.build_system(verbose=False)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def system(blob):
    return tsetup.build_system(device="cpu", verbose=False,
                               params=bridge.system(blob, device="cpu"))


def test_export_loads_without_jax(record):
    """The port alone reads the export (no pickle), bridges it with the
    shapes checked, and gets the recorded weights' digest."""
    code = (
        "import sys\n"
        "sys.path.insert(0, sys.argv[2])\n"
        "from export_jax_reference import weights_digest\n"
        "from repro_torch import bridge\n"
        "from repro_torch.training.checkpoint import load_checkpoint\n"
        "from repro_torch.tree import tree_map\n"
        "blob = load_checkpoint(sys.argv[1], device='cpu')\n"
        "p = bridge.system(blob, device='cpu')\n"
        "assert p['weak']['layers']['attn']['wq'].shape == "
        "(3, 128, 4, 32)\n"
        "assert p['router_w'].shape == (384,)\n"
        "assert p['router_b'].shape == ()\n"
        "print('DIGEST', weights_digest(tree_map(lambda t: t.numpy(), "
        "blob)))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code, str(EXPORT),
                          str(ROOT / "scripts")], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"DIGEST {record['weights_digest']}" in out.stdout
    assert "BAD []" in out.stdout


def test_export_is_the_jax_system(blob, jsys, record):
    """The JAX system assembled from the export holds the exported leaves
    (f32, exactly), and the port's loaded tree has the recorded digest."""
    tree = jax.tree.map(np.asarray, {
        "weak": jsys.weak.engine.params, "strong": jsys.strong.engine.params,
        "embedder": jsys.embedder_params, "router_w": jsys.router.w,
        "router_b": jsys.router.b})
    assert weights_digest(tree) == record["weights_digest"]
    assert weights_digest(tree_map(lambda t: t.numpy(), blob)) == \
        record["weights_digest"]
    assert {str(a.dtype) for a in jax.tree.leaves(tree)} == {"float32"}


def test_record_is_whole(record):
    """Every run the export script lists, with its stages, and fig4's and
    fig7's summaries recomputed from the recorded rows."""
    assert set(record["runs"]) == set(RUNS)
    for name, kw in RUNS.items():
        run = record["runs"][name]
        assert {k: run[k] for k in kw} == kw
        assert len(run["stages"]) == kw["n_stages"]
        assert all(r["n"] == kw["pool_n"] for r in run["stages"])
    assert len(record["pool"]) == 754
    assert set(record["baselines"]) == {"weak", "weak_cot", "strong",
                                        "oracle_router"}
    for k in (1, 4):
        seq = [record["runs"][f"seq_seed{s}_k{k}"]["stages"] for s in (0, 1)]
        assert record["fig4"][f"k{k}"] == fig4_summary(seq,
                                                       record["baselines"])
        assert record["fig7"][f"k{k}"] == fig7_split(seq)
    assert set(record["margins"]) == {"logit_gap", "logit_gap_rel",
                                      "threshold_margin"}
    assert {"jax", "commit", "cpu", "cores", "seconds"} <= \
        set(record["provenance"])


def test_failing_pool_matches_jax_and_record(system, jsys, record):
    pool = tsetup.failing_pool(system, domain=0, n=754)
    assert pool == jsetup.failing_pool(jsys, domain=0, n=754)
    assert pool == [tuple(c) for c in record["pool"]]


def test_small_case_matches_jax_and_record(system, jsys, record):
    run = record["runs"][SMALL]
    pool = [tuple(c) for c in record["pool"][:run["pool_n"]]]
    got, _ = tstages.run_rar_experiment(system, pool, device="cpu",
                                        **_kwargs(run))
    want, _ = jstages.run_rar_experiment(jsys, pool, **_kwargs(run))
    assert _rows(got) == _rows(want)
    assert _rows(got) == run["stages"]
