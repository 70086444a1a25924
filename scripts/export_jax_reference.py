"""Export the JAX package's trained RAR system and its fig4/fig7 runs, the
reference the port is held to where JAX cannot run (the H100's machine).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_jax_reference.py

Writes two files under ``reference/``:

- ``jax_rar_system.npz``: the system's weights (``weak``, ``strong``,
  ``embedder``, ``router_w``, ``router_b``) as numpy leaves in the JAX
  package's own layout, written by ``repro_torch.training.checkpoint``
  (``/``-joined key paths, no pickle). The port reads it back with its
  ``load_checkpoint`` and bridges it with ``repro_torch.bridge.system``.
- ``jax_fig4_fig7.json``: the JAX package's runs on those weights, in the
  shape of ``benchmarks/common.py`` and ``benchmarks/fig4_rar_vs_baselines.py``
  / ``fig7_guide_memory.py``: domain 0's failing pool (754 triples),
  ``run_baselines(n_stages=5)``, ``run_rar_experiment(n_stages=5)``
  sequentially for seeds 0 and 1 at ``retrieval_k`` 1 and 4, at microbatch
  16 (seed 0), and a small case (the pool's first 120 questions, 2 stages,
  microbatch 16, ``retrieval_k=4``); every ``StageResult``, fig4's ratios,
  fig7's per-stage split, the pool's margins from a flip, and provenance.

The system comes from ``repro.experiments.setup.build_system()``: its cache
(``.cache/rar_system/``) or ~20 min of training first. The runs take
~15-20 min of CPU; start the script detached (``nohup setsid ... &``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "reference"
DOMAIN = 0
N_STAGES = 5                       # benchmarks/common.py N_STAGES
SEEDS = (0, 1)                     # shuffles 0-1 of common.py's five
RETRIEVAL_KS = (1, 4)              # common.py RETRIEVAL_KS
SIM_THRESHOLD = 0.6                # RARConfig.sim_threshold

#: every recorded run: its name and the arguments that replay it
#: (``pool_n`` questions from the front of the recorded pool)
RUNS = {
    **{f"seq_seed{s}_k{k}": dict(pool_n=754, n_stages=N_STAGES, seed=s,
                                 microbatch=1, retrieval_k=k)
       for s in SEEDS for k in RETRIEVAL_KS},
    "mb16_seed0_k1": dict(pool_n=754, n_stages=N_STAGES, seed=0,
                          microbatch=16, retrieval_k=1),
    "small_mb16_seed0_k4": dict(pool_n=120, n_stages=2, seed=0,
                                microbatch=16, retrieval_k=4),
}


def weights_digest(tree: dict) -> str:
    """sha256 over the leaves' ``/``-joined paths, dtypes, shapes and bytes
    in path order: the same for the JAX tree and the port's loaded one."""
    flat: dict = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.ascontiguousarray(np.asarray(t))

    walk(tree, "")
    h = hashlib.sha256()
    for k in sorted(flat):
        a = flat[k]
        h.update(f"{k}|{a.dtype.str}|{a.shape}|".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def fig4_summary(runs: list[list[dict]], base: dict) -> dict:
    """``benchmarks/fig4_rar_vs_baselines.py``'s four headline ratios over
    ``runs`` (one list of per-stage rows a shuffle)."""
    n_total = len(runs[0]) * runs[0][0]["n"]
    rar_strong = float(np.mean([sum(r["strong_calls"] for r in run)
                                for run in runs]))
    rar_aligned = float(np.mean([sum(r["aligned"] for r in run)
                                 for run in runs]))
    return {
        "strong_call_reduction_vs_oracle": 1.0 - rar_strong / max(
            sum(r["strong_calls"] for r in base["oracle_router"]), 1),
        "quality_vs_oracle": rar_aligned / n_total,
        "aligned_vs_weak": rar_aligned / max(
            sum(r["aligned"] for r in base["weak"]), 1),
        "aligned_vs_cot": rar_aligned / max(
            sum(r["aligned"] for r in base["weak_cot"]), 1)}


def fig7_split(runs: list[list[dict]]) -> dict:
    """``benchmarks/fig7_guide_memory.py``'s per-stage aligned guided
    responses by guide source, mean over ``runs``."""
    mem = np.array([[r["guides_from_memory"] for r in run] for run in runs],
                   float)
    fresh = np.array([[r["guides_fresh"] for r in run] for run in runs],
                     float)
    return {"memory_per_stage": mem.mean(0).tolist(),
            "fresh_per_stage": fresh.mean(0).tolist(),
            "memory_total": float(mem.sum(1).mean()),
            "fresh_total": float(fresh.sum(1).mean())}


def pool_margins(system, pool) -> dict:
    """How far the pool sits from a flip, as ``chip_smoke.pool_margins``
    measures it on the card: the smallest top-2 logit gap of the first
    answer token (weak and strong over the prompts, strong over the guide
    requests), that gap over the largest logit of its row, and the closest
    pairwise embedding similarity to the 0.6 routing threshold."""
    import jax.numpy as jnp

    from repro.configs import rar_system
    from repro.experiments.stages import _prompts
    from repro.models import prefill
    prompts, greqs = _prompts(system, pool)
    gap, rel = np.inf, np.inf
    for cfg, params, batch in ((rar_system.WEAK, system.weak.engine.params,
                                prompts),
                               (rar_system.STRONG,
                                system.strong.engine.params, prompts),
                               (rar_system.STRONG,
                                system.strong.engine.params, greqs)):
        by_len: dict = {}
        for x in batch:
            by_len.setdefault(len(x), []).append(x)
        for xs in by_len.values():
            t = jnp.asarray(np.stack(xs))
            logits = np.asarray(prefill(cfg, params, {"tokens": t},
                                        t.shape[1] + 1)[0])
            top = -np.sort(-logits, axis=-1)[:, :2]
            g = top[:, 0] - top[:, 1]
            gap = min(gap, float(g.min()))
            rel = min(rel, float((g / np.abs(logits).max(-1)).min()))
    e = system.embed_many(prompts)
    sims = e @ e.T
    np.fill_diagonal(sims, 0.0)
    return {"logit_gap": gap, "logit_gap_rel": rel,
            "threshold_margin": float(np.abs(sims - SIM_THRESHOLD).min())}


def git_commit() -> str | None:
    try:
        return subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT,
                              capture_output=True, text=True,
                              check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None


def cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def main() -> int:
    import jax

    from repro.experiments.setup import POOL_NAMES, build_system, failing_pool
    from repro.experiments.stages import run_baselines, run_rar_experiment
    from repro_torch.training.checkpoint import save_checkpoint

    t_start = time.perf_counter()
    system = build_system(verbose=True)
    tree = jax.tree.map(np.asarray, {
        "weak": system.weak.engine.params,
        "strong": system.strong.engine.params,
        "embedder": system.embedder_params,
        "router_w": system.router.w, "router_b": system.router.b})
    OUT.mkdir(exist_ok=True)
    save_checkpoint(str(OUT / "jax_rar_system.npz"), tree)
    print(f"[export] weights -> {OUT / 'jax_rar_system.npz'}", flush=True)

    pool = failing_pool(system, DOMAIN, n=754)
    t0 = time.perf_counter()
    margins = pool_margins(system, pool)
    print(f"[export] margins {margins} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    base = {k: [dataclasses.asdict(r) for r in v] for k, v in
            run_baselines(system, pool, n_stages=N_STAGES).items()}

    runs = {}
    for name, kw in RUNS.items():
        t0 = time.perf_counter()
        k = kw["retrieval_k"]
        results, _ = run_rar_experiment(
            system, pool[:kw["pool_n"]], n_stages=kw["n_stages"],
            seed=kw["seed"], microbatch=kw["microbatch"],
            retrieval_k=None if k == 1 else k)
        dt = time.perf_counter() - t0
        stages = [dataclasses.asdict(r) for r in results]
        runs[name] = dict(kw, stages=stages, cpu_seconds=dt,
                          cpu_requests_per_s=kw["pool_n"] * kw["n_stages"]
                          / dt)
        print(f"[export] {name}: strong calls "
              f"{[r['strong_calls'] for r in stages]}, aligned "
              f"{[r['aligned'] for r in stages]} ({dt:.1f} s)", flush=True)

    seq = {k: [runs[f"seq_seed{s}_k{k}"]["stages"] for s in SEEDS]
           for k in RETRIEVAL_KS}
    record = {
        "domain": DOMAIN, "pool_name": POOL_NAMES[DOMAIN],
        "pool": [list(map(int, c)) for c in pool],
        "weights": "reference/jax_rar_system.npz",
        "weights_digest": weights_digest(tree),
        "margins": margins,
        "baselines": base,
        "runs": runs,
        "fig4": {f"k{k}": fig4_summary(seq[k], base) for k in RETRIEVAL_KS},
        "fig7": {f"k{k}": fig7_split(seq[k]) for k in RETRIEVAL_KS},
        "paper": {"strong_call_reduction_vs_oracle": "50.2%",
                  "quality_vs_oracle": "90.5%", "aligned_vs_weak": "+349%",
                  "aligned_vs_cot": "+135%"},
        "cut": "shuffles 2-4 of benchmarks/common.py's five are not "
               "recorded (CPU time)",
        "provenance": {
            "jax": jax.__version__, "numpy": np.__version__,
            "python": platform.python_version(), "commit": git_commit(),
            "cpu": cpu_model(), "cores": len(os.sched_getaffinity(0)),
            "seconds": None},
    }
    record["provenance"]["seconds"] = time.perf_counter() - t_start
    with open(OUT / "jax_fig4_fig7.json", "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"[export] record -> {OUT / 'jax_fig4_fig7.json'} in "
          f"{record['provenance']['seconds']:.1f} s; fig4 {record['fig4']}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
