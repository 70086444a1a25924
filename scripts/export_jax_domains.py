"""Record the JAX package's runs of the paper's fig5, fig6 and Table I on
the exported system, the reference the port is held to on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/export_jax_domains.py

It trains nothing: the JAX system is assembled from
``reference/jax_rar_system.npz`` (written into a temporary cache in the JAX
package's checkpoint format, training refused), and its weights must have
the digest that ``reference/jax_fig4_fig7.json`` records. Writes
``reference/jax_fig5_fig6_table1.json``:

- for domains 1 (``benchmarks/fig6_hs_psychology.py``, 359 questions) and 2
  (``benchmarks/fig5_moral_scenarios.py``, 675): the failing pool (every
  triple), its margins from a flip, ``run_baselines(n_stages=5)``, every
  ``StageResult`` of ``run_rar_experiment`` sequentially (seed 0, k = 1,
  the paper's procedure) and at microbatch 16 (seed 0, ``retrieval_k=4``),
  both over 5 stages, and fig4's summary of the sequential run;
- Table I by ``benchmarks/table1_generalization.py``'s own
  ``populate_memory`` and ``guided_eval``: the source memory from domain 0's
  recorded 754-question pool, for each target the inter, intra and unguided
  aligned counts and the three ``diff_from_strong_pct`` rows as its
  ``main`` emits them; beside them, each guided read's retrieved row,
  similarity, guided flag and weak answer (their aligned count asserted
  equal to ``guided_eval``'s) and the smallest |sim - 0.1|;
- a small Table I case for the CPU tests: the source from domain 0's first
  120 questions, the targets' first 60 questions;
- provenance and the CPU seconds.

About 5 min of CPU on an 8-core host.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from export_jax_reference import (N_STAGES, cpu_model,  # noqa: E402
                                  fig4_summary, git_commit, pool_margins,
                                  weights_digest)

REF = ROOT / "reference"
OUT = REF / "jax_fig5_fig6_table1.json"
DOMAINS = (1, 2)                    # fig6, fig5
FIGURES = {1: "fig6", 2: "fig5"}
#: every recorded run of a domain's pool and the arguments that replay it
RUNS = {"seq_seed0_k1": dict(n_stages=N_STAGES, seed=0, microbatch=1,
                             retrieval_k=1),
        "mb16_seed0_k4": dict(n_stages=N_STAGES, seed=0, microbatch=16,
                              retrieval_k=4)}
SMALL = dict(source_n=120, target_n=60)


def jax_system():
    """The JAX package's system from the export: its leaves written in the
    JAX checkpoint format where ``build_system`` looks, training refused."""
    import jax

    from repro.data.tasks import TaskSuiteConfig
    from repro.experiments import setup
    from repro.training import save_checkpoint
    from repro_torch.training.checkpoint import load_checkpoint

    blob = load_checkpoint(str(REF / "jax_rar_system.npz"), device="cpu")
    tree = jax.tree.map(lambda t: t.numpy(), blob)
    s = TaskSuiteConfig()
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(os.path.join(
            tmp, f"sys_{s.seed}_{s.guide_train_frac}_900_1100_0.npz"), tree)
        setup.CACHE_DIR, setup._train_lm = tmp, None
        return setup.build_system(verbose=True), tree


def guided_reads(system, pool, memory) -> tuple[int, list, list]:
    """``guided_eval`` of ``benchmarks/table1_generalization.py`` with its
    rows kept: the aligned count, a ``[row, sim, guided, weak answer]``
    row a question, and the strong tier's answers."""
    from benchmarks.table1_generalization import XFER_THRESHOLD
    from repro.core import memory as mem
    from repro.experiments.stages import _batched_answers, _prompts
    prompts, _ = _prompts(system, pool)
    strong_ref = _batched_answers(system.strong, prompts)
    embs = system.embed_many(prompts)
    guided, reads = [], []
    for p, e in zip(prompts, embs):
        q = mem.query(memory, e, guides_only=True)
        sim, hit = float(q.sim), float(q.sim) >= XFER_THRESHOLD
        reads.append([int(q.index), sim, hit])
        if hit:
            g = np.asarray(q.guide)
            g = g[g != 0]
            guided.append(np.concatenate([p[:1], g, p[1:]]).astype(np.int32))
        else:
            guided.append(p)
    ans = np.zeros(len(pool), np.int64)
    for ln in {len(p) for p in guided}:
        idx = [i for i, p in enumerate(guided) if len(p) == ln]
        ans[idx] = system.weak.answer_batch(np.stack([guided[i]
                                                      for i in idx]))
    for r, a in zip(reads, ans):
        r.append(int(a))
    aligned = int(np.sum((ans == strong_ref) & (ans >= 0)))
    return aligned, reads, [int(a) for a in strong_ref]


def table1(system, source, targets: dict) -> dict:
    """Table I as ``benchmarks/table1_generalization.py``'s ``main`` runs
    it, from ``source`` onto each of ``targets`` ({domain: pool}), with
    the per-question reads beside its counts."""
    from benchmarks.table1_generalization import guided_eval, populate_memory
    from repro.experiments.setup import POOL_NAMES
    from repro.experiments.stages import _batched_answers, _prompts
    t_start = time.perf_counter()
    src_memory = populate_memory(system, source)
    out, rows, sims = {}, [], []
    for d, pool in targets.items():
        n = len(pool)
        prompts, _ = _prompts(system, pool)
        strong_ref = _batched_answers(system.strong, prompts)
        inter = guided_eval(system, pool, src_memory)
        tgt_memory = populate_memory(system, pool)
        intra = guided_eval(system, pool, tgt_memory)
        weak_ans = _batched_answers(system.weak, prompts)
        unguided = int(np.sum((weak_ans == strong_ref) & (weak_ans >= 0)))
        reads = {}
        for tag, memory, count in (("inter", src_memory, inter),
                                   ("intra", tgt_memory, intra)):
            got, reads[tag], strong = guided_reads(system, pool, memory)
            assert got == count, (d, tag, got, count)
            assert strong == [int(a) for a in strong_ref]
            sims += [r[1] for r in reads[tag]]
        name = POOL_NAMES[d]
        short = lambda a: round(100.0 * (n - a) / n, 1)   # noqa: E731
        rows += [
            {"target": name, "guide_source": POOL_NAMES[0],
             "diff_from_strong_pct": short(inter)},
            {"target": name, "guide_source": name,
             "diff_from_strong_pct": short(intra)},
            {"target": name, "guide_source": "unguided",
             "diff_from_strong_pct": short(unguided)}]
        out[str(d)] = dict(target=name, n=n, inter=inter, intra=intra,
                           unguided=unguided, strong=[int(a) for a in
                                                      strong_ref],
                           reads=reads)
        print(f"[export] Table I {name} (n={n}): inter {inter}, intra "
              f"{intra}, unguided {unguided}", flush=True)
    return dict(source_domain=0, source_n=len(source), source_stages=2,
                xfer_threshold=0.1, targets=out, rows=rows,
                threshold_margin=float(np.abs(np.asarray(sims) - 0.1).min()),
                cpu_seconds=time.perf_counter() - t_start)


def domain_record(system, d: int) -> dict:
    from repro.experiments.setup import POOL_NAMES, POOL_SIZES, failing_pool
    from repro.experiments.stages import run_baselines, run_rar_experiment
    pool = failing_pool(system, d)
    assert len(pool) == POOL_SIZES[d]
    base = {k: [dataclasses.asdict(r) for r in v] for k, v in
            run_baselines(system, pool, n_stages=N_STAGES).items()}
    runs = {}
    for name, kw in RUNS.items():
        t0 = time.perf_counter()
        k = kw["retrieval_k"]
        results, _ = run_rar_experiment(
            system, pool, n_stages=kw["n_stages"], seed=kw["seed"],
            microbatch=kw["microbatch"], retrieval_k=None if k == 1 else k)
        dt = time.perf_counter() - t0
        stages = [dataclasses.asdict(r) for r in results]
        runs[name] = dict(kw, pool_n=len(pool), stages=stages,
                          cpu_seconds=dt,
                          cpu_requests_per_s=len(pool) * kw["n_stages"] / dt)
        print(f"[export] domain {d} {name}: strong calls "
              f"{[r['strong_calls'] for r in stages]}, aligned "
              f"{[r['aligned'] for r in stages]} ({dt:.1f} s)", flush=True)
    return {"domain": d, "figure": FIGURES[d], "pool_name": POOL_NAMES[d],
            "pool": [list(map(int, c)) for c in pool],
            "margins": pool_margins(system, pool), "baselines": base,
            "runs": runs,
            "fig4": fig4_summary([runs["seq_seed0_k1"]["stages"]], base)}


def main() -> int:
    import jax

    from repro.experiments.setup import POOL_SIZES

    t_start = time.perf_counter()
    fig4_fig7 = json.loads((REF / "jax_fig4_fig7.json").read_text())
    system, tree = jax_system()
    digest = weights_digest(tree)
    assert digest == fig4_fig7["weights_digest"], digest
    domains = {str(d): domain_record(system, d) for d in DOMAINS}
    source = [tuple(c) for c in fig4_fig7["pool"]]
    assert len(source) == POOL_SIZES[0]
    pools = {d: [tuple(c) for c in domains[str(d)]["pool"]] for d in DOMAINS}
    small = table1(system, source[:SMALL["source_n"]],
                   {d: p[:SMALL["target_n"]] for d, p in pools.items()})
    full = table1(system, source, pools)
    record = {
        "weights": "reference/jax_rar_system.npz", "weights_digest": digest,
        "domains": domains, "table1": full,
        "table1_small": dict(small, **SMALL),
        "paper": {"fig5_fig6": "the trends of fig4 hold on both domains "
                               "(50.2% fewer strong calls, 90.5% quality "
                               "on professional law)",
                  "table1": "guides generalise within a domain, not "
                            "across: intra < inter <= unguided "
                            "difference from the strong FM"},
        "provenance": {
            "jax": jax.__version__, "numpy": np.__version__,
            "python": platform.python_version(), "commit": git_commit(),
            "cpu": cpu_model(), "cores": len(os.sched_getaffinity(0)),
            "seconds": None},
    }
    record["provenance"]["seconds"] = time.perf_counter() - t_start
    with open(OUT, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(f"[export] record -> {OUT} in "
          f"{record['provenance']['seconds']:.1f} s; Table I "
          f"{full['rows']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
