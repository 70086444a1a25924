"""End-to-end serving driver: batched requests through the full RAR stack
with cost accounting — the paper's deployment scenario (weak edge tier +
strong cloud tier). The PyTorch port's twin of ``examples/serve_rar.py``,
on the card by default.

    PYTHONPATH=src python examples/serve_rar_torch.py --requests 150 \\
        --stages 3 [--device cpu]
"""
import argparse
import time

from repro_torch.core.rar import RARConfig
from repro_torch.experiments.setup import build_system, failing_pool
from repro_torch.experiments.stages import run_baselines, run_rar_experiment


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=150)
    ap.add_argument("--stages", type=int, default=3)
    ap.add_argument("--domain", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args()

    system = build_system(device=args.device)
    pool = failing_pool(system, args.domain, n=args.requests)

    cfg = RARConfig(reprobe_period=2 * len(pool))
    t0 = time.time()
    results, rar = run_rar_experiment(
        system, pool, n_stages=args.stages, rar_cfg=cfg, verbose=True,
        device=args.device)
    dt = time.time() - t0

    n = args.stages * len(pool)
    aligned = sum(r.aligned for r in results)
    strong = sum(r.strong_calls for r in results)
    base = run_baselines(system, pool, n_stages=args.stages, rar_cfg=cfg)
    oracle_strong = sum(r.strong_calls for r in base["oracle_router"])

    # FLOPs-based cost model (6·N_active per token, per tier config)
    weak_cost = system.weak.flops_spent
    strong_cost = system.strong.flops_spent
    print(f"\nserved {n} requests in {dt:.1f}s "
          f"({1e3 * dt / n:.1f} ms/request on this host)")
    print(f"quality (aligned with strong FM): {100 * aligned / n:.1f}%")
    print(f"strong-FM calls: {strong} vs oracle static router "
          f"{oracle_strong} → {100 * (1 - strong / oracle_strong):.1f}% "
          f"reduction (paper: 50.2%)")
    print(f"FLOPs split: weak {weak_cost:.2e}, strong {strong_cost:.2e} "
          f"(strong tier is {system.strong.cfg.flops_per_token() / system.weak.cfg.flops_per_token():.1f}x cost/token)")


if __name__ == "__main__":
    main()
