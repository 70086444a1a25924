"""Rehearse ``chip_smoke.py`` Phase M (the sharded guide store) on the CPU,
before spending time on the card.

    PYTHONPATH=src python scripts/rehearse_phase_m.py

Every kernel's CUDA wrapper is replaced by its plain version, counting
launches (``rehearse_phase_f.patch_for_cpu``); the timers run their
function once, on the host clock or not at all. R1 and Phase I (which M3
is held to) run first on the CPU, then Phase M with M2's stores cut to
65536 and 8192 rows (the card's 4,194,304-row store is 6.4 GB a copy), so
the cut store's top-4 reads run on every shard count. Takes ~5-10 min.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    import torch

    import chip_smoke as cs
    from rehearse_phase_f import patch_for_cpu, r1
    from repro_torch.configs import rar_system
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    torch.set_num_threads(4)
    patch_for_cpu(all_kernels=True)
    cs.M2_CAPACITIES = (65536, 8192)
    cpu = torch.device("cpu")
    tiers = (init_params(rar_system.WEAK, cs.SEEDS["weak"], device=cpu),
             init_params(rar_system.STRONG, cs.SEEDS["strong"], device=cpu))
    r_results = r1(torch, cs, tiers)
    t0 = time.perf_counter()
    _, i_results = cs.phase_i(torch, ops, tiers, r_results)
    print(f"rehearsal: Phase I in {time.perf_counter() - t0:.1f} s",
          flush=True)
    t0 = time.perf_counter()
    counts, _ = cs.phase_m(torch, ops, tiers, r_results, i_results)
    print(f"rehearsal: Phase M in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; launches {counts}", flush=True)


if __name__ == "__main__":
    main()
