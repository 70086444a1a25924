"""Rehearse ``chip_smoke.py`` Phases P and G (the paper's fig4/fig7, and
its fig5, fig6 and Table I, against the JAX package's records) on the CPU,
before spending time on the card.

    PYTHONPATH=src python scripts/rehearse_phase_p.py [--skip-p]

As ``scripts/rehearse_phase_f.py``: the kernels' CUDA wrappers are their
plain versions counting launches, dispatch sends every tensor to them and
the card's synchronizations are no-ops. The port then serves the exported
JAX system on the CPU and must give every recorded row; the rates printed
are this host's CPU, not the card's. ``--skip-p`` runs Phase G alone on the
bridged system. Takes ~3-5 min for P and ~1.5 min for G at 4 threads.
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
    from rehearse_phase_f import patch_for_cpu
    from repro_torch.kernels import ops

    torch.set_num_threads(4)
    patch_for_cpu(all_kernels=True)
    if "--skip-p" in sys.argv[1:]:
        system = cs.reference_system(torch)
    else:
        t0 = time.perf_counter()
        counts, results = cs.phase_p(torch, ops)
        system = results["system"]
        print(f"rehearsal: Phase P in {time.perf_counter() - t0:.1f} s on "
              f"the CPU; launches {counts}", flush=True)
    t0 = time.perf_counter()
    counts, _ = cs.phase_g(torch, ops, system)
    print(f"rehearsal: Phase G in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; launches {counts}", flush=True)


if __name__ == "__main__":
    main()
