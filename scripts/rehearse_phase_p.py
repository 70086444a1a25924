"""Rehearse ``chip_smoke.py`` Phase P (the paper's fig4/fig7 runs against
the JAX package's record) on the CPU, before spending time on the card.

    PYTHONPATH=src python scripts/rehearse_phase_p.py

As ``scripts/rehearse_phase_f.py``: the kernels' CUDA wrappers are their
plain versions counting launches, dispatch sends every tensor to them and
the card's synchronizations are no-ops. The port then serves the exported
JAX system on the CPU and must give every recorded row; the rates printed
are this host's CPU, not the card's. Takes ~3-5 min at 4 threads.
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
    patch_for_cpu()
    t0 = time.perf_counter()
    counts, _ = cs.phase_p(torch, ops)
    print(f"rehearsal: Phase P in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; launches {counts}", flush=True)


if __name__ == "__main__":
    main()
