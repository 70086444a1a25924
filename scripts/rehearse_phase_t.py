"""Rehearse ``chip_smoke.py`` Phases T (the zoo trainer) and D (the dry
run) on the CPU, before spending time on the card.

    PYTHONPATH=src python scripts/rehearse_phase_t.py [--skip-d]

As ``scripts/rehearse_phase_z.py``: every kernel's CUDA wrapper is its
plain version counting launches, the profiler and the card's memory
counters read nothing, and ``configs.get`` is ``configs.get_smoke``, so
T1 and T2 train the smoke configs (T1 at sequence 128) and T1 serves
from their checkpoint; T3's "card" run is a second CPU run. Phase D runs
as on the card: the six dry-run pairs at full size, a process each.
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
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops

    torch.set_num_threads(4)
    patch_for_cpu(all_kernels=True)
    configs.get = configs.get_smoke
    counted = da.decode_attention_cuda

    def decode(q, k, v, cache_len, **kw):       # zeros at cache_len 0
        out = counted(q, k, v, cache_len, **kw)
        return torch.where((cache_len > 0)[:, None, None], out,
                           torch.zeros_like(out))
    da.decode_attention_cuda = decode
    cs.busy_ms = lambda torch, fn, tag: (fn(), (None, 1.0))[1]
    torch.cuda.reset_peak_memory_stats = lambda *a, **kw: None
    torch.cuda.max_memory_allocated = lambda *a, **kw: 0
    torch.cuda.empty_cache = lambda: None
    cs.T1 = cs.T1[:3] + (128,)
    t0 = time.perf_counter()
    counts, _ = cs.phase_t(torch, ops)
    print(f"rehearsal: Phase T in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; launches {counts}", flush=True)
    if "--skip-d" not in sys.argv:
        t0 = time.perf_counter()
        cs.phase_d()
        print(f"rehearsal: Phase D in {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
