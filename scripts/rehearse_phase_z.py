"""Rehearse ``chip_smoke.py`` Phase K (every kernel case, the zoo's
shapes included) and Phase Z (the model zoo, all ten archs) on
the CPU, before spending time on the card.

    PYTHONPATH=src python scripts/rehearse_phase_z.py

Every kernel's CUDA wrapper is replaced by its plain version, counting
launches (``rehearse_phase_f.patch_for_cpu``); each timer runs its
function once; the profiler's busy share and the card's memory counters
read nothing; the decode stand-in gives zeros where ``cache_len`` is
0, as the kernel does. The zoo runs at its smoke configs (``configs.get`` is
``configs.get_smoke``; f32), Z3's rings at 8 slots over 24 steps.
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
    cs.cold_ms = lambda torch, fn, **kw: cs.time_ms(torch, fn)
    cs.Z_RINGS = tuple((arch, 8, 24, B, cut and 2)
                       for arch, _, _, B, cut in cs.Z_RINGS)
    cs.busy_ms = lambda torch, fn, tag: (fn(), (None, 0.0))[1]
    torch.cuda.reset_peak_memory_stats = lambda *a, **kw: None
    torch.cuda.max_memory_allocated = lambda *a, **kw: 0
    t0 = time.perf_counter()
    rows = cs.phase_k(torch)
    print(f"rehearsal: Phase K in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; cases {({k: len(v) for k, v in rows.items()})}", flush=True)
    t0 = time.perf_counter()
    counts, _ = cs.phase_z(torch, ops)
    print(f"rehearsal: Phase Z in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; launches {counts}", flush=True)


if __name__ == "__main__":
    main()
