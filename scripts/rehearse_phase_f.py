"""Rehearse ``chip_smoke.py`` Phase F (F1-F4, the serving fabrics) on the
CPU, before spending time on the card.

    PYTHONPATH=src python scripts/rehearse_phase_f.py

The kernels' CUDA wrappers are replaced by their plain versions, wrapped
to count launches as the wrappers do (the stream a launch is noted on is
the calling thread), dispatch sends every tensor to them, and the card's
synchronizations are no-ops. R1 (``serve_rar`` at microbatch 8 and 32 on
the CPU) is the reference, as on the card. Spawned workers import the real
wrappers and run the plain versions, so their launch counts stay empty
here: the workers' launch check is the card's. The rates printed are this
host's CPU, not the card's. Takes ~1-2 min.
"""
from __future__ import annotations

import dataclasses
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def patch_for_cpu(all_kernels: bool = False) -> None:
    """Run ``chip_smoke`` on the CPU: ``DEV`` is the CPU, the CUDA wrappers
    (the store read's, flash's and decode's; with ``all_kernels`` also
    top-1's, the route's and the candidate read's) become their plain
    versions counting launches, dispatch sends every tensor to them, the
    card's synchronizations are no-ops; with ``all_kernels`` the CUDA-event
    timer runs its function once on the host clock and the profiler's
    runs it once and measures nothing."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import memory_ivf as ivf
    from repro_torch.kernels import memory_topk as mt

    cs.DEV = "cpu"

    def stand_in(mod, attr, plain, name, kernel):
        def launch(*a, **kw):
            with _build.COUNT_LOCK:
                setattr(mod, attr, getattr(mod, attr) + 1)
                _build.note_stream(kernel, threading.get_ident())
            return plain(*a, **kw)
        setattr(mod, name, launch)

    stand_in(mt, "launches", mt.memory_topk_batch_padded_plain,
             "memory_topk_batch_padded_cuda", "memory_topk")
    stand_in(fa, "launches", fa.flash_attention_plain,
             "flash_attention_cuda", "flash_attention")
    stand_in(da, "launches", da.decode_attention_plain,
             "decode_attention_cuda", "decode_attention")
    if all_kernels:
        stand_in(mt, "top1_launches", mt.memory_top1_batch_padded_plain,
                 "memory_top1_batch_padded_cuda", "memory_top1")
        stand_in(ivf, "launches", ivf.ivf_route_batch_padded_plain,
                 "ivf_route_batch_padded_cuda", "ivf_route")
        stand_in(ivf, "scan_launches", ivf.ivf_scan_batch_plain,
                 "ivf_scan_batch_cuda", "ivf_scan")
        def host_ms(torch, fn, **kw):
            t0 = time.perf_counter()
            fn()
            return (time.perf_counter() - t0) * 1e3
        cs.time_ms = host_ms
        cs.device_ms = lambda torch, fn, tag, **kw: (fn(), (None, []))[1]
        torch.cuda.empty_cache = lambda: None
    ops._on_cuda = lambda t, *inputs: True
    _build.lib = lambda: None
    torch.cuda.synchronize = lambda *a, **kw: None


def r1(torch, cs, tiers):
    """R1 at microbatch 8 and 32 on the CPU, as Phase R keeps it."""
    vocab, prompts, greqs, embs = cs.workload()
    cpu = torch.device("cpu")
    r_results = {}
    for mb in cs.MICROBATCHES:
        ctrl, outs, dt, _, _ = cs.serve_rar(cpu, tiers, None, mb, prompts,
                                            greqs, embs, vocab)
        r_results[f"R1_mb{mb}"] = dict(
            req_per_s=cs.PASSES * cs.POOL / dt, ctrl=ctrl,
            outcomes=[dataclasses.astuple(o) for o in outs])
    return r_results


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import rar_system
    from repro_torch.kernels import ops
    from repro_torch.models import init_params

    torch.set_num_threads(2)
    patch_for_cpu()
    cpu = torch.device("cpu")
    tiers = (init_params(rar_system.WEAK, cs.SEEDS["weak"], device=cpu),
             init_params(rar_system.STRONG, cs.SEEDS["strong"], device=cpu))
    r_results = r1(torch, cs, tiers)
    t0 = time.perf_counter()
    counts, _ = cs.phase_f(torch, ops, tiers, r_results)
    print(f"rehearsal: Phase F in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; launches {counts}", flush=True)


if __name__ == "__main__":
    main()
