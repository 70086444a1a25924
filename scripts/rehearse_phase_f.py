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


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import rar_system
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import memory_topk as mt
    from repro_torch.models import init_params

    torch.set_num_threads(2)
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
    ops._on_cuda = lambda t, *inputs: True
    _build.lib = lambda: None
    torch.cuda.synchronize = lambda *a, **kw: None

    cpu = torch.device("cpu")
    vocab, prompts, greqs, embs = cs.workload()
    tiers = (init_params(rar_system.WEAK, cs.SEEDS["weak"], device=cpu),
             init_params(rar_system.STRONG, cs.SEEDS["strong"], device=cpu))
    r_results = {}
    for mb in cs.MICROBATCHES:
        ctrl, outs, dt, _, _ = cs.serve_rar(cpu, tiers, None, mb, prompts,
                                            greqs, embs, vocab)
        r_results[f"R1_mb{mb}"] = dict(
            req_per_s=cs.PASSES * cs.POOL / dt, ctrl=ctrl,
            outcomes=[dataclasses.astuple(o) for o in outs])
    t0 = time.perf_counter()
    counts, _ = cs.phase_f(torch, ops, tiers, r_results)
    print(f"rehearsal: Phase F in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; launches {counts}", flush=True)


if __name__ == "__main__":
    main()
