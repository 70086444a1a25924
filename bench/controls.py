"""The controls of the compared numbers: the plain reference put in the
measured system's place, one precision below the configuration's (TF32
below float32, fp8 below bfloat16), judged exactly as a run is. Every
limit in ``limits/`` lies below what these read (``PERF.md`` gives both
readings of each limit).

    python3 bench/controls.py --workload <cell> --seeds 1 2 3 [--steps N]

prints one JSON line a seed. Not part of a benchmark run. ``--steps``
(RAR cells): the window's steps after the warm-up, as many as a run of
the cell serves.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def rar_control(cell, seed: int, steps: int, device) -> dict:
    import torch

    from bench.drivers.rar import filler_chunks
    from bench.harness import traffic as htraffic
    from bench.harness.manifest import ROOT as R
    from bench.reference import npz, numerics, plain_lm, plain_rar
    from bench.reference.tasks import Universe
    cfg = cell.config
    u = Universe(cfg)
    stream = htraffic.make(cell.traffic, cfg, seed, universe=u)
    qids = [stream.next() for _ in range(stream.warmup + steps)]
    params = npz.load(R / cfg["weights"]["file"], device=device)
    k1 = cfg["rar"]["retrieval_k"] + 1
    toks = torch.as_tensor(u.padded(), device=device)

    def controller(cast):
        e = plain_lm.embed(cfg["embedder"], params["embedder"], toks,
                           pad=cfg["vocab"]["PAD"], cast=cast)
        table = plain_rar.filler_top(e, filler_chunks(cfg, seed, device), k1,
                                     cast=cast)
        return plain_rar.PlainRAR(cfg, params, u, e, table, device,
                                  cast=cast)

    with numerics.exact_f32(), torch.no_grad():
        low = controller(numerics.tf32)
        logs = [low.process_batch(q) for q in qids]
        ref = controller(numerics.f32)
        try:
            for q, log in zip(qids, logs):
                ref.process_batch(q, forced=log)
            ref.compare_store(low.learned_rows())
        except plain_rar.Diverged as e:
            ref.checks.note(str(e))
    out = ref.checks.numbers()
    out["strong_calls_diff"] = abs(low.strong_calls - ref.strong_calls)
    out["notes"] = ref.checks.notes
    return out


def lm_control(cell, seed: int, device) -> dict:
    from bench.drivers.lm import compare, sample
    from bench.harness import traffic as htraffic
    from bench.harness import weights
    from bench.reference import numerics
    model = cell.config["model"]
    params = weights.lm_params(model, seed, device)
    stream = htraffic.make(cell.traffic, cell.config, seed)
    rows = [r for _ in stream.lengths for r in stream.next()]
    pick = sample([len(r) for r in rows], cell.config["check"][
        "sample_prompts"], seed)
    return compare(model, params, [rows[i] for i in pick], None, None,
                   cast=numerics.fp8)


def main(argv=None, device=None, cell=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--steps", type=int, default=400)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from bench.harness.manifest import Cell
    cell = cell or Cell(args.workload)
    device = device or torch.device("cuda", 0)
    for seed in args.seeds:
        if cell.config["system"] == "rar":
            out = rar_control(cell, seed, args.steps, device)
        else:
            out = lm_control(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": out}), flush=True)


if __name__ == "__main__":
    main()
