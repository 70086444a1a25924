"""Quickstart: the RAR public API in ~60 lines — the PyTorch port's twin of
``examples/quickstart.py``, on the card by default.

Builds (or loads) the trained layered system — weak FM, strong FM,
embedder, static router — wires up the RAR controller, and serves a few
requests, printing the routing decision and cost for each.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.rar import RAR, RARConfig
from repro_torch.experiments.setup import build_system, failing_pool

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
args = ap.parse_args()

# 1. A trained layered FM system (cached under .cache/rar_system_torch).
system = build_system(device=args.device)
suite = system.suite

# 2. The RAR controller: weak + strong tiers, embedder, static router.
rar = RAR(
    weak=system.weak,
    strong=system.strong,
    embed_fn=lambda prompt: system.embed_one(prompt),
    route_weak_fn=lambda emb, key: system.router.route_weak(emb),
    cfg=RARConfig(sim_threshold=0.2, guide_sim_threshold=0.2,
                  reprobe_period=1000),
    device=args.device,
)

# 3. Serve requests the weak FM can't handle alone. Repeats of a skill
#    should migrate from the strong FM to guided weak-FM serving.
pool = failing_pool(system, domain=0, n=20)
print(f"{'case':<14} {'served_by':<9} {'strong_calls':<12} guide_source")
for repeat in range(2):
    print(f"--- pass {repeat + 1} over the same 20 requests ---")
    for d, s, x in pool:
        prompt = np.asarray(suite.vocab.question(d, s, x), np.int32)
        greq = np.asarray(suite.vocab.guide_request(d, s), np.int32)
        out = rar.process(prompt, greq)
        print(f"{out.case:<14} {out.served_by:<9} {out.strong_calls:<12} "
              f"{out.guide_source or '-'}")

print(f"\nweak-FM calls: {system.weak.calls}, strong-FM calls: "
      f"{system.strong.calls}")
print(f"guide memory entries: {rar.memory.size_fast}")
print("Pass 2 should show memory_guide / memory_skill cases with zero "
      "strong calls — that's RAR's continual cost reduction.")
