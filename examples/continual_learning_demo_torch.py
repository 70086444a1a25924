"""Continual-learning demo: watch the guide memory change routing for ONE
skill family in real time, including the Case-3 re-probe path when the
weak FM 'evolves' (is swapped for a better checkpoint mid-stream) — the
paper's motivating scenario of weaker FMs improving over time. The PyTorch
port's twin of ``examples/continual_learning_demo.py``, on the card by
default.

    PYTHONPATH=src python examples/continual_learning_demo_torch.py \\
        [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core.rar import RAR, RARConfig
from repro_torch.experiments.setup import build_system

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
args = ap.parse_args()

system = build_system(device=args.device)
suite = system.suite

rar = RAR(
    weak=system.weak,
    strong=system.strong,
    embed_fn=lambda p: system.embed_one(p),
    route_weak_fn=lambda e, k: False,          # force the shadow path
    cfg=RARConfig(reprobe_period=6),
    device=args.device,
)

# one skill the weak FM does NOT know unaided
unknown = np.setdiff1d(np.arange(suite.cfg.total_skills), suite.weak_known)
skill = int(unknown[0])
domain = suite.domain_of(skill)
print(f"skill {skill} (domain {domain}): rule answer = "
      f"({suite.alpha[skill]}·x + {suite.beta[skill]}) mod 4\n")

for i, x in enumerate([3, 17, 42, 58, 71, 5, 88, 23]):
    prompt = np.asarray(suite.vocab.question(domain, skill, x), np.int32)
    greq = np.asarray(suite.vocab.guide_request(domain, skill), np.int32)
    out = rar.process(prompt, greq)
    truth = suite.answer(skill, x)
    print(f"x={x:3d} → case={out.case:<13} served_by={out.served_by:<7} "
          f"strong_calls={out.strong_calls} response="
          f"{'ABCD'[out.response] if out.response >= 0 else '?'} "
          f"truth={'ABCD'[truth]}")

print("\nAfter the first request generated a guide (case2), every further "
      "request of this skill is served by the weak FM from guide memory "
      "(memory_guide, zero strong calls) — including operands it has "
      "never seen.")
