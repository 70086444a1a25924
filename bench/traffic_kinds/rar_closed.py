"""``rar_closed``: ``microbatch`` callers in a closed loop; each step hands
the controller ``microbatch`` fresh questions, each a domain drawn
uniformly, then one of its skills and an operand uniformly (the draws of
``TaskSuite.question_pool``); set-up serves ``warmup_steps`` steps of the
same stream first."""
from __future__ import annotations

import numpy as np

from bench.harness.traffic import closed_loop


class Stream:
    def __init__(self, traffic: dict, config: dict, seed: int, universe):
        self.B = traffic["microbatch"]
        self.warmup = traffic["warmup_steps"]
        self.u = universe
        self.rng = np.random.default_rng(seed)
        self._buf: list[np.ndarray] = []

    def next(self) -> np.ndarray:
        """Question ids of the next step (B,)."""
        if not self._buf:
            n = 64 * self.B
            d = self.rng.integers(0, len(self.u.skills), n)
            j = self.rng.integers(0, self.u.per_domain, n)
            x = self.rng.integers(0, self.u.n_operands, n)
            self._buf = list(self.u.qid(d, j, x).reshape(64, self.B))[::-1]
        return self._buf.pop()

    def warmup_items(self):
        return [self.next() for _ in range(self.warmup)]

    def loop(self, serve, rec, seconds, max_steps=None):
        closed_loop(self, serve, rec, seconds, max_steps)
