"""``lm_closed``: one caller in a closed loop of prefill calls. A call
holds prompts of one length, as many as fit ``tokens_per_call``, ids drawn
uniformly over the vocabulary; ``max_new`` tokens are generated.

The lengths follow a log-normal (``length``: ``median``, ``sigma``) cut to
[``min``, ``max``] and rounded to a multiple of ``step``: a cycle of
``cycle`` calls takes the distribution's quantiles at (i + 1/2) / cycle,
served in bit-reversed order of length, so that any run of calls mixes
short and long ones. Each seed starts the cycle at its own place and
draws its own ids; every seed serves the same lengths. Set-up serves one
call of each shape, the longest first."""
from __future__ import annotations

import math
import statistics

import numpy as np

from bench.harness.traffic import closed_loop


def cycle_lengths(spec: dict) -> list[int]:
    """The lengths of one cycle, in the order served."""
    n = spec["cycle"]
    z = statistics.NormalDist()
    step = spec["step"]
    out = []
    for i in range(n):
        x = spec["median"] * math.exp(spec["sigma"] * z.inv_cdf((i + .5) / n))
        out.append(int(min(spec["max"], max(spec["min"],
                                            round(x / step) * step))))
    out.sort()
    bits = max(1, (n - 1).bit_length())
    order = sorted(range(n), key=lambda i: int(
        format(i, f"0{bits}b")[::-1], 2))
    return [out[i] for i in order]


class Stream:
    def __init__(self, traffic: dict, config: dict, seed: int):
        self.budget = traffic["tokens_per_call"]
        self.max_new = traffic["max_new"]
        self.V = config["model"]["vocab_size"]
        self.lengths = cycle_lengths(traffic["length"])
        self.rng = np.random.default_rng(seed)
        self.at = int(self.rng.integers(0, len(self.lengths)))

    def shape(self, length: int) -> tuple[int, int]:
        return max(1, self.budget // length), length

    def draw(self, length: int) -> np.ndarray:
        return self.rng.integers(0, self.V, self.shape(length), np.int64)

    def next(self) -> np.ndarray:
        """The prompts of the next call (B, S)."""
        length = self.lengths[self.at % len(self.lengths)]
        self.at += 1
        return self.draw(length)

    def warmup_items(self):
        return [self.draw(s) for s in sorted(set(self.lengths), reverse=True)]

    def loop(self, serve, rec, seconds, max_steps=None):
        closed_loop(self, serve, rec, seconds, max_steps)
