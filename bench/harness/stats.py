"""Order statistics of raw samples."""
from __future__ import annotations

import math


def percentile(values, p: float) -> float:
    """Nearest-rank percentile over every sample: the smallest value with
    at least p% of the samples at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no samples")
    return xs[max(0, math.ceil(p / 100.0 * len(xs)) - 1)]
