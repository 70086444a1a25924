"""Ms a step in shadow drains: the controller's ``shadow/drain_seconds``
histogram, its total over the window (count and total only) a step."""
from bench.harness.readers import per_step_ms


def read(rec):
    s = rec.counters.get("drain_s")
    return None if s is None else per_step_ms(s, rec)
