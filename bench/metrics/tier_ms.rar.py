"""Host ms a step in the FM tiers (the benchmark's spans around each
engine sweep of both tiers, which end on the host)."""
from bench.harness.readers import span_ms


def read(rec):
    return span_ms(rec, "tier.weak", "tier.strong")
