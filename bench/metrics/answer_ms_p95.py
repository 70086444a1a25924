"""The 95th percentile of every request's latency in the window (host
clock, raw samples): from the hand-over of its call's prompts until the
call's tokens are on the host."""
from bench.harness.stats import percentile


def read(rec):
    return percentile(rec.latencies_ms, 95) if rec.latencies_ms else None
