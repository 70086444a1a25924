"""Host ms a step in the embedder (the benchmark's span around the
injected ``embed_batch_fn``, which ends on the host)."""
from bench.harness.readers import span_ms


def read(rec):
    return span_ms(rec, "embedder")
