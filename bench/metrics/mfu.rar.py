"""Operations the window's steps need (embedder, both tiers at 2 per
weight per token plus attention, the store scans) over the traced window
at the float32 peak (%)."""
from bench.harness.readers import mfu


def read(rec):
    return mfu(rec)
