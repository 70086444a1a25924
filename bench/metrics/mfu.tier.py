"""Operations the window's calls need (2 per active weight per token,
causal attention, the output head at the positions whose logits are
computed) over the traced window at the bf16 peak (%)."""
from bench.harness.readers import mfu


def read(rec):
    return mfu(rec)
