"""Share of the traced window in which no kernel, copy or memset ran (%)."""
from bench.harness.readers import idle_share


def read(rec):
    return idle_share(rec)
