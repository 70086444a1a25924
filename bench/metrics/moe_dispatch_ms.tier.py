"""Device ms a call of the MoE layers' routing, dispatch and combine: the
device ops launched inside the port's ``moe.route``, ``moe.dispatch`` and
``moe.combine`` spans (joined by their launch records)."""
from bench.harness import program
from bench.harness.readers import per_step_ms

program.arm()

SPANS = ("moe.route", "moe.dispatch", "moe.combine")


def read(rec):
    dev = program.device_by_span(rec)
    if dev is None or not any(n in dev for n in SPANS):
        return None
    return per_step_ms(sum(dev.get(n, 0.0) for n in SPANS), rec)
