"""Device ms a call of the MoE layers' expert products: the device ops
launched inside the port's ``moe.experts`` spans (joined by their launch
records)."""
from bench.harness import program
from bench.harness.readers import per_step_ms

program.arm()


def read(rec):
    dev = program.device_by_span(rec)
    if dev is None or "moe.experts" not in dev:
        return None
    return per_step_ms(dev["moe.experts"], rec)
