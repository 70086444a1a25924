"""Host ms a step in which the FM tiers' engines issue their kernels: the
port's ``engine.call`` spans less their ``engine.fetch`` children."""
from bench.harness import program
from bench.harness.readers import per_step_ms

program.arm()


def read(rec):
    p = program.take(rec)
    return None if p is None else per_step_ms(
        p.self_seconds("engine.call", "engine.fetch"), rec)
