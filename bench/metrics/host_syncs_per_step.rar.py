"""Host syncs a step: every ``host_sync.*`` count of the port's tracer (each
call where the host waits for the card: a fetch, a blocking upload, a
``bool`` of a device tensor) over the window's steps."""
from bench.harness import program

program.arm()


def read(rec):
    p = program.take(rec)
    return None if p is None or not rec.steps else \
        p.count("host_sync.") / rec.steps
