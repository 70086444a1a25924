"""Host ms a step in the controller's partition (the port's
``pipeline.partition`` span: the decision core's classification, the
router's calls and their syncs included)."""
from bench.harness import program
from bench.harness.readers import per_step_ms

program.arm()


def read(rec):
    p = program.take(rec)
    return None if p is None else per_step_ms(
        p.seconds("pipeline.partition"), rec)
