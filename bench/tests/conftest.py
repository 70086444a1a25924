"""Loading a reader of the port's spans arms the port's tracer (see
``bench.harness.program``); a test that loads readers without reading
them leaves it on. Turn it off after each test of the benchmark, so that
no later test in the process runs traced."""
import _bench_path  # noqa: F401
import pytest


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    from bench.harness import program
    t = program.tracer()
    if t is not None:
        t.disable()
        t.collect()
