"""The traffic generator. A mix is a data file (``traffic/<name>.json``)
whose ``kind`` names the stream that reads it: ``traffic_kinds/<kind>.py``,
found by that name as metrics and kernels are. Its ``Stream`` takes the
mix's other keys as parameters, draws every request from the seed (every
seed gives the same sizes and arrivals, in another order), lists what
set-up serves (``warmup_items``) and owns the window's arrival loop
(``loop``). A driver hands it ``serve(item) -> requests completed``."""
from __future__ import annotations

import time

from bench.harness.manifest import load_module


def make(traffic: dict, config: dict, seed: int, **kw):
    kind = load_module("traffic_kinds", traffic["kind"])
    return kind.Stream(traffic, config, seed, **kw)


def closed_loop(stream, serve, rec, seconds: float, max_steps=None) -> None:
    """Callers in a closed loop: the next item goes in as soon as the last
    is back, and each of its requests waits the item's round trip. Stops
    at the first item back ``seconds`` after ``rec.t0_ns`` (or after
    ``max_steps`` items)."""
    while True:
        item = stream.next()
        t0 = time.perf_counter_ns()
        n = serve(item)
        t1 = time.perf_counter_ns()
        rec.latencies_ms += [(t1 - t0) / 1e6] * n
        rec.steps += 1
        if (t1 - rec.t0_ns) / 1e9 >= seconds or rec.steps == max_steps:
            break
    rec.t1_ns = t1
