"""What one run of a cell hands to the metric readers and the result
line."""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
from typing import Any

from bench.harness.probes import Spans


@dataclasses.dataclass
class Context:
    cell: Any                     # bench.harness.manifest.Cell
    seed: int
    seconds: float
    trace: bool
    device: Any                   # torch.device
    t0: float                     # perf_counter at process start
    max_steps: int | None = None  # tests: stop the window after N steps
    recorders: dict = dataclasses.field(default_factory=dict)

    def window_started(self) -> None:
        """Forget the kernel calls recorded in set-up, and leave set-up's
        objects out of the garbage collector's passes in the window, as a
        long-running server freezes the heap it builds at start-up."""
        for r in self.recorders.values():
            r.calls.clear()
        gc.collect()
        gc.freeze()

    def window_ended(self) -> dict:
        """Give set-up's objects back to the collector; the kernel calls
        the window recorded."""
        gc.unfreeze()
        return {k: list(r.calls) for k, r in self.recorders.items()}

    def measure(self, rec, stream, serve) -> None:
        """The window: set-up ends, the device is traced (``--trace 1``)
        while the stream's arrival loop hands its items to ``serve``."""
        from bench.harness.trace import DeviceTrace
        traced = DeviceTrace(self.device) if self.trace else None
        with traced or contextlib.nullcontext():
            self.window_started()
            rec.setup_s = time.perf_counter() - self.t0
            rec.t0_ns = time.perf_counter_ns()
            stream.loop(serve, rec, self.seconds, self.max_steps)
        rec.trace = traced
        rec.window_s = (rec.t1_ns - rec.t0_ns) / 1e9
        rec.kernel_calls = self.window_ended()

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Record:
    setup_s: float = 0.0
    window_s: float = 0.0
    steps: int = 0                # controller steps or engine calls
    requests: int = 0             # completed in the window
    attempted: int = 0
    failed: int = 0
    tokens: int = 0               # prompt + generated tokens completed
    latencies_ms: list = dataclasses.field(default_factory=list)
    spans: Spans = dataclasses.field(default_factory=Spans)
    t0_ns: int = 0                # the window on perf_counter_ns
    t1_ns: int = 0
    counters: dict = dataclasses.field(default_factory=dict)
    trace: Any = None             # DeviceTrace of the window, --trace 1
    kernel_calls: dict = dataclasses.field(default_factory=dict)
    flops: float = 0.0            # operations the window's work needs
    peak_dtype: str = "float32"
    memory_peak: int = 0
    checks: list = dataclasses.field(default_factory=list)  # (name, value, limit)
    notes: list = dataclasses.field(default_factory=list)
