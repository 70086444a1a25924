"""The device trace of a measured window (``torch.profiler``, device
activity only, read from the profiler in memory) and its reduction: busy time as the union
of the card's kernel, copy and memset intervals, device time by kernel
name, and the idle gaps by the host span they fell in.

``union_us`` is ``chip_smoke.py``'s arithmetic, copied here so that the
yardstick stays with the benchmark."""
from __future__ import annotations

import bisect
import time


def union_us(intervals) -> float:
    """Microseconds covered by the (start, end) ``intervals``."""
    busy, end = 0.0, float("-inf")
    for s, t in sorted(intervals):
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy


def short(name: str) -> str:
    """A device op's name without its return type, namespace and
    arguments."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:80] or name[:80]


class DeviceTrace:
    """Profile the card over a ``with`` block. After it: ``events``
    (name, start_us, end_us) on the wall clock, ``t0_us``/``t1_us``
    the block's bounds, ``busy_s`` and ``window_s``."""

    def __init__(self, device):
        self.device = device
        self.events: list[tuple[str, float, float]] = []

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._sync()
        # the CPU's own ops stand in for a card's in the tests on the CPU
        act = (ProfilerActivity.CUDA if self.device.type == "cuda"
               else ProfilerActivity.CPU)
        self.prof = profile(activities=[act])
        self.prof.__enter__()
        self.t0_us = time.time_ns() / 1e3
        return self

    def __exit__(self, *exc):
        self._sync()
        self.t1_us = time.time_ns() / 1e3
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.events = self._read()

    def _read(self):
        from torch.autograd import DeviceType
        kind = (DeviceType.CUDA if self.device.type == "cuda"
                else DeviceType.CPU)
        return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                for e in self.prof.profiler.kineto_results.events()
                if e.device_type() == kind and e.duration_ns() > 0]

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    @property
    def busy_s(self) -> float:
        return union_us((max(s, self.t0_us), min(t, self.t1_us))
                        for _, s, t in self.events
                        if t > self.t0_us and s < self.t1_us) / 1e6

    def device_s(self, match) -> float:
        """Device seconds of the events whose name ``match`` accepts."""
        return sum(t - s for n, s, t in self.events if match(n)) / 1e6

    def matching(self, match) -> list:
        return [(n, s, t) for n, s, t in sorted(self.events,
                                                key=lambda e: e[1])
                if match(n)]

    def breakdown(self, spans=None) -> dict:
        """The ten device ops that took most time, and the ten host spans
        in which the card sat idle longest (seconds each)."""
        by_name: dict[str, float] = {}
        for n, s, t in self.events:
            by_name[short(n)] = by_name.get(short(n), 0.0) + (t - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps: dict[str, float] = {}
        marks = [] if spans is None else sorted(
            ((a + spans.wall_offset) / 1e3, (b + spans.wall_offset) / 1e3, n)
            for n, a, b in spans.events)
        starts = [a for a, _, _ in marks]
        end = self.t0_us
        ivs = sorted((s, t) for _, s, t in self.events)
        for s, t in ivs + [(self.t1_us, self.t1_us)]:
            if s > end:
                j = bisect.bisect_right(starts, (s + end) / 2) - 1
                who = (marks[j][2] if j >= 0 and (s + end) / 2 < marks[j][1]
                       else "host outside the benchmark's spans")
                gaps[who] = gaps.get(who, 0.0) + (min(s, self.t1_us) -
                                                  end) / 1e6
            end = max(end, t)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}
