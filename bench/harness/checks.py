"""The numbers a run compares against its plain reference, each beside
its limit (``limits/<workload>.json``)."""
from __future__ import annotations

from bench.harness.manifest import BENCH, load_json


def held(workload: str, numbers: dict) -> list[tuple[str, float, float]]:
    """(name, value, limit) for every number the cell's limits name; a
    number the run could not produce reads as infinite."""
    limits = load_json(BENCH / "limits" / f"{workload}.json")
    return [(name, float(numbers.get(name, float("inf"))), float(lim))
            for name, lim in limits.items()]


def passed(checks) -> bool:
    return all(v <= lim for _, v, lim in checks)
