"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``),
metric readers (``metrics/<metric>.py``) and kernel counts
(``kernels/<kernel>.py``), each found by its name."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``bench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Cell:
    """One entry of ``workloads`` with everything it names; ``overrides``
    (tests) replaces keys of the configuration and of the traffic."""

    def __init__(self, name: str, manifest: dict | None = None,
                 config: dict | None = None, traffic: dict | None = None):
        m = manifest if manifest is not None else load_json(
            ROOT / "BENCHMARK.json")
        by_name = {w["name"]: w for w in m["workloads"]}
        if name not in by_name:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(by_name)})")
        self.name = name
        self.workload = by_name[name]
        conf = {c["name"]: c for c in m["configs"]}[self.workload["config"]]
        self.config = load_json(ROOT / conf["file"])
        self.traffic = load_json(BENCH / "traffic" /
                                 f"{self.workload['traffic']}.json")
        self.config.update(config or {})
        self.traffic.update(traffic or {})
        self.chips = self.workload["chips"]
        self.end_to_end = [x for x in m["end_to_end"] if _applies(x, name)]
        self.per_layer = [x for x in m["per_layer"] if _applies(x, name)]
