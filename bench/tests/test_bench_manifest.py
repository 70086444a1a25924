"""``BENCHMARK.json`` resolves by name to the files of the benchmark, and
keeps to the benchmark file's format."""
import json
import re

import _bench_path  # noqa: F401
import pytest

from bench.harness.manifest import BENCH, ROOT, Cell, load_module

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert all((ROOT / p).is_dir() for p in MANIFEST["paths"])
    assert MANIFEST["command"] == ["python3", "bench/run.py"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    n = len(MANIFEST["workloads"])
    assert 1 <= n <= 24 and 1 <= len(MANIFEST["configs"]) <= 24
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, n // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    for group in (MANIFEST["configs"], MANIFEST["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(set(names)) == len(names)
        assert all(NAME.match(x) for x in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
        assert "\t" not in x["why"]
    for m in MANIFEST["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in MANIFEST["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_end_to_end_bounds():
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in MANIFEST["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_by_name(cell):
    c = Cell(cell)
    assert (BENCH / "drivers" / f"{c.config['system']}.py").exists()
    assert (BENCH / "limits" / f"{cell}.json").exists()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert callable(load_module("metrics", m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])
        kernel = getattr(load_module("metrics", m["name"]), "KERNEL", None)
        if kernel:
            k = load_module("kernels", kernel)
            assert callable(k.flops) and callable(k.bytes_moved)


def test_configs_are_files_under_paths():
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("bench/configs/")
        assert json.loads((ROOT / c["file"]).read_text())
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16


def test_per_layer_workloads_name_cells():
    for m in MANIFEST["per_layer"]:
        assert set(m["workloads"]) <= set(CELLS)


def test_unknown_workload_exits():
    with pytest.raises(SystemExit):
        Cell("no.such.cell")


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_kind_resolves_by_name(cell):
    c = Cell(cell)
    kind = load_module("traffic_kinds", c.traffic["kind"])
    assert callable(kind.Stream.loop) and callable(kind.Stream.warmup_items)


def test_lm_lengths_are_the_same_on_every_seed():
    from bench.traffic_kinds import lm_closed
    c = Cell([w for w in CELLS if w.startswith("olmoe")][0])
    a, b = (lm_closed.Stream(c.traffic, c.config, s) for s in (1, 2 ** 31 + 7))
    la = [a.next().shape for _ in a.lengths]
    lb = [b.next().shape for _ in b.lengths]
    assert sorted(la) == sorted(lb) and la != lb
    assert {s for _, s in la} == {512, 1024, 1536, 2048, 2560, 3584, 4096}
    assert all(B * S <= c.traffic["tokens_per_call"] for B, S in la)
