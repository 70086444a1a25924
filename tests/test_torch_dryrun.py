"""The port's dry run (``python -m repro_torch.launch.dryrun``): the twin
of ``tests/test_dryrun.py``.

The reference's six pairs run through the CLI, each pair a subprocess of
its own (the training pair beside the five others): each record is
``ok``, with FLOPs per device above 0 and the dominant term named
(whisper-medium ``train_4k``, which the JAX package fails on its sharding
constraint, runs too). For llama3-8b
``decode_32k`` and olmoe-1b-7b ``prefill_32k`` the FLOPs counted per
device are within [0.5, 2] of the analytic ``flops_per_device`` (bounds
fixed before the first run). ``make_train_step(batch_axes=...)`` on a
DTensor batch over the debug mesh (four gloo ranks on the CPU) gives the
plain step's metrics within 1e-5 relative.
"""
import _torch_threads  # noqa: F401  (a worker's share of the cores)
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = [
    ("llama3-8b", "decode_32k", False),
    ("llama3-8b", "decode_32k", True),          # multi-pod
    ("mamba2-2.7b", "long_500k", False),
    ("olmoe-1b-7b", "prefill_32k", False),
    ("recurrentgemma-2b", "decode_32k", False),
    ("whisper-medium", "train_4k", False),
]
FLOP_BOUNDS = {("llama3-8b", "decode_32k"): (0.5, 2.0),
               ("olmoe-1b-7b", "prefill_32k"): (0.5, 2.0)}


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")


def _cli(arch, shape, mp, out, cwd):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, "--shape", shape, "--out", str(out)]
    return subprocess.Popen(cmd + (["--multi-pod"] if mp else []),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=_env(), cwd=cwd)


def _done(p):
    text, _ = p.communicate(timeout=900)
    assert p.returncode == 0, text[-3000:]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """{(arch, shape, multi_pod): record} of the six pairs, each run by
    the CLI in a process of its own: the training pair (the longest) in
    one, beside it the five others one after another."""
    d = tmp_path_factory.mktemp("dryrun")
    outs = [d / f"dr{i}.json" for i in range(len(CASES))]
    longest = _cli(*CASES[-1], outs[-1], d)
    for case, out in zip(CASES[:-1], outs):
        _done(_cli(*case, out, d))
    _done(longest)
    recs = {}
    for out in outs:
        for r in json.loads(out.read_text()):
            recs[(r["arch"], r["shape"], r["multi_pod"])] = r
    return recs


@pytest.mark.parametrize("arch,shape,mp", CASES)
def test_dryrun_pair_runs(arch, shape, mp, records):
    rec = records[(arch, shape, mp)]
    assert rec["status"] == "ok", rec
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert rec["kind"] == {"decode_32k": "decode", "long_500k": "decode",
                           "prefill_32k": "prefill",
                           "train_4k": "train"}[shape]
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["fits"] == (rec["memory"]["argument_bytes"]
                                     <= 80e9)
    assert rec["analytic"]["compute_s"] == \
        rec["analytic"]["flops_per_device"] / 989e12
    lo, hi = FLOP_BOUNDS.get((arch, shape), (0.0, float("inf")))
    ratio = roof["flops_per_device"] / rec["analytic"]["flops_per_device"]
    assert lo <= ratio <= hi, ratio


def test_multi_pod_halves_the_decode_work(records):
    one = records[("llama3-8b", "decode_32k", False)]
    two = records[("llama3-8b", "decode_32k", True)]
    assert two["roofline"]["flops_per_device"] == pytest.approx(
        one["roofline"]["flops_per_device"] / 2, rel=0.05)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_batch_axes_on_a_dtensor_batch_equals_the_plain_step(tmp_path):
    out = tmp_path / "ba.json"
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "_torch_batch_axes_worker.py"),
         str(r), "4", str(port), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env()) for r in range(4)]
    for p in procs:
        text, _ = p.communicate(timeout=300)
        assert p.returncode == 0, text[-3000:]
    res = json.loads(out.read_text())
    assert res["placements"] == ["S(0)", "R"]
    assert sorted(res["dtensor"]) == sorted(res["plain"])
    for k, want in res["plain"].items():
        got = res["dtensor"][k]
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-6), (k, got, want)
