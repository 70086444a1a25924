"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and metric readers are found by the
names ``BENCHMARK.json`` gives them. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a run traced
by ``torch.profiler``. The last lines of standard error, and the
``checks`` key that closes the result line, give every number compared
with the plain reference beside its limit. Needs as many CUDA cards as
the cell asks for; without them it exits 2 and prints no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SCRATCH = ROOT / "build" / "bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Fixed cache directories inside the checkout, the package on the
    path, and no JAX pulled in by a library."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(SCRATCH / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(SCRATCH / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def loaded_forbidden(modules) -> list[str]:
    """Forbidden top-level names among ``modules``, each compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def result(cell, rec, trace: bool, device_info: dict) -> dict:
    from bench.harness.checks import passed
    from bench.harness.manifest import load_module
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_module("metrics", m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=int(rec.memory_peak))
    out = {"correct": bool(passed(rec.checks) and rec.failed == 0),
           "attempted": rec.attempted, "failed": rec.failed,
           "metrics": metrics, "device": device}
    if trace and rec.trace is not None:
        device["busy_s"] = rec.trace.busy_s
        device["window_s"] = rec.trace.window_s
        out["breakdown"] = rec.trace.breakdown(rec.spans)
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rec.checks}
    return out


def main(argv=None, device=None, cell=None, max_steps=None,
         preloaded=frozenset()) -> int:
    """One run; returns the exit code. ``device``, ``cell`` and
    ``max_steps`` let a test drive the run on the CPU with a cell of its
    own; ``preloaded`` names the modules its process loaded before the
    run, which the forbidden-module check leaves out."""
    args = parse(argv)
    import torch

    from bench.harness.manifest import Cell, load_module
    from bench.harness.probes import CallRecorder
    from bench.harness.record import Context
    cell = cell or Cell(args.workload)
    info = {"platform": "gpu", "count": cell.chips}
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA card(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        info["kind"] = torch.cuda.get_device_name(0)
    else:
        info = {"platform": device.type, "kind": device.type, "count": 1}
    driver = importlib.import_module(f"bench.drivers.{cell.config['system']}")
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  trace=bool(args.trace), device=device, t0=T0,
                  max_steps=max_steps)
    recorders = {}
    if args.trace:
        for m in cell.per_layer:
            kernel = getattr(load_module("metrics", m["name"]), "KERNEL", None)
            if kernel and kernel not in recorders:
                k = load_module("kernels", kernel)
                recorders[kernel] = CallRecorder(
                    importlib.import_module(k.OPS[0]), k.OPS[1], k.shape)
    ctx.recorders = recorders
    with contextlib.ExitStack() as stack:
        for r in recorders.values():
            stack.enter_context(r)
        rec = driver.run(ctx)
    out = result(cell, rec, bool(args.trace), info)
    found = loaded_forbidden(m for m in list(sys.modules)
                             if m not in preloaded)
    if found:
        print(f"modules of the reference package or JAX loaded: {found}",
              file=sys.stderr)
        return 3
    for note in rec.notes:
        print(f"note: {note}", file=sys.stderr)
    print("counters: " + json.dumps(rec.counters), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    _environment()
    import torch
    # one host thread for torch's own CPU work: the load of one process
    # with few threads, so the host-paced cells spread less
    torch.set_num_threads(1)
    sys.exit(main())
