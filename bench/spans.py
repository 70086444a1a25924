"""One traced run of a cell whose result line also carries
``program_breakdown``: the idle gaps by the innermost span, the
benchmark's or the port's, and the device time by the port's span that
launched it (:func:`bench.harness.program.breakdown`).

    python3 bench/spans.py --workload <cell> --seed <n> --seconds <s>

It is ``bench/run.py`` with ``--trace 1``, the port's tracer armed before
set-up whatever the cell's readers are.
"""
from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bench import run  # noqa: E402


def main(argv=None) -> int:
    from bench.harness import program
    plain = run.result

    def result(cell, rec, trace, info):
        out = plain(cell, rec, trace, info)
        if rec.trace is not None:
            checks = out.pop("checks")
            out["program_breakdown"] = program.breakdown(rec)
            out["checks"] = checks
        return out

    program.arm()
    run.result = result
    try:
        return run.main(list(sys.argv[1:] if argv is None else argv) +
                        ["--trace", "1"])
    finally:
        run.result = plain
        if program.tracer() is not None:
            program.tracer().disable()


if __name__ == "__main__":
    run._environment()
    import torch
    torch.set_num_threads(1)
    sys.exit(main())
