"""Put the checkout (for ``bench``) and ``src`` (for the measured package)
on the path of the benchmark's tests, and size torch's thread pool to one
pytest-xdist worker's share of the cores (outside xdist: unchanged)."""
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 0:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
