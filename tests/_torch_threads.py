"""torch's intra-op thread pool sized to one pytest-xdist worker's share of
the host's cores.

Each worker process is a torch process of its own, and torch sizes its
pool to every core of the host: six workers each spinning a pool of all
the cores oversubscribe them, and small-op tests slow down by tens of
times (``tests/test_torch_store_scan_design.py``: 39 s alone, ~1560 s
beside five workers and two JAX trainings on an 8-core host). Importing
this module sets the pool to ``cores // workers`` (at least 1) in a
worker; outside xdist it changes nothing. The port's test files import
it; torch's pool is per process, so the first import in a worker sets it
for the worker."""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 0:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
