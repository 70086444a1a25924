import os

import numpy as np
import pytest

# NOTE: no XLA_FLAGS here — smoke tests and benches must see 1 device;
# only repro.launch.dryrun forces 512 placeholder devices (in-process).

os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Pin the hypothesis profile for reproducibility: CI runs with
# HYPOTHESIS_PROFILE=ci (derandomized — the property sweeps, incl. the
# pallas/ref top-k parity suite, must not flake on a lucky draw; a failure
# reproduces exactly). Without the real library the _hyp shim is already
# deterministic (fixed rng seed per test).
try:                                     # pragma: no cover - env dependent
    from hypothesis import settings as _hyp_settings

    _hyp_settings.register_profile("ci", derandomize=True, deadline=None,
                                   max_examples=30)
    _hyp_settings.register_profile("dev", deadline=None)
    _hyp_settings.load_profile(os.environ.get("HYPOTHESIS_PROFILE", "dev"))
except ImportError:
    pass


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_addoption(parser):
    parser.addoption("--skip-slow", action="store_true",
                     default=bool(os.environ.get("REPRO_FAST")),
                     help="skip slow integration tests (trained RAR "
                          "system, subprocess dry-runs)")
    parser.addoption("--run-slow", action="store_true", default=False,
                     help="deprecated no-op (slow tests run by default)")


def pytest_collection_modifyitems(config, items):
    if not config.getoption("--skip-slow"):
        return
    skip = pytest.mark.skip(reason="slow; skipped via --skip-slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips "
                            "without one")
