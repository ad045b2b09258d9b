import numpy as np
import pytest

# NOTE: no XLA_FLAGS here — smoke tests must see the real (1-device) CPU;
# only launch/dryrun.py forces 512 host devices (per assignment brief).

# Property suites import hypothesis; hermetic containers can't pip-install
# it, so fall back to the bundled sampler (no-op when the real one exists).
from repro._compat.hypothesis_fallback import install as _install_hypothesis

_install_hypothesis()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xFB)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); "
        "skipped where torch.cuda.is_available() is false")
