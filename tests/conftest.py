import os

# keep the default single CPU device for tests (the dry-run subprocess test
# sets its own device count via REPRO_DRYRUN_DEVICES)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Drop jax's global jit/pjit caches after each test module.

    The suite compiles hundreds of executables across modules (serving
    engines alone warm up dozens each); they stay referenced by global
    dispatch caches long after the owning test finished, and the
    accumulated native state can crash XLA's CPU compiler late in a long
    single-process run. Tests never share compiled functions across
    modules, so clearing at module teardown only costs recompiles that
    would not have been hits anyway."""
    yield
    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skipped "
                   "on hosts without one")
