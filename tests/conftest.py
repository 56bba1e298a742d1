"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Device paths are validated on simulated devices
(`xla_force_host_platform_device_count=8`) so sharded/halo results can be
asserted equal to single-device results without a GPU; the Pallas kernels
run in interpret mode there through `dispatch.interpret_kernels()`.
chip_smoke.py runs the card-only tests (`-m gpu`) inside its own GPU
process and sets TRIPLE_ACCEL_TEST_GPU=1, which leaves JAX's platform
alone.
"""

import os

ON_GPU = os.environ.get("TRIPLE_ACCEL_TEST_GPU", "") == "1"

if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402
import pytest  # noqa: E402

from triple_accel_jax.utils.runtime import setup_compile_cache  # noqa: E402

if not ON_GPU:
    # jax may already be imported by a pytest plugin, in which case it
    # latched the environment's JAX_PLATFORMS at import time — override
    # through the config API so the session really runs on 8 CPU devices
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
setup_compile_cache()


@pytest.fixture
def gpu():
    """Card-only tests take this fixture: it skips unless JAX's default
    backend is a GPU (decided here, never at import)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernels have no CPU form")


@pytest.fixture
def interpret_kernels():
    """Run the dispatcher's kernel arms in Pallas interpret mode."""
    from triple_accel_jax.dispatch import interpret_kernels as switch

    with switch():
        yield


# The CPU suite compiles a few hundred XLA programs in one process; the
# XLA CPU JIT's accumulated code mappings eventually exceed
# vm.max_map_count and the process segfaults.  Dropping the executables
# periodically keeps the process well away from that cliff; later tests
# recompile what they reuse.
_TESTS_RUN = {"n": 0}


@pytest.fixture(autouse=True)
def _periodic_jax_cache_clear():
    yield
    _TESTS_RUN["n"] += 1
    if _TESTS_RUN["n"] % 25 == 0:
        jax.clear_caches()
