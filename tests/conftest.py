"""
Test configuration (reference: conftest.py).

* Tests run on the CPU unless ``JAX_PLATFORMS`` names another platform,
  with an 8-device virtual mesh (``--xla_force_host_platform_device_count=8``)
  so distributed row partitioning is exercised without several cards.
* Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; the fixture
  below decides at run time.  Run them on a card with
  ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
* The ``kernel`` fixture parameterizes kernel-dependent tests over every
  backend (reference: conftest.py:11-37).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        )

# make the in-repo package importable from any working directory
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import logging

import pytest
from hypothesis import settings

logging.getLogger("jax").setLevel(logging.WARNING)

# The hypothesis suite jit-compiles tens of thousands of small programs
# in one process, and every loaded executable adds memory mappings; at
# the default vm.max_map_count (65530) the process runs out of map slots
# ~3/4 through a cold run and XLA SEGFAULTS at the next mmap (measured:
# /proc/<pid>/maps grew 8k -> 63k, then rc=139; crash sites wander
# between compile/serialize/deserialize because they are just the next
# mmap).  Raise the limit when we can; warn when we cannot.
def _ensure_map_count(minimum: int = 262144) -> None:
    path = "/proc/sys/vm/max_map_count"
    try:
        with open(path) as f:
            current = int(f.read())
        if current >= minimum:
            return
        with open(path, "w") as f:
            f.write(str(minimum))
    except (OSError, ValueError):
        import warnings

        warnings.warn(
            f"vm.max_map_count < {minimum} and could not be raised; a full"
            " cold suite run may exhaust memory maps and crash. Run"
            f" `sysctl -w vm.max_map_count={minimum}` as root.",
            stacklevel=1,
        )


_ensure_map_count()

# persistent compilation cache: property-based tests compile many small
# programs; caching them across runs keeps the suite fast
import jax

from csr_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

KERNELS = ["scipy", "xla"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped on other platforms"
    )


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``gpu``-marked tests where JAX finds no GPU."""
    if request.node.get_closest_marker("gpu") and jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX backend is {jax.default_backend()!r}")


@pytest.fixture(scope="module", params=KERNELS)
def kernel(request):
    """Parameterize a test over all kernel backends; pre-warms each kernel
    with a tiny handle round-trip (reference: conftest.py:22-37)."""
    from csr_tpu import CSR
    from csr_tpu.kernels import get_kernel, releasing, use_kernel

    k = get_kernel(request.param)
    with use_kernel(request.param):
        m = CSR.empty(1, 1)
        with releasing(k.to_handle(m), k) as h:
            k.from_handle(h)
        yield request.param


@pytest.fixture(scope="session")
def tmp_path_shared(tmp_path_factory):
    """Session-scoped tmp dir (hypothesis forbids function-scoped fixtures)."""
    return tmp_path_factory.mktemp("csr")


settings.register_profile("default", max_examples=50, deadline=None)
settings.register_profile("large", max_examples=5000, deadline=None)
settings.register_profile("fast", max_examples=50, deadline=None)
settings.register_profile("ci", max_examples=8, deadline=None)
settings.load_profile(os.environ.get("CSR_HYPOTHESIS_PROFILE", "default"))
