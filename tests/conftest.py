"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

Tests are hermetic and exercise multi-device sharding on the host CPU.
Tests that need the GPU carry the `gpu` marker (registered in pytest.ini)
and request the `gpu_device` fixture, which skips them when JAX finds no
GPU; `python chip_smoke.py` runs them on the card.
"""

import os
import sys

import pytest

# the CPU unless the caller chose a platform (chip_smoke.py runs the `gpu`
# tests in its own process, on the card)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gencore_tpu.utils.compile_cache import REPO_ROOT, setup_compile_cache  # noqa: E402

# persistent compile cache: identical kernel shapes recur across the suite
setup_compile_cache(os.path.join(REPO_ROOT, "bench_data", "jax_cache_cpu"))


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX finds none."""
    import jax
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU (run `python chip_smoke.py` on the card)")
