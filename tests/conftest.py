import os

# Tests run on a virtual 8-device CPU mesh; sharding logic is validated
# without a GPU. XLA_FLAGS must be set before the CPU backend initializes;
# the platform is pinned through jax.config so that a machine with a card
# still runs the suite on the CPU.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _release_executables(request):
    """Release compiled executables after heavy end-to-end tests.

    The CPU backend JIT-compiles thousands of kernel variants across full
    VBMC runs; accumulated LLVM code sections eventually exhaust mmap space
    and SEGFAULT *inside a later compile* (observed in the slow suite after
    the fused proposal kernels landed). The persistent-cache/per-test
    recompile cost is negligible next to the runs themselves.
    """
    yield
    if (request.node.get_closest_marker("slow")
            or "e2e" in request.node.nodeid):
        jax.clear_caches()
