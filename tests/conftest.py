"""Test configuration: an 8-device virtual CPU mesh by default.

Tests run on the CPU (the analog of the reference's scalar/LLVM variants,
src/conftest.py:29-62) so JIT semantics are exercised without a GPU; the
virtual device count lets sharding tests validate the multi-device path.
Tests marked `gpu` need the card: they skip on the CPU, and run on a GPU
machine with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache: the wavefront megakernels are large graphs
# (minutes to compile on this 1-core CPU); cache across test sessions.
# The cache dir is keyed by a host-CPU fingerprint: XLA:CPU AOT results
# embed the COMPILE machine's vector features, and this container image
# migrates across hosts — loading an entry compiled with (e.g.) AMX/AVX
# variants this host lacks SIGILLs/segfaults mid-suite.
def _cpu_fingerprint() -> str:
    import hashlib
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:12]
    except OSError:
        pass
    return "generic"


jax.config.update("jax_compilation_cache_dir",
                  f"/tmp/lr_cpu_jax_cache_{_cpu_fingerprint()}")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


@pytest.fixture
def np_rng():
    return np.random.default_rng(seed=12345)
