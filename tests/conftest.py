"""Test harness config: hermetic CPU backend with a virtual 8-device mesh.

Mirrors SURVEY.md §4's institutionalized strategy: all tests run on the CPU
backend (f64 available for oracle-grade checks) with
``--xla_force_host_platform_device_count=8`` so distributed/sharding logic is
exercised on one host.  Env vars must be set before jax imports.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# Tests are hermetic on the CPU backend with a virtual 8-device mesh, and
# f64 is on for oracle-grade checks.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache: warm suite runs skip recompiling the heavy
# RANSAC/pipeline graphs.
from sks_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import pytest  # noqa: E402

import jax.numpy as jnp  # noqa: E402
from functools import partial  # noqa: E402


def pytest_addoption(parser):
    parser.addoption(
        "--runslow",
        action="store_true",
        default=False,
        help="also run tests marked slow (full pre-merge suite)",
    )


def pytest_collection_modifyitems(config, items):
    """Slow-marked tests (the full matrix) need --runslow / RUN_SLOW=1."""
    if config.getoption("--runslow") or os.environ.get("RUN_SLOW"):
        return
    skip = pytest.mark.skip(reason="slow: run with --runslow or RUN_SLOW=1")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)

from sks_tpu.utils.synth import random_correspondences  # noqa: E402

# Eager (unjitted) jnp dispatch compiles every scalar op separately — seconds
# per call.  All tests go through this jitted, cached entry point instead.
_synth = partial(jax.jit, static_argnums=(1, 2, 3, 4))(
    lambda key, batch, n, noise, dtype: random_correspondences(
        key, (batch,), n, noise, dtype
    )
)

_JIT_CACHE: dict = {}


def jit_of(fn):
    """Shared jit wrapper cache so repeated tests reuse compilations."""
    if fn not in _JIT_CACHE:
        _JIT_CACHE[fn] = jax.jit(fn)
    return _JIT_CACHE[fn]


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(params=["float32", "float64"])
def dtype(request):
    return jnp.dtype(request.param)


@pytest.fixture
def synth():
    """synth(key, batch, n_points, noise, dtype) -> (src, tar, H_true), jitted."""

    def call(key, batch=32, n=4, noise=0.0, dtype=jnp.float32):
        return _synth(key, batch, n, noise, dtype)

    return call
