"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["REPO_CACHE_DIR", "enable_compile_cache"]

#: The fallback location, ``<repo>/.jax_cache`` (listed in ``.gitignore``).
#: The path is part of the cache key, so it is fixed: never built from a
#: temporary name, a pid or the time.
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache(min_compile_secs: float = 0.5) -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing.  Otherwise the cache goes to :data:`REPO_CACHE_DIR`, for
    compilations longer than ``min_compile_secs``.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(REPO_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
