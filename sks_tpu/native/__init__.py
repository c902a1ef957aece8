"""ctypes bindings for the native CPU runtime (``native/libsks_native.so``).

Auto-builds the library with ``make`` on first use if missing (g++ only, no
external deps).  Provides: fp32/fp64 scalar-batch solvers for all six kernels (the fp64
oracle), the reference-format correspondence reader,
and the reference-comparable hot-loop CPU benchmark (BASELINE.md Table 5).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "aca_batch",
    "sks_batch",
    "solve_batch",
    "read_points",
    "bench_hot_loop",
]

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libsks_native.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # Always invoke make: it is a timestamp no-op when the .so is fresh, and
    # it rebuilds stale libraries that predate newly exported symbols (a
    # stale .so would otherwise fail getattr below and silently disable the
    # whole native layer).
    subprocess.run(
        ["make", "-s"], cwd=_NATIVE_DIR, check=True,
        env={**os.environ, "MAKEFLAGS": ""},
    )
    lib = ctypes.CDLL(str(_LIB_PATH))
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    for name, fp in (("f32", f32p), ("f64", f64p)):
        for alg in ("aca", "sks", "ge", "gpt", "ho", "ndlt"):
            fn = getattr(lib, f"sks_{alg}_{name}")
            fn.argtypes = [fp, fp, fp, i64, ctypes.c_int]
            fn.restype = None
            bf = getattr(lib, f"sks_bench_{alg}_{name}")
            bf.argtypes = [fp, fp, i64]
            bf.restype = ctypes.c_double
    lib.sks_read_points.argtypes = [ctypes.c_char_p, f64p, f64p, i64]
    lib.sks_read_points.restype = i64
    _lib = lib
    return lib


def available() -> bool:
    """Whether the library builds and loads (the oracle's callers that must
    not run without it call the solvers directly, which raise)."""
    try:
        _load()
        return True
    except (OSError, AttributeError, subprocess.CalledProcessError):
        return False


def _batch(alg: str, src: np.ndarray, tar: np.ndarray, normalize: bool):
    lib = _load()
    src = np.ascontiguousarray(src)
    tar = np.ascontiguousarray(tar)
    assert src.shape == tar.shape and src.shape[-2:] == (4, 2), src.shape
    dt = src.dtype
    assert dt in (np.float32, np.float64) and tar.dtype == dt
    n = int(np.prod(src.shape[:-2], dtype=np.int64))
    out = np.empty((*src.shape[:-2], 3, 3), dt)
    suffix = "f32" if dt == np.float32 else "f64"
    cp = ctypes.POINTER(ctypes.c_float if dt == np.float32 else ctypes.c_double)
    fn = getattr(lib, f"sks_{alg}_{suffix}")
    fn(
        src.ctypes.data_as(cp),
        tar.ctypes.data_as(cp),
        out.ctypes.data_as(cp),
        n,
        int(normalize),
    )
    return out


def aca_batch(src, tar, normalize: bool = True) -> np.ndarray:
    """Native batched ACA: (..., 4, 2) x2 -> (..., 3, 3)."""
    return _batch("aca", np.asarray(src), np.asarray(tar), normalize)


def sks_batch(src, tar, normalize: bool = True) -> np.ndarray:
    """Native batched SKS: (..., 4, 2) x2 -> (..., 3, 3)."""
    return _batch("sks", np.asarray(src), np.asarray(tar), normalize)


def solve_batch(alg: str, src, tar, normalize: bool = True) -> np.ndarray:
    """Native batched minimal solve for any of the six solver kernels.

    ``alg``: 'aca' | 'sks' | 'ge' | 'gpt' | 'ho' | 'ndlt' (the reference's
    full Table-5 roster; each mirrors the repo's own ops/ derivation).
    """
    assert alg in ("aca", "sks", "ge", "gpt", "ho", "ndlt"), alg
    return _batch(alg, np.asarray(src), np.asarray(tar), normalize)


def read_points(path: str | Path, cap: int = 1 << 20):
    """Read the reference correspondence format -> (src (N,2), tar (N,2)) f64.

    Format (``CPU_Runtime Test/utils.cpp:6-21``): first line the count, then
    one ``x1 y1 x2 y2`` line per correspondence.
    """
    lib = _load()
    src = np.empty((cap, 2), np.float64)
    tar = np.empty((cap, 2), np.float64)
    f64p = ctypes.POINTER(ctypes.c_double)
    n = lib.sks_read_points(
        str(path).encode(), src.ctypes.data_as(f64p), tar.ctypes.data_as(f64p),
        cap,
    )
    if n < 0:
        raise IOError(f"failed to read {path}")
    return src[:n].copy(), tar[:n].copy()


def bench_hot_loop(alg: str, src4, tar4, iters: int = 10_000_000) -> float:
    """Nanoseconds per solve, cache-hot single set (reference Table 5 shape)."""
    lib = _load()
    src4 = np.ascontiguousarray(src4).reshape(8)
    tar4 = np.ascontiguousarray(tar4).reshape(8)
    dt = src4.dtype
    suffix = "f32" if dt == np.float32 else "f64"
    cp = ctypes.POINTER(ctypes.c_float if dt == np.float32 else ctypes.c_double)
    fn = getattr(lib, f"sks_bench_{alg}_{suffix}")
    return float(fn(src4.ctypes.data_as(cp), tar4.ctypes.data_as(cp), iters))
