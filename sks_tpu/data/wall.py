"""Runtime-only loader for the reference's REAL wall correspondences.

The one reference asset without a synthetic equivalent: 2,540 real SIFT
matches of a 3-D wall scene (``/root/reference/C++ Codes/Runtime Test/
CPU_Runtime Test/orig_pts_wall.txt:1-2541``) — the substrate of both
reference harnesses (``main.cpp:21-30`` samples 4-point subsets from it;
``GPU_Runtime Test.cu:52-78`` resamples it into SoA batches).  Nothing is
copied into this repository: the file is read from the reference checkout
(or ``SKS_WALL_POINTS``) at runtime, and every consumer skips cleanly when
it is absent (grounding the stack in the exact data the paper used, while
keeping the repo's no-copy stance).

Format: count header, then ``x1 y1 x2 y2`` per line — the same format
:func:`sks_tpu.data.fixture.load_correspondences` and the native
``sks_read_points`` (``native/src/sks_native.cpp``) already parse.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from sks_tpu.data.fixture import load_correspondences

__all__ = ["wall_path", "load_wall", "resample_quads"]

#: Default location of the reference checkout's wall file; override with
#: the SKS_WALL_POINTS environment variable.
_DEFAULT_CANDIDATES = (
    "/root/reference/C++ Codes/Runtime Test/CPU_Runtime Test/"
    "orig_pts_wall.txt",
)


def wall_path() -> Path | None:
    """Path to the real wall data, or None when no checkout is mounted."""
    env = os.environ.get("SKS_WALL_POINTS")
    if env:
        p = Path(env)
        return p if p.exists() else None
    for cand in _DEFAULT_CANDIDATES:
        p = Path(cand)
        if p.exists():
            return p
    return None


def load_wall():
    """(src (N, 2), tar (N, 2)) float64 real matches, or None if absent."""
    p = wall_path()
    if p is None:
        return None
    return load_correspondences(p)


def resample_quads(src: np.ndarray, tar: np.ndarray, batch: int,
                   seed: int = 11):
    """Reference-shaped resampling: ``batch`` random 4-point subsets.

    Mirrors the GPU harness's batch builder (``GPU_Runtime Test.cu:52-78``:
    uniform random indices mod the dataset size, 4 per hypothesis) — the
    configuration under which every Table-8 number was measured.  Pure
    numpy (host-side data prep, not the benchmark).

    Returns (src_quads (batch, 4, 2), tar_quads (batch, 4, 2)) float64.
    """
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, src.shape[0], size=(batch, 4))
    return src[idx], tar[idx]
