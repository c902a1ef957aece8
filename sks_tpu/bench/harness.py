"""Timing harness.

Honest-methodology replacement for the reference's three timing stacks
(OpenCV ticks ``utils.h:13-29``, CUDA events with calibration sizing
``GPU_Runtime Test.cu:1182-1196``, and perf_counter+synchronize
``Modules_Runtime_Test.py:45-76``): compile (warmup) is separated from
steady-state, timing brackets use ``block_until_ready``, iteration count is
auto-calibrated to a time budget, and the median-of-batches statistic is
reported instead of a bare mean.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import jax

__all__ = ["BenchResult", "time_jitted"]


@dataclass
class BenchResult:
    seconds_per_call: float  # median over repeat batches
    mean_seconds: float
    min_seconds: float
    iters: int
    repeats: int
    compile_seconds: float

    def throughput(self, items_per_call: int) -> float:
        return items_per_call / self.seconds_per_call


def time_jitted(
    fn,
    *args,
    budget_s: float = 2.0,
    repeats: int = 5,
    max_iters: int = 100_000,
) -> BenchResult:
    """Time a jitted callable: warmup/compile, calibrate, then measure.

    ``fn(*args)`` is dispatched ``iters`` times back-to-back (async dispatch
    pipelines host overhead behind device execution) and the batch is bracketed
    with ``block_until_ready``; per-call time is the batch median.
    """
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    compile_s = time.perf_counter() - t0

    # Calibration with an *async pilot batch* (the reference GPU harness sizes
    # its loop the same way, `.cu:1182-1188`).  A single blocking call would
    # include the full host<->device round trip and misestimate per-call
    # cost.
    pilot = 32
    t0 = time.perf_counter()
    for _ in range(pilot):
        out = fn(*args)
    jax.block_until_ready(out)
    once = max((time.perf_counter() - t0) / pilot, 1e-8)
    # Enough iterations that dispatch-latency noise is amortized.
    iters = int(min(max_iters, max(100, budget_s / repeats / once)))

    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) / iters)
    samples.sort()
    return BenchResult(
        seconds_per_call=samples[len(samples) // 2],
        mean_seconds=sum(samples) / len(samples),
        min_seconds=samples[0],
        iters=iters,
        repeats=repeats,
        compile_seconds=compile_s,
    )
