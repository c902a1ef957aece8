"""Fused ACA solve + RANSAC scoring in one Pallas kernel through Triton.

``score_hypotheses`` builds the (B, N) residual of every hypothesis against
every correspondence, and returns a (B, N) inlier mask beside the scores: at
B = 131,072 and N = 5,000 that mask alone is ~655 MB.  The kernel here never
forms either.  Each program solves a block of hypotheses with the
division-free ACA core in registers, then walks the (4, N) correspondence
rows in chunks (read through L2, shared by every program), accumulating each
hypothesis's score in registers.  One float per hypothesis is written.  The
reference's CUDA kernel has the same shape: one thread per hypothesis over a
structure-of-arrays layout (``GPU_Runtime Test.cu:81-240``).

No entry point of the library calls this kernel.  On an H100 it was slower
than XLA's own solve + score (CHANGES.md), so RANSAC scores on the XLA path;
the kernel stays here, with the probe that times the two, so the comparison
can be run again on another card or JAX version:

    python -m sks_tpu.bench.fused_probe
"""

from __future__ import annotations

import functools
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from sks_tpu.ops.aca import aca_core
from sks_tpu.robust.ransac import _MAGSAC_K

__all__ = ["aca_solve_score", "SCORINGS", "main"]

#: Sum-style scorings the kernel implements (a median, as in 'lmeds', is not
#: a running sum and stays on the XLA path).
SCORINGS = ("inliers", "msac", "magsac")

#: (hypotheses, correspondences) the probe times: OpenCV's default RANSAC
#: budget on 2,000 matches, and a large adaptive-RANSAC stage.
SIZES = ((2048, 2000), (131072, 5000))


def _solve_score_kernel(src_ref, tar_ref, pts_ref, w_ref, out_ref, *,
                        n_chunks, block_n, t2, scoring):
    s = [src_ref[i, :].astype(jnp.float32) for i in range(8)]
    t = [tar_ref[i, :].astype(jnp.float32) for i in range(8)]
    h = aca_core(*s, *t)
    # The division-free core's entries reach ~1e20 at pixel coordinates, and
    # the adjugate squares them: scale by the largest entry first, or the
    # reverse transfer overflows float32.
    m = functools.reduce(jnp.maximum, [jnp.abs(v) for v in h])
    h00, h01, h02, h10, h11, h12, h20, h21, h22 = (v / m for v in h)
    # Adjugate: the division-free up-to-scale inverse for the reverse
    # transfer.
    i00 = h11 * h22 - h12 * h21
    i01 = h02 * h21 - h01 * h22
    i02 = h01 * h12 - h02 * h11
    i10 = h12 * h20 - h10 * h22
    i11 = h00 * h22 - h02 * h20
    i12 = h02 * h10 - h00 * h12
    i20 = h10 * h21 - h11 * h20
    i21 = h01 * h20 - h00 * h21
    i22 = h00 * h11 - h01 * h10
    # (block_b, 1) columns broadcast against (1, block_n) point rows.
    h00, h01, h02, h10, h11, h12, h20, h21, h22 = (
        v[:, None] for v in (h00, h01, h02, h10, h11, h12, h20, h21, h22))
    i00, i01, i02, i10, i11, i12, i20, i21, i22 = (
        v[:, None] for v in (i00, i01, i02, i10, i11, i12, i20, i21, i22))

    def body(j, acc):
        sl = pl.ds(j * block_n, block_n)
        x = pts_ref[0, sl][None, :]
        y = pts_ref[1, sl][None, :]
        xp = pts_ref[2, sl][None, :]
        yp = pts_ref[3, sl][None, :]
        pw = w_ref[sl][None, :]
        w = h20 * x + h21 * y + h22
        dx = (h00 * x + h01 * y + h02) / w - xp
        dy = (h10 * x + h11 * y + h12) / w - yp
        wr = i20 * xp + i21 * yp + i22
        dxr = (i00 * xp + i01 * yp + i02) / wr - x
        dyr = (i10 * xp + i11 * yp + i12) / wr - y
        r2 = dx * dx + dy * dy + dxr * dxr + dyr * dyr
        # Every gain is gated on r2 < t2: a NaN residual (0 * inf in a
        # degenerate transfer) compares False and scores 0.
        inl = (r2 < t2) & (w != 0.0) & (wr != 0.0)
        if scoring == "inliers":
            gain = jnp.where(inl, 1.0, 0.0)
        elif scoring == "msac":
            gain = jnp.where(inl, 1.0 - r2 / t2, 0.0)
        else:  # magsac: t2 = (k sigma_max)^2, weight (1 - r / (k sigma_max))^2
            g = 1.0 - jnp.sqrt(jnp.maximum(r2, 0.0) / t2)
            gain = jnp.where(inl, g * g, 0.0)
        return acc + jnp.sum(gain * pw, axis=1)

    acc = jnp.zeros(s[0].shape, jnp.float32)
    out_ref[...] = jax.lax.fori_loop(0, n_chunks, body, acc)


@functools.partial(jax.jit, static_argnames=(
    "threshold", "scoring", "sigma_max", "block_b", "block_n", "num_warps",
    "interpret"))
def aca_solve_score(
    src4: Array, tar4: Array, src: Array, tar: Array, threshold: float,
    point_weights: Array | None = None, scoring: str = "inliers",
    sigma_max: float | None = None, block_b: int = 64, block_n: int = 16,
    num_warps: int = 2, interpret: bool | None = None,
) -> Array:
    """Solve B ACA hypotheses and score each against N correspondences.

    Scores as :func:`sks_tpu.robust.ransac.score_hypotheses` does for the
    same ``threshold``, ``scoring`` and ``sigma_max``.

    Args:
      src4, tar4: (B, 4, 2) minimal sets (float32 or bfloat16; the kernel
        computes in float32).
      src, tar: (N, 2) correspondences.
      threshold: inlier threshold in pixels (symmetric transfer).
      point_weights: optional (N,) gain multiplier (0 drops a padded point).
      scoring: 'inliers', 'msac' or 'magsac'.
      sigma_max: MAGSAC's largest noise scale (default ``3 * threshold``).
      block_b, block_n: hypotheses per program and points per inner chunk
        (powers of two).  Of the four shapes :func:`main` times, the
        defaults were the fastest on an H100 at (B, N) = (131,072, 5,000)
        and 1.3x the fastest at (2,048, 2,000).
      num_warps: Triton warps per program.
      interpret: run in Pallas's interpreter.  None: only where the default
        backend is the CPU, which has no Triton lowering.

    Returns:
      (B,) float32 scores.
    """
    if scoring not in SCORINGS:
        raise ValueError(f"scoring must be one of {SCORINGS}, got {scoring!r}")
    if interpret is None:
        interpret = jax.default_backend() == "cpu"
    if scoring == "magsac":
        sm = 3.0 * threshold if sigma_max is None else sigma_max
        t2 = (_MAGSAC_K * sm) ** 2
    else:
        t2 = threshold * threshold
    b, n = src4.shape[0], src.shape[0]
    n_pad = -(-n // block_n) * block_n
    b_pad = -(-b // block_b) * block_b

    def soa(p):  # (B, 4, 2) -> (8, B_pad) component-major
        return jnp.pad(p.reshape(b, 8).T, ((0, 0), (0, b_pad - b)))

    pts = jnp.concatenate([src.T, tar.T], axis=0).astype(jnp.float32)
    pts = jnp.pad(pts, ((0, 0), (0, n_pad - n)))
    w = (jnp.ones((n,), jnp.float32) if point_weights is None
         else point_weights.astype(jnp.float32))
    w = jnp.pad(w, (0, n_pad - n))

    kernel = functools.partial(
        _solve_score_kernel, n_chunks=n_pad // block_n, block_n=block_n,
        t2=float(t2), scoring=scoring)
    hyp_spec = pl.BlockSpec((8, block_b), lambda i: (0, i))
    scores = pl.pallas_call(
        kernel,
        grid=(b_pad // block_b,),
        in_specs=[
            hyp_spec,
            hyp_spec,
            pl.BlockSpec((4, n_pad), lambda i: (0, 0)),
            pl.BlockSpec((n_pad,), lambda i: (0,)),
        ],
        out_specs=pl.BlockSpec((block_b,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((b_pad,), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name="aca_solve_score",
    )(soa(src4), soa(tar4), pts, w)
    return scores[:b]


def _median_seconds(fn, *args, reps: int = 10) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main(argv=None) -> int:
    """Time the kernel against XLA's solve + score at two RANSAC sizes."""
    import argparse

    from sks_tpu.ops import aca_h
    from sks_tpu.robust.ransac import sample_minimal_sets, score_hypotheses
    from sks_tpu.utils.compile_cache import enable_compile_cache
    from sks_tpu.utils.synth import random_correspondences

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--threshold", type=float, default=3.0)
    args = ap.parse_args(argv)
    if jax.default_backend() != "gpu":
        raise SystemExit("fused_probe: times the Triton kernel; needs a GPU")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    thr = args.threshold
    shapes = ((64, 16, 2), (64, 32, 4), (128, 16, 4), (128, 32, 4))
    for b, n in SIZES:
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(b), 3)
        src, tar, _ = random_correspondences(k1, (), n, 1.0, jnp.float32)
        junk = jax.random.uniform(k2, (n // 2, 2), jnp.float32, 0.0, 640.0)
        tar = tar.at[: n // 2].set(junk)  # 50% outliers
        idx = sample_minimal_sets(k3, n, b)
        s4, t4 = src[idx], tar[idx]
        xla = jax.jit(lambda s, t, p, q: score_hypotheses(
            aca_h(s, t), p, q, thr)[0])
        # A degenerate draw (a repeated index) scores -1 there and 0 here.
        ref = np.maximum(np.asarray(xla(s4, t4, src, tar)), 0.0)
        sec = _median_seconds(xla, s4, t4, src, tar)
        print(f"B={b} N={n} XLA aca_h + score_hypotheses: {sec * 1e3:.4f} ms"
              f" | card: {card}", flush=True)
        for bb, bn, warps in shapes:
            fn = functools.partial(aca_solve_score, threshold=thr, block_b=bb,
                                   block_n=bn, num_warps=warps)
            got = np.asarray(fn(s4, t4, src, tar))
            off = int(np.sum(np.abs(got - ref) > 0.5))
            sec = _median_seconds(fn, s4, t4, src, tar)
            print(f"B={b} N={n} kernel block_b={bb} block_n={bn} "
                  f"warps={warps}: {sec * 1e3:.4f} ms; {off} of {b} counts "
                  f"differ from XLA by > 0.5 | card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
