"""Double-float ("df64") arithmetic: fp64-parity accuracy from fp32 arithmetic.

The reference ships fp64 twins of every solver (``sks::runKernel_ACA_double``,
``ACA_SKS.cpp:104-179``; CUDA kernels are fp64 throughout,
``GPU_Runtime Test.cu:81-151``) because RANSAC pipelines care about solver
accuracy.  For devices without fast native fp64 this module supplies the
standard alternative: *double-word* (a.k.a. double-float / df64) arithmetic, an unevaluated
sum ``hi + lo`` of two fp32 values carrying ~49 bits of significand — enough to
match fp64 parity configs (``BASELINE.json`` config 1) on the 85-flop ACA chain.

Built on the classic error-free transforms (Dekker's split/product, Knuth's
two-sum) — branch-free, elementwise, batched, and differentiable like any other
jnp code.  The :class:`DF` type overloads ``+ - *`` so the *same*
:func:`sks_tpu.ops.aca.aca_core` straight-line body computes either fp32 or
df64 homographies — no duplicated solver source (the reference maintains the
fp32/fp64 pair by hand; see SURVEY.md §1).

Error-free transforms assume the compiler executes the written operation
order; XLA's algebraic simplifier will happily rewrite ``(a + b) - a`` and
friends, silently destroying the error terms (measured: 7 digits lost under
jit on the SKS chain).  Every cancellation that *is* the algorithm is
therefore guarded with the :func:`_pin` opaque copy (see its docstring for
why ``lax.optimization_barrier`` is not sufficient on XLA:CPU); the accuracy
tests in ``tests/test_df64.py`` run jitted to guard the guards.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import Array

from sks_tpu.ops.aca import aca_core


def _pin(x):
    """Opaque copy: blocks XLA algebraic simplification through ``x``.

    ``lax.optimization_barrier`` is NOT enough: the XLA:CPU pipeline strips
    barriers before algebraic simplification runs (measured: 13 barriers in
    the StableHLO, 0 in the optimized module, and ``(p + e) - p`` folded to
    ``e``, zeroing every df64 error term).  ``select(x == x, x, nan)`` is
    structurally opaque to the simplifier on every backend, is the identity
    for all non-NaN x, and preserves NaN propagation (x != x -> NaN).
    """
    if isinstance(x, tuple):
        return tuple(_pin(v) for v in x)
    return jnp.where(x == x, x, jnp.asarray(jnp.nan, x.dtype))

__all__ = [
    "DF",
    "df_lift",
    "df_from_f64",
    "df_to_f64",
    "aca_df64_h",
    "aca_df64",
    "sks_df64_h",
    "sks_df64",
    "ndlt_df64_h",
    "ge_df64_h",
    "gpt_df64_h",
    "ho_df64_h",
    "invit_smallest_col_df",
    "residual2_df64",
    "df_sqrt",
    "df_where",
    "jacobi_smallest_col_df",
]

# Dekker split constant for fp32 (2^12 + 1); fp64 inputs use 2^27 + 1.
_SPLIT = {jnp.dtype("float32"): 4097.0, jnp.dtype("float64"): 134217729.0}


def _two_sum(a: Array, b: Array):
    """Error-free a + b = s + e (Knuth).

    Inputs are pinned: an EFT's operands must be opaque to XLA or the
    simplifier reassociates the transform's adds with the sub-expressions
    *feeding* it (measured: ``p + (e0 + cross)`` -> ``(p + e0) + cross``,
    which changes rounding and destroys the error term).
    """
    a, b = _pin((a, b))
    s = a + b
    bb = _pin(s - a)
    e = (a - _pin(s - bb)) + (b - bb)
    return s, e


def _quick_two_sum(a: Array, b: Array):
    """Error-free a + b = s + e, assuming |a| >= |b| (inputs pinned)."""
    a, b = _pin((a, b))
    s = a + b
    e = b - _pin(s - a)
    return s, e


def _split(a: Array):
    """Dekker split: a = hi + lo with hi, lo each half-width."""
    a = _pin(a)
    c = _pin(jnp.asarray(_SPLIT[jnp.dtype(a.dtype)], a.dtype) * a)
    hi = _pin(c - _pin(c - a))
    return hi, a - hi


def _two_prod(a: Array, b: Array):
    """Error-free a * b = p + e (Dekker, FMA-free; inputs pinned)."""
    a, b = _pin((a, b))
    p = _pin(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((_pin(ah * bh) - p) + ah * bl + al * bh) + al * bl
    return p, e


class DF(NamedTuple):
    """Unevaluated sum ``hi + lo`` (|lo| <= ulp(hi)/2) with df64 operators.

    Python scalars interoperate on either side (``0.5 * x``, ``1.0 / x``) —
    exactly representable constants lift losslessly, so the shared
    straight-line cores (``aca_core``, ``sks_core``, ``ge_core``) run on DF
    components unchanged.
    """

    hi: Array
    lo: Array

    def _coerce(self, other) -> "DF":
        if isinstance(other, DF):
            return other
        arr = jnp.asarray(other, self.hi.dtype)
        return DF(arr, jnp.zeros_like(arr))

    def __add__(self, other) -> "DF":
        other = self._coerce(other)
        s, e = _two_sum(self.hi, other.hi)
        e = e + (self.lo + other.lo)
        return DF(*_quick_two_sum(s, e))

    __radd__ = __add__

    def __sub__(self, other) -> "DF":
        return self + (-self._coerce(other))

    def __rsub__(self, other) -> "DF":
        return self._coerce(other) + (-self)

    def __neg__(self) -> "DF":
        return DF(-self.hi, -self.lo)

    def __mul__(self, other) -> "DF":
        other = self._coerce(other)
        p, e = _two_prod(self.hi, other.hi)
        e = e + (self.hi * other.lo + self.lo * other.hi)
        return DF(*_quick_two_sum(p, e))

    __rmul__ = __mul__

    def __truediv__(self, other) -> "DF":
        other = self._coerce(other)
        # One Newton correction on the fp32 quotient.
        q0 = self.hi / other.hi
        r = self - DF(q0, jnp.zeros_like(q0)) * other
        q1 = (r.hi + r.lo) / other.hi
        return DF(*_quick_two_sum(q0, q1))

    def __rtruediv__(self, other) -> "DF":
        return self._coerce(other) / self


def df_lift(x: Array) -> DF:
    """Exact fp32 array -> DF (lo = 0)."""
    return DF(x, jnp.zeros_like(x))


def df_from_f64(x: Array) -> DF:
    """Split an fp64 array into a df64 pair of fp32 words (lossless to ~49 bits)."""
    hi = x.astype(jnp.float32)
    lo = (x - hi.astype(x.dtype)).astype(jnp.float32)
    return DF(hi, lo)


def df_to_f64(x: DF) -> Array:
    """Evaluate the unevaluated sum in fp64 (for verification on CPU)."""
    return x.hi.astype(jnp.float64) + x.lo.astype(jnp.float64)


def _df_components(pts: Array | DF):
    if not isinstance(pts, DF):
        pts = df_lift(pts)
    hi = pts.hi.reshape(*pts.hi.shape[:-2], 8)
    lo = pts.lo.reshape(*pts.lo.shape[:-2], 8)
    return tuple(DF(hi[..., i], lo[..., i]) for i in range(8))


def aca_df64_h(src: Array | DF, tar: Array | DF) -> DF:
    """Up-to-scale ACA homography in df64 precision.

    Runs the identical division-free straight-line body as :func:`aca_h`
    (``sks_tpu.ops.aca.aca_core``) with every op in double-word arithmetic.

    Args:
      src, tar: (..., 4, 2) fp32 arrays, or :class:`DF` pairs of them when the
        inputs themselves need more than fp32 precision.

    Returns:
      DF of two (..., 3, 3) fp32 arrays; ``hi`` alone is the correctly-rounded
      fp32 homography, ``hi + lo`` carries ~49 bits.
    """
    h = aca_core(*_df_components(src), *_df_components(tar))
    hi = jnp.stack([e.hi for e in h], axis=-1).reshape(*h[0].hi.shape, 3, 3)
    lo = jnp.stack([e.lo for e in h], axis=-1).reshape(*h[0].lo.shape, 3, 3)
    return DF(hi, lo)


def aca_df64(src: Array | DF, tar: Array | DF) -> DF:
    """df64 ACA homography normalized to ``H[2,2] == 1`` (df64 division)."""
    h = aca_df64_h(src, tar)
    denom = DF(h.hi[..., 2:3, 2:3], h.lo[..., 2:3, 2:3])
    return h / denom


def sks_df64_h(src: Array | DF, tar: Array | DF) -> DF:
    """Up-to-scale SKS homography in df64 precision.

    The identical straight-line body as :func:`sks_h`
    (``sks_tpu.ops.sks.sks_core``) with every op — including the 5 intrinsic
    reciprocals — in double-word arithmetic (capability parity with
    ``sks::runKernel_SKS_double``, ``ACA_SKS.cpp:305-418``).
    """
    from sks_tpu.ops.sks import sks_core

    h = sks_core(*_df_components(src), *_df_components(tar))
    hi = jnp.stack([e.hi for e in h], axis=-1).reshape(*h[0].hi.shape, 3, 3)
    lo = jnp.stack([e.lo for e in h], axis=-1).reshape(*h[0].lo.shape, 3, 3)
    return DF(hi, lo)


def sks_df64(src: Array | DF, tar: Array | DF) -> DF:
    """df64 SKS homography normalized to ``H[2,2] == 1``."""
    h = sks_df64_h(src, tar)
    denom = DF(h.hi[..., 2:3, 2:3], h.lo[..., 2:3, 2:3])
    return h / denom


def residual2_df64(h: Array | DF, src: Array, tar: Array) -> Array:
    """Symmetric-transfer squared residuals computed in df64, returned as f32.

    The df64 scoring option for RANSAC (``RansacConfig(df64_scoring=True)``):
    at wall-scale coordinates the f32 forward/backward transfer loses ~3
    significant digits through the adjugate inverse; computing the transfer
    chain in double-word arithmetic restores fp64-grade residual ordering
    where conditioning bites (near-degenerate hypotheses, long-tail inlier
    decisions at tight thresholds).

    Args:
      h: (..., 3, 3) homographies (f32 array or DF).
      src, tar: (N, 2) correspondences (f32).

    Returns:
      (..., N) f32 squared symmetric-transfer residuals.
    """
    if not isinstance(h, DF):
        h = DF(h, jnp.zeros_like(h))

    # Up-to-scale inputs can carry ~1e20 entries (raw division-free ACA);
    # the adjugate squares that past f32 range.  Rescale by an exact power
    # of two (no rounding, exact DF scaling); the common factor cancels in
    # every homogeneous ratio.
    m = jnp.max(jnp.abs(h.hi), axis=(-2, -1), keepdims=True)
    c = jnp.exp2(-jnp.ceil(jnp.log2(jnp.maximum(m, 1e-30))))
    h = DF(h.hi * c, h.lo * c)

    def entry(i, j):
        return DF(h.hi[..., i, j, None], h.lo[..., i, j, None])

    e = [[entry(i, j) for j in range(3)] for i in range(3)]
    x = df_lift(src[..., :, 0])
    y = df_lift(src[..., :, 1])
    xp = df_lift(tar[..., :, 0])
    yp = df_lift(tar[..., :, 1])

    # Forward transfer.
    w = e[2][0] * x + e[2][1] * y + e[2][2]
    dx = (e[0][0] * x + e[0][1] * y + e[0][2]) / w - xp
    dy = (e[1][0] * x + e[1][1] * y + e[1][2]) / w - yp
    r2 = dx * dx + dy * dy

    # Adjugate (reverse transfer, up to scale — the scale cancels in the
    # homogeneous division).
    a = [[e[1][1] * e[2][2] - e[1][2] * e[2][1],
          e[0][2] * e[2][1] - e[0][1] * e[2][2],
          e[0][1] * e[1][2] - e[0][2] * e[1][1]],
         [e[1][2] * e[2][0] - e[1][0] * e[2][2],
          e[0][0] * e[2][2] - e[0][2] * e[2][0],
          e[0][2] * e[1][0] - e[0][0] * e[1][2]],
         [e[1][0] * e[2][1] - e[1][1] * e[2][0],
          e[0][1] * e[2][0] - e[0][0] * e[2][1],
          e[0][0] * e[1][1] - e[0][1] * e[1][0]]]
    wr = a[2][0] * xp + a[2][1] * yp + a[2][2]
    dxr = (a[0][0] * xp + a[0][1] * yp + a[0][2]) / wr - x
    dyr = (a[1][0] * xp + a[1][1] * yp + a[1][2]) / wr - y
    r2 = r2 + dxr * dxr + dyr * dyr
    return r2.hi + r2.lo


def df_where(cond: Array, a: DF, b: DF) -> DF:
    """Componentwise select on DF values (cond is an ordinary bool array)."""
    return DF(jnp.where(cond, a.hi, b.hi), jnp.where(cond, a.lo, b.lo))


def df_sqrt(x: DF) -> DF:
    """df64 square root: f32 seed + one df64 Newton step (Karp-Markstein).

    Exact at x == 0 (guarded); negative inputs propagate NaN like jnp.sqrt.
    """
    s0 = jnp.sqrt(x.hi)
    safe = s0 > 0
    s0g = jnp.where(safe, s0, 1.0)
    s = DF(s0g, jnp.zeros_like(s0g))
    s = 0.5 * (s + x / s)
    return df_where(safe, s, DF(s0, jnp.zeros_like(s0)))


def jacobi_smallest_col_df_unrolled(a, sweeps: int = 8):
    """Static-pair unrolled DF Jacobi — the straight-line SoA form.

    :func:`jacobi_smallest_col_df` scans one rotation body over a
    (sweeps*36, 2) index schedule, which keeps the XLA graph small but
    needs dynamic row/column gathers.  This twin mirrors
    :func:`sks_tpu.ops.linalg.jacobi_smallest_col_core` instead: every
    (p, q) rotation is unrolled at trace time over static indices, the
    sweep loop is a ``fori_loop`` whose carry is the flattened (hi, lo)
    component tuple, and every op is elementwise DF arithmetic — exactly
    what a component-major (SoA) batch wants.  Same math, same results to df64
    rounding.
    """
    n = len(a)
    base = a[0][0].hi
    one = DF(jnp.ones_like(base), jnp.zeros_like(base))
    zero = DF(jnp.zeros_like(base), jnp.zeros_like(base))
    v = [[one if i == j else zero for j in range(n)] for i in range(n)]
    tiny = float(jnp.finfo(base.dtype).tiny)

    def flat(m):
        out = []
        for i in range(n):
            for j in range(n):
                out.extend((m[i][j].hi, m[i][j].lo))
        return tuple(out)

    def unflat(t):
        return [[DF(t[2 * (i * n + j)], t[2 * (i * n + j) + 1])
                 for j in range(n)] for i in range(n)]

    def sweep(_, carry):
        a_ = unflat(carry[0])
        v_ = unflat(carry[1])
        for p in range(n):
            for q in range(p + 1, n):
                app, aqq, apq = a_[p][p], a_[q][q], a_[p][q]
                tau = (aqq - app) * 0.5
                sgn = jnp.where(tau.hi >= 0, 1.0, -1.0).astype(base.dtype)
                hyp = df_sqrt(tau * tau + apq * apq + tiny)
                t = (sgn * apq) / (sgn * tau + hyp)
                c = 1.0 / df_sqrt(t * t + 1.0)
                s_ = t * c
                for j in range(n):
                    rp, rq = a_[p][j], a_[q][j]
                    a_[p][j] = c * rp - s_ * rq
                    a_[q][j] = s_ * rp + c * rq
                for i in range(n):
                    cp, cq = a_[i][p], a_[i][q]
                    a_[i][p] = c * cp - s_ * cq
                    a_[i][q] = s_ * cp + c * cq
                    vp, vq = v_[i][p], v_[i][q]
                    v_[i][p] = c * vp - s_ * vq
                    v_[i][q] = s_ * vp + c * vq
        return (flat(a_), flat(v_))

    a_f, v_f = jax.lax.fori_loop(0, sweeps, sweep, (flat(a), flat(v)))
    a_ = unflat(a_f)
    v_ = unflat(v_f)
    best_w = a_[0][0]
    best = [v_[i][0] for i in range(n)]
    for j in range(1, n):
        take = (a_[j][j].hi + a_[j][j].lo) < (best_w.hi + best_w.lo)
        best_w = df_where(take, a_[j][j], best_w)
        best = [df_where(take, v_[i][j], best[i]) for i in range(n)]
    return tuple(best)


def jacobi_smallest_col_df(a, sweeps: int = 8):
    """Smallest eigenvector of a symmetric component matrix in df64.

    The DF twin of :func:`sks_tpu.ops.linalg.jacobi_smallest_col_core`:
    ``a`` is an n x n list-of-lists of :class:`DF` components; every rotation
    runs in double-word arithmetic (rotation angles from :func:`df_sqrt`),
    giving fp64-grade eigenvectors of badly conditioned normal matrices —
    what NDLT needs at raw pixel scale, where the 9x9 LtL squares the
    conditioning beyond f32 (the reference solves this by being fp64
    everywhere, ``GPU_Runtime Test.cu:1034-1160``).

    Compile-friendly form: the components are packed into (..., n, n)
    hi/lo arrays and a single rotation body is ``lax.scan``-ned over the
    static (p, q) pair schedule (sweeps x 36 steps for n=9) — the graph holds
    ONE rotation, not sweeps*36 unrolled copies of it.

    Returns the eigenvector column (tuple of n DF components) for the
    smallest eigenvalue.
    """
    import jax
    import numpy as np

    n = len(a)
    ah = jnp.stack(
        [jnp.stack([a[i][j].hi for j in range(n)], -1) for i in range(n)], -2)
    al = jnp.stack(
        [jnp.stack([a[i][j].lo for j in range(n)], -1) for i in range(n)], -2)
    eye = jnp.broadcast_to(jnp.eye(n, dtype=ah.dtype), ah.shape)
    vh = eye
    vl = jnp.zeros_like(eye)
    tiny = float(jnp.finfo(ah.dtype).tiny)

    pairs = np.asarray(
        [(p, q) for p in range(n) for q in range(p + 1, n)], np.int32)
    schedule = jnp.asarray(np.tile(pairs, (sweeps, 1)))

    def rot(carry, pq):
        ah, al, vh, vl = carry
        p, q = pq[0], pq[1]

        def at(m_h, m_l, i, j):
            return DF(m_h[..., i, j], m_l[..., i, j])

        app = at(ah, al, p, p)
        aqq = at(ah, al, q, q)
        apq = at(ah, al, p, q)
        tau = (aqq - app) * 0.5
        sgn = jnp.where(tau.hi >= 0, 1.0, -1.0).astype(ah.dtype)
        hyp = df_sqrt(tau * tau + apq * apq + tiny)
        t = (sgn * apq) / (sgn * tau + hyp)
        c = 1.0 / df_sqrt(t * t + 1.0)
        s_ = t * c
        cb = DF(c.hi[..., None], c.lo[..., None])
        sb = DF(s_.hi[..., None], s_.lo[..., None])

        def rows(m_h, m_l, i):
            return DF(m_h[..., i, :], m_l[..., i, :])

        def setrow(m_h, m_l, i, v):
            return m_h.at[..., i, :].set(v.hi), m_l.at[..., i, :].set(v.lo)

        rp = rows(ah, al, p)
        rq = rows(ah, al, q)
        ah, al = setrow(ah, al, p, cb * rp - sb * rq)
        ah, al = setrow(ah, al, q, sb * rp + cb * rq)

        def cols(m_h, m_l, j):
            return DF(m_h[..., :, j], m_l[..., :, j])

        def setcol(m_h, m_l, j, v):
            return m_h.at[..., :, j].set(v.hi), m_l.at[..., :, j].set(v.lo)

        cp = cols(ah, al, p)
        cq = cols(ah, al, q)
        ah, al = setcol(ah, al, p, cb * cp - sb * cq)
        ah, al = setcol(ah, al, q, sb * cp + cb * cq)
        vp = cols(vh, vl, p)
        vq = cols(vh, vl, q)
        vh, vl = setcol(vh, vl, p, cb * vp - sb * vq)
        vh, vl = setcol(vh, vl, q, sb * vp + cb * vq)
        return (ah, al, vh, vl), None

    (ah, al, vh, vl), _ = jax.lax.scan(rot, (ah, al, vh, vl), schedule)

    diag = jnp.diagonal(ah, axis1=-2, axis2=-1) + jnp.diagonal(
        al, axis1=-2, axis2=-1)
    j = jnp.argmin(diag, axis=-1)
    vh_c = jnp.take_along_axis(vh, j[..., None, None], axis=-1)[..., 0]
    vl_c = jnp.take_along_axis(vl, j[..., None, None], axis=-1)[..., 0]
    return tuple(DF(vh_c[..., i], vl_c[..., i]) for i in range(n))


def invit_smallest_col_df(a, seed, shift_rel: float = 2.0 ** -40,
                          solves: int = 2):
    """Smallest eigenvector of a symmetric PSD DF matrix by shifted inverse
    iteration: one unrolled df64 LDL^T factorization + ``solves`` chained
    triangular solves.

    The ~40x cheaper twin of :func:`jacobi_smallest_col_df` for the
    *smallest-eigenvector-only* problem (which is all NDLT needs): the df64
    Jacobi runs sweeps x 36 rotations of ~150 df64 ops each (~45K df64 ops
    for 8 sweeps), while this runs one 9x9 LDL^T (~300 df64 multiply-adds,
    36 divisions — no square roots, which is why LDL^T over Cholesky) plus
    ``solves`` forward/diagonal/backward substitutions (~160 df64 ops each).

    Why it is as accurate: ``A + eps*I`` with ``eps = shift_rel * trace``
    is positive definite (A is a PSD normal matrix; the shift dominates the
    df64 rounding floor of the computed lambda_min ~ u*||A||, u ~ 2^-49),
    so the unpivoted LDL^T is stable.  Each solve amplifies the
    smallest-eigenvalue component by ~lambda_2/eps >= 1e9 relative to the
    rest; from an f32-grade seed (c_perp ~ 1e-7) one solve already puts the
    contamination below df64 roundoff, and the classic inverse-iteration
    result applies — the solve's backward error lands almost entirely
    *along* the returned direction, so direction accuracy is
    ~u*||A||/lambda_2, the same bound the converged Jacobi obeys.  The
    second solve (sharing the factorization) removes any dependence on seed
    quality short of exact orthogonality.

    Between solves the iterate is rescaled by the exact power of two
    ``shift_rel`` (lossless in fp32) so hi words stay in range despite the
    ~1/eps per-solve growth.

    Fully static/unrolled (no gathers, no scan).

    Args:
      a: n x n list-of-lists of :class:`DF` components (symmetric PSD).
      seed: length-n list of DF components, a rough smallest-eigenvector
        guess (e.g. a few f32 Jacobi sweeps); must not be orthogonal to it.
      shift_rel: diagonal shift relative to trace(a).
      solves: inverse-iteration steps re-using the one factorization.

    Returns the eigenvector as a tuple of n DF components, up to scale.
    """
    n = len(a)
    tr = a[0][0]
    for i in range(1, n):
        tr = tr + a[i][i]
    eps = tr * shift_rel
    # LDL^T of A + eps I.  W[i][j] = L[i][j] * d[j] halves the inner-sum
    # multiplies (one product per term instead of two).
    lmat = [[None] * n for _ in range(n)]
    wmat = [[None] * n for _ in range(n)]
    d = [None] * n
    for j in range(n):
        s = a[j][j] + eps
        for k in range(j):
            s = s - lmat[j][k] * wmat[j][k]
        d[j] = s
        for i in range(j + 1, n):
            t = a[i][j]
            for k in range(j):
                t = t - lmat[i][k] * wmat[j][k]
            wmat[i][j] = t
            lmat[i][j] = t / s
    x = list(seed)
    scale = float(shift_rel)
    for _ in range(solves):
        y = []
        for i in range(n):
            yi = x[i]
            for k in range(i):
                yi = yi - lmat[i][k] * y[k]
            y.append(yi)
        z = [y[i] / d[i] for i in range(n)]
        xn = [None] * n
        for i in reversed(range(n)):
            xi = z[i]
            for k in range(i + 1, n):
                xi = xi - lmat[k][i] * xn[k]
            xn[i] = xi
        x = [DF(v.hi * scale, v.lo * scale) for v in xn]
    return tuple(x)


def ndlt_df64_h(src: Array, tar: Array, sweeps: int = 8,
                df_eig: str = "invit") -> DF:
    """Minimal-set (N=4) NDLT in df64: fp64-grade from fp32 arithmetic.

    Runs the identical block-structured chain as
    :func:`sks_tpu.ops.ndlt.ndlt_core` — Hartley normalization, the 24
    weighted p p^T sums, the 9x9 smallest-eigenvector solve — entirely in
    double-word arithmetic.  This is the refine-grade NDLT that lets fp32
    arithmetic match the reference's fp64 normal-matrix solve (``DLT.cpp:53-119``);
    the f32 path is conditioning-limited at raw pixel scale (measured:
    ~1e3 px median on wall-fixture minimal sets vs ~0.4 px for this).

    ``df_eig='invit'`` (default) solves the eigenproblem by shifted inverse
    iteration (:func:`invit_smallest_col_df` — f32 Jacobi seed + df64 LDL^T
    + 2 solves, ~1/40 the df64 ops of the converged Jacobi at equal
    direction accuracy); ``'jacobi'`` keeps the full df64 Jacobi
    (``sweeps`` applies to that path only).

    Returns DF of (..., 3, 3), up to scale.
    """
    from sks_tpu.ops.ndlt import ndlt_core

    h = ndlt_core(*_df_components(src), *_df_components(tar), sweeps=sweeps,
                  df_eig=df_eig)
    hi = jnp.stack([e.hi for e in h], axis=-1).reshape(*h[0].hi.shape, 3, 3)
    lo = jnp.stack([e.lo for e in h], axis=-1).reshape(*h[0].lo.shape, 3, 3)
    return DF(hi, lo)


def _df64_h_from_core(core, src, tar, **kw) -> DF:
    h = core(*_df_components(src), *_df_components(tar), **kw)
    hi = jnp.stack([e.hi for e in h], axis=-1).reshape(*h[0].hi.shape, 3, 3)
    lo = jnp.stack([e.lo for e in h], axis=-1).reshape(*h[0].lo.shape, 3, 3)
    return DF(hi, lo)


def ge_df64_h(src: Array, tar: Array) -> DF:
    """RHO-GE in df64 (fp64 twin of ``cv::runKernel_GE``, fp32-only in the
    reference ``GE.cpp:44-188`` but fp64 on its GPU, ``.cu:359-507``): the
    identical dtype-polymorphic :func:`sks_tpu.ops.ge.ge_core` on DF pairs.
    Returns DF of (..., 3, 3) with h22 == 1 by construction."""
    from sks_tpu.ops.ge import ge_core

    return _df64_h_from_core(ge_core, src, tar)


def gpt_df64_h(src: Array, tar: Array) -> DF:
    """GPT-LU in df64 (fp64 twin of the reference's per-thread pivoted LU,
    ``GPU_Runtime Test.cu:242-357``): the branch-free pivoted Gauss-Jordan
    :func:`sks_tpu.ops.gpt.gpt_core` on DF pairs (pivot selection compares
    evaluated hi+lo magnitudes).  Returns DF of (..., 3, 3), h22 == 1."""
    from sks_tpu.ops.gpt import gpt_core

    return _df64_h_from_core(gpt_core, src, tar)


def ho_df64_h(src: Array, tar: Array) -> DF:
    """Harker-O'Leary in df64 (fp64 twin of ``cal_Homo_HO``,
    ``GPU_Runtime Test.cu:788-1031``): :func:`sks_tpu.ops.ho.ho_core` on DF
    pairs — df64 isotropic normalization (df_sqrt distances), the reduced
    3x3 eigenproblem by LDL^T inverse iteration, df64 back-substitution.
    Returns DF of (..., 3, 3), up to scale."""
    from sks_tpu.ops.ho import ho_core

    return _df64_h_from_core(ho_core, src, tar)
