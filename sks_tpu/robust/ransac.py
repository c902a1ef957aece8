"""Fixed-shape vectorized RANSAC for homography fitting.

The compiled replacement for the data-dependent RANSAC loop (SURVEY.md §7
hard part (d)): instead of iterating until a confidence bound is met, generate
a *fixed* batch of B hypotheses (sized for the worst-case outlier ratio, just
like the reference's RANSAC-motivated batch sizes, ``imgs/GPU-runtime.png``),
solve them all with the batched minimal solver, score them all, and take the
consensus argmax — everything static-shape, jit-compiled, and shardable over a
device mesh (hypotheses are embarrassingly parallel, the consensus is one tiny
collective).

Degenerate hypotheses (collinear samples, duplicate indices, non-finite H) are
masked with a score of -1 rather than branched on — the fault-masking strategy
SURVEY.md §5 calls for.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from sks_tpu.geom.homography import apply_homography, inv_h
from sks_tpu.ops import SOLVERS_H, aca_valid_mask, sks_valid_mask
from sks_tpu.ops.ndlt import ndlt_h

__all__ = [
    "RansacConfig",
    "RansacResult",
    "magsac_weights",
    "ransac_homography",
    "ransac_homography_adaptive",
    "sample_minimal_sets",
    "sample_minimal_sets_prosac",
    "prosac_prefix_sizes",
    "score_hypotheses",
]

#: MAGSAC++ residual-space dimensionality: the symmetric transfer error is a
#: 4-vector (forward + backward 2D reprojection), so nu = 4 and the 0.99
#: chi^2_4 quantile gives tau(sigma) = k * sigma with k = sqrt(13.2767).
_MAGSAC_NU = 4.0
_MAGSAC_K = 3.6437


def magsac_weights(r2: Array, sigma_max, k: float = _MAGSAC_K) -> Array:
    """Sigma-marginalized point weights (MAGSAC-style sigma-consensus).

    Model: the noise scale is unknown; each ``sigma ~ U(0, sigma_max]`` deems
    a point an inlier within ``tau(sigma) = k * sigma`` (k the 0.99 chi_4
    quantile — the symmetric transfer residual is 4-dimensional) and scores
    it with the truncated-quadratic (MSAC) gain.  Marginalizing that gain
    over the sigma prior has a closed form:

        (1/s) ∫_0^s max(0, 1 - r²/(k²σ²)) dσ = (1 - r / (k s))²_+ ,  s = σ_max

    — a flat-topped weight, smoothly decaying, exactly 0 beyond ``k σ_max``:
    no single threshold is trusted, which is the point of MAGSAC's
    sigma-consensus (Barath et al., CVPR 2019/2020; no reference counterpart
    — the reference has no robust estimator).  These weights both score
    models (their sum is the marginalized soft consensus) and drive the
    weighted-DLT polishing step, the two halves of sigma-consensus.

    Args:
      r2: (...) squared residuals (symmetric transfer, 4-dim).
      sigma_max: maximum noise scale in pixels, set generously (the MAGSAC
        papers use ~10 px everywhere).

    Returns:
      weights in [0, 1], same shape as ``r2``.
    """
    sigma_max = jnp.asarray(sigma_max, r2.dtype)
    r = jnp.sqrt(jnp.maximum(r2, 0.0))
    w = jnp.clip(1.0 - r / (k * sigma_max), 0.0, 1.0) ** 2
    return jnp.where(jnp.isfinite(r2), w, 0.0)


@dataclass(frozen=True)
class RansacConfig:
    """Static RANSAC parameters (hashable -> usable as jit static arg)."""

    num_hypotheses: int = 2048
    threshold: float = 3.0  # pixels, symmetric transfer
    solver: str = "aca"
    refine_iters: int = 2  # IRLS refinement rounds on the winning consensus
    scoring: str = "inliers"  # 'inliers' (RANSAC) | 'msac' | 'magsac' | 'lmeds'
    sampling: str = "uniform"  # 'uniform' | 'prosac' (points sorted by quality)
    # MAGSAC++ maximum noise scale.  None -> 3 * threshold: sigma_max is meant
    # to be set generously (the MAGSAC paper uses ~10 px everywhere) — the
    # marginalization, not the user, localizes the true scale.
    sigma_max: float | None = None
    # LO-RANSAC candidate count: the top-K hypotheses (not just the argmax)
    # are polished and the winner is selected *post*-polish — a bad champion
    # basin cannot eclipse a recoverable runner-up.  K NDLT solves ~ free next
    # to scoring B hypotheses.
    lo_candidates: int = 4
    # Score residuals in double-word (df64) arithmetic — fp64-grade inlier
    # decisions from fp32 arithmetic (the reference scores in fp64 everywhere;
    # ops/df64.residual2_df64).  ~10x elementwise scoring cost; off by
    # default.
    df64_scoring: bool = False
    # Final geometric polish: annealed-threshold Levenberg-Marquardt on the
    # selected model's consensus (robust.polish.anneal_polish) — the
    # reprojection-error refinement cv2.findHomography ends with, plus
    # threshold annealing that beats cv2's single-level LM on real-photo
    # pairs (bench_results/REAL_PHOTO.md).  O(N) per iteration; on by
    # default.
    final_polish: bool = True


@jax.tree_util.register_pytree_node_class
@dataclass
class RansacResult:
    h: Array  # (..., 3, 3) best model, H[2,2]-normalized
    inlier_mask: Array  # (..., N) bool
    num_inliers: Array  # (...,) int32
    score: Array  # (...,) float — scoring-dependent quality (higher better)

    def tree_flatten(self):
        return (self.h, self.inlier_mask, self.num_inliers, self.score), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)


def sample_minimal_sets(key: Array, num_points: Array | int, batch: int) -> Array:
    """(B, 4) random index tuples into the correspondence set.

    Independent uniform draws (collisions allowed — they produce degenerate
    hypotheses that scoring masks out; same trade as the reference's
    ``% size`` resampling, ``GPU_Runtime Test.cu:71-76``).
    """
    return jax.random.randint(key, (batch, 4), 0, num_points, dtype=jnp.int32)


def prosac_prefix_sizes(num_points: int, batch: int, m: int = 4):
    """PROSAC growth schedule: prefix size n_t for each hypothesis t.

    The Chum & Matas (2005) growth function — how many top-quality
    correspondences hypothesis t may draw from — computed with the standard
    recurrence T'_{n+1} = T'_n + ceil(T_{n+1} - T_n),
    T_{n+1} = T_n (n+1)/(n+1-m).  Data-independent (depends only on
    ``num_points`` and ``batch``), so it is evaluated at trace time and baked
    into the compiled program as a constant: progressive sampling costs
    nothing on device.

    Returns an int32 numpy array (batch,) with m <= n_t <= num_points,
    non-decreasing.
    """
    import math

    import numpy as np

    n_pts = int(num_points)
    t_n = float(batch)
    for i in range(m):
        t_n *= (m - i) / (n_pts - i)  # T_m
    sizes = np.empty(batch, np.int32)
    n = m
    t_prime = 1.0
    for t in range(batch):
        if t + 1 > t_prime and n < n_pts:
            t_next = t_n * (n + 1) / (n + 1 - m)
            t_prime += math.ceil(t_next - t_n)
            t_n = t_next
            n += 1
        sizes[t] = n
    return sizes


def sample_minimal_sets_prosac(
    key: Array, num_points: int, batch: int, sizes: Array | None = None
) -> Array:
    """(B, 4) progressive index tuples (PROSAC; Chum & Matas 2005).

    Assumes correspondences are sorted by descending match quality (e.g. the
    scores from ``sks_tpu.features.matching``).  Hypothesis t draws point
    n_t - 1 (the newest admitted) plus 3 *distinct* picks from the first
    n_t - 1 (sequential shifted draws — at the smallest prefix a
    with-replacement draw would waste ~78% of hypotheses on duplicates).

    ``sizes`` optionally supplies a precomputed growth schedule slice so
    chunked callers can continue one global schedule instead of restarting it
    (see :func:`ransac_homography_adaptive`).

    Padded fixed-shape sets: PROSAC assumes quality-sorted points, so pad at
    the *end* (the natural layout for a quality-sorted matcher).  The growth
    schedule then touches padded slots only in its late uniform tail, where
    scoring's ``point_mask`` discards them — no special handling needed
    (uniform sampling, by contrast, draws mask-aware, see ``_sample_chunk``).
    """
    if sizes is None:
        sizes = jnp.asarray(prosac_prefix_sizes(num_points, batch))  # (B,)
    u = jax.random.uniform(key, (batch, 3))
    m = (sizes - 1).astype(u.dtype)  # companion pool: the top n_t - 1 points
    i0 = jnp.floor(u[:, 0] * m).astype(jnp.int32)
    i1 = jnp.floor(u[:, 1] * (m - 1.0)).astype(jnp.int32)
    i1 = i1 + (i1 >= i0).astype(jnp.int32)
    i2 = jnp.floor(u[:, 2] * (m - 2.0)).astype(jnp.int32)
    lo = jnp.minimum(i0, i1)
    hi = jnp.maximum(i0, i1)
    i2 = i2 + (i2 >= lo).astype(jnp.int32)
    i2 = i2 + (i2 >= hi).astype(jnp.int32)
    head = jnp.stack([i0, i1, i2], axis=-1)
    return jnp.concatenate([head, sizes[:, None] - 1], axis=-1)


def _residual2(h: Array, src: Array, tar: Array,
               df64: bool = False) -> Array:
    """Squared symmetric transfer error of hypotheses (B,3,3) on points (N,2).

    Returns (B, N).  Written against precomputed homogeneous products so the
    whole thing fuses into one bandwidth-light elementwise pass.  With
    ``df64=True`` the transfer chain runs in double-word arithmetic
    (:func:`sks_tpu.ops.df64.residual2_df64`) — fp64-grade residual ordering
    from fp32 arithmetic, at ~10x the elementwise cost.
    """
    if df64:
        from sks_tpu.ops.df64 import residual2_df64

        return residual2_df64(h, src, tar)
    # Unnormalised hypotheses (the division-free ACA core reaches ~1e20 at
    # pixel coordinates) would overflow float32 in the adjugate's products.
    h = h / jnp.max(jnp.abs(h), axis=(-2, -1), keepdims=True)
    d1 = apply_homography(h, src) - tar[..., None, :, :]
    hinv = inv_h(h)
    d2 = apply_homography(hinv, tar) - src[..., None, :, :]
    return jnp.sum(d1 * d1, axis=-1) + jnp.sum(d2 * d2, axis=-1)


def score_hypotheses(
    h: Array,
    src: Array,
    tar: Array,
    threshold: float,
    point_mask: Array | None = None,
    scoring: str = "inliers",
    sigma_max: float | None = None,
    df64: bool = False,
):
    """Score a batch of hypotheses against all correspondences.

    Args:
      h: (B, 3, 3) hypotheses (any scale).
      src, tar: (N, 2) correspondences (leading batch dims broadcast).
      threshold: inlier threshold in pixels (symmetric transfer).
      point_mask: optional (N,) validity for padded point sets.
      scoring: 'inliers' counts; 'msac' sums truncated quadratic gains;
        'magsac' the sigma-marginalized soft consensus (sum of
        :func:`magsac_weights` with sigma_max = threshold — MAGSAC++
        sigma-consensus scoring); 'lmeds' negated median squared residual
        (threshold-free, cv2.LMEDS — inliers from the 2.5-robust-sigma rule
        on the median).

    Returns:
      (scores (B,), inlier_mask (B, N)) — degenerate/non-finite hypotheses get
      score -1 and empty masks.
    """
    r2 = _residual2(h, src, tar, df64=df64)  # (B, N)
    t2 = jnp.asarray(threshold * threshold, r2.dtype)
    finite = jnp.all(jnp.isfinite(h), axis=(-2, -1))
    r2 = jnp.where(jnp.isfinite(r2), r2, jnp.inf)
    inl = r2 < t2
    if point_mask is not None:
        inl = inl & point_mask
    if scoring == "inliers":
        score = jnp.sum(inl, axis=-1).astype(r2.dtype)
    elif scoring == "msac":
        gain = jnp.maximum(0.0, 1.0 - r2 / t2)
        if point_mask is not None:
            gain = jnp.where(point_mask, gain, 0.0)
        score = jnp.sum(gain, axis=-1)
    elif scoring == "magsac":
        # MAGSAC++ sigma-consensus: marginalized soft inlier mass (closed-form
        # incomplete-gamma weights).  The inlier *mask* stays at the user
        # threshold (cv2 semantics); only scoring/polishing marginalize sigma.
        g = magsac_weights(r2, sigma_max if sigma_max is not None else 3.0 * threshold)
        if point_mask is not None:
            g = jnp.where(point_mask, g, 0.0)
        score = jnp.sum(g, axis=-1)
    elif scoring == "lmeds":
        # Least-median-of-squares (cv2.LMEDS): threshold-free model score;
        # inliers from the standard robust-sigma rule on the median residual.
        r2m = (
            jnp.where(point_mask, r2, jnp.nan) if point_mask is not None else r2
        )
        med = jnp.nanmedian(jnp.where(jnp.isfinite(r2m), r2m, jnp.nan), axis=-1)
        med = jnp.where(jnp.isfinite(med), med, jnp.inf)
        score = -med
        nf = (
            jnp.sum(point_mask) if point_mask is not None else r2.shape[-1]
        )
        sigma = 2.5 * 1.4826 * (1.0 + 5.0 / jnp.maximum(nf - 4.0, 1.0)) * jnp.sqrt(med)
        # Floor sigma (as cv2 does): on exact/noise-free data the median
        # residual is ~0 and an unfloored rule would report zero inliers.
        sigma = jnp.maximum(sigma, 1e-3)
        inl = r2 < (sigma * sigma)[..., None]
        if point_mask is not None:
            inl = inl & point_mask
    else:
        raise ValueError(f"unknown scoring {scoring!r}")
    worst = -jnp.inf if scoring == "lmeds" else -1.0
    score = jnp.where(finite, score, worst)
    inl = inl & finite[..., None]
    return score, inl


def _irls_refine(h0: Array, src: Array, tar: Array, iters: int,
                 threshold: float, point_mask: Array | None = None,
                 scoring: str = "inliers",
                 sigma_max: float | None = None,
                 df64: bool = False) -> Array:
    """Local optimization: annealed IRLS NDLT (LO-RANSAC + GNC).

    Each iteration rebuilds the weight set from the *current* model's
    residuals, so the refit can grow the consensus beyond the seed
    hypothesis's inliers (post-polish selection in the caller guards
    regressions).  The scale anneals 4x -> 1x over the iterations (graduated
    non-convexity): a coarse first basin lets a mediocre seed slide toward
    the global consensus before the weights sharpen.  ``scoring='magsac'``
    uses the sigma-marginalized :func:`magsac_weights` instead of a hard
    threshold — MAGSAC++'s sigma-consensus polishing.  Padded points
    (``point_mask``) never receive weight.
    """
    pm = None if point_mask is None else jnp.asarray(point_mask, src.dtype)
    sm = sigma_max if sigma_max is not None else 3.0 * threshold

    def body(t, h):
        # GNC schedule: 2^(iters-2-t) capped to [1, 4] => e.g. [4,2,1,1].
        scale = jnp.clip(
            2.0 ** (iters - 2 - t).astype(src.dtype), 1.0, 4.0
        )
        r2 = _residual2(h[None], src, tar, df64=df64)[0]
        if scoring == "magsac":
            w = magsac_weights(r2, scale * jnp.asarray(sm, src.dtype))
            w = w.astype(src.dtype)
        else:
            thr = scale * threshold
            w = jnp.where(r2 < thr * thr, 1.0, 0.0).astype(src.dtype)
        if pm is not None:
            w = w * pm
        h_new = ndlt_h(src, tar, weights=w)
        # Require >= 4 points of effective weight mass, not just 4 nonzeros —
        # a refit from vanishing weights is ill-conditioned garbage.
        ok = jnp.all(jnp.isfinite(h_new)) & (jnp.sum(w) >= 4)
        return jnp.where(ok, h_new, h)

    return jax.lax.fori_loop(0, iters, body, h0)


def _sample_chunk(key, n, config, prosac_sizes=None, point_mask=None):
    if config.sampling == "prosac":
        return sample_minimal_sets_prosac(
            key, n, config.num_hypotheses, sizes=prosac_sizes
        )
    if config.sampling == "uniform":
        if point_mask is None:
            return sample_minimal_sets(key, n, config.num_hypotheses)
        # Padded sets: draw only valid indices (a uniform draw over all N
        # slots would need (n_valid/N)^4 luck per hypothesis — at 60 valid
        # of 512 that is ~2e-4, i.e. a 2048-hypothesis budget with <1 usable
        # sample).  Gumbel-categorical over the mask keeps the fixed shape.
        logits = jnp.where(point_mask, 0.0, -jnp.inf)
        return jax.random.categorical(
            key, logits, shape=(config.num_hypotheses, 4)
        ).astype(jnp.int32)
    raise ValueError(f"unknown sampling {config.sampling!r}")


def _eval_chunk(key, src, tar, config, point_mask, prosac_sizes=None):
    """Sample + solve + score one fixed-shape batch; return its champion."""
    n = src.shape[-2]
    solver = SOLVERS_H[config.solver]
    idx = _sample_chunk(key, n, config, prosac_sizes, point_mask)
    s4 = jnp.take(src, idx, axis=0)  # (B, 4, 2)
    t4 = jnp.take(tar, idx, axis=0)
    h = solver(s4, t4)  # (B, 3, 3), up to scale
    if config.solver == "aca":
        valid = aca_valid_mask(s4, t4)
        h = jnp.where(valid[..., None, None], h, jnp.nan)
    elif config.solver == "sks":
        # SKS has its own degeneracy set (M==N anchors, P/Q on the MN line,
        # vanishing kernel determinant) — mask with the SKS-specific rule so
        # near-degenerate-but-finite hypotheses score -1 instead of garbage.
        valid = sks_valid_mask(s4, t4)
        h = jnp.where(valid[..., None, None], h, jnp.nan)
    scores, inl = score_hypotheses(
        h, src, tar, config.threshold, point_mask, config.scoring,
        config.sigma_max, config.df64_scoring,
    )
    k_cand = max(1, min(config.lo_candidates, config.num_hypotheses))
    sc_top, top_idx = jax.lax.top_k(scores, k_cand)
    return h[top_idx], sc_top, inl[top_idx[0]]


def _refine_and_pack(h_top, sc_top, inl_best, src, tar, config, point_mask):
    """Shared tail: polish the top-K candidates, select post-polish, normalize.

    Args:
      h_top: (K, 3, 3) best hypotheses by pre-polish score, best first.
      sc_top: (K,) their scores.
      inl_best: (N,) inlier mask of the pre-polish champion.
    """
    h_best, score0 = h_top[0], sc_top[0]
    if config.refine_iters > 0:
        h_pol = jax.vmap(
            lambda h: _irls_refine(
                h, src, tar, config.refine_iters, config.threshold,
                point_mask, config.scoring, config.sigma_max,
                config.df64_scoring,
            )
        )(h_top)
        # Candidates: every polished model, plus the raw champion as the
        # keep-if-better fallback (last, so polished wins score ties).
        cand = jnp.concatenate([h_pol, h_best[None]], axis=0)
        sc, inls = score_hypotheses(
            cand, src, tar, config.threshold, point_mask,
            config.scoring, config.sigma_max, config.df64_scoring,
        )
        if config.scoring == "lmeds":
            # LMedS selects by median but (like cv2) keeps the least-squares
            # refit that explains the most robust-sigma inliers — a
            # minimal-sample champion often has a marginally lower median yet
            # a much smaller consensus set.
            sel = jnp.sum(inls, axis=-1).astype(sc.dtype)
        else:
            sel = sc
        idx = jnp.argmax(sel)
        h_best = cand[idx]
        inl_best = inls[idx]
        score0 = sc[idx]
    if config.final_polish:
        from sks_tpu.robust.polish import anneal_polish, gn_refine_h

        if config.scoring == "lmeds":
            # No fixed threshold to anneal: one weighted LM on the
            # robust-sigma consensus of the selected model.
            h_pol = gn_refine_h(h_best, src, tar, inl_best.astype(src.dtype))
        else:
            h_pol = anneal_polish(
                h_best, src, tar, config.threshold, point_mask
            )
        # Report mask/score of the polished model at the *user* threshold
        # (cv2 semantics: the polish improves the model, not the inlier rule).
        sc_p, inl_p = score_hypotheses(
            h_pol[None], src, tar, config.threshold, point_mask,
            config.scoring, config.sigma_max, config.df64_scoring,
        )
        ok = jnp.all(jnp.isfinite(h_pol))
        if config.scoring != "lmeds":
            # Collapse guard: a geometric polish may trade a few thresholded
            # inliers for accuracy (that is its job), but a LARGE consensus
            # drop means the refit left the basin — keep the pre-polish
            # model.  (Defense in depth: a real-hardware precision bug once
            # collapsed 205 -> 53 through this stage, finite throughout.)
            ok = ok & (sc_p[0] >= 0.5 * score0)
        h_best = jnp.where(ok, h_pol, h_best)
        inl_best = jnp.where(ok, inl_p[0], inl_best)
        score0 = jnp.where(ok, sc_p[0], score0)
    h_best = h_best / h_best[2, 2]
    return RansacResult(
        h=h_best,
        inlier_mask=inl_best,
        num_inliers=jnp.sum(inl_best).astype(jnp.int32),
        score=score0,
    )


@partial(jax.jit, static_argnames=("config",))
def ransac_homography(
    key: Array,
    src: Array,
    tar: Array,
    config: RansacConfig = RansacConfig(),
    point_mask: Array | None = None,
) -> RansacResult:
    """Fit a homography to (N, 2) correspondences by vectorized RANSAC.

    One jit-compiled, fixed-shape pipeline: sample -> batched minimal solve ->
    score -> argmax consensus -> IRLS local refinement.

    Args:
      key: PRNG key.
      src, tar: (N, 2) matched points.
      config: static parameters.
      point_mask: optional (N,) bool for padded sets.

    Returns:
      RansacResult with the best model (normalized), its inliers and score.
    """
    h_best, score_best, inl_best = _eval_chunk(key, src, tar, config, point_mask)
    return _refine_and_pack(
        h_best, score_best, inl_best, src, tar, config, point_mask
    )


#: Default cap on the geometric chunk growth: measured, growing to 2^17 beat a 4096 cap by ~10% at
#: high outlier rates — XLA chunk cost is ~linear in size above 4096, so a
#: large cap only sheds loop-iteration overhead.
ADAPTIVE_MAX_CHUNK = 131072


def _chunk_schedule(chunk0: int, max_chunks: int, growth: int,
                    chunks_per_stage: int, max_chunk: int):
    """[(chunk_size, num_chunks), ...] stages covering chunk0 * max_chunks.

    Geometric growth: ``chunks_per_stage`` chunks at each size, size x
    ``growth`` between stages, capped at ``max_chunk``; the final stage
    absorbs the remaining budget at the cap size.
    """
    total = chunk0 * max_chunks
    if growth <= 1 or max_chunks <= 1 or max_chunk <= chunk0:
        return [(chunk0, max_chunks)]
    stages = []
    c, budget = chunk0, 0
    while budget < total:
        remaining_chunks = -(-(total - budget) // c)
        n = remaining_chunks if c >= max_chunk else min(
            chunks_per_stage, remaining_chunks
        )
        stages.append((c, n))
        budget += c * n
        c = min(c * growth, max_chunk)
    return stages


@partial(jax.jit, static_argnames=("config", "max_chunks", "growth",
                                   "chunks_per_stage", "max_chunk"))
def ransac_homography_adaptive(
    key: Array,
    src: Array,
    tar: Array,
    config: RansacConfig = RansacConfig(),
    confidence: float = 0.99,
    max_chunks: int = 16,
    point_mask: Array | None = None,
    growth: int = 4,
    chunks_per_stage: int = 2,
    max_chunk: int | None = None,
) -> RansacResult:
    """RANSAC with confidence-based early exit (cv2 ``confidence`` semantic).

    The fixed-batch :func:`ransac_homography` sizes its budget for the
    worst-case outlier ratio; on easy problems most of that work is wasted.
    This variant evaluates hypotheses in fixed-shape chunks inside
    ``lax.while_loop``s and stops once the standard RANSAC termination bound
    says the hypotheses drawn so far find an all-inlier sample with
    probability >= ``confidence``:

        k_needed = log(1 - confidence) / log(1 - w^4),   w = inlier ratio.

    The total draw is bounded by the stage schedule built from a budget of
    ``config.num_hypotheses * max_chunks`` hypotheses: the final stage
    absorbs the remainder at the grown chunk size, so the worst case rounds
    that budget UP to a stage boundary (e.g. 1024 x 16 schedules 26,624,
    ~1.6x — see ``_chunk_schedule``); the bound-met exit makes the typical
    draw far smaller.

    **Geometric chunk growth**: chunk sizes start at
    ``config.num_hypotheses`` and grow ``growth``x every
    ``chunks_per_stage`` chunks up to ``max_chunk`` — a low-outlier fit
    exits after one small chunk, while a high-outlier fit reaches large
    batches that shed per-chunk loop overhead.  Each stage is its own
    fixed-shape ``while_loop``; once the bound is met every later stage's
    loop runs zero iterations.  Everything stays static-shape — the
    data-dependent part is only the trip counts, which XLA supports natively
    (SURVEY.md §7 hard part (d)).

    ``confidence`` is traced (changing it does not recompile); ``max_chunks``,
    ``config``, and the schedule parameters are static.  ``max_chunk``
    defaults to 2^17 (XLA chunk cost is ~linear in size above 4096, so large
    chunks only shed loop overhead); ``growth=1`` recovers a flat schedule.
    """
    nf = (
        jnp.sum(point_mask).astype(src.dtype)
        if point_mask is not None
        else jnp.asarray(src.shape[-2], src.dtype)
    )
    chunk0 = config.num_hypotheses
    if max_chunk is None:
        max_chunk = ADAPTIVE_MAX_CHUNK
    stages = _chunk_schedule(chunk0, max_chunks, growth, chunks_per_stage,
                             max_chunk)
    total_budget = sum(c * n for c, n in stages)
    conf = jnp.clip(jnp.asarray(confidence, src.dtype), 0.0, 1.0 - 1e-7)

    def needed(num_inl):
        w = num_inl / jnp.maximum(nf, 1.0)
        p_good = jnp.clip(w**4, 1e-12, 1.0 - 1e-7)
        return jnp.log1p(-conf) / jnp.log1p(-p_good)

    # PROSAC: one global growth schedule over the worst-case budget, sliced
    # per chunk at the running hypothesis offset — later chunks continue
    # toward uniform sampling instead of re-drawing the quality-concentrated
    # head every time.
    all_sizes = (
        jnp.asarray(prosac_prefix_sizes(src.shape[-2], total_budget))
        if config.sampling == "prosac"
        else None
    )
    k_cand = max(1, min(config.lo_candidates, chunk0))

    n = src.shape[-2]
    carry = (
        key,
        jnp.full((k_cand, 3, 3), jnp.nan, src.dtype),
        jnp.full((k_cand,), -jnp.inf, src.dtype),
        jnp.zeros((n,), bool),
        jnp.asarray(0.0, src.dtype),
        jnp.asarray(0, jnp.int32),  # hypotheses drawn so far
    )

    for c_s, n_s in stages:
        cfg_s = replace(config, num_hypotheses=c_s)

        def cond(state, n_s=n_s):
            j, (_, _, _, _, ninl, done) = state
            return (j < n_s) & (done.astype(src.dtype) < needed(ninl))

        def body(state, c_s=c_s, cfg_s=cfg_s):
            j, (k, h_k, sc_k, inl, ninl, done) = state
            k, sub = jax.random.split(k)
            sizes_i = (
                jax.lax.dynamic_slice(all_sizes, (done,), (c_s,))
                if all_sizes is not None
                else None
            )
            h_c, sc_c, inl_c = _eval_chunk(
                sub, src, tar, cfg_s, point_mask, prosac_sizes=sizes_i
            )
            # Merge running top-K with this chunk's top-K.
            sc_all = jnp.concatenate([sc_k, sc_c])
            h_all = jnp.concatenate([h_k, h_c])
            sc_new, idx = jax.lax.top_k(sc_all, k_cand)
            h_new = h_all[idx]
            better = sc_c[0] > sc_k[0]
            inl = jnp.where(better, inl_c, inl)
            ninl = jnp.where(better, jnp.sum(inl_c).astype(src.dtype), ninl)
            return (j + 1, (k, h_new, sc_new, inl, ninl, done + c_s))

        _, carry = jax.lax.while_loop(
            cond, body, (jnp.asarray(0, jnp.int32), carry)
        )

    _, h_top, sc_top, inl_best, _, _ = carry
    # All-or-nothing fallback per candidate: a partially-finite model must not
    # be blended elementwise with the identity.
    finite = jnp.all(jnp.isfinite(h_top), axis=(-2, -1))
    h_top = jnp.where(
        finite[:, None, None], h_top, jnp.eye(3, dtype=src.dtype)
    )
    return _refine_and_pack(
        h_top, sc_top, inl_best, src, tar, config, point_mask
    )

