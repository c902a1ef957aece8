"""IHN-style iterative deep homography estimation with an ACA-rect core.

The reference carries ``TensorDLT_2`` (torchgeometry's
``get_perspective_transform``) explicitly because the Iterative Homography
Network uses it as the inner solver of a recurrent estimate-warp-correct loop
(``PyTorch Codes/Modules_Runtime_Test.py:81-101`` attribution).  This module
provides that model family as one fixed-shape JAX program:

  encode both images once -> loop (static trip count, shared weights):
    H_k = aca_rect(corners + offsets_k)          # ~50-flop closed-form head
    warp features of image 2 by H_k              # bilinear gather
    delta_k = CNN(f1, f2_warped, f2_warped - f1) # correction
    offsets_{k+1} = offsets_k + delta_k

Design notes:
  * The warp samples f2 *at* H(grid) — the forward map — so no 3x3 inverse is
    ever formed; together with the division-free ACA-rect head the whole loop
    body is gathers + convs + straight-line FP.
  * The iteration count is static and the weights are shared, so the loop is
    unrolled into one jit region (no data-dependent control flow); all conv
    work is NHWC.
  * Training uses the RAFT/IHN exponentially-weighted sequence loss over the
    per-iteration estimates.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import flax.linen as nn
import optax
from jax import Array

from sks_tpu.features.descriptors import _bilinear_weights, bilinear_sample
from sks_tpu.geom.homography import apply_homography
from sks_tpu.models.deep_homography import TrainState, corner_loss
from sks_tpu.ops.aca_rect import aca_rect, rect_corners

__all__ = [
    "IterativeHomographyNet",
    "warp_by_homography",
    "sequence_loss",
    "create_ihn_state",
    "ihn_train_step",
]


def warp_by_homography(img: Array, h: Array, sampler: str = "auto") -> Array:
    """Sample ``img`` at H(grid): out(x) = img(H x), bilinear, edge-clamped.

    ``sampler='gather'`` (also what ``'auto'`` means) gathers; its backward
    pass scatter-adds.  ``sampler='matmul'`` runs the interpolation as
    one-hot row-weight matmuls over the channel-concatenated feature map,
    dense work in both directions (the VJP of a matmul is a matmul) — the
    better arm only where gathers serialize.  Gathers won both sampling
    sites measured on the H100 (descriptors, ESM polish; PERF.md).

    Args:
      img: (B, S, S, C) feature/image stack.
      h: (B, 3, 3) homography in the pixel coordinates of ``img``.

    Returns:
      (B, S, S, C) warped stack (differentiable in both arguments).
    """
    b, s, _, c = img.shape
    xs = jnp.arange(s, dtype=img.dtype)
    gy, gx = jnp.meshgrid(xs, xs, indexing="ij")
    grid = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)  # (S*S, 2) as (x, y)
    pts = apply_homography(h, grid)  # (B, S*S, 2)
    if sampler == "matmul":
        def one(im, p):
            dt = im.dtype
            wy = _bilinear_weights(p[:, 1], s, dt)  # (S^2, S)
            wx = _bilinear_weights(p[:, 0], s, dt)  # (S^2, S)
            # One matmul interpolates all C channels along y...
            rows = jax.lax.dot(wy, im.reshape(s, s * c),
                               precision="highest")  # (S^2, S*C)
            # ...then the x-weights reduce per channel.
            return jnp.einsum("nsc,ns->nc", rows.reshape(-1, s, c), wx,
                              precision="highest")  # (S^2, C)

        vals = jax.vmap(one)(img, pts)
        return vals.reshape(b, s, s, c)
    flat = jnp.moveaxis(img, -1, 1).reshape(b * c, s, s)
    pts = jnp.repeat(pts, c, axis=0)  # channel-major to match flat
    vals = jax.vmap(bilinear_sample)(flat, pts)  # (B*C, S*S)
    return jnp.moveaxis(vals.reshape(b, c, s, s), 1, -1)


class _Encoder(nn.Module):
    """Shared 1/4-resolution feature encoder (applied to each image)."""

    dim: int = 64

    @nn.compact
    def __call__(self, x: Array) -> Array:
        x = nn.Conv(self.dim // 2, (3, 3), strides=(2, 2), dtype=x.dtype)(x)
        x = nn.relu(x)
        x = nn.Conv(self.dim, (3, 3), strides=(2, 2), dtype=x.dtype)(x)
        return nn.relu(x)


class _Update(nn.Module):
    """Correction block: stacked (f1, f2w, f2w - f1) -> delta offsets."""

    dim: int = 64
    step_scale: float = 8.0

    @nn.compact
    def __call__(self, x: Array) -> Array:
        x = nn.Conv(self.dim, (3, 3), strides=(2, 2), dtype=x.dtype)(x)
        x = nn.relu(x)
        x = nn.Conv(self.dim, (3, 3), strides=(2, 2), dtype=x.dtype)(x)
        x = nn.relu(x)
        x = jnp.mean(x, axis=(1, 2))  # global context
        x = nn.Dense(128, dtype=x.dtype)(x)
        x = nn.relu(x)
        x = nn.Dense(8, dtype=x.dtype)(x)
        return self.step_scale * jnp.tanh(x).reshape(-1, 4, 2)


class IterativeHomographyNet(nn.Module):
    """Recurrent estimate-warp-correct homography regressor (IHN family).

    ``__call__`` returns the (iters, B, 4, 2) sequence of offset estimates in
    *image* pixels (last entry is the prediction); weights are shared across
    iterations.
    """

    dim: int = 64
    iters: int = 6
    step_scale: float = 8.0

    @nn.compact
    def __call__(self, pair: Array) -> Array:
        b, s = pair.shape[0], pair.shape[1]
        enc = _Encoder(self.dim)
        upd = _Update(self.dim, self.step_scale)
        f1 = enc(pair[..., :1])  # (B, s4, s4, D)
        f2 = enc(pair[..., 1:])
        s4 = f1.shape[1]
        scale = jnp.asarray(s4 / s, pair.dtype)
        origin = jnp.zeros((b, 2), pair.dtype)
        size = jnp.full((b, 2), float(s4 - 1), pair.dtype)
        corners = rect_corners(origin, size)

        offsets = jnp.zeros((b, 4, 2), pair.dtype)  # feature-scale
        seq = []
        for _ in range(self.iters):
            h = aca_rect(corners + offsets, origin, size)
            f2w = warp_by_homography(f2, h)
            delta = upd(jnp.concatenate([f1, f2w, f2w - f1], axis=-1))
            offsets = offsets + delta
            seq.append(offsets / scale)  # report at image scale
        return jnp.stack(seq, axis=0)

    def homography(self, params, pair: Array) -> Array:
        """(B, 3, 3) H (image pixels) from the final iteration's offsets."""
        offsets = self.apply(params, pair)[-1]
        b, s = pair.shape[0], pair.shape[1]
        origin = jnp.zeros((b, 2), pair.dtype)
        size = jnp.full((b, 2), float(s - 1), pair.dtype)
        return aca_rect(rect_corners(origin, size) + offsets, origin, size)


def sequence_loss(seq: Array, offsets_true: Array, gamma: float = 0.85) -> Array:
    """RAFT/IHN exponentially-weighted corner loss over the iterate sequence."""
    n = seq.shape[0]
    w = gamma ** jnp.arange(n - 1, -1, -1, dtype=seq.dtype)
    per = jax.vmap(corner_loss, in_axes=(0, None))(seq, offsets_true)
    return jnp.sum(w * per) / jnp.sum(w)


_TX = optax.adam(1e-4)


def create_ihn_state(key: Array, image_size: int = 64, iters: int = 6,
                     dtype=jnp.float32):
    model = IterativeHomographyNet(iters=iters)
    params = model.init(key, jnp.zeros((1, image_size, image_size, 2), dtype))
    return model, TrainState(params, _TX.init(params))


@partial(jax.jit, static_argnames=("model",))
def ihn_train_step(model: IterativeHomographyNet, state: TrainState,
                   pair: Array, offsets_true: Array):
    """One supervised step (sequence loss); batch dim shards for DP."""

    def loss_fn(params):
        return sequence_loss(model.apply(params, pair), offsets_true)

    loss, grads = jax.value_and_grad(loss_fn)(state.params)
    updates, opt_state = _TX.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates)
    return TrainState(params, opt_state), loss
