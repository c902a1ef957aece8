"""sks_tpu — homography / planar-SfM framework in JAX.

A JAX/XLA framework with the capabilities of the reference
SKS-Homography repository (closed-form SKS / ACA 4-point homography
decompositions plus the classical baselines), designed around batched,
fixed-shape accelerator programs:

- one canonical *batched* formulation of every solver, ``(..., 4, 2) -> (..., 3, 3)``,
  dtype-polymorphic (bf16/f32/f64) instead of the reference's four hand-duplicated
  stacks (scalar C++ fp32/fp64, CUDA, PyTorch, MATLAB);
- fixed-shape vectorized RANSAC/MAGSAC;
- homography -> pose recovery, pose-graph optimization and bundle adjustment,
  sharded over a ``jax.sharding.Mesh`` with XLA collectives.

Reference parity map (see SURVEY.md for file:line inventory):
  ops.aca       <-  sks::runKernel_ACA        (C++ Codes/modules/ACA_SKS.cpp:24)
  ops.sks       <-  sks::runKernel_SKS        (C++ Codes/modules/ACA_SKS.cpp:189)
  ops.aca_rect  <-  TensorACA_rect            (PyTorch Codes/Modules_Runtime_Test.py:286)
  ops.ndlt      <-  cv::runKernel_DLT         (C++ Codes/modules/DLT.cpp:53)
  ops.rho_ge    <-  cv::runKernel_GE          (C++ Codes/modules/GE.cpp:44)
  ops.gpt_lu    <-  cv::runKernel_GPT         (C++ Codes/modules/GPT.cpp:51)
  ops.ho        <-  cv::runKernel_HO          (C++ Codes/modules/HO.cpp:33)
"""

import os as _os

import jax as _jax

# Geometry arithmetic MUST run matmuls in full f32.  A GPU's default float32
# matmul may run in TF32 (10 mantissa bits): ~0.1% relative error on every
# 3x3 homography/pose product, ~0.5-1 px at 640-px coordinates.  A reduced-
# precision matmul was once measured collapsing a 205-inlier consensus to 53
# through the polish denormalization (t2i @ h @ t1) while identical code was
# correct on CPU.  Pixel-precision geometry everywhere in this package
# (pose chains, SL(3) warps, denormalizations) has the same hazard, so the
# package sets the f32-accumulation default once here rather than trusting
# every future call site to remember ``precision=``.  Models/descriptor
# matmuls that can afford bf16 opt back in locally.
#
# Host applications that manage their own precision can opt out
# (``SKS_TPU_NO_GLOBAL_PRECISION=1``), and an explicit setting — via
# JAX_DEFAULT_MATMUL_PRECISION or a prior config.update — is never
# clobbered (ADVICE r4: an unconditional import-time update silently
# degraded/overrode host defaults).  The hottest geometry sites
# (solvers, polish, tracking, pose recovery) pass ``precision=`` at the
# call, so core accuracy survives an opt-out; small 3x3 chain products
# elsewhere rely on the default, so opting out trades pose-chain precision
# for host-app throughput — the caller's choice.
if not _os.environ.get("SKS_TPU_NO_GLOBAL_PRECISION"):
    _explicit = (
        _os.environ.get("JAX_DEFAULT_MATMUL_PRECISION") is not None
        or _jax.config.jax_default_matmul_precision is not None
    )
    if not _explicit:
        _jax.config.update("jax_default_matmul_precision", "highest")

from sks_tpu.ops import (  # noqa: F401,E402
    aca,
    aca_h,
    aca_rect,
    aca_rect_h,
    sks,
    sks_h,
    ndlt,
    gpt_lu,
    rho_ge,
    ho,
    solve_h,
    SOLVERS,
    aca_factors,
    sks_factors,
    sks_kernel_chain,
)
from sks_tpu.robust.api import (  # noqa: F401
    find_homography,
    get_affine_transform,
    get_perspective_transform,
)
from sks_tpu.geom.homography import (  # noqa: F401
    apply_homography,
    reprojection_error,
    symmetric_transfer_error,
)

__version__ = "0.1.0"
