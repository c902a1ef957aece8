"""Planar SLAM/SfM layers: pose graph, bundle adjustment, odometry.

New capability per BASELINE.json's north star (the reference stops at the
homography solver); designed for compiled accelerator programs: fixed-shape residual sets, masked
observations, Gauss-Newton with on-device dense/Schur solves, landmark
sharding over the mesh with psum reductions.
"""

from sks_tpu.slam.ba import (  # noqa: F401
    BAProblem,
    ba_residuals,
    gauss_newton_step,
    run_ba,
)
from sks_tpu.slam.posegraph import (  # noqa: F401
    PoseGraph,
    posegraph_residuals,
    optimize_posegraph,
)
from sks_tpu.slam.pipeline import (  # noqa: F401
    frames_to_poses,
    planar_slam,
    sharded_frames_to_poses,
)
from sks_tpu.slam.tracking import (  # noqa: F401
    esm_track,
    esm_track_pyramid,
)
