"""Multi-chip layer: meshes, sharded RANSAC, distributed reductions.

The reference is single-device (SURVEY.md §2.6) — this layer is new, idiomatic
JAX: hypotheses shard across chips (data-parallel axis), points/maps shard for
the SfM layers, consensus and Schur reductions are XLA collectives.
"""

from sks_tpu.parallel.mesh import make_mesh  # noqa: F401
from sks_tpu.parallel.sharded_ransac import sharded_ransac_homography  # noqa: F401
from sks_tpu.parallel.sharded_refine import sharded_ho_h, sharded_ndlt_h  # noqa: F401
from sks_tpu.parallel.sharded_posegraph import (  # noqa: F401
    shard_graph,
    sharded_optimize_posegraph,
)
from sks_tpu.parallel.distributed import (  # noqa: F401
    global_mesh,
    initialize_multihost,
    is_multiprocess,
    replicate_to_mesh,
)
