"""On-device feature pipeline: detect -> describe -> match (all jit, fixed-K).

Replaces the host-side OpenCV feature pipeline the reference benchmarks assume
(its wall fixture is SIFT-style matches) with device-resident ops: Harris
corners via shifted adds, normalized patch descriptors via bilinear sampling,
and mutual-nearest matching on a matmul distance matrix.
"""

from sks_tpu.features.harris import harris_response, detect_corners  # noqa: F401
from sks_tpu.features.descriptors import patch_descriptors  # noqa: F401
from sks_tpu.features.matching import match_descriptors, match_frames  # noqa: F401
