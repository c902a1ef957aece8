"""Multi-host (2-process) execution: sharded RANSAC == single-process result.

Launches two fresh CPU-backend JAX processes (4 virtual devices each) joined
via ``jax.distributed`` into one 8-device cluster, runs hypothesis-sharded
RANSAC over the ('host', 'hyp') global mesh, and asserts both workers return
exactly the single-process 8-device result — the deterministic linearized
device indexing makes the hypothesis streams identical regardless of the
process topology.  This is the CI stand-in for a multi-host run.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import jit_of

_WORKER = r"""
import json, os, sys
rank = int(sys.argv[1]); port = sys.argv[2]; out_path = sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=rank)
assert jax.process_count() == 2
assert len(jax.devices()) == 8

import jax.numpy as jnp
import numpy as np
sys.path.insert(0, os.getcwd())  # launched with cwd = repo root
from sks_tpu.parallel.distributed import global_mesh, replicate_to_mesh
from sks_tpu.parallel.sharded_ransac import sharded_ransac_homography
from sks_tpu.robust.ransac import RansacConfig
from sks_tpu.utils.synth import random_correspondences

key = jax.random.PRNGKey(5)
src, tar, _ = jax.jit(
    lambda k: random_correspondences(k, (), 128, 1.0, jnp.float32))(key)
tar = tar.at[:32].set(
    jax.random.uniform(jax.random.PRNGKey(6), (32, 2), jnp.float32, 0, 640))

mesh = global_mesh({"hyp": 4})          # ('host', 'hyp') = (2, 4)
src_g = replicate_to_mesh(np.asarray(src), mesh)
tar_g = replicate_to_mesh(np.asarray(tar), mesh)
key_g = replicate_to_mesh(np.asarray(key), mesh)

cfg = RansacConfig(num_hypotheses=512, threshold=3.0)
res = sharded_ransac_homography(mesh, key_g, src_g, tar_g, cfg,
                                axis=("host", "hyp"))
out = {
    "rank": rank,
    "h": np.asarray(res.h).tolist(),
    "num_inliers": int(res.num_inliers),
}
with open(out_path, "w") as f:
    json.dump(out, f)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_sharded_ransac_matches_single(tmp_path):
    port = _free_port()
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("JAX_PLATFORMS", None)
    procs = []
    outs = []
    for rank in range(2):
        out_path = tmp_path / f"out{rank}.json"
        outs.append(out_path)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(rank), str(port),
             str(out_path)],
            env=env, cwd=os.path.dirname(os.path.dirname(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ))
    for p in procs:
        stdout, stderr = p.communicate(timeout=420)
        assert p.returncode == 0, stderr.decode()[-3000:]

    results = [json.loads(p.read_text()) for p in outs]
    # Both workers hold the identical replicated result.
    assert results[0]["num_inliers"] == results[1]["num_inliers"]
    np.testing.assert_allclose(results[0]["h"], results[1]["h"])

    # And it equals the single-process 8-device run: the linearized device
    # index makes hypothesis streams independent of process topology.
    from jax.sharding import Mesh

    from sks_tpu.parallel.sharded_ransac import sharded_ransac_homography
    from sks_tpu.robust.ransac import RansacConfig
    from sks_tpu.utils.synth import random_correspondences

    key = jax.random.PRNGKey(5)
    src, tar, _ = jit_of(
        lambda k: random_correspondences(k, (), 128, 1.0, jnp.float32))(key)
    tar = tar.at[:32].set(jax.random.uniform(
        jax.random.PRNGKey(6), (32, 2), jnp.float32, 0, 640))
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("host", "hyp"))
    ref = sharded_ransac_homography(
        mesh, key, src, tar, RansacConfig(num_hypotheses=512, threshold=3.0),
        axis=("host", "hyp"))
    np.testing.assert_allclose(
        np.asarray(results[0]["h"]), np.asarray(ref.h), rtol=1e-5, atol=1e-5)
    assert results[0]["num_inliers"] == int(ref.num_inliers)
