"""Multi-host (multi-process) execution: host-aware meshes + replication.

The reference has no distributed layer at all (SURVEY.md §2.6); this is the
idiomatic-JAX design for running the hypothesis-sharded RANSAC and sharded BA
across *processes*: ``jax.distributed`` brings every process's devices into
one global device set, the mesh lays a ``host`` axis outermost so that the
hypothesis axis spans each process's local devices and only the tiny
consensus reduction (top-K models, ~K*9 floats) crosses processes, and inputs
are replicated as global arrays so the existing ``shard_map`` code runs
unchanged.

Tested hermetically in CI with 2 CPU-backend processes
(``tests/test_multihost.py``).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "initialize_multihost",
    "global_mesh",
    "replicate_to_mesh",
    "is_multiprocess",
]


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_count: int | None = None,
) -> None:
    """Join (or start) a multi-process JAX cluster.

    Thin, idempotent wrapper over :func:`jax.distributed.initialize`: with no
    arguments it relies on the cluster environment (the
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    variables); explicit arguments are for bespoke launchers and the CI
    harness.  Safe to call once per process, before any other jax API.

    Args:
      coordinator_address: ``host:port`` of process 0.
      num_processes: world size.
      process_id: this process's rank.
      local_device_count: CPU-backend only — how many virtual devices this
        process contributes (sets the XLA host-platform flag; must be set
        before the backend initializes).
    """
    if local_device_count is not None:
        import os

        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                f"{flags} --xla_force_host_platform_device_count="
                f"{local_device_count}"
            ).strip()
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multiprocess() -> bool:
    return jax.process_count() > 1


def global_mesh(local_axes: dict[str, int] | None = None,
                host_axis: str = "host") -> Mesh:
    """A mesh over ALL processes' devices, the process axis outermost.

    The leading ``host`` axis has one slot per process; ``local_axes`` lay
    out each process's local devices.
    With one process this degenerates to :func:`sks_tpu.parallel.make_mesh`
    semantics plus a size-1 host axis, so code can be written once against
    the multi-host layout.

    Example: ``global_mesh({'hyp': 4})`` on 2 processes x 4 devices gives a
    ``('host', 'hyp')`` mesh of shape (2, 4).
    """
    n_proc = jax.process_count()
    devs = jax.devices()  # globally ordered: process-major
    per_proc = len(devs) // n_proc
    if local_axes is None:
        local_axes = {"hyp": per_proc}
    names = (host_axis, *local_axes)
    sizes = [n_proc]
    rest = list(local_axes.values())
    unknown = [i for i, s in enumerate(rest) if s == -1]
    known = int(np.prod([s for s in rest if s != -1]))
    if unknown:
        assert len(unknown) == 1 and per_proc % known == 0
        rest[unknown[0]] = per_proc // known
    sizes += rest
    assert int(np.prod(sizes)) == len(devs), (sizes, len(devs))
    return Mesh(np.asarray(devs).reshape(sizes), names)


def replicate_to_mesh(x, mesh: Mesh):
    """Host-local array (same values on every process) -> replicated global.

    Every process must pass identical values (e.g. computed from the same
    PRNG key); the result is a fully-replicated global jax.Array usable as a
    ``P()`` input of ``shard_map`` over ``mesh``.
    """
    x = np.asarray(x)
    sharding = NamedSharding(mesh, P())
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])
