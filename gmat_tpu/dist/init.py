"""Multi-host initialization for pod-scale runs.

The reference scales across machines by hand: the user starts one process
per machine with `parallel=[N, i]` and concatenates the output files
(/root/reference/gmat/remma/remma_epiAA/remma_epiAA.py:126-140,
README.md:125-204).  The replacement here is a single SPMD program:
every host calls `initialize_multihost(...)` once, gets back a global
1-D device mesh spanning all hosts' chips, and passes it as the `mesh=`
argument of any file-level entry point (agmat, remma_epi*, remma_epi*_eff,
remma_epi*_approx, ...).  Work lists (anchor tiles, screen tiles, pair
chunks) shard over the mesh; genotype codings and the pymat/pvpmat score
pieces are replicated; results merge deterministically on host in tile
order, so the output files are byte-identical to a single-device run.

On a single host this is unnecessary — build a mesh directly with
`gmat_tpu.dist.mesh.make_mesh()`.
"""
from __future__ import annotations

import logging

import jax

logger = logging.getLogger(__name__)


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         local_device_ids=None):
    """Initialize JAX's distributed runtime and return the global mesh.

    Thin wrapper over `jax.distributed.initialize` (args are forwarded;
    where a cluster manager describes the cluster they may all be None,
    otherwise pass the coordinator's `host:port`, the process count and
    this process's id).  Must be called before any other JAX
    API on every participating process.  Returns a 1-D
    `jax.sharding.Mesh` over ALL global devices — the object every
    `mesh=`-accepting entry point in this package expects.
    """
    from gmat_tpu.dist.mesh import make_mesh

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )
    mesh = make_mesh()
    logger.info(
        "Distributed runtime up: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return mesh
