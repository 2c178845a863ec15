"""Multi-host runtime initialization + (host, device) mesh construction.

Single-host multi-device sharding lives in distributed.py (mesh +
shard_map + halo exchange + key-range ownership).  This module adds the
multi-host layer: `jax.distributed` bring-up and a 2-D mesh whose inner
axis spans one host's devices and whose outer axis spans hosts.

The multi-process paths are tested with coordinated CPU processes
(tests/test_multiprocess.py); no multi-host run on accelerators has been
measured.
"""

from __future__ import annotations

import logging
import os

import numpy as np

import jax
from jax.sharding import Mesh

logger = logging.getLogger("krisp_tpu")

#: environment markers that mean a distributed bring-up was EXPLICITLY
#: configured — a failure with any of these present is a real cluster
#: fault (bad coordinator, version skew), not "single-process environment".
_DIST_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
    "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
)


def init_runtime(coordinator_address=None, num_processes=None,
                 process_id=None):
    """Initialize the multi-host JAX runtime (no-op on a single process).

    Where a cluster environment configures it, the arguments are
    discovered from the environment; otherwise pass them explicitly
    (coordinator host:port, world size, rank).

    Failure semantics: on the implicit path, "nothing configured" is the
    expected single-process case and returns False; but when the
    environment says a cluster WAS configured (coordinator/world-size
    variables present), a bring-up failure re-raises — silently degrading
    a cluster job to single-process would run N disconnected copies.
    """
    if num_processes is None and coordinator_address is None:
        configured = [v for v in _DIST_ENV_VARS if os.environ.get(v)]
        try:
            jax.distributed.initialize()
        except Exception as exc:
            if configured:
                logger.error(
                    "multi-host bring-up failed with distributed "
                    "environment configured (%s): %s",
                    ", ".join(configured), exc)
                raise
            logger.debug("no distributed environment: %s", exc)
            return False  # single-process environment
        return True
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def pod_mesh(ici_axis: str = "chip", dcn_axis: str = "host") -> Mesh:
    """2-D (host, device) mesh: shard genomes across hosts (data
    parallelism over the slower inter-host network — whole per-genome
    tables move at most once) and sequence ranges across a host's devices
    (halo exchange + key-range collectives stay inside the host).  On one
    GPU host the mesh is (1, n): its n cards are joined all to all by
    NVLink, so the inner axis needs no topology of its own."""
    devices = np.array(jax.devices())
    n_hosts = max(jax.process_count(), 1)
    per_host = devices.size // n_hosts
    grid = devices.reshape(n_hosts, per_host)
    return Mesh(grid, (dcn_axis, ici_axis))
