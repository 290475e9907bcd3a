"""
Distributed layer: mesh partitioning, shard_map kernels, multi-host init.

The reference is strictly single-node (SURVEY §5: no MPI/NCCL/Gloo
anywhere); its row sharding exists only for kernel capacity.  Here the
row axis is a first-class parallel axis over a ``jax.sharding.Mesh``,
and this package provides the process-level entry point for running that
mesh across hosts.

Modules:

* :mod:`~csr_tpu.parallel.partition` — nnz-balanced row partitioning.
* :mod:`~csr_tpu.parallel.dist`      — shard_map SpMV, SpMV-T and SpMM.
* :mod:`~csr_tpu.parallel.ring`      — ppermute ring schedule with
  communication/compute overlap.
"""

from __future__ import annotations

import logging
import os

_log = logging.getLogger(__name__)
_initialized = False


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    **kwargs,
):
    """Initialize multi-host JAX for this process.

    Wraps ``jax.distributed.initialize`` (the obligation SURVEY §5
    assigns in place of the reference's nonexistent distributed backend).
    The coordinator comes from the arguments or from the
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
    ``JAX_PROCESS_ID`` environment variables.  Without one, nothing is
    initialized: a single host needs no cluster, and on a GPU host
    ``jax.distributed.initialize()`` has nothing to detect a cluster from.

    Safe to call more than once (subsequent calls are no-ops) and safe in
    a single-process run with no coordinator configured (returns False).

    Returns:
        bool: True if multi-host initialization ran, False if skipped.
    """
    global _initialized
    if _initialized:
        return False

    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    import jax

    if coordinator_address is None:
        _log.debug("init_distributed: no coordinator given; skipping")
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
        **kwargs,
    )
    _initialized = True
    _log.info(
        "init_distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )
    return True


def is_initialized() -> bool:
    """Whether :func:`init_distributed` has run in this process."""
    return _initialized


def shutdown_distributed():
    """Tear down the multi-host runtime (test-cluster hygiene)."""
    global _initialized
    if _initialized:
        import jax

        jax.distributed.shutdown()
        _initialized = False
