"""Device-mesh utilities for sharded prediction.

The reference's only parallelism is a host multiprocessing pool at
tabulation time (reference: tabcorr/tabcorr.py:880-901); prediction is
single-threaded numpy.  Here prediction scales over a
``jax.sharding.Mesh``:

* **dp** ("data parallel"): HOD parameter batches / MCMC walkers sharded
  over devices.  The tabulation matrices are small (<= a few MB) and are
  replicated, so the hot loop needs zero communication.
* **tp** ("table parallel"): for very large tabulations, halo bins are
  sharded over devices and contractions finish with a ``psum``
  (see :mod:`tabcorr_tpu.parallel.shard`).

The mesh follows the algorithm alone, dp then tp: the GPUs of one host
reach each other all to all over NVLink at one rate, so no device order
is better than another.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BATCH_AXIS = "dp"
TABLE_AXIS = "tp"


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Initialize JAX's distributed runtime for several processes.

    Pass the coordinator's ``host:port``, the process count and this
    process's id (a plain GPU cluster advertises none of them).  After
    this, ``jax.devices()`` lists the GLOBAL device set and every mesh
    built by :func:`make_mesh` spans processes — dp stays
    communication-free (batch shards are process-local) while the tp
    contraction's psum crosses them.  Safe to call more than once
    (subsequent calls with the same arguments are no-ops).

    Returns the number of processes in the cluster.
    """
    try:
        from jax._src import distributed as _dist
        already = getattr(_dist.global_state, "client", None) is not None
    except Exception:
        already = False
    if not already:
        kwargs = {}
        if coordinator_address is not None:
            kwargs["coordinator_address"] = coordinator_address
        if num_processes is not None:
            kwargs["num_processes"] = num_processes
        if process_id is not None:
            kwargs["process_id"] = process_id
        jax.distributed.initialize(**kwargs)
    return jax.process_count()


def make_mesh(n_devices=None, table_parallel=1, devices=None):
    """Build a (dp, tp) mesh over the available devices.

    ``table_parallel`` devices cooperate on each contraction (bin-sharded);
    the remaining factor shards the parameter batch.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    devices = np.asarray(devices[:n_devices])
    if n_devices % table_parallel != 0:
        raise ValueError(f"table_parallel={table_parallel} must divide "
                         f"n_devices={n_devices}.")
    grid = devices.reshape(n_devices // table_parallel, table_parallel)
    return Mesh(grid, (BATCH_AXIS, TABLE_AXIS))


def batch_sharding(mesh):
    """Sharding for a (B, ...) array: batch across dp, replicated over tp."""
    return NamedSharding(mesh, P(BATCH_AXIS))


def replicated_sharding(mesh):
    return NamedSharding(mesh, P())


def shard_params(params, mesh):
    """Place a dict of (B,) parameter arrays batch-sharded on the mesh."""
    sharding = batch_sharding(mesh)
    return {k: jax.device_put(v, sharding) for k, v in params.items()}
