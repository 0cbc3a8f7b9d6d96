"""Multi-host (multi-process) runtime: distributed init + global arrays.

Device replacement for the reference's MPI process runtime
(reference: parallel_mod.F90:100 `initmp` MPI_Init/rank/size; restart
gather restart_io_mod.F90:524).  One JAX process per host; the global
device mesh spans all processes and the sharded subcycle
(parallel/sharded.py) runs unchanged over it — shard_map collectives are
scheduled by XLA (NCCL on GPUs).

Process-count invariance: the shard plan depends only on the shard count
(= total devices), not on how shards map to processes, and every
collective is order-deterministic — so results are bitwise identical
across process counts for a fixed mesh size (extends the reference's
BFB-under-task-count property, README:46-48; tested in
tests/test_multihost.py via real 2-process gloo runs).

On CPUs, point JAX at the CPU backend with
jax.config.update("jax_platforms", "cpu") and
jax.config.update("jax_num_cpu_devices", N) before init().
"""

from __future__ import annotations

import numpy as np


def init(coordinator_address: str | None = None,
         num_processes: int | None = None,
         process_id: int | None = None) -> None:
    """Initialize the distributed runtime (jax.distributed).

    With no arguments, cluster-environment autodetection applies (a GPU
    machine with no cluster manager needs the three arguments).  Call
    before any other JAX API touches devices.  The reference analog is initmp (parallel_mod.F90:100).
    """
    import jax
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "e"):
    """1-D mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()), (axis,))


def make_global_sharded(host_array: np.ndarray, sharding):
    """Build a global sharded array from identical per-host full copies.

    Each process supplies only its addressable shards; host_array must be
    identical on every process (true for initial conditions and for
    restart files read by all hosts).
    """
    import jax
    arr = np.asarray(host_array)
    return jax.make_array_from_callback(arr.shape, sharding,
                                        lambda idx: arr[idx])


def gather_canonical(x) -> np.ndarray:
    """Gather a sharded array to a full host copy on every process.

    The multi-host analog of the restart/history host gather
    (restart_io_mod.F90:524 WriteRestart's collective write).
    """
    import jax
    from jax.experimental import multihost_utils
    if jax.process_count() == 1:
        full = np.asarray(x)
    else:
        full = np.asarray(multihost_utils.process_allgather(x, tiled=True))
    return full


def shard_qdp_multihost(runner, Qdp_host: np.ndarray):
    """Multi-process version of ShardedRunner.shard_qdp: scatter a host
    copy to the global mesh."""
    return make_global_sharded(np.asarray(Qdp_host), runner.qdp_sharding)
