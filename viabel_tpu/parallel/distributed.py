"""Multi-host initialization.

On a cluster of GPU hosts, run one process per host and call
`initialize_distributed(coordinator_address, num_processes, process_id)`
once in each, before any JAX operation; the mesh builders in
`viabel_tpu.parallel.mesh` then see every GPU of every host via
`jax.devices()`, and the shard_map estimators run unchanged, with XLA
handing the collectives to NCCL (SURVEY.md section 5 "Distributed
communication backend").

This module is a thin, documented wrapper because JAX's collectives need no
hand-written communication layer — the work is in the sharding annotations,
which `viabel_tpu.parallel` already provides.  The cross-process path is
exercised for real by `tests/test_distributed.py`: two OS processes form a
global mesh and the sharded estimators reproduce single-process numbers
exactly.
"""
import jax

__all__ = ['initialize_distributed', 'local_device_count', 'process_info']


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Initialize `jax.distributed` for a multi-host run.

    `coordinator_address` is ``host:port`` of process 0, reachable from
    every host; `num_processes` is the number of hosts (one process each)
    and `process_id` this host's index.  A plain GPU host has no cluster
    environment for JAX to discover these from, so pass all three.  Call
    once per process, before any backend use.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs['coordinator_address'] = coordinator_address
    if num_processes is not None:
        kwargs['num_processes'] = num_processes
    if process_id is not None:
        kwargs['process_id'] = process_id
    jax.distributed.initialize(**kwargs)
    return process_info()


def local_device_count():
    return jax.local_device_count()


def process_info():
    """(process_index, process_count, global_devices, local_devices)."""
    return dict(process_index=jax.process_index(),
                process_count=jax.process_count(),
                global_devices=len(jax.devices()),
                local_devices=jax.local_device_count())
