"""Multi-device (mesh) execution.

The reference has no parallelism at all — its `n_optimisers` "chains" run
sequentially in a Python loop and every Monte Carlo estimate is a single
numpy pass (SURVEY.md section 2.4).  This package supplies the
scaling story:

* `make_mesh` — build a ``(chain, sample)`` `jax.sharding.Mesh` over the
  available devices.
* `sharded_bounds` — sample-axis-sharded fused CUBO/ELBO/moment estimation
  with `psum`/`pmax` collectives under `shard_map` (each device draws and
  scores its own shard of the samples; nothing is ever gathered).
* `sharded_chains` — optimization replicas sharded over the mesh chain axis
  (the vmapped `lax.scan` chains of `viabel_tpu.optimizers` partitioned by
  GSPMD).
* `sharded_psis` — distributed PSIS: each device computes a local top-k,
  only the global tail (~``min(0.2 n, 3 sqrt n)`` weights) is all-gathered,
  the GPD fit runs replicated, and the smoothed tail is scattered back to
  its owners; body weights never leave their device.
"""
from .distributed import (initialize_distributed, local_device_count,
                          process_info)
from .mesh import auto_mesh, fetch_global, make_mesh, shard_over
from .sharded_bounds import (sharded_all_bounds, sharded_bound_psis,
                             sharded_log_weight_stats,
                             sharded_sample_stats)
from .sharded_chains import shard_chain_inputs
from .sharded_psis import (psislw_sharded, psisloo_sharded,
                           sharded_psis_moments)

__all__ = [
    'make_mesh', 'shard_over', 'fetch_global', 'auto_mesh',
    'sharded_log_weight_stats', 'sharded_sample_stats', 'sharded_all_bounds',
    'sharded_bound_psis',
    'shard_chain_inputs',
    'psislw_sharded', 'psisloo_sharded', 'sharded_psis_moments',
    'initialize_distributed', 'local_device_count', 'process_info',
]
