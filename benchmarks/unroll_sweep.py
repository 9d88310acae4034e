"""Scan-unroll sweep of the windowed-adagrad optimizer on one GPU.

Times `adagrad_optimize` (5,000 iterations, ``return_history=False``) at
``unroll`` in {1, 4, 8} for two parameter sizes:

* P = 20: eight-schools centered, mean-field t(40), KLVI, n_mc = 100;
* P = 5,150: d = 100 linear regression, full-rank Gaussian, KLVI,
  n_mc = 800 (the `examples/large_d.py` protocol).

Each point is compiled once, then timed over three fresh keys (median
reported).  `optimizers.resolve_unroll` is set from this sweep.  Refuses
to run without a GPU.

Usage: python benchmarks/unroll_sweep.py [--iters 5000]
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _workloads():
    from viabel_tpu import (black_box_klvi,
                            full_rank_gaussian_variational_family,
                            init_from_moments,
                            mean_field_t_variational_family)
    from viabel_tpu.models import (data_generator_linear,
                                   eight_schools_cp_model,
                                   linear_regression_model)
    es = eight_schools_cp_model()
    fam = mean_field_t_variational_family(es.dim, 40)
    yield ('eight_schools_cp mean-field t(40)',
           black_box_klvi(fam, es.log_prob, 100, presampled=True),
           fam.init_param())
    d = 100
    data = data_generator_linear(N=4 * d, D=d, alpha=1.0,
                                 noise_variance=0.25, rho=0.5, seed=7)
    lr = linear_regression_model(data['X'], data['Y'], noise_scale=0.5,
                                 prior_std=3.0)
    ffam = full_rank_gaussian_variational_family(d)
    yield ('linear_regression d=100 full-rank',
           black_box_klvi(ffam, lr.log_prob, 800, presampled=True),
           init_from_moments(ffam, np.zeros(d),
                             9.0 * np.eye(d)).astype(jnp.float32))


def main(iters=5000, unrolls=(1, 4, 8), reps=3):
    if jax.devices()[0].platform != 'gpu':
        sys.exit('unroll_sweep: needs a GPU, found {!r}'.format(
            jax.devices()[0].platform))
    from viabel_tpu import adagrad_optimize
    from viabel_tpu.utils import enable_compile_cache
    enable_compile_cache()
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()
    rows = []
    for name, obj, init in _workloads():
        for u in unrolls:
            def run(seed):
                return adagrad_optimize(
                    iters, obj, init, key=jax.random.PRNGKey(seed),
                    learning_rate=.01, unroll=u, return_history=False)[0]
            t0 = time.perf_counter()
            jax.block_until_ready(run(0))
            first = time.perf_counter() - t0
            times = []
            for r in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(run(r + 1))
                times.append(time.perf_counter() - t0)
            med = float(np.median(times))
            rows.append(dict(workload=name, P=int(init.shape[0]), unroll=u,
                             median_s=med, times_s=times,
                             first_call_s=first, it_per_s=iters / med))
            print('{:>36} P={:5d} unroll={}: median {:.4f} s = {:.0f} it/s '
                  '(first call {:.1f} s)'.format(name, init.shape[0], u, med,
                                                  iters / med, first),
                  flush=True)
    print(json.dumps(dict(card=card, device_kind=jax.devices()[0].device_kind,
                          iters=iters, rows=rows)))


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--iters', type=int, default=5000)
    a = p.parse_args()
    main(a.iters)
