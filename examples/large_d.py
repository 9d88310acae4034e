"""Large-dimension validated VI with the measured-best defaults.

The reference's workloads stop at d = 10 (its full-rank machinery is
numpy `sqrtm` + per-sample loops; reference: viabel/vb.py:202-208).  This
example runs the complete validated workflow — full-rank Gaussian KLVI,
1e6-sample bounds, PSIS — at d = 100 (5,150 variational parameters) on a
conjugate linear-regression posterior whose exact moments are known
(the model computes them via `compute_posterior_moments`), then checks
the fit against the truth.

What the defaults do for you at this scale (benchmarks/DIM_SCALING.md):

* `unroll='auto'` resolves to the measured-best scan unroll
  (`optimizers.resolve_unroll`);
* `n_mc_samples=800` here, not the protocol default 100 — 8x the gradient
  samples cut gradient variance ~8x;
* `return_history=False` semantics inside `validated_vi` keep optimizer
  memory O(P) — the (n_iters, P) history is never materialized.

Usage: python examples/large_d.py [--full] [--d 100] [--cpu]
       (--full: d = 300, 40k iterations — the DIM_SCALING.md flagship run)
"""
import argparse
import sys
import time

sys.path.insert(0, '.')

import jax
import jax.numpy as jnp
import numpy as np


def main(d=100, n_iters=None, cpu=False):
    if cpu:
        jax.config.update('jax_platforms', 'cpu')
    from viabel_tpu import (full_rank_gaussian_variational_family,
                            init_from_moments, validated_vi)
    from viabel_tpu.models import (data_generator_linear,
                                   linear_regression_model)

    n_iters = n_iters or (10000 if d < 300 else 40000)
    data = data_generator_linear(N=4 * d, D=d, alpha=1.0,
                                 noise_variance=0.25, rho=0.5, seed=7)
    model = linear_regression_model(data['X'], data['Y'], noise_scale=0.5,
                                    prior_std=3.0)
    fam = full_rank_gaussian_variational_family(d)
    # init q at the PRIOR — at large d the posterior scales are far
    # tighter than unit-scale zeros, and P parameters will not cross that
    # gap in any reasonable schedule from a unit start
    init = init_from_moments(
        fam, np.zeros(d), 3.0 ** 2 * np.eye(d)).astype(jnp.float32)
    print('d = {}  (P = {} variational parameters), {} iterations'.format(
        d, fam.var_param_dim, n_iters))

    t0 = time.perf_counter()
    out = validated_vi(model.log_prob, fam, init, n_iters,
                       n_mc_samples=800, n_bound_samples=1000000,
                       key=jax.random.PRNGKey(0), learning_rate=.05,
                       learning_rate_end=.001)
    jax.block_until_ready(out['opt_param'])
    wall = time.perf_counter() - t0

    mean = np.asarray(out['q_mean'])
    cov = np.asarray(out['q_cov'])
    mean_err = float(np.linalg.norm(mean - model.true_mean))
    cov_err = float(np.linalg.norm(cov - model.true_cov)
                    / np.linalg.norm(model.true_cov))
    print('wall (incl compile): {:.1f}s'.format(wall))
    print('khat = {:+.3f}  (< 0.7 certifies the PSIS correction)'.format(
        out['khat']))
    print('d2 bound = {:.3g}'.format(out['bounds']['d2']))
    print('|mean - truth| = {:.4f}   rel cov err = {:.3f}'.format(
        mean_err, cov_err))
    ok = out['khat'] < 0.7 and mean_err < 0.05
    print('validated fit: {}'.format('OK' if ok else 'NOT CERTIFIED'))
    return 0 if ok else 1


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--d', type=int, default=100)
    p.add_argument('--full', action='store_true',
                   help='d = 300 / 40k iterations (DIM_SCALING.md flagship)')
    p.add_argument('--n-iters', type=int)
    p.add_argument('--cpu', action='store_true')
    a = p.parse_args()
    sys.exit(main(300 if a.full else a.d, a.n_iters, a.cpu))
