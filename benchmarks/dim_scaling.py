"""Dimension-scaling study: full-rank VI at production dimensionality.

The reference's workloads top out at d = 10 (its full-rank `sqrtm` sampling
and per-sample numpy loops make higher dimensions impractical:
viabel/vb.py:202-208).  This study runs the complete validated pipeline —
full-rank Gaussian KLVI + 1e6-sample bound pass + PSIS — on a conjugate
linear-regression posterior (analytic truth from
`diagnostics.compute_posterior_moments`) at d = 10 / 30 / 100 / 300, where
the family transform is a real (n, d) x (d, d) matmul and the
variational parameter vector reaches d(d+3)/2 = 45,450 entries.

Correctness gates per dimension: posterior mean error under the analytic
truth, khat (the exact posterior is inside the family, so the fit should
be near-exact), and d2.  Performance: steady-state optimizer it/s and the
fused bound-pass wall clock.  Writes DIM_SCALING.md rows to stdout and
`dim_scaling.json`.

Usage: python benchmarks/dim_scaling.py [--dims 10,30,100,300] [--cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def run_dim(d, n_iters, n_bound, key):
    import warnings

    from viabel_tpu import (adagrad_optimize, black_box_klvi,
                            full_rank_gaussian_variational_family,
                            init_from_moments)
    from viabel_tpu.bounds import (MonteCarloErrorWarning, all_bounds,
                                   family_moment_bounds)
    from viabel_tpu.experiments import get_samples_and_log_weights
    from viabel_tpu.models import data_generator_linear, \
        linear_regression_model
    from viabel_tpu.psis import psislw
    warnings.simplefilter('ignore', MonteCarloErrorWarning)

    data = data_generator_linear(N=4 * d, D=d, alpha=1.0,
                                 noise_variance=0.25, rho=0.5, seed=7)
    model = linear_regression_model(data['X'], data['Y'], noise_scale=0.5,
                                    prior_std=3.0)
    fam = full_rank_gaussian_variational_family(d)
    # at d >= 300 the presampled batch is its own memory hog
    # (n_iters x 100 x d f32 = 4.8 GB at 40k iters); in-scan Gaussian
    # draws are rejection-free anyway, so hoisting buys nothing there
    obj = black_box_klvi(fam, model.log_prob, 100, presampled=d < 300)
    # initialize q at the PRIOR (the principled default): at d = 300 the
    # posterior scales are ~100x tighter than the zeros-init unit scales,
    # and 45k parameters will not cross that gap in any reasonable
    # schedule from a unit-scale start
    init = init_from_moments(
        fam, np.zeros(d), 3.0 ** 2 * np.eye(d)).astype(jnp.float32)
    k_opt, k_bound, k_warm = jax.random.split(key, 3)

    # optimize (compile excluded: warm-up with a throwaway key); the
    # no-history mode keeps memory O(P) instead of O(n_iters * P)
    warm = adagrad_optimize(n_iters, obj, init, key=k_warm,
                            learning_rate=.05, learning_rate_end=.001,
                            return_history=False)
    jax.block_until_ready(warm[0])
    t0 = time.perf_counter()
    opt_param, _, _, _ = adagrad_optimize(n_iters, obj, init, key=k_opt,
                                          learning_rate=.05,
                                          learning_rate_end=.001,
                                          return_history=False)
    jax.block_until_ready(opt_param)
    it_s = n_iters / (time.perf_counter() - t0)

    # fused bound pass at n_bound (draw+score+stats, log-weights on device)
    def bound_pass(k):
        _, lw = get_samples_and_log_weights(model.log_prob, fam, opt_param,
                                            n_bound, k)
        return lw
    lw = bound_pass(k_bound)
    jax.block_until_ready(lw)  # compile
    t_draw = float('inf')  # best-of-3, varied inputs (CLAUDE.md timing)
    for rep in range(1, 4):
        t0 = time.perf_counter()
        lw = bound_pass(jax.random.fold_in(k_bound, rep))
        jax.block_until_ready(lw)
        t_draw = min(t_draw, time.perf_counter() - t0)
    res = all_bounds(lw, q_var=np.asarray(fam.mean_and_cov(opt_param)[1]),
                     moment_bound_fn=family_moment_bounds(fam, opt_param))
    slw, khat = psislw(lw)
    khat = float(khat)

    # flagship API at this dimension: the COMPLETE validated workflow
    # (optimize + bounds + PSIS + corrected moments) as one fused program —
    # feasible at d = 300 only because the pipeline's optimizer stage
    # accumulates the tail average in-scan instead of stacking the
    # (n_iters, P) history
    from viabel_tpu import validated_vi
    def fused(k):
        out = validated_vi(model.log_prob, fam, init, n_iters,
                           objective_and_grad=obj, n_bound_samples=n_bound,
                           key=k, learning_rate=.05, learning_rate_end=.001)
        return out['smoothed_log_weights']
    jax.block_until_ready(fused(k_warm))  # compile
    t_fused = float('inf')
    for rep in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fused(jax.random.fold_in(k_opt, rep)))
        t_fused = min(t_fused, time.perf_counter() - t0)

    mean, cov = map(np.asarray, fam.mean_and_cov(opt_param))
    mean_err = float(np.linalg.norm(mean - model.true_mean))
    rel_cov_err = float(np.linalg.norm(cov - model.true_cov)
                        / np.linalg.norm(model.true_cov))
    row = dict(d=d, var_param_dim=fam.var_param_dim, n_iters=n_iters,
               it_s=it_s, bound_pass_s=t_draw, fused_pipeline_s=t_fused,
               n_bound=n_bound, khat=khat, d2=float(res['d2']),
               mean_error=mean_err, rel_cov_error=rel_cov_err)
    print('d={:4d} (P={:6d}): {:8.0f} it/s | bound pass {:6.3f}s '
          '(n={:.0e}) | fused pipeline {:7.3f}s | khat {:+.3f} | '
          'd2 {:.2e} | mean_err {:.4f} | rel cov err {:.3f}'.format(
              d, fam.var_param_dim, it_s, t_draw, float(n_bound), t_fused,
              khat, res['d2'], mean_err, rel_cov_err), flush=True)
    return row


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--dims', default='10,30,100,300')
    p.add_argument('--n-iters', type=int, default=10000)
    p.add_argument('--n-bound', type=int, default=1000000)
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--json', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'dim_scaling.json'))
    args = p.parse_args()
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
    print('device: {}'.format(jax.devices()[0]))
    rows = []
    for d in [int(x) for x in args.dims.split(',')]:
        # the d(d+3)/2-parameter surface needs a longer schedule at the
        # largest dimension (45k parameters at d = 300)
        n_iters = args.n_iters * (4 if d >= 300 else 1)
        rows.append(run_dim(d, n_iters, args.n_bound,
                            jax.random.PRNGKey(d)))
    with open(args.json, 'w') as f:
        json.dump(dict(device=str(jax.devices()[0]), rows=rows), f,
                  indent=1)
    print('wrote', args.json)


if __name__ == '__main__':
    main()
