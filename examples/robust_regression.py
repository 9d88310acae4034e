"""Robust-regression workload
(reference: notebooks/robust-regression.ipynb): KLVI with a mean-field
Student-t family, CHIVI warm-started from the KLVI solution, and full-rank
Student-t KLVI — each with bounds and PSIS khat."""
import argparse
import sys
import time

sys.path.insert(0, '.')

import jax
import jax.numpy as jnp
import numpy as np

from viabel_tpu import (adagrad_optimize, all_bounds, black_box_chivi,
                        black_box_klvi, mean_field_t_variational_family,
                        t_variational_family)
from viabel_tpu.bounds import family_moment_bounds
from viabel_tpu.experiments import (check_approx_accuracy,
                                    get_samples_and_log_weights,
                                    print_bounds)
from viabel_tpu.models import robust_regression_model
from viabel_tpu.psis import psislw


def bounds_and_khat(model, fam, opt_param, n_samples, key, elbo=None):
    _, lw = get_samples_and_log_weights(model.log_prob, fam, opt_param,
                                        n_samples, key)
    cov = np.asarray(fam.mean_and_cov(opt_param)[1])
    # lw stays on device (only scalars cross to the host) and the two
    # closed-form moments come from one cached program + one transfer
    # (CLAUDE.md)
    res = all_bounds(lw, q_var=cov,
                     moment_bound_fn=family_moment_bounds(fam, opt_param),
                     log_norm_bound=elbo)
    _, khat = psislw(lw)
    # khat and the ELBO estimate cross to the host in ONE stacked fetch
    # (each device->host scalar pays the ~25-35 ms dispatch floor; CLAUDE.md)
    khat, mean_lw = np.asarray(jnp.stack([khat, jnp.mean(lw)]))
    return res, float(khat), float(mean_lw)


def timed_optimize(n_iters, obj, init, key, **kw):
    """Compile/warm with a throwaway key, then time a steady-state run with
    the caller's key (never interpret a first-call time as compute time —
    remote compile takes seconds to minutes; CLAUDE.md)."""
    warm = adagrad_optimize(n_iters, obj, init,
                            key=jax.random.fold_in(key, 99), **kw)
    jax.block_until_ready(warm[0])
    t0 = time.perf_counter()
    out = adagrad_optimize(n_iters, obj, init, key=key, **kw)
    jax.block_until_ready(out[0])
    return out, n_iters / (time.perf_counter() - t0)


def main(full=False, mc_samples=None, n_iters=None):
    mc_samples = mc_samples or (1000000 if full else 100000)
    n_iters = n_iters or (5000 if full else 2000)
    model = robust_regression_model()
    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4, k5, k6 = jax.random.split(key, 6)

    # --- KLVI, mean-field t(40) (reference cells 13-21: 245.65 it/s,
    #     khat after PSIS = 0.92) ---
    fam = mean_field_t_variational_family(2, 40)
    klvi = black_box_klvi(fam, model.log_prob, 100)
    init = jnp.asarray(np.concatenate([np.zeros(2), np.ones(2)]),
                       dtype=jnp.float32)
    (klvi_param, _, _, _), it_s = timed_optimize(n_iters, klvi, init, k1,
                                                 learning_rate=.01)
    print('KLVI mf-t(40): {:.0f} it/s (reference laptop 245.65)'.format(
        it_s))
    check_approx_accuracy(fam, klvi_param, model.true_mean, model.true_cov,
                          verbose=True)
    res, khat, elbo = bounds_and_khat(model, fam, klvi_param, mc_samples, k2)
    print_bounds(res)
    print('khat = {:.3f} (reference 0.92)'.format(khat))
    khat_klvi = khat

    # --- CHIVI alpha=2, warm start (reference cells 23-30: khat 0.341) ---
    chivi = black_box_chivi(2, fam, model.log_prob, 500)
    chivi_init = jnp.asarray(np.asarray(klvi_param)).at[2:].add(3.0)
    (chivi_param, _, _, _), it_s = timed_optimize(n_iters, chivi, chivi_init,
                                                  k3, learning_rate=.01)
    print('\nCHIVI: {:.0f} it/s (reference laptop 48.70)'.format(it_s))
    check_approx_accuracy(fam, chivi_param, model.true_mean, model.true_cov,
                          verbose=True)
    res, khat, _ = bounds_and_khat(model, fam, chivi_param, mc_samples, k4,
                                   elbo=elbo)
    print_bounds(res)
    print('khat = {:.3f} (reference 0.341)'.format(khat))
    khat_chivi = khat

    # --- full-rank t(100) KLVI (reference cells 32-38: khat -0.93,
    #     W2 = 0.385, d2 = 5.92e-4, mean_err = 0.0456) ---
    tfam = t_variational_family(2, 100)
    full_klvi = black_box_klvi(tfam, model.log_prob, 100)
    tinit = tfam.init_param()
    (full_param, _, _, _), it_s = timed_optimize(n_iters, full_klvi, tinit,
                                                 k5, learning_rate=.1,
                                                 learning_rate_end=.001)
    print('\nfull-rank KLVI: {:.0f} it/s (reference laptop 143.81)'.format(
        it_s))
    check_approx_accuracy(tfam, full_param, model.true_mean, model.true_cov,
                          verbose=True)
    res, khat, _ = bounds_and_khat(model, tfam, full_param, mc_samples, k6)
    print_bounds(res)
    print('khat = {:.3f} (reference -0.93)'.format(khat))
    return dict(khat_full=khat, W2_full=res['W2'], d2_full=res['d2'],
                mean_err_full=res['mean_error'], khat_klvi=khat_klvi,
                khat_chivi=khat_chivi)


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--full', action='store_true')
    main(p.parse_args().full)
