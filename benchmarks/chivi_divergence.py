"""CHIVI large-d divergence: lr sweep + trajectory mechanism probe.

Reproduces the two measurements behind DIM_SCALING.md's "CHIVI does not
survive past d ~ 10-30" section (recorded in dim_objectives.json and the
tables there):

* **lr sweep** (`--mode sweep`, GPU or CPU): from a warm KLVI fit at
  d = 100, CHIVI (alpha = 2, n_mc = 800) either hits NaN (first bad
  iteration recorded) or, at lr small enough to stay finite, drifts to a
  non-certifying fit (khat ~ 9) — there is no stable step size.
* **neff probe** (`--mode neff`): same warm start, but with
  `black_box_chivi_neff` — the ESS-damped gradient stays finite where
  plain CHIVI hits NaN (drift from the warm start bounded at ~0.30,
  identical after 2k and 5k iterations) yet still lands at khat ~ 2.8:
  the damping arrests the runaway without restoring signal.
* **trajectory probe** (`--mode mech`, CPU, d = 30): re-runs the same
  CHIVI start for increasing horizons and prints the estimated CUBO value
  and the parameter block extremes: the value falls monotonically
  (-186 -> -5.8e4 over 800 iterations) while q's mean walks away from the
  posterior — the degenerate estimator (w_alpha collapsed onto the argmax
  sample; see the alpha-ESS column in dim_objectives.json) reduces to
  ~max(lw), and minimizing THAT is unbounded below.

Reference anchor: viabel/vb.py:248-266 (the CUBO construction); the
reference's CHIVI workloads stop at d = 10, where the parity suite
reproduces it exactly (benchmarks/RESULTS.md).

Usage: python benchmarks/chivi_divergence.py --mode sweep [--cpu] [--d 100]
       python benchmarks/chivi_divergence.py --mode mech --cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _setup(d):
    import warnings

    from viabel_tpu import (adagrad_optimize, black_box_klvi,
                            full_rank_gaussian_variational_family,
                            init_from_moments)
    from viabel_tpu.bounds import MonteCarloErrorWarning
    from viabel_tpu.models import (data_generator_linear,
                                   linear_regression_model)
    warnings.simplefilter('ignore', MonteCarloErrorWarning)
    data = data_generator_linear(N=4 * d, D=d, alpha=1.0,
                                 noise_variance=0.25, rho=0.5, seed=7)
    model = linear_regression_model(data['X'], data['Y'], noise_scale=0.5,
                                    prior_std=3.0)
    fam = full_rank_gaussian_variational_family(d)
    init = init_from_moments(
        fam, np.zeros(d), 9.0 * np.eye(d)).astype(jnp.float32)
    klvi = black_box_klvi(fam, model.log_prob, 100, presampled=True)
    kp, _, _, _ = adagrad_optimize(10000, klvi, init,
                                   key=jax.random.PRNGKey(1),
                                   learning_rate=.05,
                                   learning_rate_end=.001,
                                   return_history=False)
    jax.block_until_ready(kp)
    print('d={} P={}: KLVI warm fit done'.format(d, fam.var_param_dim),
          flush=True)
    return model, fam, kp


def sweep(d, neff=False):
    from viabel_tpu import (adagrad_optimize, black_box_chivi,
                            black_box_chivi_neff)
    from viabel_tpu.bounds import all_bounds, family_moment_bounds
    from viabel_tpu.experiments import get_samples_and_log_weights
    from viabel_tpu.psis import psislw
    model, fam, kp = _setup(d)
    factory = black_box_chivi_neff if neff else black_box_chivi
    chivi = factory(2, fam, model.log_prob, 800, presampled=True)
    for lr in ((.005,) if neff else (.005, .002, .001, .0005)):
        p, _, v, ln = adagrad_optimize(5000 if neff else 2000, chivi, kp,
                                       key=jax.random.PRNGKey(3),
                                       learning_rate=lr,
                                       learning_rate_end=lr / 10,
                                       return_history=False)
        v = np.asarray(v)
        ln = np.asarray(ln)
        bad = np.nonzero(~np.isfinite(v) | ~np.isfinite(ln))[0]
        fb = int(bad[0]) if bad.size else -1
        line = 'lr={:.4f}: first_bad={}'.format(lr, fb)
        if fb < 0:
            mean, cov = map(np.asarray, fam.mean_and_cov(p))
            _, lw = get_samples_and_log_weights(model.log_prob, fam, p,
                                                500000,
                                                jax.random.PRNGKey(5))
            res = all_bounds(lw, q_var=cov,
                             moment_bound_fn=family_moment_bounds(fam, p))
            _, kh = psislw(lw)
            line += ' khat={:+.3f} d2={:.3g} merr={:.4f}'.format(
                float(kh), float(res['d2']),
                float(np.linalg.norm(mean - model.true_mean)))
        print(line, flush=True)


def mech(d):
    from viabel_tpu import adagrad_optimize, black_box_chivi
    model, fam, kp = _setup(d)
    chivi = black_box_chivi(2, fam, model.log_prob, 800, presampled=True)
    for T in (50, 200, 400, 600, 660):
        p2, _, v2, _ = adagrad_optimize(T, chivi, kp,
                                        key=jax.random.PRNGKey(3),
                                        learning_rate=.005,
                                        learning_rate_end=.0005,
                                        return_history=False)
        p2 = np.asarray(p2)
        print('T={:4d}: value={:10.3g} |mean|max={:8.3g} '
              'chol[min,max]=[{:8.3g},{:8.3g}] finite={}'.format(
                  T, float(np.asarray(v2)[-1]), np.abs(p2[:d]).max(),
                  p2[d:].min(), p2[d:].max(),
                  bool(np.all(np.isfinite(p2)))), flush=True)


if __name__ == '__main__':
    ap = argparse.ArgumentParser()
    ap.add_argument('--mode', choices=('sweep', 'mech', 'neff'),
                    default='sweep')
    ap.add_argument('--d', type=int, default=None)
    ap.add_argument('--cpu', action='store_true')
    args = ap.parse_args()
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
    print('device: {}'.format(jax.devices()[0]), flush=True)
    if args.mode == 'mech':
        mech(args.d or 30)
    else:
        sweep(args.d or 100, neff=args.mode == 'neff')
