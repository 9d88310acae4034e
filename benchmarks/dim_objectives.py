"""Large-d study for the OTHER two optimizer surfaces.

benchmarks/dim_scaling.py covers full-rank Gaussian KLVI only; this study
runs the remaining optimizer surfaces at d in {100, 300} (full-rank,
P = d(d+3)/2 up to 45,450) on the same conjugate linear-regression
posterior with analytic truth:

* **CHIVI** (the exp-weighted, overflow-prone gradient; reference:
  viabel/vb.py:248-266) — initialized from a KLVI warm fit with the
  reference's ELBO -> log_norm_bound threading (reference:
  notebooks/experiments.py:205-208).  Gates: every value/log-norm in the
  history finite (no overflow in ``exp(lw - max lw)**alpha``), khat and
  d2 certify, steady-state it/s recorded so the step cost can be compared
  across objectives.
* **IA chains** (RMSProp + R-hat-gated averaging; reference:
  viabel/vb.py:392-549) — K vmapped chains at full production d.  Gates:
  finite histories, khat/d2 of the IA-averaged fit, aggregate chain-steps/s
  vs the single-fit adagrad rate (what the vmapped batch costs over one
  chain).

Writes `dim_objectives.json`; DIM_SCALING.md records the conclusions.

Usage: python benchmarks/dim_objectives.py [--dims 100,300] [--cpu]
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


def _steady(fn, reps=3):
    """Best-of-reps wall clock after a warm/compile call; inputs varied
    per rep (CLAUDE.md timing rules)."""
    jax.block_until_ready(fn(0))
    best = float('inf')
    for r in range(1, reps + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(r))
        best = min(best, time.perf_counter() - t0)
    return best


def _certify(fam, opt_param, model, n_bound, key):
    """Bound pass + PSIS on a fitted parameter: (khat, d2, mean_err).
    A non-finite fit (a diverged optimizer) certifies as (nan, nan, nan)
    instead of crashing the study — that outcome IS a result here."""
    from viabel_tpu.bounds import all_bounds, family_moment_bounds
    from viabel_tpu.experiments import get_samples_and_log_weights
    from viabel_tpu.psis import psislw
    mean, cov = map(np.asarray, fam.mean_and_cov(opt_param))
    if not (np.all(np.isfinite(mean)) and np.all(np.isfinite(cov))):
        return float('nan'), float('nan'), float('nan')
    _, lw = get_samples_and_log_weights(model.log_prob, fam, opt_param,
                                        n_bound, key)
    res = all_bounds(lw, q_var=cov,
                     moment_bound_fn=family_moment_bounds(fam, opt_param))
    _, khat = psislw(lw)
    mean_err = float(np.linalg.norm(mean - model.true_mean))
    return float(khat), float(res['d2']), mean_err


def run_dim(d, n_iters, n_bound, n_chains, key, chivi_lr=.005,
            ia_lr=.01):
    import warnings

    from viabel_tpu import (adagrad_optimize, black_box_chivi,
                            black_box_klvi,
                            full_rank_gaussian_variational_family,
                            init_from_moments,
                            rmsprop_IA_optimize_with_rhat)
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
        fam, np.zeros(d), 3.0 ** 2 * np.eye(d)).astype(jnp.float32)
    P = fam.var_param_dim
    print('--- d = {} (P = {}) ---'.format(d, P), flush=True)
    k_klvi, k_chivi, k_ia, k_bound = jax.random.split(key, 4)

    # KLVI warm stage: CHIVI's init and log_norm_bound come from a KLVI
    # fit, the reference's experiment protocol (notebooks/
    # experiments.py:205-208); in-scan draws at d >= 300 (memory, see
    # dim_scaling.py)
    klvi = black_box_klvi(fam, model.log_prob, 100, presampled=d < 300)
    klvi_param, _, klvi_vals, _ = adagrad_optimize(
        n_iters, klvi, init, key=k_klvi, learning_rate=.05,
        learning_rate_end=.001, return_history=False)
    jax.block_until_ready(klvi_param)
    elbo = float(np.mean(np.asarray(klvi_vals)[-max(n_iters // 4, 1):]))

    # alpha-weight effective sample size AT the KLVI optimum: the CHIVI
    # gradient is a w_alpha-weighted average (w = exp(alpha*(lw - max));
    # reference: viabel/vb.py:255-263), so ESS = (sum w)^2 / sum w^2 out
    # of n is the information content of one gradient draw.  If this
    # collapses with d, CHIVI's gradient follows a handful of samples no
    # matter the batch size — the estimator, not the optimizer, is the
    # limit.
    from viabel_tpu.experiments import get_samples_and_log_weights
    _, lw_ess = get_samples_and_log_weights(model.log_prob, fam,
                                            klvi_param, 100000,
                                            jax.random.fold_in(k_bound, 9))
    w = jnp.exp(2.0 * (lw_ess - jnp.max(lw_ess)))
    alpha_ess = float(jnp.sum(w) ** 2 / jnp.sum(w * w))
    print('alpha-weight ESS at KLVI fit: {:.1f} / 1e5'.format(alpha_ess),
          flush=True)

    # --- CHIVI from the KLVI fit ---
    # n_mc = 800, not the reference's 100-500: the alpha-exponentiated
    # CHIVI gradient (reference: viabel/vb.py:255-263) concentrates on the
    # few largest weights, and at d >= 100 a 100-sample estimate is noisy
    # enough to kick the 5k+-parameter full-rank fit into a diverging
    # region, so large-d CHIVI uses 8x the samples.
    n_mc_chivi = 800
    chivi = black_box_chivi(2, fam, model.log_prob, n_mc_chivi,
                            presampled=False)
    # refinement-stage length, capped: at d >= 100 the CHIVI stage's
    # outcome (divergence or drift; see DIM_SCALING.md) is established
    # within a few thousand iterations
    n_chivi = min(n_iters // 2, 5000)

    def chivi_run(r):
        return adagrad_optimize(n_chivi, chivi, klvi_param,
                                key=jax.random.fold_in(k_chivi, r),
                                learning_rate=chivi_lr,
                                learning_rate_end=chivi_lr / 10,
                                return_history=False)[0]

    t_chivi = _steady(chivi_run)
    chivi_param, _, cvals, clognorms = adagrad_optimize(
        n_chivi, chivi, klvi_param, key=k_chivi, learning_rate=chivi_lr,
        learning_rate_end=chivi_lr / 10, return_history=False)
    cvals = np.asarray(cvals)
    clognorms = np.asarray(clognorms)
    chivi_finite = bool(np.all(np.isfinite(cvals))
                        and np.all(np.isfinite(clognorms)))
    bad = np.nonzero(~np.isfinite(cvals) | ~np.isfinite(clognorms))[0]
    first_bad = int(bad[0]) if bad.size else -1
    khat_c, d2_c, merr_c = _certify(fam, chivi_param, model, n_bound,
                                    k_bound)
    chivi_row = dict(objective='chivi', d=d, P=P, n_iters=n_chivi,
                     n_mc=n_mc_chivi, alpha_weight_ess_1e5=alpha_ess,
                     it_s=n_chivi / t_chivi, all_finite=chivi_finite,
                     first_nonfinite_iter=first_bad,
                     max_abs_log_norm=float(np.max(np.abs(clognorms))),
                     khat=khat_c, d2=d2_c, mean_error=merr_c)
    print('CHIVI : {:7.0f} it/s | finite={} (first bad it {}) | '
          'max|log_norm|={:.1f} | '
          'khat {:+.3f} | d2 {:.2e} | mean_err {:.4f}'.format(
              chivi_row['it_s'], chivi_finite, first_bad,
              chivi_row['max_abs_log_norm'], khat_c, d2_c, merr_c),
          flush=True)

    # --- IA chains (RMSProp + R-hat) ---
    # The IA post-pass gathers the (n_chains, 100*window, P) retained
    # history to the host for the R-hat gates (reference semantics,
    # viabel/vb.py:487-549).  At P = 45,450 the window=10 default retains
    # 727 MB per 4 chains, so the study shrinks the window with P: the
    # R-hat gates then read
    # the last 100 iterates, which is what they inspect anyway at these
    # chain lengths.
    ia_window = 10 if P < 20000 else 1
    ia_rhat_window = 500 if P < 20000 else 25
    # At P = 45,450 the whole-run 4-chain program is one long device
    # dispatch; the segmented checkpoint driver — the framework's own
    # long-run feature, bit-identical to the whole-run scan — executes it
    # in shorter dispatches that each write a resumable checkpoint.
    import shutil
    import tempfile
    segmented = P >= 20000

    def ia_run(r, keep=False):
        kw = {}
        tmp = None
        if segmented:
            tmp = tempfile.mkdtemp(prefix='ia_seg_')
            kw = dict(checkpoint_path=os.path.join(tmp, 'c.npz'),
                      save_every=4000)
        try:
            out = rmsprop_IA_optimize_with_rhat(
                n_iters, klvi, init, model.dim, n_optimisers=n_chains,
                key=jax.random.fold_in(k_ia, r), learning_rate=ia_lr,
                learning_rate_end=ia_lr / 20, window=ia_window,
                rhat_window=ia_rhat_window, tail_avg_iters=n_iters // 4,
                **kw)
        finally:
            if tmp is not None:
                shutil.rmtree(tmp, ignore_errors=True)
        return out if keep else out[0]

    t_ia = _steady(ia_run, reps=1 if segmented else 2)
    out = ia_run(12345, keep=True)
    # certify the ITERATE-AVERAGED parameter (chain 0's online running
    # mean over the last ~23% of iterations) — the averaging is the point
    # of this optimizer; out[0] is the reference-parity raw last iterate
    # of the last chain (reference: viabel/vb.py:547), which is one noisy
    # draw of the trajectory, not the fit
    ia_param = jnp.asarray(out[6]['averaged_variational_param'][0])
    ia_vals = np.asarray(out[4])
    ia_finite = bool(np.all(np.isfinite(ia_vals)))
    khat_i, d2_i, merr_i = _certify(fam, ia_param, model, n_bound,
                                    jax.random.fold_in(k_bound, 1))
    ia_row = dict(objective='ia_rmsprop', d=d, P=P, n_iters=n_iters,
                  n_chains=n_chains, it_s=n_iters / t_ia,
                  chain_steps_s=n_chains * n_iters / t_ia,
                  all_finite=ia_finite, khat=khat_i, d2=d2_i,
                  mean_error=merr_i)
    print('IA x{} : {:7.0f} it/s ({:7.0f} chain-steps/s) | finite={} | '
          'khat {:+.3f} | d2 {:.2e} | mean_err {:.4f}'.format(
              n_chains, ia_row['it_s'], ia_row['chain_steps_s'], ia_finite,
              khat_i, d2_i, merr_i), flush=True)
    return [dict(objective='klvi_ref', d=d, P=P, n_iters=n_iters,
                 elbo=elbo), chivi_row, ia_row]


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--dims', default='30,100,300')
    p.add_argument('--n-iters', type=int, default=10000)
    p.add_argument('--n-bound', type=int, default=1000000)
    p.add_argument('--n-chains', type=int, default=4)
    p.add_argument('--chivi-lr', type=float, default=.005)
    p.add_argument('--ia-lr', type=float, default=.01)
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--json', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'dim_objectives.json'))
    args = p.parse_args()
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
    print('device: {}'.format(jax.devices()[0]), flush=True)
    rows = []
    for d in [int(x) for x in args.dims.split(',')]:
        n_iters = args.n_iters * (4 if d >= 300 else 1)
        rows += run_dim(d, n_iters, args.n_bound, args.n_chains,
                        jax.random.PRNGKey(1000 + d),
                        chivi_lr=args.chivi_lr, ia_lr=args.ia_lr)
        jax.clear_caches()  # vm.max_map_count guard (CLAUDE.md)
        # write after every dim: a crashed later leg must not lose the
        # recorded ones
        with open(args.json, 'w') as f:
            json.dump(dict(device=str(jax.devices()[0]), rows=rows), f,
                      indent=1)
    print('wrote', args.json)


if __name__ == '__main__':
    main()
