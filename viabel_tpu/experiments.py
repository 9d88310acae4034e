"""Experiment harness: optimize, check accuracy, bound, PSIS-correct.

JAX rebuild of the reference harness
(reference: notebooks/experiments.py:1-210 + notebooks/utils.py).  The same
workflow — KLVI then CHIVI (reusing KLVI's ELBO as CHIVI's log-normalizer
bound), accuracy checks against ground truth, large-sample bound estimation
under a timer, and PSIS correction — with the Monte Carlo passes fused/jitted
(and mesh-sharded when a mesh is supplied).  Plotting is optional and
requires matplotlib (reference plots: experiments.py:94-135); everything
else is dependency-free.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from .bounds import all_bounds, family_moment_bounds
from .objectives import black_box_chivi, black_box_klvi
from .optimizers import adagrad_optimize
from .psis import psislw
from .utils import Timer

__all__ = [
    'print_bounds',
    'check_accuracy',
    'check_approx_accuracy',
    'get_samples_and_log_weights',
    'psis_correction',
    'improve_with_psis',
    'improve_with_psis_sharded',
    'run_experiment',
    'plot_approx_and_exact_contours',
    'plot_history',
    'plot_dist_to_opt_param',
]


def _print_table(title, rows):
    """Aligned label/value report used by all console output in this
    module.  `rows` is a sequence of ``(label, scalar)`` pairs."""
    print(title)
    width = max((len(label) for label, _ in rows), default=0)
    for label, value in rows:
        print('    {label:<{w}}  {value:.3g}'.format(label=label,
                                                     value=float(value),
                                                     w=width))


def print_bounds(results):
    """Report the validated posterior-error bounds from an `all_bounds`
    result dict (semantic counterpart of reference:
    notebooks/experiments.py:14-21; the report layout is this project's
    own).  Only the bound entries present in `results` are shown."""
    rows = []
    for key, label in (('W2', '2-Wasserstein'), ('W1', '1-Wasserstein'),
                       ('d2', '2-divergence'), ('mean_error', 'mean error'),
                       ('std_error', 'stdev error')):
        if results.get(key) is not None:
            rows.append((label, results[key]))
    if results.get('cov_error') is not None:
        rows.append(('cov error', results['cov_error']))
        rows.append(('cov error (sqrt)', np.sqrt(results['cov_error'])))
    _print_table('Upper bounds on the approximation error:', rows)


def check_accuracy(true_mean, true_cov, approx_mean, approx_cov,
                   verbose=False, method=None):
    """Norm-based moment-error metrics vs ground truth.

    Computes the same statistics as the reference's accuracy check
    (reference: notebooks/experiments.py:26-48) — vector-2-norm mean and
    stdev errors, spectral- and nuclear-norm covariance errors with the
    corresponding norms of the true covariance for scale, and a relative
    stdev error — under the same result keys, so downstream consumers are
    interchangeable.
    """
    true_mean, approx_mean, true_cov, approx_cov = map(
        np.asarray, (true_mean, approx_mean, true_cov, approx_cov))
    true_std = np.sqrt(np.diag(true_cov))
    approx_std = np.sqrt(np.diag(approx_cov))

    results = {} if method is None else {'method': method}
    results['mean_error'] = np.linalg.norm(true_mean - approx_mean)
    results['std_error'] = np.linalg.norm(true_std - approx_std)
    results['rel_std_error'] = np.linalg.norm(approx_std / true_std - 1)
    for suffix, order in (('2', 2), ('nuc', 'nuc')):
        results['cov_error_' + suffix] = np.linalg.norm(
            true_cov - approx_cov, ord=order)
        results['cov_norm_' + suffix] = np.linalg.norm(true_cov, ord=order)

    if verbose:
        print('approx mean   =', approx_mean)
        print('approx stdevs =', approx_std)
        print()
        _print_table('Moment errors vs ground truth:', [
            ('mean error', results['mean_error']),
            ('stdev error', results['std_error']),
            ('sqrt spectral cov error', np.sqrt(results['cov_error_2'])),
            ('sqrt spectral true-cov norm', np.sqrt(results['cov_norm_2'])),
        ])
    return results


def check_approx_accuracy(var_family, var_param, true_mean, true_cov,
                          verbose=False, name=None):
    """(reference: notebooks/experiments.py:51-55)"""
    mean, cov = var_family.mean_and_cov(var_param)
    return check_accuracy(true_mean, true_cov, np.asarray(mean),
                          np.asarray(cov), verbose, name)


@lru_cache(maxsize=256)
def _draw_fn(log_density, var_family, n_samples):
    """Cached compiled sample+score pass, keyed on (density, family, n) so
    repeated bound/PSIS estimation calls reuse the executable."""

    @jax.jit
    def draw(vp, k):
        samples = var_family.sample(k, vp, n_samples)
        lw = log_density(samples) - var_family.log_prob(vp, samples)
        return samples, lw

    return draw


def get_samples_and_log_weights(log_density, var_family, var_param,
                                n_samples, key=None):
    """Draw samples and log-weights in one fused jitted pass
    (reference: notebooks/experiments.py:60-63)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    try:
        draw = _draw_fn(log_density, var_family, n_samples)
    except TypeError:  # unhashable density (e.g. a Model with array fields)
        draw = _draw_fn(log_density.log_prob, var_family, n_samples) \
            if hasattr(log_density, 'log_prob') else \
            _draw_fn.__wrapped__(log_density, var_family, n_samples)
    return draw(jnp.asarray(var_param), key)


def psis_correction(log_density, var_family, var_param, n_samples, key=None):
    """(reference: notebooks/experiments.py:66-70).  Note: returns samples
    transposed, (dim, n), matching the reference convention."""
    samples, log_weights = get_samples_and_log_weights(
        log_density, var_family, var_param, n_samples, key)
    smoothed_log_weights, khat = psislw(log_weights)
    return samples.T, smoothed_log_weights, khat


def improve_with_psis(log_density, var_family, var_param, n_samples,
                      true_mean, true_cov, transform=None, verbose=False,
                      key=None):
    """PSIS-corrected moment estimates + accuracy check
    (reference: notebooks/experiments.py:73-89).

    With no `transform`, the weighted moments are computed on device and
    only the dim-sized results cross to the host; a `transform` (a host
    numpy function over the (dim, n) sample matrix) forces the samples to
    the host first, as the reference does."""
    samples, slw, khat = psis_correction(log_density, var_family,
                                         var_param, n_samples, key)
    if verbose:
        print('khat = {:.3g}'.format(float(khat)))
        print()
    if transform is None:
        from .psis import weighted_moments
        approx_mean, approx_cov = weighted_moments(
            jnp.asarray(samples).T, jnp.asarray(slw))
        approx_mean, approx_cov = (np.asarray(approx_mean),
                                   np.asarray(approx_cov))
    else:
        samples = transform(np.asarray(samples))
        slw = np.asarray(slw)
        slw = slw - np.max(slw)
        wts = np.exp(slw)
        wts = wts / np.sum(wts)
        approx_mean = np.sum(wts[np.newaxis, :] * samples, axis=1)
        c = samples - approx_mean[:, None]
        approx_cov = (wts[np.newaxis, :] * c) @ c.T
    res = check_accuracy(true_mean, true_cov, approx_mean, approx_cov,
                         verbose)
    res['khat'] = float(khat)
    return res, approx_mean, approx_cov


def improve_with_psis_sharded(log_density, var_family, var_param, n_samples,
                              true_mean, true_cov, mesh, verbose=False,
                              key=None):
    """Mesh-sharded PSIS correction: samples and log-weights are generated
    per device, only the weight tail is gathered for the GPD fit, and the
    corrected moments are psum-reduced (scales `improve_with_psis` to a pod
    slice; see `viabel_tpu.parallel`)."""
    from .parallel import (psislw_sharded, sharded_all_bounds,
                           sharded_psis_moments)
    if key is None:
        key = jax.random.PRNGKey(0)
    _, lw, samples = sharded_all_bounds(
        log_density, var_family, var_param, n_samples, key, mesh,
        # both closed-form moments in one cached program + one fetch (an
        # eager per-order lambda would pay a dispatch and a fetch per call)
        moment_bound_fn=family_moment_bounds(var_family,
                                             jnp.asarray(var_param)),
        return_log_weights=True, return_samples=True)
    slw, khat = psislw_sharded(lw, mesh)
    mean, cov = sharded_psis_moments(samples, slw, mesh)
    if verbose:
        print('khat = {:.3g}'.format(float(khat)))
    res = check_accuracy(true_mean, true_cov, np.asarray(mean),
                         np.asarray(cov), verbose)
    res['khat'] = float(khat)
    return res, np.asarray(mean), np.asarray(cov)


# -- plotting (optional; requires matplotlib) -------------------------------

def plot_approx_and_exact_contours(log_density, var_family, var_param,
                                   xlim=(-10, 10), ylim=(-3, 3),
                                   cmap2='Reds', savepath=None,
                                   aux_var=None):
    """(reference: notebooks/experiments.py:94-112).  `aux_var` is accepted
    for compatibility with the chivi notebooks, which pass it although the
    reference harness has no such parameter (SURVEY.md section 2.3); when
    given, it is appended to the variational parameter vector."""
    if aux_var is not None:
        var_param = jnp.concatenate([jnp.asarray(var_param),
                                     jnp.atleast_1d(jnp.asarray(aux_var))])
    import matplotlib.pyplot as plt
    xlist = np.linspace(*xlim, 100)
    ylist = np.linspace(*ylim, 100)
    X, Y = np.meshgrid(xlist, ylist)
    XY = np.concatenate([np.atleast_2d(X.ravel()),
                         np.atleast_2d(Y.ravel())]).T
    zs = np.exp(np.asarray(log_density(jnp.asarray(XY))))
    Z = zs.reshape(X.shape)
    zsapprox = np.exp(np.asarray(var_family.log_prob(jnp.asarray(var_param),
                                                     jnp.asarray(XY))))
    Zapprox = zsapprox.reshape(X.shape)
    plt.contour(X, Y, Z, cmap='Greys', linestyles='solid')
    plt.contour(X, Y, Zapprox, cmap=cmap2, linestyles='solid')
    if savepath is not None:
        plt.savefig(savepath, bbox_inches='tight')
    plt.show()


def plot_history(history, B=None, ylabel=None):
    """Plot a moving average of an optimization trace, log-scaled when the
    smoothed trace is positive throughout (semantic counterpart of
    reference: notebooks/experiments.py:115-127).  `B` is the averaging
    window; default one-tenth of the trace, at most 500."""
    import matplotlib.pyplot as plt
    history = np.asarray(history, dtype=float)
    B = max(1, min(500, history.size // 10) if B is None else B)
    # windowed mean via a cumulative-sum difference (O(n), no convolution)
    csum = np.concatenate([[0.0], np.cumsum(history)])
    smoothed = (csum[B:] - csum[:-B]) / B
    _, ax = plt.subplots()
    ax.plot(smoothed)
    if np.all(smoothed > 0):
        ax.set_yscale('log')
    ax.set_xlabel('iteration')
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    plt.show()


def plot_dist_to_opt_param(var_param_history, opt_param):
    """Plot per-iteration Euclidean distance of the parameter trajectory to
    the final optimum (semantic counterpart of reference:
    notebooks/experiments.py:130-136)."""
    import matplotlib.pyplot as plt
    gap = np.asarray(var_param_history) - np.asarray(opt_param)
    _, ax = plt.subplots()
    ax.plot(np.sqrt(np.sum(gap * gap, axis=1)))
    ax.set_title('convergence toward the final parameter')
    ax.set_xlabel('iteration')
    ax.set_ylabel('distance to optimum')
    plt.show()


# -- the experiment driver --------------------------------------------------

def _stage_banner(name):
    """Section header for the experiment console log."""
    print()
    print('======== {} ========'.format(name), flush=True)


def _optimize_and_check_results(log_density, var_family, objective_and_grad,
                                init_var_param, true_mean, true_cov,
                                plot_contours, ylabel, contour_kws=None,
                                elbo=None, n_iters=5000, bound_w2=True,
                                verbose=False, use_psis=True,
                                n_psis_samples=1000000, key=None, **kwargs):
    """(reference: notebooks/experiments.py:138-180)"""
    if key is None:
        key = jax.random.PRNGKey(0)
    opt_key, bound_key, psis_key = jax.random.split(key, 3)
    # has_log_norm=False matches the reference harness, which runs adagrad
    # without the log-norm rescaling path even for CHIVI
    # (reference: notebooks/experiments.py:144 + viabel/vb.py:345-347).
    kwargs.setdefault('has_log_norm', False)
    opt_param, var_param_history, value_history, _ = adagrad_optimize(
        n_iters, objective_and_grad, init_var_param, key=opt_key, **kwargs)
    if plot_contours:
        # the objective-history trace `ylabel` labels ('-ELBO' / 'CUBO';
        # reference: notebooks/experiments.py:146-147)
        plot_history(value_history, ylabel=ylabel)
        plot_dist_to_opt_param(var_param_history, opt_param)
    accuracy_results = check_approx_accuracy(var_family, opt_param,
                                             true_mean, true_cov, verbose)
    other_results = dict(opt_param=np.asarray(opt_param),
                         var_param_history=np.asarray(var_param_history),
                         value_history=np.asarray(value_history))
    if bound_w2 not in [False, None]:
        n_samples = 1000000 if bound_w2 is True else int(bound_w2)
        print()
        with Timer('bound estimation (CUBO + ELBO, {:,} MC samples)'.format(
                n_samples), sync=lambda: ()):
            samples, log_weights = get_samples_and_log_weights(
                log_density, var_family, opt_param, n_samples, bound_key)
            var_dist_cov = np.asarray(var_family.mean_and_cov(opt_param)[1])
            # None for df <= 4 t families: empirical fallback from samples
            moment_bound_fn = family_moment_bounds(var_family, opt_param)
            other_results.update(all_bounds(
                log_weights,
                samples=samples if moment_bound_fn is None else None,
                q_var=var_dist_cov, moment_bound_fn=moment_bound_fn,
                log_norm_bound=elbo))
        if verbose:
            print()
            print_bounds(other_results)
    if plot_contours:
        plot_approx_and_exact_contours(log_density, var_family, opt_param,
                                       **(contour_kws or {}))
    if use_psis:
        _stage_banner('PSIS-corrected moments')
        other_results['psis_results'], _, _ = improve_with_psis(
            log_density, var_family, opt_param, n_psis_samples,
            true_mean, true_cov, verbose=verbose, key=psis_key)
    return accuracy_results, other_results


def run_experiment(log_density, var_family, init_param, true_mean, true_cov,
                   kl_n_samples=100, chivi_n_samples=500, alpha=2,
                   plot_contours=None, key=None, presampled=True, **kwargs):
    """Run KLVI then CHIVI on a target, reusing KLVI's ELBO as CHIVI's
    log-normalizer bound (reference: notebooks/experiments.py:183-210).

    Contour plots are produced for 2-D targets only when matplotlib is
    importable (pass ``plot_contours=False`` to disable explicitly).
    Objectives default to pre-sampled mode (bit-identical trajectories,
    substantially faster scans; draws for all iterations are held in device
    memory — pass ``presampled=False`` for very large
    ``n_iters * n_samples * dim``).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    klvi = black_box_klvi(var_family, log_density, kl_n_samples,
                          presampled=presampled)
    chivi = black_box_chivi(alpha, var_family, log_density, chivi_n_samples,
                            presampled=presampled)
    true_mean = np.asarray(true_mean)
    if plot_contours is None:
        try:
            import matplotlib  # noqa: F401
            plot_contours = true_mean.size == 2
        except ImportError:
            plot_contours = False
    if plot_contours:
        plot_approx_and_exact_contours(log_density, var_family, init_param,
                                       **kwargs.get('contour_kws', {}))

    kl_key, chivi_key = jax.random.split(key)
    _stage_banner('KLVI')
    kl_results, other_kl_results = _optimize_and_check_results(
        log_density, var_family, klvi, init_param,
        true_mean, true_cov, plot_contours, '-ELBO', key=kl_key, **kwargs)
    kl_results['method'] = 'KLVI'
    _stage_banner('CHIVI')
    elbo = other_kl_results.get('log_norm_bound')
    chivi_results, other_chivi_results = _optimize_and_check_results(
        log_density, var_family, chivi, init_param, true_mean, true_cov,
        plot_contours, 'CUBO', elbo=elbo, key=chivi_key, **kwargs)
    chivi_results['method'] = 'CHIVI'
    return (klvi, chivi, kl_results, chivi_results, other_kl_results,
            other_chivi_results)
