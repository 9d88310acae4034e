"""Pareto-smoothed importance sampling (PSIS), jit-compatible.

JAX rebuild of the vendored Vehtari/Sivula PSIS module
(reference: notebooks/psis.py:112-395; algorithm from Vehtari, Gelman &
Gabry 2017, arXiv:1507.02646).  Functionally equivalent to the reference:
`psislw` splits log-weights into a body and right tail above the
``min(0.2 n, 3 sqrt(n / Reff))``-largest cutoff, fits a generalized Pareto
distribution to the tail exceedances with the Zhang-Stephens empirical-Bayes
quadrature (`gpdfit`), replaces the tail with GPD order-statistic quantiles
(`gpinv`), truncates at the max raw weight, renormalizes, and reports the
tail index `khat` (estimates are unreliable when ``khat > 0.7``).

Design notes
------------
The reference's implementation is per-column Python with data-dependent tail
sizes and in-place numpy surgery (reference: notebooks/psis.py:157-199).
Under XLA everything must be static-shape, so:

* the tail is a *fixed-length* slice of the sorted weights (`tail_len`,
  computed from the static `n`), with a boolean mask selecting the
  data-dependent subset strictly above the cutoff;
* the GPD quadrature uses a static upper bound of
  ``30 + ceil(sqrt(tail_len))`` points with a dynamic validity mask for the
  reference's ``30 + sqrt(n_tail)`` count (reference: notebooks/psis.py:262);
* all conditional paths (no smoothing when the tail is short or ``k < 1/3``;
  reference: notebooks/psis.py:177-188) are `where`-selected, never
  Python-branched;

so one compiled program handles every input and the whole routine runs on
device.  The multi-column case vmaps the single-column kernel.  A
mesh-sharded variant (local top-k + gather of only the tail) lives in
`viabel_tpu.parallel.sharded_psis`.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.special import logsumexp

__all__ = ['psislw', 'psisloo', 'gpdfit', 'gpinv', 'sumlogs',
           'weighted_moments']


@jax.jit
def weighted_moments(samples, slw):
    """Self-normalized importance-weighted mean and covariance.

    `samples` is (n, dim), `slw` the (n,) smoothed log-weights under any
    normalization (they are exp-normalized here).  The device counterpart
    of the reference's weighted mean + ``np.cov(..., aweights=wts)``
    (reference: notebooks/experiments.py:80-87); the single shared kernel
    behind `experiments.improve_with_psis` and the fused pipeline's
    PSIS-corrected moments (the mesh-collective variant lives in
    `parallel.sharded_psis_moments`).
    """
    w = jnp.exp(slw - jnp.max(slw))
    w = w / jnp.sum(w)
    # f32-pinned matmuls: see families._mm (an unpinned f32 matmul may
    # run in TF32 on the GPU and shift statistics)
    hi = jax.lax.Precision.HIGHEST
    mean = jnp.matmul(w, samples, precision=hi)
    c = samples - mean[None, :]
    return mean, jnp.matmul((w[:, None] * c).T, c, precision=hi)

_PRIOR_B = 3.0   # scale prior on b (reference: notebooks/psis.py:261 PRIOR)
_PRIOR_K_A = 10.0  # weakly informative prior on k (notebooks/psis.py:320-323)
_K_MIN = 1.0 / 3.0


def _tail_len(n, Reff):
    """Static tail length ceil(min(0.2 n, 3 sqrt(n/Reff)))
    (reference: notebooks/psis.py:157)."""
    return int(np.ceil(min(0.2 * n, 3 * np.sqrt(n / Reff))))


def gpinv(p, k, sigma):
    """Inverse generalized-Pareto CDF, vectorized and branch-free
    (reference: notebooks/psis.py:334-376).  Assumes ``0 < p < 1``."""
    small_k = jnp.abs(k) < 1e-15
    k_safe = jnp.where(small_k, 1.0, k)
    base = -jnp.log1p(-p)
    x = jnp.where(small_k, base, jnp.expm1(k_safe * base) / k_safe)
    x = x * sigma
    return jnp.where(sigma <= 0, jnp.nan, x)


def _masked_mean(values, mask, count):
    return jnp.sum(jnp.where(mask, values, 0.0)) / count


def gpdfit(x2, mask, n2):
    """Zhang-Stephens empirical-Bayes GPD fit on masked exceedances.

    `x2` is an ascending fixed-length array whose *valid suffix* (selected
    by `mask`, `n2` entries) holds the tail exceedances; invalid entries are
    a prefix (an artifact of slicing a sorted array).  Implements the
    quadrature posterior of the reference `gpdfitnew`
    (reference: notebooks/psis.py:211-331) with a dynamic quadrature-point
    count masked inside a static buffer.  Returns ``(k, sigma)`` where `k`
    already includes the weakly-informative prior shrinkage.
    """
    tail_len = x2.shape[0]
    M = 30 + int(np.ceil(np.sqrt(tail_len)))    # static quadrature bound
    n2f = n2.astype(x2.dtype)
    m_dyn = 30.0 + jnp.floor(jnp.sqrt(n2f))
    j = jnp.arange(1, M + 1, dtype=x2.dtype)
    valid_j = j <= m_dyn

    # quartile and max of the valid (ascending) exceedances
    q_pos = (tail_len - n2 + jnp.floor(n2f / 4 + 0.5).astype(n2.dtype) - 1)
    q_pos = jnp.clip(q_pos, 0, tail_len - 1)
    x_quart = x2[q_pos]
    x_max = x2[-1]

    bs = 1.0 - jnp.sqrt(m_dyn / (j - 0.5))
    bs = bs / (_PRIOR_B * x_quart) + 1.0 / x_max      # (M,)

    ks_j = -bs
    x2_safe = jnp.where(mask, x2, 0.0)
    # per-quadrature-point profile k: mean over tail of log1p(k_j * x)
    lm = jnp.log1p(ks_j[:, None] * x2_safe[None, :])  # (M, tail_len)
    k_j = jnp.sum(jnp.where(mask[None, :], lm, 0.0), axis=1) / n2f

    L = n2f * (jnp.log(-bs / k_j) - k_j - 1.0)
    L = jnp.where(valid_j, L, -jnp.inf)
    # normalized posterior weights w_j = 1 / sum_i exp(L_i - L_j)
    w = 1.0 / jnp.sum(jnp.exp(L[None, :] - L[:, None]), axis=1)
    w = jnp.where(valid_j, w, 0.0)
    w = jnp.where(w >= 10 * jnp.finfo(x2.dtype).eps, w, 0.0)
    w = w / jnp.sum(w)

    b_post = jnp.sum(bs * w)
    k = _masked_mean(jnp.log1p(-b_post * x2_safe), mask, n2f)
    sigma = -k / b_post
    k = k * n2f / (n2f + _PRIOR_K_A) + _PRIOR_K_A * 0.5 / (n2f + _PRIOR_K_A)
    return k, sigma


@partial(jax.jit, static_argnames=('tail_len',))
def _psislw_1d(x, tail_len):
    """Smooth one column of log-weights; returns (smoothed, khat).

    Only the tail participates in the GPD fit and the rewrite, so the
    ``tail_len + 1`` largest weights are extracted with `lax.top_k` instead
    of a full sort and only those positions are scattered back.  Identical
    output in f64; in f32,
    *tied* weight values at the tail boundary may be assigned quantiles in
    a different (equally valid) tie order than a stable sort would.
    """
    dtype = x.dtype
    cutoffmin = jnp.log(jnp.finfo(dtype).tiny)

    x = x - jnp.max(x)
    # largest tail_len weights (ascending) + the cutoff element below them
    top_vals, top_idx = jax.lax.top_k(x, tail_len + 1)
    xcutoff = jnp.maximum(top_vals[tail_len], cutoffmin)
    tail_slice = top_vals[:tail_len][::-1]
    tail_idx = top_idx[:tail_len][::-1]
    mask = tail_slice > xcutoff
    n2 = jnp.sum(mask)

    expxcutoff = jnp.exp(xcutoff)
    exceedances = jnp.exp(tail_slice) - expxcutoff

    k, sigma = gpdfit(exceedances, mask, n2)
    khat = jnp.where(n2 <= 4, jnp.inf, k)
    do_smooth = (n2 > 4) & (k >= _K_MIN) & jnp.isfinite(k)

    # GPD order statistics for the valid tail positions
    pos_in_valid = jnp.arange(tail_len) - (tail_len - n2)
    sti = (pos_in_valid.astype(dtype) + 0.5) / jnp.maximum(n2, 1).astype(dtype)
    sti = jnp.clip(sti, 1e-12, 1 - 1e-12)
    qq = jnp.log(gpinv(sti, k, sigma) + expxcutoff)
    new_tail = jnp.where(do_smooth & mask, qq, tail_slice)

    out = x.at[tail_idx].set(new_tail)
    # truncate smoothed values at the max raw weight (0 after rescaling)
    out = jnp.where(do_smooth, jnp.minimum(out, 0.0), out)
    out = out - logsumexp(out)
    return out, khat


def psislw(lw, Reff=1.0):
    """Pareto-smoothed importance sampling (reference: notebooks/psis.py:112-199).

    Parameters
    ----------
    lw : array, shape (n,) or (n, m)
        m sets of n log-weights (a single set if 1-D).
    Reff : float
        Relative MCMC efficiency ``N_eff / N`` (affects the tail size).

    Returns
    -------
    lw_out : smoothed, self-normalized log weights (same shape)
    kss : Pareto tail index, scalar for 1-D input else shape (m,)
    """
    lw = jnp.asarray(lw)
    if lw.ndim not in (1, 2):
        raise ValueError('Argument `lw` must be 1 or 2 dimensional.')
    n = lw.shape[0]
    if n <= 1:
        raise ValueError('More than one log-weight needed.')
    tail_len = _tail_len(n, Reff)
    if lw.ndim == 1:
        return _psislw_1d(lw, tail_len)
    out, ks = jax.vmap(lambda col: _psislw_1d(col, tail_len),
                       in_axes=1, out_axes=(1, 0))(lw)
    return out, ks


def sumlogs(x, axis=None):
    """log(sum(exp(x))) computed stably (reference: notebooks/psis.py:379-395)."""
    return logsumexp(jnp.asarray(x), axis=axis)


def psisloo(log_lik, **kwargs):
    """PSIS leave-one-out log predictive densities
    (reference: notebooks/psis.py:68-109).

    Parameters
    ----------
    log_lik : array, shape (n, m)
        n posterior draws of the m pointwise log-likelihood terms.
    Reff : float, optional keyword
        Relative efficiency ``N_eff / N`` of the posterior draws.  For MCMC
        draws compute it in-repo as ``Reff =
        diagnostics.effective_sample_size(chains).min() / (n_chains *
        n_iters)`` — smaller Reff enlarges the smoothed tail
        ``min(0.2 n, 3 sqrt(n / Reff))`` to compensate for autocorrelation
        (reference: notebooks/psis.py:112-155; exercised end to end in
        tests/test_psis.py::test_ess_reff_closes_the_psis_loop).

    Returns
    -------
    loo : float — sum of the LOO log predictive densities
    loos : (m,) — individual LOO terms
    ks : (m,) — Pareto tail indices (unreliable when k > 0.7)
    """
    log_lik = jnp.asarray(log_lik)
    lw, ks = psislw(-log_lik, **kwargs)
    lw = lw + log_lik
    loos = sumlogs(lw, axis=0)
    # ONE packed device->host transfer for the scalar total and both
    # (m,) vectors — a separate float(jnp.sum(loos)) would pay this
    # environment's per-fetch dispatch-latency floor on top of the
    # fetches the caller makes anyway (CLAUDE.md device->host convention;
    # the `bounds._fetch_stats` pattern)
    loos1 = jnp.atleast_1d(loos)  # 1-D log_lik yields 0-d loos/ks
    ks1 = jnp.atleast_1d(ks)
    packed = np.asarray(jnp.concatenate(
        [jnp.sum(loos)[None], loos1, ks1.astype(loos.dtype)]))
    m = loos1.shape[0]
    return (float(packed[0]), packed[1:1 + m].reshape(np.shape(loos)),
            packed[1 + m:].reshape(np.shape(ks)))
