"""Variational families as pure-function bundles.

JAX rebuild of the reference families
(reference: viabel/vb.py:42-233).  The reference packages each family as a
namedtuple of closures over a *global* `numpy.random.RandomState`
(reference: viabel/vb.py:42-45, 49); here each family is a `VariationalFamily`
of *pure* functions threaded with explicit `jax.random` keys, so every
function jits, vmaps over chains, and shards over a device mesh unchanged.

Variational parameters are flat f32/f64 vectors (like the reference), so the
optimizer/diagnostics convention of slicing ``param[:K]`` (location block) and
``param[K:]`` (scale block) carries over (reference: viabel/vb.py:489-518).

Full-rank families use an unconstrained Cholesky parameterization
``[mu (d), log diag L (d), strict lower tri of L (d(d-1)/2)]`` instead of the
reference's paragami PSD pattern / `sqrtm` sampling
(reference: viabel/vb.py:185-233) — triangular products are plain matmuls,
unlike `sqrtm`, and the parameter dimension d(d+3)/2 matches the
reference's flat length.  The reference's broken full-rank-Gaussian
`pth_moment` (copy-pasted mean-field code; reference: viabel/vb.py:126-134)
is *fixed* here, not replicated, as is its leftover debug print
(reference: viabel/vb.py:89).
"""
import math
from functools import lru_cache
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .distributions import (chi2_sample, diag_normal_logpdf,
                            diag_student_t_logpdf, mvn_logpdf_chol,
                            mvt_logpdf_chol, student_t_sample)

__all__ = [
    'VariationalFamily',
    'NoClosedFormMomentError',
    'mean_field_gaussian_variational_family',
    'mean_field_t_variational_family',
    'full_rank_gaussian_variational_family',
    't_variational_family',
    'init_from_moments',
]

_LOG_2PI = math.log(2.0 * math.pi)


class NoClosedFormMomentError(ValueError):
    """Raised by a family's `pth_moment` when the requested moment has no
    finite closed form (a Student-t with ``2 < df <= p`` — the constructors
    accept such df, the reference's moment formulas just do not apply;
    reference: viabel/vb.py:219-230).  A dedicated type so callers
    (`bounds.family_moment_bounds`, the fused pipeline) can branch to the
    empirical-moment fallback on exactly this condition without string-
    matching the message or masking real defects raised as plain
    ValueError (round-5 advisor finding).  Custom families should raise
    this same type from their own no-closed-form guards to opt in to the
    fallback."""


def _memoized_constructor(build):
    """Memoize a family constructor on normalized (int dim, float df) args.

    `VariationalFamily` holds closures, so two calls of
    ``t_variational_family(2, 40)`` would otherwise be DISTINCT objects —
    and every compiled program keyed on the family identity (the jit caches
    in `bounds._family_moments_prog`, `pipeline._default_objective`, the
    sharded builders) would silently recompile when a caller reconstructs
    the family per call (CLAUDE.md conventions).  Memoizing the
    constructors makes reconstruction free: same arguments, same object,
    caches hit.  Arguments are normalized (``int(dim)``, ``float(df)``)
    before keying so ``f(2, 3)``, ``f(2, 3.0)``, and ``f(dim=2, df=3)``
    all return the one cached family.
    """
    cached = lru_cache(maxsize=256)(build)

    def constructor(dim, df=None):
        if df is None:
            return cached(int(dim))
        return cached(int(dim), float(df))

    constructor.__name__ = build.__name__
    constructor.__qualname__ = build.__qualname__
    constructor.__doc__ = build.__doc__
    return constructor


def _mm(a, b):
    """f32-accurate matmul for the full-rank families' tiny products.

    An unpinned f32 matmul may run in TF32 on the GPU (about three
    decimal digits); these (n, d) @ (d, d) products set the sample
    geometry the optimizer differentiates through.  Reduced-precision
    products measurably shift the converged optimum (robust-regression
    full-rank t(100): d2 6.0e-4 -> 3.1e-3, khat -0.94 -> -0.04;
    benchmarks/KHAT_NOISE.md); HIGHEST restores CPU-parity statistics.
    """
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


class VariationalFamily(NamedTuple):
    """Bundle of pure functions defining a variational family.

    Counterpart of the reference namedtuple (reference: viabel/vb.py:42-45)
    with JAX conventions: `sample` takes an explicit PRNG key, `log_prob` is
    parameter-first, and `pth_moment` takes the (static) order last.

    Fields
    ------
    sample : (key, var_param, n_samples) -> (n_samples, dim) array
        Reparameterized sampler; gradients flow through `var_param`.
    entropy : (var_param) -> scalar
    log_prob : (var_param, x) -> (n,) log q(x; var_param)
    mean_and_cov : (var_param) -> (mean (dim,), cov (dim, dim))
    pth_moment : (var_param, p) -> scalar bound on min_y E||x - y||^p, p in {2,4}
    var_param_dim, dim : int
    init_param : () -> zeros var-param vector
    base_sample : (key, n_samples) -> parameter-free standard draws (pytree)
        All randomness of `sample`, decoupled from the parameters — enables
        batching draws for many iterations at once (pre-sampled
        optimization; `sample(key, p, n) == transform(p, base_sample(key,
        n))` holds exactly).
    transform : (var_param, draws) -> (n_samples, dim)
        Deterministic reparameterization applied to `base_sample` output.
    """
    sample: Callable
    entropy: Callable
    log_prob: Callable
    mean_and_cov: Callable
    pth_moment: Callable
    var_param_dim: int
    dim: int
    name: str
    base_sample: Callable = None
    transform: Callable = None

    def logdensity(self, x, var_param):
        """Reference-argument-order alias (reference: viabel/vb.py:63)."""
        return self.log_prob(var_param, x)

    def init_param(self, dtype=jnp.float32):
        return jnp.zeros(self.var_param_dim, dtype=dtype)


@_memoized_constructor
def mean_field_gaussian_variational_family(dim):
    """Mean-field Gaussian: ``var_param = [mean (d), log_std (d)]``
    (reference: viabel/vb.py:48-82)."""

    def unpack(var_param):
        return var_param[:dim], var_param[dim:]

    def base_sample(key, n_samples, dtype=jnp.float32):
        return jax.random.normal(key, (n_samples, dim), dtype=dtype)

    def transform(var_param, z):
        mean, log_std = unpack(var_param)
        return mean + jnp.exp(log_std) * z

    def sample(key, var_param, n_samples):
        return transform(var_param,
                         base_sample(key, n_samples, var_param.dtype))

    def entropy(var_param):
        _, log_std = unpack(var_param)
        return 0.5 * dim * (1.0 + _LOG_2PI) + jnp.sum(log_std)

    def log_prob(var_param, x):
        mean, log_std = unpack(var_param)
        return diag_normal_logpdf(x, mean, log_std)

    def mean_and_cov(var_param):
        mean, log_std = unpack(var_param)
        return mean, jnp.diag(jnp.exp(2 * log_std))

    def pth_moment(var_param, p):
        if p not in (2, 4):
            raise ValueError('only p = 2 or 4 supported')
        _, log_std = unpack(var_param)
        variances = jnp.exp(2 * log_std)
        if p == 2:
            return jnp.sum(variances)
        return 2 * jnp.sum(variances ** 2) + jnp.sum(variances) ** 2

    return VariationalFamily(sample, entropy, log_prob, mean_and_cov,
                             pth_moment, 2 * dim, dim, 'mf_gaussian',
                             base_sample, transform)


@_memoized_constructor
def mean_field_t_variational_family(dim, df):
    """Mean-field Student-t: ``var_param = [mean (d), log_scale (d)]``
    (reference: viabel/vb.py:140-182).  Entropy drops df-only constants like
    the reference (reference: viabel/vb.py:153-156)."""
    if df <= 2:
        raise ValueError('df must be greater than 2')

    def unpack(var_param):
        return var_param[:dim], var_param[dim:]

    def base_sample(key, n_samples, dtype=jnp.float32):
        # rejection-free for integer df, no gamma rejection loop
        # (see distributions.student_t_sample)
        return student_t_sample(key, df, (n_samples, dim), dtype=dtype)

    def transform(var_param, t):
        mean, log_scale = unpack(var_param)
        return mean + jnp.exp(log_scale) * t

    def sample(key, var_param, n_samples):
        return transform(var_param,
                         base_sample(key, n_samples, var_param.dtype))

    def entropy(var_param):
        _, log_scale = unpack(var_param)
        return jnp.sum(log_scale)

    def log_prob(var_param, x):
        mean, log_scale = unpack(var_param)
        return diag_student_t_logpdf(x, df, mean, log_scale)

    def mean_and_cov(var_param):
        mean, log_scale = unpack(var_param)
        return mean, df / (df - 2) * jnp.diag(jnp.exp(2 * log_scale))

    def pth_moment(var_param, p):
        if p not in (2, 4):
            raise ValueError('only p = 2 or 4 supported')
        if df <= p:
            raise NoClosedFormMomentError(
                'df must be greater than p = {} for a closed-form moment '
                '(df = {}); callers fall back to empirical central '
                'moments'.format(p, df))
        _, log_scale = unpack(var_param)
        scales = jnp.exp(log_scale)
        c = df / (df - 2)
        if p == 2:
            return c * jnp.sum(scales ** 2)
        return c ** 2 * (2 * (df - 1) / (df - 4) * jnp.sum(scales ** 4)
                         + jnp.sum(scales ** 2) ** 2)

    return VariationalFamily(sample, entropy, log_prob, mean_and_cov,
                             pth_moment, 2 * dim, dim, 'mf_t',
                             base_sample, transform)


def _unpack_chol(var_param, dim):
    """Unpack ``[mu, log diag L, strict lower L]`` into (mu, L)."""
    mu = var_param[:dim]
    log_diag = var_param[dim:2 * dim]
    off = var_param[2 * dim:]
    L = jnp.zeros((dim, dim), dtype=var_param.dtype)
    if dim > 1:
        rows, cols = jnp.tril_indices(dim, k=-1)
        L = L.at[rows, cols].set(off)
    L = L + jnp.diag(jnp.exp(log_diag))
    return mu, L


def _chol_param_dim(dim):
    return dim * (dim + 3) // 2


@_memoized_constructor
def full_rank_gaussian_variational_family(dim):
    """Full-rank Gaussian with Cholesky parameterization.

    Counterpart of the reference family (reference: viabel/vb.py:85-137) with
    its known defects fixed: no debug print (reference: viabel/vb.py:89), a
    mathematically correct full-rank `pth_moment`
    (E||x-mu||^2 = tr(Sigma), E||x-mu||^4 = 2 tr(Sigma^2) + tr(Sigma)^2;
    the reference copy-pasted the mean-field formula at viabel/vb.py:126-134),
    and `mean_and_cov` returning the full covariance matrix rather than its
    diagonal (reference: viabel/vb.py:120-124).
    """

    def base_sample(key, n_samples, dtype=jnp.float32):
        return jax.random.normal(key, (n_samples, dim), dtype=dtype)

    def transform(var_param, z):
        mu, L = _unpack_chol(var_param, dim)
        return mu + _mm(z, L.T)

    def sample(key, var_param, n_samples):
        return transform(var_param,
                         base_sample(key, n_samples, var_param.dtype))

    def entropy(var_param):
        log_diag = var_param[dim:2 * dim]
        return jnp.sum(log_diag) + 0.5 * dim * (1.0 + _LOG_2PI)

    def log_prob(var_param, x):
        mu, L = _unpack_chol(var_param, dim)
        return mvn_logpdf_chol(x, mu, L)

    def mean_and_cov(var_param):
        mu, L = _unpack_chol(var_param, dim)
        return mu, _mm(L, L.T)

    def pth_moment(var_param, p):
        if p not in (2, 4):
            raise ValueError('only p = 2 or 4 supported')
        _, L = _unpack_chol(var_param, dim)
        tr_sigma = jnp.sum(L ** 2)
        if p == 2:
            return tr_sigma
        tr_sigma2 = jnp.sum(_mm(L.T, L) ** 2)  # tr(Sigma^2) = ||L^T L||_F^2
        return 2 * tr_sigma2 + tr_sigma ** 2

    return VariationalFamily(sample, entropy, log_prob, mean_and_cov,
                             pth_moment, _chol_param_dim(dim), dim,
                             'full_rank_gaussian', base_sample, transform)


@_memoized_constructor
def t_variational_family(dim, df):
    """Full-rank multivariate Student-t with Cholesky parameterization.

    Counterpart of the reference paragami/`sqrtm` family
    (reference: viabel/vb.py:185-233): samples via the chi-square scale
    mixture ``mu + (z @ L^T) / s`` with ``s = sqrt(chi2(df)/df)``
    (reference: viabel/vb.py:202-208 uses sqrtm(Sigma); the distribution is
    identical), entropy ``0.5 log det Sigma`` dropping df-only constants
    (reference: viabel/vb.py:210-213), and moments using the df/(df-2) and
    (df-1)/(df-4) inflation factors (reference: viabel/vb.py:219-230).
    """
    if df <= 2:
        raise ValueError('df must be greater than 2')

    def base_sample(key, n_samples, dtype=jnp.float32):
        key_z, key_s = jax.random.split(key)
        return dict(
            z=jax.random.normal(key_z, (n_samples, dim), dtype=dtype),
            chi2=chi2_sample(key_s, df, (n_samples,), dtype=dtype))

    def transform(var_param, draws):
        mu, L = _unpack_chol(var_param, dim)
        s = jnp.sqrt(draws['chi2'] / df)
        return mu + _mm(draws['z'], L.T) / s[:, None]

    def sample(key, var_param, n_samples):
        return transform(var_param,
                         base_sample(key, n_samples, var_param.dtype))

    def entropy(var_param):
        log_diag = var_param[dim:2 * dim]
        return jnp.sum(log_diag)  # = 0.5 log det(Sigma)

    def log_prob(var_param, x):
        mu, L = _unpack_chol(var_param, dim)
        return mvt_logpdf_chol(x, mu, L, df)

    def mean_and_cov(var_param):
        mu, L = _unpack_chol(var_param, dim)
        return mu, df / (df - 2.0) * _mm(L, L.T)

    def pth_moment(var_param, p):
        if p not in (2, 4):
            raise ValueError('only p = 2 or 4 supported')
        if df <= p:
            raise NoClosedFormMomentError(
                'df must be greater than p = {} for a closed-form moment '
                '(df = {}); callers fall back to empirical central '
                'moments'.format(p, df))
        _, L = _unpack_chol(var_param, dim)
        tr_sigma = jnp.sum(L ** 2)
        if p == 2:
            return df / (df - 2) * tr_sigma
        # All coordinates share ONE chi-square divisor, so
        # E||x-mu||^4 = E[(df/chi2)^2] * E||z||^4
        #             = df^2/((df-2)(df-4)) * (2 tr(Sigma^2) + tr(Sigma)^2).
        # The reference (viabel/vb.py:228-230) instead applies the
        # independent-coordinate mean-field formula to eigvalsh(Sigma),
        # which drops the shared-mixing cross terms and UNDERestimates the
        # 4th moment — making the downstream W2/moment "bounds" not actual
        # upper bounds.  Fixed here, not replicated; see PARITY.md.
        tr_sigma2 = jnp.sum(_mm(L.T, L) ** 2)
        return df ** 2 / ((df - 2) * (df - 4)) * (
            2 * tr_sigma2 + tr_sigma ** 2)

    return VariationalFamily(sample, entropy, log_prob, mean_and_cov,
                             pth_moment, _chol_param_dim(dim), dim,
                             'full_rank_t', base_sample, transform)


def init_from_moments(family, mean, cov):
    """Variational parameters matching given first/second moments.

    Convenience the reference lacks (its notebooks assemble init vectors by
    hand, e.g. eight-schools.ipynb cell 16 concatenates NUTS moments).
    For Student-t families the *scale* is set from `cov` directly, so the
    distribution covariance comes out ``df/(df-2) * cov`` — dividing out
    the df/(df-2) inflation is deliberately skipped, matching the reference
    notebooks, which also set log-scales directly from target stdevs
    (round-4 review: the previous wording claimed the distribution
    covariance itself matches `cov`, which contradicts the code).
    """
    import numpy as np
    mean = np.asarray(mean, dtype=float)
    cov = np.atleast_2d(np.asarray(cov, dtype=float))
    d = family.dim
    if mean.shape != (d,) or cov.shape != (d, d):
        raise ValueError('moments must have shape ({0},) and ({0}, {0})'
                         .format(d))
    if family.name in ('mf_gaussian', 'mf_t'):
        log_scale = 0.5 * np.log(np.diag(cov))
        return jnp.asarray(np.concatenate([mean, log_scale]))
    L = np.linalg.cholesky(cov)
    off = L[np.tril_indices(d, k=-1)]
    return jnp.asarray(np.concatenate([mean, np.log(np.diag(L)), off]))
