"""Log-density primitives for the variational families.

JAX rebuild of the reference distribution helpers
(reference: viabel/_distributions.py:8-38 and the autograd.scipy usages in
viabel/vb.py:63-65, 158-162).  Everything here is pure `jax.numpy`, shape
polymorphic over a leading sample batch, differentiable, and jit/vmap/pjit
friendly.

Design notes: where the reference multivariate-t logpdf takes a dense
covariance and eigendecomposes it per call
(reference: viabel/_distributions.py:27-38), the hot paths here take a
Cholesky factor so the Mahalanobis term is a tiny triangular inverse and one
matmul, and the log-determinant is a diagonal sum.  An eigh-based
general-covariance entry point is kept for parity.
"""
import math

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

__all__ = [
    'normal_logpdf',
    'diag_normal_logpdf',
    'student_t_logpdf',
    'diag_student_t_logpdf',
    'mvn_logpdf_chol',
    'mvt_logpdf_chol',
    'multivariate_t_logpdf',
    'student_t_sample',
    'chi2_sample',
]

_LOG_2PI = math.log(2.0 * math.pi)

# student_t_sample: fall back to jax.random.t's rejection sampler above
# this df (the log-uniform construction's cost grows linearly in df while
# the rejection sampler's is constant).
_MAX_EXACT_T_DF = 200


def _gamma_integer_shape(key, k, shape, dtype):
    """Gamma(k, 1) draws for small integer shape ``k``, rejection-free.

    A Gamma(k, 1) variate is a sum of k unit exponentials,
    ``-sum_i log u_i``; grouping the uniforms into products of at most 10
    before taking logs cuts the transcendental count ~10x
    (``-log(prod u)``; a product of 10 U(0,1) draws cannot underflow f32).
    """
    total = jnp.zeros(shape, dtype)
    tiny = jnp.finfo(dtype).tiny
    i = 0
    while i < k:
        group = min(10, k - i)
        prod = jnp.ones(shape, dtype)
        for j in range(group):
            u = jax.random.uniform(jax.random.fold_in(key, i + j), shape,
                                   dtype=dtype, minval=tiny)
            prod = prod * u
        total = total - jnp.log(prod)
        i += group
    return total


def chi2_sample(key, df, shape, dtype=jnp.float32):
    """Chi-square draws, rejection-free for integer ``df`` (the same
    closed-form construction as `student_t_sample`); falls back to
    `jax.random.chisquare` otherwise."""
    df_int = int(df)
    if df != df_int or not 1 <= df_int <= _MAX_EXACT_T_DF:
        return jax.random.chisquare(key, df, shape, dtype=dtype)
    kg, ko = jax.random.split(key)
    chi2 = jnp.zeros(shape, dtype)
    if df_int // 2 > 0:
        chi2 = 2.0 * _gamma_integer_shape(kg, df_int // 2, shape, dtype)
    if df_int % 2 == 1:
        z1 = jax.random.normal(ko, shape, dtype=dtype)
        chi2 = chi2 + z1 * z1
    return chi2


def student_t_sample(key, df, shape, dtype=jnp.float32):
    """Standard Student-t draws, rejection-free for integer ``df``.

    ``t = z * sqrt(df / chi2_df)`` with the chi-square built from closed
    identities instead of gamma rejection sampling:

    * even df:  ``chi2_df = 2 Gamma(df/2, 1)``;
    * odd df:   ``chi2_df = 2 Gamma((df-1)/2, 1) + z1^2``
      (``Gamma(1/2, 1) = z^2 / 2``).

    `jax.random.t` draws gammas by rejection, a data-dependent loop; this
    construction is pure vectorized uniforms + logs with a fixed amount of
    work, and exact — same distribution, different draws for the same key.
    Falls back to `jax.random.t` for non-integer or very large df.
    """
    df_int = int(df)
    if df != df_int or not 1 <= df_int <= _MAX_EXACT_T_DF:
        return jax.random.t(key, df, shape, dtype=dtype)
    kz, kg, ko = jax.random.split(key, 3)
    z = jax.random.normal(kz, shape, dtype=dtype)
    k = df_int // 2
    chi2 = jnp.zeros(shape, dtype)
    if k > 0:
        chi2 = 2.0 * _gamma_integer_shape(kg, k, shape, dtype)
    if df_int % 2 == 1:
        z1 = jax.random.normal(ko, shape, dtype=dtype)
        chi2 = chi2 + z1 * z1
    return z * jnp.sqrt(df / chi2)


def normal_logpdf(x, loc=0.0, scale=1.0):
    """Elementwise univariate normal log-density."""
    z = (x - loc) / scale
    return -0.5 * (z * z + _LOG_2PI) - jnp.log(scale)


def diag_normal_logpdf(x, mean, log_std):
    """Diagonal-covariance Gaussian log-density, summed over the last axis.

    Equivalent to the reference's `mvn.logpdf(x, mean, diag(exp(2 log_std)))`
    (reference: viabel/vb.py:63-65) without materializing the dense matrix.
    """
    z = (x - mean) * jnp.exp(-log_std)
    return -0.5 * jnp.sum(z * z + _LOG_2PI, axis=-1) - jnp.sum(log_std, axis=-1)


def student_t_logpdf(x, df, loc=0.0, scale=1.0):
    """Elementwise univariate Student-t log-density
    (reference: viabel/vb.py:158-162 uses autograd's t_dist.logpdf)."""
    z = (x - loc) / scale
    lognorm = (gammaln(0.5 * (df + 1.0)) - gammaln(0.5 * df)
               - 0.5 * jnp.log(df * jnp.pi))
    return lognorm - 0.5 * (df + 1.0) * jnp.log1p(z * z / df) - jnp.log(scale)


def diag_student_t_logpdf(x, df, mean, log_scale):
    """Product of independent Student-t log-densities, summed over last axis
    (reference: viabel/vb.py:158-162)."""
    return jnp.sum(student_t_logpdf(x, df, mean, jnp.exp(log_scale)), axis=-1)


def _chol_mahalanobis_and_logdet(x, mean, chol):
    """Return (||L^{-1}(x-mean)||^2, log det Sigma) for Sigma = L L^T."""
    dev = x - mean
    # z = L^{-1} dev^T, batched over samples — computed as an explicit
    # (d, d) triangular inverse followed by one (d, n) matmul instead of a
    # TriangularSolve over n columns.  Two reasons: (1) TriangularSolve is a
    # single XLA primitive whose internal blocked matmuls need not honour
    # JAX precision controls, while the matmul here is pinned to full f32
    # (this log-density is differentiated by CHIVI and sets the PSIS
    # log-weights; same defect class as families._mm); (2) one batched
    # matmul over the sample axis instead of a solve.  The tiny d x d
    # inverse itself stays a forward substitution; fine for the
    # well-conditioned Cholesky factors variational fits produce.
    eye = jnp.eye(chol.shape[-1], dtype=chol.dtype)
    inv_chol = jax.scipy.linalg.solve_triangular(chol, eye, lower=True)
    z = jnp.matmul(inv_chol, dev.T, precision=jax.lax.Precision.HIGHEST)
    maha = jnp.sum(z * z, axis=0)
    log_det = 2.0 * jnp.sum(jnp.log(jnp.diag(chol)))
    return maha, log_det


def mvn_logpdf_chol(x, mean, chol):
    """Multivariate normal log-density with covariance ``Sigma = chol chol^T``."""
    d = mean.shape[-1]
    maha, log_det = _chol_mahalanobis_and_logdet(x, mean, chol)
    return -0.5 * (maha + log_det + d * _LOG_2PI)


def mvt_logpdf_chol(x, mean, chol, df):
    """Multivariate Student-t log-density with scale ``Sigma = chol chol^T``.

    Same density as the reference's eigh-based `multivariate_t_logpdf`
    (reference: viabel/_distributions.py:8-38) but via a triangular solve.
    """
    d = mean.shape[-1]
    maha, log_det = _chol_mahalanobis_and_logdet(x, mean, chol)
    lognorm = (gammaln(0.5 * (df + d)) - gammaln(0.5 * df)
               - 0.5 * d * jnp.log(jnp.pi * df) - 0.5 * log_det)
    return lognorm - 0.5 * (df + d) * jnp.log1p(maha / df)


def multivariate_t_logpdf(x, m, S, df=jnp.inf):
    """Multivariate-t log-density with a dense (PSD) scale matrix.

    Parity entry point matching the reference signature
    (reference: viabel/_distributions.py:8-38), including the normal
    fallback when ``df`` is infinite (used there to emulate a full-rank
    Gaussian via ``t_variational_family(k, df=1e6)``).  Uses an eigh-based
    pseudo-inverse like the reference so rank-deficient `S` is tolerated.
    """
    x = jnp.atleast_2d(x)
    d = m.shape[-1]
    s, u = jnp.linalg.eigh(S)
    eps = 1e-10
    s_pinv = jnp.where(jnp.abs(s) <= eps, 0.0, 1.0 / s)
    U = u * jnp.sqrt(s_pinv)
    log_pdet = jnp.sum(jnp.log(jnp.where(jnp.abs(s) <= eps, 1.0, s)))
    dev = x - m
    maha = jnp.sum(jnp.square(
        jnp.matmul(dev, U, precision=jax.lax.Precision.HIGHEST)), axis=-1)
    if df == jnp.inf or df is None:
        return -0.5 * (maha + log_pdet + d * _LOG_2PI)
    log_pdf = (gammaln(0.5 * (df + d)) - gammaln(0.5 * df)
               - 0.5 * d * jnp.log(jnp.pi * df) - 0.5 * log_pdet)
    return log_pdf - 0.5 * (df + d) * jnp.log1p(maha / df)
