"""Distribution-primitive tests against scipy, including the eigh-based
multivariate-t parity path (reference: viabel/_distributions.py:8-38)."""
import jax
import jax.numpy as jnp
import numpy as np
import scipy.stats as sps

from viabel_tpu.distributions import (diag_normal_logpdf,
                                      diag_student_t_logpdf,
                                      multivariate_t_logpdf, mvn_logpdf_chol,
                                      mvt_logpdf_chol, normal_logpdf,
                                      student_t_logpdf)


def test_normal_logpdf():
    x = np.linspace(-3, 3, 11)
    np.testing.assert_allclose(
        np.asarray(normal_logpdf(jnp.asarray(x), 0.5, 2.0)),
        sps.norm(0.5, 2.0).logpdf(x), rtol=1e-12)


def test_student_t_logpdf():
    x = np.linspace(-4, 4, 9)
    np.testing.assert_allclose(
        np.asarray(student_t_logpdf(jnp.asarray(x), 7.0, -0.5, 1.5)),
        sps.t(7.0, loc=-0.5, scale=1.5).logpdf(x), rtol=1e-10)


def test_diag_densities():
    rng = np.random.RandomState(0)
    x = rng.randn(6, 3)
    mean = np.array([0.1, -0.2, 0.3])
    log_s = np.array([0.0, 0.5, -0.5])
    np.testing.assert_allclose(
        np.asarray(diag_normal_logpdf(jnp.asarray(x), jnp.asarray(mean),
                                      jnp.asarray(log_s))),
        sps.multivariate_normal(mean, np.diag(np.exp(2 * log_s))).logpdf(x),
        rtol=1e-10)
    expected_t = sum(sps.t(9.0, loc=mean[d],
                           scale=np.exp(log_s[d])).logpdf(x[:, d])
                     for d in range(3))
    np.testing.assert_allclose(
        np.asarray(diag_student_t_logpdf(jnp.asarray(x), 9.0,
                                         jnp.asarray(mean),
                                         jnp.asarray(log_s))),
        expected_t, rtol=1e-10)


def _spd(dim, seed):
    rng = np.random.RandomState(seed)
    A = rng.randn(dim, dim)
    return A @ A.T + dim * np.eye(dim)


def test_chol_densities():
    dim = 4
    S = _spd(dim, 1)
    L = np.linalg.cholesky(S)
    mean = np.arange(dim, dtype=float)
    x = np.random.RandomState(2).randn(7, dim)
    np.testing.assert_allclose(
        np.asarray(mvn_logpdf_chol(jnp.asarray(x), jnp.asarray(mean),
                                   jnp.asarray(L))),
        sps.multivariate_normal(mean, S).logpdf(x), rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(mvt_logpdf_chol(jnp.asarray(x), jnp.asarray(mean),
                                   jnp.asarray(L), 11.0)),
        sps.multivariate_t(mean, S, df=11.0).logpdf(x), rtol=1e-10)


def test_chol_densities_ill_conditioned_factor():
    """Bound the accuracy loss of the explicit-triangular-inverse path on a
    badly scaled Cholesky factor (distributions.py replaces the per-sample
    TriangularSolve with inv(L) @ dev for precision control; a factor
    whose diagonal spans 1e-6..1e2 — cond(L) ~ 1e8 — is far outside what a
    variational fit produces).  The oracle is the exact per-sample
    triangular solve in f64 — NOT scipy's density, whose eigh pseudo-inverse
    silently projects out the smallest eigenvalue at cond(S) ~ 1e16 and
    returns a different (wrong) density."""
    import scipy.linalg as sla
    dim = 5
    rng = np.random.RandomState(7)
    L = np.tril(rng.randn(dim, dim), k=-1) * 0.3 + np.diag(
        np.logspace(-6, 2, dim))
    mean = rng.randn(dim)
    # draw x from the distribution itself so the mahalanobis terms are O(d),
    # not astronomically large (a generic x would overflow ANY method)
    x = mean + rng.randn(20, dim) @ L.T
    z = sla.solve_triangular(L, (x - mean).T, lower=True)
    maha = np.sum(z * z, axis=0)
    log_det = 2.0 * np.sum(np.log(np.diag(L)))
    ref = -0.5 * (maha + log_det + dim * np.log(2 * np.pi))
    ours = np.asarray(mvn_logpdf_chol(jnp.asarray(x), jnp.asarray(mean),
                                      jnp.asarray(L)))
    np.testing.assert_allclose(ours, ref, rtol=1e-8)
    from scipy.special import gammaln
    df = 9.0
    ref_t = (gammaln(0.5 * (df + dim)) - gammaln(0.5 * df)
             - 0.5 * dim * np.log(np.pi * df) - 0.5 * log_det
             - 0.5 * (df + dim) * np.log1p(maha / df))
    ours_t = np.asarray(mvt_logpdf_chol(jnp.asarray(x), jnp.asarray(mean),
                                        jnp.asarray(L), df))
    np.testing.assert_allclose(ours_t, ref_t, rtol=1e-8)


def test_multivariate_t_logpdf_parity_path():
    """The eigh/pseudo-inverse entry point matches scipy on full-rank S and
    falls back to the normal when df is infinite (the reference uses
    t_variational_family(k, df=1e6) as a Gaussian that way)."""
    dim = 3
    S = _spd(dim, 3)
    mean = np.array([1.0, -1.0, 0.5])
    x = np.random.RandomState(4).randn(5, dim)
    np.testing.assert_allclose(
        np.asarray(multivariate_t_logpdf(jnp.asarray(x), jnp.asarray(mean),
                                         jnp.asarray(S), 6.0)),
        sps.multivariate_t(mean, S, df=6.0).logpdf(x), rtol=1e-8)
    np.testing.assert_allclose(
        np.asarray(multivariate_t_logpdf(jnp.asarray(x), jnp.asarray(mean),
                                         jnp.asarray(S), jnp.inf)),
        sps.multivariate_normal(mean, S).logpdf(x), rtol=1e-8)


def test_multivariate_t_logpdf_rank_deficient():
    """Rank-deficient scale matrices are tolerated via the pseudo-inverse
    (reference behavior; viabel/_distributions.py:29-31)."""
    S = np.diag([1.0, 2.0, 0.0])
    mean = np.zeros(3)
    x = np.array([[0.5, -0.5, 0.0]])
    out = np.asarray(multivariate_t_logpdf(jnp.asarray(x),
                                           jnp.asarray(mean),
                                           jnp.asarray(S), 8.0))
    assert np.isfinite(out).all()


def test_student_t_sample_distribution():
    """The rejection-free integer-df Student-t sampler
    (distributions.student_t_sample) is
    exact: KS tests against scipy's t CDF pass across df, including the
    odd-df (Gamma(1/2) = z^2/2) branch and the non-integer fallback."""
    from viabel_tpu.distributions import student_t_sample
    for df in [3, 5, 10, 40, 100, 4.5]:
        x = np.asarray(student_t_sample(
            jax.random.PRNGKey(int(df)), df, (120000,), jnp.float64))
        _, p = sps.kstest(x, sps.t(df).cdf)
        assert p > 0.005, 'KS rejected at df={} (p={})'.format(df, p)
        if df > 2.5:
            np.testing.assert_allclose(x.var(), df / (df - 2),
                                       rtol=0.1 if df > 4 else 0.35)


def test_student_t_sample_shapes_and_dtype():
    from viabel_tpu.distributions import student_t_sample
    x = student_t_sample(jax.random.PRNGKey(0), 40, (100, 3), jnp.float32)
    assert x.shape == (100, 3) and x.dtype == jnp.float32
    assert np.all(np.isfinite(np.asarray(x)))


def test_chi2_sample_distribution():
    from viabel_tpu.distributions import chi2_sample
    for df in [1, 2, 5, 40, 101, 6.5]:
        x = np.asarray(chi2_sample(jax.random.PRNGKey(int(df)), df,
                                   (120000,), jnp.float64))
        _, p = sps.kstest(x, sps.chi2(df).cdf)
        assert p > 0.005, 'KS rejected at df={} (p={})'.format(df, p)
        np.testing.assert_allclose(x.mean(), df, rtol=0.05)
