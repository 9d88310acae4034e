"""Pin the f32 matmul-precision discipline on the statistical paths.

An unpinned f32 matmul may run in reduced precision on an accelerator (TF32
on the GPU, about three decimal digits); reduced precision measurably
shifted the full-rank families' converged optima (robust-regression
full-rank t(100): d2 6.0e-4 -> 3.1e-3; benchmarks/KHAT_NOISE.md).  The fix
pins ``precision=HIGHEST`` on every statistically load-bearing product.
These tests assert the pins at the jaxpr level so a refactor that silently
drops one fails here rather than as a puzzling accelerator-only statistics
drift; `chip_smoke.py` checks the resulting float32 accuracy on the GPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viabel_tpu import (full_rank_gaussian_variational_family,
                        t_variational_family)
from viabel_tpu.bounds import central_moments
from viabel_tpu.distributions import mvn_logpdf_chol, mvt_logpdf_chol
from viabel_tpu.models import linear_regression_model, robust_regression_model
from viabel_tpu.psis import weighted_moments

HI = jax.lax.Precision.HIGHEST


def _dot_precisions(fn, *args):
    """All dot_general precision configs in fn's jaxpr (recursing into
    inner jitted calls)."""
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == 'dot_general':
                out.append(eqn.params.get('precision'))
            for v in eqn.params.values():
                if hasattr(v, 'jaxpr'):
                    walk(v.jaxpr)
    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


def _assert_all_highest(fn, *args):
    precs = _dot_precisions(fn, *args)
    assert precs, 'expected at least one dot_general'
    assert all(p == (HI, HI) for p in precs), precs


@pytest.mark.parametrize('fam', [
    full_rank_gaussian_variational_family(3),
    t_variational_family(3, 50),
], ids=['full_rank_gaussian', 'full_rank_t'])
def test_full_rank_family_matmuls_pinned(fam):
    vp = fam.init_param()
    draws = fam.base_sample(jax.random.PRNGKey(0), 8)
    _assert_all_highest(fam.transform, vp, draws)
    _assert_all_highest(fam.mean_and_cov, vp)
    _assert_all_highest(lambda p: fam.pth_moment(p, 4), vp)
    _assert_all_highest(fam.log_prob, vp, jnp.ones((8, 3)))


def test_bound_and_psis_covariances_pinned():
    x = jnp.ones((16, 3))
    _assert_all_highest(central_moments, x)
    slw = jnp.zeros(16)
    _assert_all_highest(lambda s, xs: weighted_moments(xs, s), slw, x)


def test_regression_likelihood_pinned():
    import numpy as np
    xd = np.ones((6, 2))
    yd = np.ones(6)
    for model in (robust_regression_model(),
                  linear_regression_model(xd, yd)):
        x = jnp.zeros((4, model.dim))
        _assert_all_highest(model.log_prob, x)


def test_log_density_has_no_triangular_solve_over_samples():
    """The Mahalanobis term is an explicit tiny-inverse + pinned matmul —
    TriangularSolve over the sample axis need not honour precision
    controls (distributions._chol_mahalanobis_and_logdet)."""
    chol = jnp.tril(jnp.ones((3, 3))) + 2 * jnp.eye(3)
    x = jnp.ones((64, 3))

    def prims(fn, *args):
        names = set()

        def walk(jaxpr):
            for eqn in jaxpr.eqns:
                names.add(eqn.primitive.name)
                for v in eqn.params.values():
                    if hasattr(v, 'jaxpr'):
                        walk(v.jaxpr)
        walk(jax.make_jaxpr(fn, static_argnums=(3,))(
            x, jnp.zeros(3), chol, 7.0).jaxpr
            if fn is mvt_logpdf_chol else
            jax.make_jaxpr(fn)(x, jnp.zeros(3), chol).jaxpr)
        return names

    for fn in (mvn_logpdf_chol,):
        names = prims(fn, x, jnp.zeros(3), chol)
        assert 'dot_general' in names
        # the only solve left is the (d, d) inverse, whose operand count
        # is independent of the sample axis — assert by operand shape
        jaxpr = jax.make_jaxpr(fn)(x, jnp.zeros(3), chol).jaxpr

        def solves(jaxpr, acc):
            for eqn in jaxpr.eqns:
                if eqn.primitive.name == 'triangular_solve':
                    acc.append([tuple(v.aval.shape) for v in eqn.invars])
                for v in eqn.params.values():
                    if hasattr(v, 'jaxpr'):
                        solves(v.jaxpr, acc)
            return acc
        for shapes in solves(jaxpr, []):
            assert all(s == (3, 3) for s in shapes), shapes


def test_mahalanobis_inverse_path_matches_dense():
    """The explicit-inverse Mahalanobis path agrees with the dense f64
    computation on a non-trivial factor."""
    rng = np.random.RandomState(0)
    L = np.tril(rng.randn(4, 4) * 0.3) + np.diag(np.exp(rng.randn(4) * 0.5))
    x = rng.randn(32, 4)
    mean = rng.randn(4)
    got = np.asarray(mvn_logpdf_chol(jnp.asarray(x), jnp.asarray(mean),
                                     jnp.asarray(L)))
    Sigma = L @ L.T
    dev = x - mean
    maha = np.einsum('ni,ij,nj->n', dev, np.linalg.inv(Sigma), dev)
    want = -0.5 * (maha + np.linalg.slogdet(Sigma)[1]
                   + 4 * np.log(2 * np.pi))
    np.testing.assert_allclose(got, want, rtol=1e-9)

    got_t = np.asarray(mvt_logpdf_chol(jnp.asarray(x), jnp.asarray(mean),
                                       jnp.asarray(L), 9.0))
    from scipy import special
    lognorm = (special.gammaln(0.5 * (9.0 + 4)) - special.gammaln(0.5 * 9.0)
               - 0.5 * 4 * np.log(np.pi * 9.0)
               - 0.5 * np.linalg.slogdet(Sigma)[1])
    want_t = lognorm - 0.5 * (9.0 + 4) * np.log1p(maha / 9.0)
    np.testing.assert_allclose(got_t, want_t, rtol=1e-9)
