"""PSIS tests against reference-implementation oracle values.

Expected numbers were computed once with the reference numpy implementation
(reference: notebooks/psis.py:112-199) on deterministic JAX-generated
log-weight draws, covering the smoothing path (khat in the smoothing range),
the heavy-tail warning range (khat > 0.7), and the no-smoothing path
(khat < 1/3).  Additional tests check khat recovery on synthetic
Pareto-tailed weights and self-normalization invariants.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viabel_tpu.psis import gpinv, psislw, psisloo, sumlogs


def _make_lw(seed, n, dist):
    key = jax.random.PRNGKey(seed)
    if dist == 'lognormal':
        return 1.5 * jax.random.normal(key, (n,), dtype=jnp.float64)
    if dist == 'frechet':
        u = jax.random.uniform(key, (n,), dtype=jnp.float64,
                               minval=1e-12, maxval=1 - 1e-12)
        return 0.7 * -jnp.log(-jnp.log(u))
    return 0.3 * jax.random.normal(key, (n,), dtype=jnp.float64)


# (seed, n, dist) -> (khat, smoothed[:5], max)
_ORACLE = {
    (0, 4000, 'lognormal'): (
        0.4299937356,
        [-9.6887458295, -10.557131285, -6.6379478972, -9.098216601,
         -9.2586807988],
        -4.005192692353574),
    (1, 20000, 'frechet'): (
        0.7275445881,
        [-11.4956290904, -10.7996031521, -10.564370621, -9.7846731721,
         -11.2922764043],
        -3.4379327095319687),
    (2, 4000, 'normal'): (
        0.0715072742,
        [-8.4042726679, -8.6597956256, -8.2182335103, -8.3933135769,
         -8.5567221765],
        -7.1385720164705075),
}


@pytest.mark.parametrize('case', list(_ORACLE))
def test_psislw_matches_reference(case):
    seed, n, dist = case
    lw = _make_lw(seed, n, dist)
    smoothed, khat = psislw(lw)
    exp_k, exp_head, exp_max = _ORACLE[case]
    np.testing.assert_allclose(float(khat), exp_k, rtol=1e-8)
    np.testing.assert_allclose(np.asarray(smoothed)[:5], exp_head, rtol=1e-8)
    np.testing.assert_allclose(float(jnp.max(smoothed)), exp_max, rtol=1e-8)
    # self-normalized
    np.testing.assert_allclose(float(jnp.sum(jnp.exp(smoothed))), 1.0,
                               rtol=1e-10)


def test_psislw_2d_columns():
    lw1 = _make_lw(0, 4000, 'lognormal')
    lw2 = _make_lw(2, 4000, 'normal')
    lw = jnp.stack([lw1, lw2], axis=1)
    smoothed, ks = psislw(lw)
    assert smoothed.shape == (4000, 2)
    assert ks.shape == (2,)
    s1, k1 = psislw(lw1)
    np.testing.assert_allclose(np.asarray(smoothed[:, 0]), np.asarray(s1),
                               rtol=1e-12)
    np.testing.assert_allclose(float(ks[0]), float(k1), rtol=1e-12)


def test_psislw_khat_recovery_on_pareto_tail():
    """Weights with a generalized-Pareto right tail of known index k are
    recovered within estimation error."""
    k_true = 0.5
    n = 50000
    key = jax.random.PRNGKey(42)
    u = jax.random.uniform(key, (n,), dtype=jnp.float64,
                           minval=1e-12, maxval=1 - 1e-12)
    # inverse-CDF GPD sample, log scale
    w = (jnp.power(1 - u, -k_true) - 1) / k_true
    lw = jnp.log1p(w)
    _, khat = psislw(lw)
    assert 0.3 < float(khat) < 0.7


def test_psislw_reff_matches_reference():
    """Reff changes the tail size ceil(min(0.2n, 3 sqrt(n/Reff)));
    oracle values from the reference implementation on the same draw."""
    lw = 1.5 * jax.random.normal(jax.random.PRNGKey(5), (8000,),
                                 dtype=jnp.float64)
    expected = {1.0: (0.3699929953, -9.58152421),
                0.5: (0.4579705594, -9.58406726),
                0.1: (0.5590226430, -9.59167073)}
    for reff, (exp_k, exp_head) in expected.items():
        smoothed, khat = psislw(lw, Reff=reff)
        np.testing.assert_allclose(float(khat), exp_k, rtol=1e-8)
        np.testing.assert_allclose(float(smoothed[0]), exp_head, rtol=1e-8)


def test_psislw_short_tail_returns_inf():
    """Too few tail samples => khat = inf, no smoothing
    (reference: notebooks/psis.py:177-180)."""
    lw = jnp.asarray(np.concatenate([np.zeros(30), [5.0]]))
    smoothed, khat = psislw(lw)
    assert np.isinf(float(khat))
    # renormalized but otherwise unchanged ordering
    assert float(jnp.argmax(smoothed)) == 30


def test_psislw_validates_input():
    with pytest.raises(ValueError):
        psislw(jnp.zeros((2, 2, 2)))
    with pytest.raises(ValueError):
        psislw(jnp.zeros(1))


def test_gpinv_basic():
    p = jnp.asarray(np.linspace(0.01, 0.99, 50))
    # k -> 0 reduces to exponential quantiles
    np.testing.assert_allclose(np.asarray(gpinv(p, 0.0, 1.0)),
                               -np.log1p(-np.asarray(p)), rtol=1e-10)
    # k = 0.5, sigma = 2: x = sigma*((1-p)^-k - 1)/k
    k, s = 0.5, 2.0
    expected = s * (np.power(1 - np.asarray(p), -k) - 1) / k
    np.testing.assert_allclose(np.asarray(gpinv(p, k, s)), expected,
                               rtol=1e-10)


def test_sumlogs():
    x = jnp.asarray([1000.0, 1000.0])
    np.testing.assert_allclose(float(sumlogs(x)), 1000.0 + np.log(2.0))


def test_psisloo_matches_reference():
    """Value oracle: the reference psisloo (notebooks/psis.py:68-109) run
    once on this exact deterministic log-lik matrix produced these
    outputs; ours must agree to float precision."""
    key = jax.random.PRNGKey(3)
    log_lik = -0.5 * jax.random.normal(key, (2000, 5), dtype=jnp.float64) ** 2
    loo, loos, ks = psisloo(log_lik)
    assert loos.shape == (5,)
    assert ks.shape == (5,)
    np.testing.assert_allclose(float(jnp.sum(loos)), loo, rtol=1e-10)
    np.testing.assert_allclose(float(loo), -5.358254803347489, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(loos),
        [-1.02782436, -1.24493741, -1.14638693, -0.91675027, -1.02235584],
        atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(ks),
        [0.77351414, 0.82808595, 0.98846316, 0.65742325, 0.69506118],
        atol=1e-7)


def _tied_f32_log_weights(n=4096, n_cut_ties=3, n_tail_ties=4, seed=7):
    """Heavy-tailed f32 log-weights with exact ties at and above the PSIS
    tail cutoff (pins the documented f32 tie semantics; psis.py:146-148)."""
    from viabel_tpu.psis import _tail_len
    rs = np.random.RandomState(seed)
    # Pareto(1.5) weights -> khat ~ 2/3: the smoothing branch is taken
    lw = np.log(rs.pareto(1.5, size=n) + 1.0).astype(np.float32)
    tail_len = _tail_len(n, 1.0)
    order = np.argsort(lw)
    cut_val = lw[order[n - tail_len - 1]]  # the cutoff element
    # exact f32 ties AT the cutoff (straddling the boundary) ...
    lw[order[n - tail_len - 1 - n_cut_ties // 2:
             n - tail_len - 1 + (n_cut_ties + 1) // 2]] = cut_val
    # ... and a tied group strictly INSIDE the tail
    mid = order[n - tail_len // 2]
    lw[order[n - tail_len // 2: n - tail_len // 2 + n_tail_ties]] = lw[mid]
    return jnp.asarray(lw), tail_len


def test_psislw_f32_ties_invariants():
    """f32 ties at the tail boundary keep every PSIS invariant: exact
    normalization, a finite khat, and smoothed values monotone in the raw
    weight (tied raw values may receive different but adjacent quantiles —
    the documented 'equally valid tie order'; psis.py:146-148)."""
    from viabel_tpu.psis import _psislw_1d, psislw
    lw, tail_len = _tied_f32_log_weights()
    out, khat = psislw(lw)
    out = np.asarray(out)
    assert out.dtype == np.float32
    assert np.isfinite(float(khat)) and float(khat) > 1 / 3
    # self-normalized
    from scipy.special import logsumexp
    assert abs(logsumexp(out.astype(np.float64))) < 1e-5
    # monotone: sorting by raw weight sorts the smoothed weights too
    # (within a tie group the assignment order is arbitrary, but values of
    # equal raw weight get adjacent quantiles, so sorting by (raw, out)
    # must leave out non-decreasing)
    order = np.lexsort((out, np.asarray(lw)))
    assert np.all(np.diff(out[order]) >= -1e-7)
    # truncation at the max raw weight (0 after max-rescaling), i.e. no
    # smoothed weight exceeds the largest raw weight
    assert np.all(out <= 1e-6)


@pytest.mark.slow
def test_psislw_sharded_f32_ties_match_unsharded():
    """Sharded PSIS on tied f32 input: khat identical to unsharded (the
    tail multiset is the same), normalization exact, tied raw values get
    the SAME smoothed quantile (sharded_psis.py:18-21's documented
    semantics), and untied positions match the unsharded output."""
    from viabel_tpu.parallel import make_mesh, psislw_sharded
    from viabel_tpu.psis import psislw
    from scipy.special import logsumexp

    lw, tail_len = _tied_f32_log_weights()
    mesh = make_mesh(axis_names=('sample',), shape=(8,))
    out_s, khat_s = psislw_sharded(lw, mesh)
    out_u, khat_u = psislw(lw)
    out_s, out_u = np.asarray(out_s), np.asarray(out_u)
    lw_np = np.asarray(lw)

    # identical tail multiset -> identical GPD fit -> identical khat
    np.testing.assert_allclose(float(khat_s), float(khat_u), rtol=1e-6)
    assert abs(logsumexp(out_s.astype(np.float64))) < 1e-5

    # tied raw values receive one shared smoothed value in the sharded path
    vals, counts = np.unique(lw_np, return_counts=True)
    for v in vals[counts > 1]:
        tied_out = out_s[lw_np == v]
        assert np.all(tied_out == tied_out[0]), \
            'tied raw weights must share a smoothed quantile'

    # away from tie groups the two implementations agree exactly up to a
    # constant shift: the in-tail tie group's quantile assignment (shared
    # lowest vs distinct adjacent) perturbs only the normalization constant,
    # which moves every entry by the same amount
    untied = np.isin(lw_np, vals[counts == 1])
    ds = out_s[untied].astype(np.float64)
    du = out_u[untied].astype(np.float64)
    shift = np.median(ds - du)
    assert abs(shift) < 1e-3  # the normalizer perturbation itself is tiny
    np.testing.assert_allclose(ds - shift, du, atol=1e-5)


@pytest.mark.slow
def test_ess_reff_closes_the_psis_loop():
    """End-to-end ESS -> Reff -> PSIS wiring: MCMC
    draws from `viabel_tpu.mcmc` give ``Reff = effective_sample_size /
    (n_chains * n_iters)``, which feeds `psisloo`'s tail sizing
    (reference: notebooks/psis.py:112-155, the Reff parameter's purpose).
    """
    from viabel_tpu.diagnostics import effective_sample_size
    from viabel_tpu.mcmc import hmc_sample
    from viabel_tpu.models import (data_generator_linear,
                                   linear_regression_model)
    from viabel_tpu.psis import _tail_len, psisloo

    data = data_generator_linear(30, 2, rho=0.3, seed=1)
    model = linear_regression_model(data['X'], data['Y'])
    # single-leapfrog HMC: deliberately autocorrelated chains, so the ESS
    # correction is material (Reff ~ 0.33, not ~1)
    out = hmc_sample(model.log_prob, np.zeros(model.dim),
                     key=jax.random.PRNGKey(0), n_samples=1000,
                     n_warmup=400, n_chains=4, max_steps=1, eps0=0.02)
    chains = np.asarray(out['samples'])          # (4, 1000, d)
    assert np.all(np.asarray(out['r_hat']) < 1.05)

    ess = np.asarray(effective_sample_size(chains))
    n_total = chains.shape[0] * chains.shape[1]
    Reff = float(ess.min()) / n_total
    assert 0.1 < Reff < 0.6, Reff  # autocorrelated but mixing

    # pointwise log-likelihood of each observation under each draw
    draws = chains.reshape(n_total, -1)
    X, Y = np.asarray(data['X']), np.asarray(data['Y'])
    mu = draws @ X.T
    s = 0.5  # the model's fixed noise scale
    log_lik = -0.5 * ((Y[None] - mu) / s) ** 2 \
        - np.log(s) - 0.5 * np.log(2 * np.pi)

    loo1, _, ks1 = psisloo(jnp.asarray(log_lik))
    loo2, _, ks2 = psisloo(jnp.asarray(log_lik), Reff=Reff)
    ks1, ks2 = np.asarray(ks1), np.asarray(ks2)

    # Reff < 1 enlarges the fitted tail: min(0.2 n, 3 sqrt(n / Reff))
    assert _tail_len(n_total, Reff) > _tail_len(n_total, 1.0)
    # and the tail fits actually change
    assert not np.allclose(ks1, ks2)
    # expected direction for these light-tailed LOO weights: the enlarged
    # tail reaches into the (faster-decaying) body, flattening the fitted
    # GPD shape — khat drops on average.  (Heavy-tailed weights shift the
    # other way; see test_psislw_reff_matches_reference's oracle.)
    assert np.mean(ks2 - ks1) < 0
    # LOO values are finite and in the same ballpark under both tails
    assert np.isfinite(loo1) and np.isfinite(loo2)
    assert abs(loo1 - loo2) < 0.5


def test_psisloo_1d_input():
    """1-D log_lik (a single observation column) must work: psislw
    documents 1-D support and the packed-fetch rewrite briefly broke it
    (0-d loos cannot concatenate with the (1,) total; round-5 review)."""
    ll = jnp.asarray(np.linspace(-2.0, -1.0, 200))
    loo, loos, ks = psisloo(ll)
    assert np.isfinite(loo)
    assert np.shape(loos) == ()
    assert np.shape(ks) == ()
    # matches the 2-D single-column path
    loo2, loos2, ks2 = psisloo(ll[:, None])
    assert np.allclose(loo, loo2)
    assert np.allclose(float(loos), loos2[0])
