"""Fused single-dispatch pipeline vs the composed multi-call path.

`validated_vi` must reproduce exactly what `adagrad_optimize` +
`get_samples_and_log_weights` + `all_bounds` + `psislw` +
`improve_with_psis`'s weighted moments produce when given the same keys —
the fusion is a dispatch optimization, not a semantic change.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viabel_tpu import (adagrad_optimize, all_bounds, black_box_chivi,
                        black_box_klvi, mean_field_gaussian_variational_family,
                        mean_field_t_variational_family, validated_vi)
from viabel_tpu.models import funnel_model, robust_regression_model
from viabel_tpu.psis import psislw

N_ITERS = 400
N_BOUND = 20000


def _composed(log_density, fam, obj, init, key, n_bound,
              log_norm_bound=None, **opt_kw):
    opt_key, draw_key = jax.random.split(key)
    opt, _, values, log_norms = adagrad_optimize(
        N_ITERS, obj, init, key=opt_key, **opt_kw)
    samples = fam.sample(draw_key, opt, n_bound)
    lw = log_density(samples) - fam.log_prob(opt, samples)
    bounds = all_bounds(np.asarray(lw),
                        q_var=np.asarray(fam.mean_and_cov(opt)[1]),
                        moment_bound_fn=lambda p: float(fam.pth_moment(opt, p)),
                        log_norm_bound=log_norm_bound)
    slw, khat = psislw(lw)
    w = np.exp(np.asarray(slw))
    s = np.asarray(samples)
    psis_mean = w @ s
    c = s - psis_mean[None, :]
    psis_cov = (w[:, None] * c).T @ c
    return dict(opt_param=opt, value_history=values, bounds=bounds,
                khat=float(khat), psis_mean=psis_mean, psis_cov=psis_cov,
                log_weights=lw, smoothed_log_weights=slw)


def test_matches_composed_path_klvi():
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 50)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    key = jax.random.PRNGKey(7)

    out = validated_vi(model.log_prob, fam, init, N_ITERS,
                       objective_and_grad=obj, n_bound_samples=N_BOUND,
                       key=key)
    ref = _composed(model.log_prob, fam, obj, init, key, N_BOUND)

    np.testing.assert_allclose(out['opt_param'], ref['opt_param'],
                               rtol=1e-12)
    np.testing.assert_allclose(out['value_history'], ref['value_history'],
                               rtol=1e-12)
    np.testing.assert_allclose(out['log_weights'], ref['log_weights'],
                               rtol=1e-10)
    np.testing.assert_allclose(out['smoothed_log_weights'],
                               ref['smoothed_log_weights'], rtol=1e-10)
    assert out['khat'] == pytest.approx(ref['khat'], rel=1e-10)
    for k in ('d2', 'W1', 'W2', 'mean_error', 'std_error', 'cov_error',
              'log_norm_bound'):
        assert out['bounds'][k] == pytest.approx(ref['bounds'][k],
                                                 rel=1e-8), k
    np.testing.assert_allclose(out['psis_mean'], ref['psis_mean'],
                               rtol=1e-8)
    np.testing.assert_allclose(out['psis_cov'], ref['psis_cov'],
                               rtol=1e-7, atol=1e-12)


@pytest.mark.slow
def test_matches_composed_path_chivi_with_log_norm_bound():
    model = robust_regression_model()
    fam = mean_field_t_variational_family(model.dim, 40)
    obj = black_box_chivi(2, fam, model.log_prob, 100)
    init = jnp.concatenate([jnp.asarray(model.true_mean, dtype=jnp.float64),
                            jnp.zeros(model.dim, dtype=jnp.float64)])
    key = jax.random.PRNGKey(3)
    elbo = -1.0  # stand-in KLVI ELBO (any fixed bound must thread through)

    out = validated_vi(model.log_prob, fam, init, N_ITERS,
                       objective_and_grad=obj, n_bound_samples=N_BOUND,
                       key=key, log_norm_bound=elbo)
    ref = _composed(model.log_prob, fam, obj, init, key, N_BOUND,
                    log_norm_bound=elbo)

    np.testing.assert_allclose(out['opt_param'], ref['opt_param'],
                               rtol=1e-12)
    assert out['bounds']['log_norm_bound'] == elbo
    assert out['bounds']['d2'] == pytest.approx(ref['bounds']['d2'],
                                                rel=1e-8)
    assert out['khat'] == pytest.approx(ref['khat'], rel=1e-10)


def test_default_objective_converges_and_caches():
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)

    out = validated_vi(model.log_prob, fam, init, 1500, n_mc_samples=50,
                       n_bound_samples=N_BOUND, key=jax.random.PRNGKey(0))
    # converged to the KLVI mean-field solution: centered, with the usual
    # variance underestimate (true log-sigma stdev is 1.35; KLVI mode-seeks)
    q_std = np.sqrt(np.diag(np.asarray(out['q_cov'])))
    assert abs(float(out['q_mean'][0])) < 1.0
    assert 0.3 < q_std[1] < 1.35
    vals = np.asarray(out['value_history'])
    assert vals[-100:].mean() < vals[:100].mean()
    assert out['bounds']['W2'] > 0 and np.isfinite(out['bounds']['d2'])

    # the default-objective factory must be cached: a second call with the
    # same (family, density, n) hits the same objective instance
    from viabel_tpu.pipeline import _default_objective
    assert _default_objective(fam, model.log_prob, 50) is \
        _default_objective(fam, model.log_prob, 50)


@pytest.mark.slow
def test_mesh_path_matches_composed_sharded_path():
    from viabel_tpu.parallel import (make_mesh, psislw_sharded,
                                     sharded_all_bounds,
                                     sharded_psis_moments)
    mesh = make_mesh(axis_names=('sample',), shape=(8,))
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 50)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    key = jax.random.PRNGKey(11)

    out = validated_vi(model.log_prob, fam, init, N_ITERS,
                       objective_and_grad=obj, n_bound_samples=N_BOUND,
                       key=key, mesh=mesh)

    opt_key, draw_key = jax.random.split(key)
    opt, _, _, _ = adagrad_optimize(N_ITERS, obj, init, key=opt_key)
    ref_bounds, lw, samples = sharded_all_bounds(
        model.log_prob, fam, opt, N_BOUND, draw_key, mesh,
        moment_bound_fn=lambda p: float(fam.pth_moment(opt, p)),
        return_log_weights=True, return_samples=True)
    slw, khat = psislw_sharded(lw, mesh)
    psis_mean, psis_cov = sharded_psis_moments(samples, slw, mesh)

    np.testing.assert_allclose(out['opt_param'], opt, rtol=1e-12)
    for k in ('d2', 'W1', 'W2', 'log_norm_bound'):
        assert out['bounds'][k] == pytest.approx(ref_bounds[k],
                                                 rel=1e-8), k
    assert out['khat'] == pytest.approx(float(khat), rel=1e-10)
    np.testing.assert_allclose(out['smoothed_log_weights'], slw,
                               rtol=1e-10)
    np.testing.assert_allclose(out['psis_mean'], psis_mean, rtol=1e-8)
    np.testing.assert_allclose(out['psis_cov'], psis_cov, rtol=1e-7)
    # sharded outputs keep their sharding (nothing gathered to one device)
    assert len(out['log_weights'].sharding.device_set) == 8


def test_multistart_matches_independent_runs():
    from viabel_tpu import validated_vi_multistart
    from viabel_tpu.optimizers import _perturbed_inits
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 50)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    key = jax.random.PRNGKey(21)
    K = 3

    out = validated_vi_multistart(model.log_prob, fam, init, N_ITERS,
                                  n_starts=K, objective_and_grad=obj,
                                  n_bound_samples=N_BOUND, key=key)
    assert out['opt_param'].shape == (K, fam.var_param_dim)
    assert len(out['bounds']) == K and len(out['khat']) == K

    # each start must equal an independent validated_vi run with the same
    # derived (init, key) pair
    perturb_key, run_key = jax.random.split(key)
    inits = _perturbed_inits(init, K, 0.5, perturb_key)
    for k in range(K):
        single = validated_vi(model.log_prob, fam, inits[k], N_ITERS,
                              objective_and_grad=obj,
                              n_bound_samples=N_BOUND,
                              key=jax.random.fold_in(run_key, k))
        np.testing.assert_allclose(out['opt_param'][k],
                                   single['opt_param'], rtol=1e-12)
        assert out['khat'][k] == pytest.approx(single['khat'], rel=1e-10)
        for name in ('d2', 'W2', 'log_norm_bound'):
            assert out['bounds'][k][name] == pytest.approx(
                single['bounds'][name], rel=1e-8), name
    # start 0 is the unperturbed init
    np.testing.assert_array_equal(inits[0], init)
    # best = smallest validated 2-divergence bound
    assert out['best'] == int(np.argmin([b['d2'] for b in out['bounds']]))


@pytest.mark.slow
def test_multistart_mesh_sharded_matches_unsharded():
    """Sharding the start axis over a mesh is a placement decision only —
    GSPMD partitions the vmapped batch without changing any value."""
    from viabel_tpu import validated_vi_multistart
    from viabel_tpu.parallel import make_mesh
    mesh = make_mesh(axis_names=('chain',), shape=(8,))
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    kw = dict(n_starts=8, objective_and_grad=obj, n_bound_samples=4000,
              key=jax.random.PRNGKey(17))
    plain = validated_vi_multistart(model.log_prob, fam, init, 150, **kw)
    sharded = validated_vi_multistart(model.log_prob, fam, init, 150,
                                      mesh=mesh, **kw)
    np.testing.assert_allclose(sharded['opt_param'], plain['opt_param'],
                               rtol=1e-12)
    assert sharded['best'] == plain['best']
    for k in range(8):
        assert sharded['bounds'][k]['d2'] == pytest.approx(
            plain['bounds'][k]['d2'], rel=1e-8, abs=1e-12)


def test_batched_pipelines_accept_sample_named_run_axis():
    """Round-4 review: a 1-axis mesh named 'sample' carrying the run axis
    (axis == sample_axis, the natural call on make_mesh's default sample
    mesh) used to take the 2-D fused path and crash deep in shard_map with
    a DuplicateSpecError; it must fall back to the 1-D placement and match
    the unsharded run."""
    from viabel_tpu import validated_vi_multistart, validated_vi_sweep
    from viabel_tpu.parallel import make_mesh
    mesh = make_mesh(axis_names=('sample',), shape=(8,))
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    kw = dict(objective_and_grad=obj, n_bound_samples=4000,
              key=jax.random.PRNGKey(23))
    plain = validated_vi_multistart(model.log_prob, fam, init, 100,
                                    n_starts=8, **kw)
    placed = validated_vi_multistart(model.log_prob, fam, init, 100,
                                     n_starts=8, mesh=mesh, axis='sample',
                                     **kw)
    np.testing.assert_allclose(placed['opt_param'], plain['opt_param'],
                               rtol=1e-12)
    assert placed['best'] == plain['best']

    lrs = [0.005 * (i + 1) for i in range(8)]
    plain_sw = validated_vi_sweep(model.log_prob, fam, init, 100,
                                  learning_rates=lrs, **kw)
    placed_sw = validated_vi_sweep(model.log_prob, fam, init, 100,
                                   learning_rates=lrs, mesh=mesh,
                                   axis='sample', **kw)
    np.testing.assert_allclose(placed_sw['opt_param'],
                               plain_sw['opt_param'], rtol=1e-12)


def test_multistart_mesh_requires_divisible_starts():
    from viabel_tpu import validated_vi_multistart
    from viabel_tpu.parallel import make_mesh
    mesh = make_mesh(axis_names=('chain',), shape=(8,))
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    with pytest.raises(ValueError, match='divide n_starts'):
        validated_vi_multistart(model.log_prob, fam, init, 50, n_starts=6,
                                mesh=mesh)


def test_multistart_explicit_init_params():
    from viabel_tpu import validated_vi_multistart
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    inits = jnp.stack([jnp.zeros(fam.var_param_dim),
                       jnp.full((fam.var_param_dim,), 0.3)]).astype(
                           jnp.float64)
    out = validated_vi_multistart(model.log_prob, fam, inits[0], 100,
                                  init_params=inits,
                                  objective_and_grad=obj,
                                  n_bound_samples=4000,
                                  key=jax.random.PRNGKey(5))
    assert out['opt_param'].shape == (2, fam.var_param_dim)
    assert out['best'] in (0, 1)


def test_low_df_t_family_uses_empirical_moments():
    """A t family with 2 < df <= 4 has no closed-form 4th moment; the
    pipeline must fall back to empirical central moments (as `all_bounds`
    does with raw samples) instead of crashing at trace time."""
    model = robust_regression_model()
    fam = mean_field_t_variational_family(model.dim, 4)
    obj = black_box_klvi(fam, model.log_prob, 50)
    init = jnp.concatenate([jnp.asarray(model.true_mean, dtype=jnp.float64),
                            jnp.zeros(model.dim, dtype=jnp.float64)])
    key = jax.random.PRNGKey(9)
    out = validated_vi(model.log_prob, fam, init, N_ITERS,
                       objective_and_grad=obj, n_bound_samples=N_BOUND,
                       key=key)
    assert np.isfinite(out['bounds']['W2'])

    # must match composing all_bounds with the same samples' empirical
    # moments
    opt_key, draw_key = jax.random.split(key)
    opt, _, _, _ = adagrad_optimize(N_ITERS, obj, init, key=opt_key)
    samples = fam.sample(draw_key, opt, N_BOUND)
    lw = model.log_prob(samples) - fam.log_prob(opt, samples)
    ref = all_bounds(np.asarray(lw), samples=np.asarray(samples))
    for name in ('d2', 'W1', 'W2'):
        assert out['bounds'][name] == pytest.approx(ref[name],
                                                    rel=1e-8), name

    # sharded path takes the same fallback via psum-reduced moments
    from viabel_tpu.parallel import make_mesh
    mesh = make_mesh(axis_names=('sample',), shape=(8,))
    out_sh = validated_vi(model.log_prob, fam, init, N_ITERS,
                          objective_and_grad=obj, n_bound_samples=N_BOUND,
                          key=key, mesh=mesh)
    assert np.isfinite(out_sh['bounds']['W2'])


def test_model_instance_accepted_as_log_density():
    """Models are NamedTuples holding numpy arrays (unhashable), but are
    natural to pass as the density; the pipeline must unwrap `.log_prob`
    like `get_samples_and_log_weights` does."""
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    out = validated_vi(model, fam, init, 200, n_mc_samples=20,
                       n_bound_samples=5000, key=jax.random.PRNGKey(2))
    ref = validated_vi(model.log_prob, fam, init, 200, n_mc_samples=20,
                       n_bound_samples=5000, key=jax.random.PRNGKey(2))
    np.testing.assert_array_equal(out['opt_param'], ref['opt_param'])


@pytest.mark.parametrize('family_name', ['mf_gaussian', 'mf_t',
                                         'full_rank_gaussian',
                                         'full_rank_t'])
def test_pipeline_all_families(family_name):
    """The fused pipeline supports every shipped family (incl. the
    Cholesky-parameterized full-rank ones)."""
    from viabel_tpu import (full_rank_gaussian_variational_family,
                            t_variational_family)
    model = funnel_model()
    fam = dict(
        mf_gaussian=lambda: mean_field_gaussian_variational_family(2),
        mf_t=lambda: mean_field_t_variational_family(2, 40),
        full_rank_gaussian=lambda: full_rank_gaussian_variational_family(2),
        full_rank_t=lambda: t_variational_family(2, 40),
    )[family_name]()
    init = fam.init_param(jnp.float64)
    out = validated_vi(model.log_prob, fam, init, 300, n_mc_samples=20,
                       n_bound_samples=5000, key=jax.random.PRNGKey(4))
    assert np.isfinite(out['bounds']['d2'])
    assert np.isfinite(out['khat']) or out['khat'] == np.inf
    assert out['psis_mean'].shape == (2,)


@pytest.mark.slow
def test_sweep_matches_per_rate_runs():
    """The learning-rate sweep must reproduce independent validated_vi
    runs at each rate with the same key (common random numbers)."""
    from viabel_tpu import validated_vi_sweep
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    key = jax.random.PRNGKey(31)
    lrs = [0.003, 0.01, 0.05]

    out = validated_vi_sweep(model.log_prob, fam, init, 300,
                             learning_rates=lrs, objective_and_grad=obj,
                             n_bound_samples=5000, key=key)
    assert out['opt_param'].shape == (3, fam.var_param_dim)
    for i, lr in enumerate(lrs):
        single = validated_vi(model.log_prob, fam, init, 300,
                              objective_and_grad=obj, n_bound_samples=5000,
                              key=key, learning_rate=lr)
        np.testing.assert_allclose(out['opt_param'][i],
                                   single['opt_param'], rtol=1e-12)
        assert out['bounds'][i]['d2'] == pytest.approx(
            single['bounds']['d2'], rel=1e-8)
    assert out['best'] == int(np.argmin([b['d2'] for b in out['bounds']]))
    np.testing.assert_array_equal(out['learning_rates'], lrs)

    # decaying schedules sweep too
    out2 = validated_vi_sweep(model.log_prob, fam, init, 300,
                              learning_rates=lrs,
                              learning_rate_ends=[lr / 10 for lr in lrs],
                              objective_and_grad=obj, n_bound_samples=5000,
                              key=key)
    single2 = validated_vi(model.log_prob, fam, init, 300,
                           objective_and_grad=obj, n_bound_samples=5000,
                           key=key, learning_rate=0.01,
                           learning_rate_end=0.001)
    np.testing.assert_allclose(out2['opt_param'][1], single2['opt_param'],
                               rtol=1e-10)


def test_sweep_validates_inputs():
    from viabel_tpu import validated_vi_sweep
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    with pytest.raises(ValueError, match='positive'):
        validated_vi_sweep(model.log_prob, fam, init, 100,
                           learning_rates=[0.01, -0.1])
    with pytest.raises(ValueError, match='end rate'):
        validated_vi_sweep(model.log_prob, fam, init, 100,
                           learning_rates=[0.01], learning_rate_ends=[0.02])
    # end rates <= 0 freeze or sign-flip the schedule — rejected too
    with pytest.raises(ValueError, match='end rate'):
        validated_vi_sweep(model.log_prob, fam, init, 100,
                           learning_rates=[0.01], learning_rate_ends=[0.0])
    with pytest.raises(ValueError, match='match'):
        validated_vi_sweep(model.log_prob, fam, init, 100,
                           learning_rates=[0.01, 0.02],
                           learning_rate_ends=[0.001])


def test_diverged_start_degrades_to_inf_bounds():
    """A non-finite pack (diverged optimizer start) must yield inf bounds,
    not an SVD crash, and must never be selected as `best`
    (regression: numpy's spectral norm raises LinAlgError on nan/inf)."""
    from viabel_tpu.pipeline import _assemble_bounds
    d = 3
    bad = np.full(8 + d * d, np.nan)
    b, khat, diverged = _assemble_bounds(bad, 1000, d, 2.0, None)
    assert diverged
    assert b['d2'] == np.inf
    assert b['W2'] == np.inf and b['cov_error'] == np.inf
    assert np.isnan(khat)

    # finite stats but non-finite covariance: bounds from stats survive,
    # cov_error degrades
    pack = np.concatenate([np.array([0.0, 1.0, 0.1, -1.0, 0.5, 4.0, 48.0,
                                     0.6]), np.full(d * d, np.inf)])
    b2, _, diverged2 = _assemble_bounds(pack, 1000, d, 2.0, None)
    assert not diverged2  # finite stats: a degraded covariance is not divergence
    assert np.isfinite(b2['d2']) and np.isfinite(b2['W2'])
    assert b2['cov_error'] == np.inf


def test_alpha_not_2_reports_dalpha_only():
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    out = validated_vi(model.log_prob, fam, init, 200, n_mc_samples=50,
                       n_bound_samples=5000, alpha=3.0,
                       key=jax.random.PRNGKey(1))
    assert 'dalpha' in out['bounds'] and 'W2' not in out['bounds']


def test_multistart_2d_mesh_both_axes_active():
    """A (chain, sample) mesh runs BOTH parallelism axes in one fused
    program: starts partition over `chain` and every start's bound/PSIS
    stage shards over `sample`.  Optimizer trajectories
    are identical to the unsharded multistart (same keys); the bound stage
    uses per-device draw keys, so its statistics agree within MC noise."""
    from viabel_tpu import validated_vi_multistart
    from viabel_tpu.parallel import make_mesh
    mesh = make_mesh(axis_names=('chain', 'sample'), shape=(2, 4))
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    # small perturbations: every start converges, so the bound statistics
    # concentrate and MC-level agreement between draw schemes is checkable
    kw = dict(n_starts=4, perturb_scale=0.05, objective_and_grad=obj,
              n_bound_samples=80000, key=jax.random.PRNGKey(31))
    plain = validated_vi_multistart(model.log_prob, fam, init, 300, **kw)
    both = validated_vi_multistart(model.log_prob, fam, init, 300,
                                   mesh=mesh, **kw)

    # the global log-weight array is partitioned over BOTH mesh axes
    spec = both['log_weights'].sharding.spec
    assert tuple(spec) == ('chain', 'sample'), spec
    assert len(both['log_weights'].sharding.device_set) == 8
    assert both['log_weights'].shape == (4, 80000)

    # identical optimizer keys -> identical trajectories
    np.testing.assert_allclose(both['opt_param'], plain['opt_param'],
                               rtol=1e-10)
    np.testing.assert_allclose(both['value_history'],
                               plain['value_history'], rtol=1e-10)
    # bound stage: same distribution, different draws -> MC-level agreement
    # on the concentrated statistics (d2/W2 are tail-dominated and can
    # swing by factors between draws on badly-perturbed starts; only their
    # finiteness is asserted)
    for k in range(4):
        assert np.isfinite(both['bounds'][k]['d2'])
        assert both['bounds'][k]['log_norm_bound'] == pytest.approx(
            plain['bounds'][k]['log_norm_bound'], rel=0.05, abs=0.05)
        assert both['khat'][k] == pytest.approx(plain['khat'][k], abs=0.2)
    # PSIS-corrected moments are high-variance at the funnel's khat ~ 0.77
    # (heavy importance weights): assert finite + loose MC agreement
    assert np.all(np.isfinite(np.asarray(both['psis_mean'])))
    np.testing.assert_allclose(both['psis_mean'], plain['psis_mean'],
                               atol=0.4)

    # sample_axis=None forces the start-axis-only placement (exact match
    # with the unsharded run, as before)
    only_chain = validated_vi_multistart(model.log_prob, fam, init, 300,
                                         mesh=mesh, sample_axis=None, **kw)
    np.testing.assert_allclose(only_chain['opt_param'], plain['opt_param'],
                               rtol=1e-12)
    for k in range(4):
        assert only_chain['bounds'][k]['d2'] == pytest.approx(
            plain['bounds'][k]['d2'], rel=1e-8, abs=1e-12)


def test_sweep_mesh_1d_chain_matches_unsharded():
    """Sharding the sweep's rate axis over a chain mesh is a placement
    decision only — GSPMD partitions the vmapped batch without changing
    any value (the sweep counterpart of the multistart mesh path)."""
    from viabel_tpu import validated_vi_sweep
    from viabel_tpu.parallel import make_mesh
    mesh = make_mesh(axis_names=('chain',), shape=(8,))
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    lrs = [0.002, 0.005, 0.01, 0.02, 0.03, 0.05, 0.08, 0.1]
    kw = dict(learning_rates=lrs, objective_and_grad=obj,
              n_bound_samples=4000, key=jax.random.PRNGKey(23))
    plain = validated_vi_sweep(model.log_prob, fam, init, 150, **kw)
    sharded = validated_vi_sweep(model.log_prob, fam, init, 150, mesh=mesh,
                                 **kw)
    np.testing.assert_allclose(sharded['opt_param'], plain['opt_param'],
                               rtol=1e-12)
    assert sharded['best'] == plain['best']
    for k in range(8):
        assert sharded['bounds'][k]['d2'] == pytest.approx(
            plain['bounds'][k]['d2'], rel=1e-8, abs=1e-12)


def test_sweep_2d_mesh_both_axes_active():
    """A (chain, sample) mesh runs the sweep's BOTH parallelism axes in one
    fused program: rates partition over `chain` and every rate's bound/PSIS
    stage shards over `sample`.  Optimizer trajectories
    are identical to the unsharded sweep (common random numbers); the bound
    stage uses per-device draw keys, so its statistics agree at MC level."""
    from viabel_tpu import validated_vi_sweep
    from viabel_tpu.parallel import make_mesh
    mesh = make_mesh(axis_names=('chain', 'sample'), shape=(2, 4))
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    lrs = [0.005, 0.01, 0.03, 0.05]
    kw = dict(learning_rates=lrs, objective_and_grad=obj,
              n_bound_samples=80000, key=jax.random.PRNGKey(29))
    plain = validated_vi_sweep(model.log_prob, fam, init, 300, **kw)
    both = validated_vi_sweep(model.log_prob, fam, init, 300, mesh=mesh,
                              **kw)

    # the global log-weight array is partitioned over BOTH mesh axes
    spec = both['log_weights'].sharding.spec
    assert tuple(spec) == ('chain', 'sample'), spec
    assert len(both['log_weights'].sharding.device_set) == 8
    assert both['log_weights'].shape == (4, 80000)

    np.testing.assert_allclose(both['opt_param'], plain['opt_param'],
                               rtol=1e-10)
    np.testing.assert_allclose(both['value_history'],
                               plain['value_history'], rtol=1e-10)
    for k in range(4):
        assert np.isfinite(both['bounds'][k]['d2'])
        assert both['bounds'][k]['log_norm_bound'] == pytest.approx(
            plain['bounds'][k]['log_norm_bound'], rel=0.05, abs=0.05)
        assert both['khat'][k] == pytest.approx(plain['khat'][k], abs=0.2)
    np.testing.assert_array_equal(both['learning_rates'], lrs)

    # per-rate schedule endpoints shard the same way
    ends = [lr / 10 for lr in lrs]
    with_ends = validated_vi_sweep(model.log_prob, fam, init, 300,
                                   learning_rate_ends=ends, mesh=mesh, **kw)
    plain_ends = validated_vi_sweep(model.log_prob, fam, init, 300,
                                    learning_rate_ends=ends, **kw)
    np.testing.assert_allclose(with_ends['opt_param'],
                               plain_ends['opt_param'], rtol=1e-10)

    # sample_axis=None forces the rate-axis-only placement (exact match)
    only_chain = validated_vi_sweep(model.log_prob, fam, init, 300,
                                    mesh=mesh, sample_axis=None, **kw)
    np.testing.assert_allclose(only_chain['opt_param'], plain['opt_param'],
                               rtol=1e-12)


def test_sweep_mesh_validates_divisibility():
    from viabel_tpu import validated_vi_sweep
    from viabel_tpu.parallel import make_mesh
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    mesh = make_mesh(axis_names=('chain',), shape=(8,))
    with pytest.raises(ValueError, match='number of learning rates'):
        validated_vi_sweep(model.log_prob, fam, init, 50,
                           learning_rates=[0.01, 0.02, 0.03], mesh=mesh)
    mesh2 = make_mesh(axis_names=('chain', 'sample'), shape=(2, 4))
    with pytest.raises(ValueError, match='divide n_bound_samples'):
        validated_vi_sweep(model.log_prob, fam, init, 50,
                           learning_rates=[0.01, 0.02],
                           n_bound_samples=1001, mesh=mesh2)


def test_multistart_2d_mesh_validates_bound_divisibility():
    from viabel_tpu import validated_vi_multistart
    from viabel_tpu.parallel import make_mesh
    mesh = make_mesh(axis_names=('chain', 'sample'), shape=(2, 4))
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    with pytest.raises(ValueError, match='divide n_bound_samples'):
        validated_vi_multistart(model.log_prob, fam, init, 50, n_starts=2,
                                n_bound_samples=1001, mesh=mesh)


def test_multistart_2d_mesh_accepts_typed_keys():
    """Review finding: the 2-D fused path hardcoded rank-2 key in_specs
    and crashed on new-style typed PRNG keys, which the 1-D path
    supports.  Both key flavors must run and agree."""
    from viabel_tpu import validated_vi_multistart
    from viabel_tpu.parallel import make_mesh
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    obj = black_box_klvi(fam, model.log_prob, 10, presampled=True)
    init = fam.init_param()
    mesh = make_mesh(axis_names=('chain', 'sample'), shape=(2, 4))
    kw = dict(n_starts=4, objective_and_grad=obj, n_bound_samples=8000,
              mesh=mesh)
    typed = validated_vi_multistart(model.log_prob, fam, init, 40,
                                    key=jax.random.key(5), **kw)
    raw = validated_vi_multistart(model.log_prob, fam, init, 40,
                                  key=jax.random.PRNGKey(5), **kw)
    np.testing.assert_allclose(np.asarray(typed['opt_param']),
                               np.asarray(raw['opt_param']), rtol=1e-12)
    assert np.isfinite(typed['khat']).all()


def test_diverged_run_warns():
    """A run whose fit goes non-finite must announce itself loudly
    (DivergedRunWarning) while still returning vacuous (inf/nan) results
    instead of raising — the failure-detection contract for the
    single-run path (the CHIVI-at-large-d mode measured in
    benchmarks/DIM_SCALING.md)."""
    import warnings

    from viabel_tpu.pipeline import DivergedRunWarning
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    init = jnp.zeros(4, dtype=jnp.float64)
    with pytest.warns(DivergedRunWarning, match='diverged'):
        out = validated_vi(model.log_prob, fam, init, 200,
                           key=jax.random.PRNGKey(0), n_bound_samples=4000,
                           learning_rate=1e18)  # guaranteed blow-up
    assert not np.isfinite(out['khat'])
    assert not np.isfinite(out['bounds']['d2'])


def test_multistart_all_diverged_warns_once():
    """Individual perturbed starts may diverge silently (that is what the
    perturbation probes); the batch warns only when EVERY start diverged
    — then `best` is arbitrary and the configuration is broken."""
    import warnings

    from viabel_tpu import validated_vi_multistart
    from viabel_tpu.pipeline import DivergedRunWarning
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    init = jnp.zeros(4, dtype=jnp.float64)
    with pytest.warns(DivergedRunWarning, match='every run'):
        out = validated_vi_multistart(
            model.log_prob, fam, init, 200, n_starts=2,
            key=jax.random.PRNGKey(0), n_bound_samples=4000,
            learning_rate=1e18)
    assert all(not np.isfinite(k) for k in out['khat'])
    # a healthy batch must NOT warn
    with warnings.catch_warnings():
        warnings.simplefilter('error', DivergedRunWarning)
        validated_vi_multistart(model.log_prob, fam, init, 200, n_starts=2,
                                key=jax.random.PRNGKey(0),
                                n_bound_samples=4000, learning_rate=.05)


def test_short_tail_khat_inf_does_not_warn_diverged():
    """khat = +inf is a legitimate short-tail outcome (tiny
    n_bound_samples leaves < 5 above-cutoff weights) on a perfectly
    healthy run — it must NOT trigger DivergedRunWarning, whose signature
    is NaN from non-finite log-weights (round-5 review)."""
    import warnings

    from viabel_tpu.pipeline import DivergedRunWarning
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    init = jnp.zeros(4, dtype=jnp.float64)
    with warnings.catch_warnings():
        warnings.simplefilter('error', DivergedRunWarning)
        out = validated_vi(model.log_prob, fam, init, 100,
                           key=jax.random.PRNGKey(0),
                           n_bound_samples=16, learning_rate=.05)
    assert np.isinf(out['khat'])  # short tail -> inf, and no warning
