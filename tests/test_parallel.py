"""Mesh-sharding tests on the virtual 8-device CPU mesh.

Every sharded estimator must agree with its single-device counterpart
(which in turn is oracle-tested); chain sharding must reproduce the vmapped
optimizer's trajectories exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viabel_tpu import (all_bounds, black_box_klvi,
                        mean_field_gaussian_variational_family,
                        rmsprop_IA_optimize_with_rhat)
from viabel_tpu.bounds import log_weight_stats
from viabel_tpu.models import funnel_model
from viabel_tpu.parallel import (make_mesh, psislw_sharded, shard_over,
                                 sharded_all_bounds, sharded_log_weight_stats,
                                 sharded_psis_moments, sharded_sample_stats)
from viabel_tpu.psis import psislw


@pytest.fixture(scope='module')
def mesh():
    assert len(jax.devices()) == 8, 'tests expect 8 virtual CPU devices'
    return make_mesh(axis_names=('sample',), shape=(8,))


@pytest.fixture(scope='module')
def chain_mesh():
    return make_mesh(axis_names=('chain', 'sample'), shape=(4, 2))


def test_sharded_log_weight_stats_matches_local(mesh):
    lw = 1.5 * jax.random.normal(jax.random.PRNGKey(0), (80000,),
                                 dtype=jnp.float64)
    lw_sharded = shard_over(lw, mesh, 'sample')
    s_sharded = sharded_log_weight_stats(lw_sharded, mesh)
    s_local = log_weight_stats(lw)
    for k in ['log_rescale', 'mean_rescaled_alpha', 'std_rescaled_alpha',
              'mean_lw', 'std_lw']:
        np.testing.assert_allclose(float(s_sharded[k]), float(s_local[k]),
                                   rtol=1e-12, err_msg=k)


def test_sharded_log_weight_stats_2d_matches_raveled(mesh):
    """Round-4 review: a (n, m) input's local reductions run over every
    element but `n` used ``shape[0]``, silently scaling every statistic by
    m.  A multi-dimensional input must match the unsharded counterpart's
    ravel semantics."""
    lw = 1.5 * jax.random.normal(jax.random.PRNGKey(7), (8000, 3),
                                 dtype=jnp.float64)
    s_sharded = sharded_log_weight_stats(shard_over(lw, mesh, 'sample'),
                                         mesh)
    s_local = log_weight_stats(lw)  # ravels internally
    assert s_sharded['n'] == 24000
    for k in ['log_rescale', 'mean_rescaled_alpha', 'std_rescaled_alpha',
              'mean_lw', 'std_lw']:
        np.testing.assert_allclose(float(s_sharded[k]), float(s_local[k]),
                                   rtol=1e-12, err_msg=k)


def test_sharded_all_bounds_accepts_model_instance(mesh):
    """Round-4 review: a `Model` instance (unhashable NamedTuple) used to
    leak an opaque unhashable-type error from the program cache; the
    public sharded API applies the same `log_prob` unwrap the pipelines
    do."""
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    vp = jnp.asarray([0.0, 0.0, 0.5, 0.5], dtype=jnp.float64)
    res = sharded_all_bounds(model, fam, vp, 8000, jax.random.PRNGKey(0),
                             mesh)
    ref = sharded_all_bounds(model.log_prob, fam, vp, 8000,
                             jax.random.PRNGKey(0), mesh)
    np.testing.assert_allclose(float(res['d2']), float(ref['d2']),
                               rtol=1e-12)


def test_sharded_log_weight_stats_f32_large_mean(mesh):
    """std_lw must survive f32 with |mean| >> std (mean ~ -500, std ~ 1 is
    routine for log-weights): the one-pass E[x^2]-E[x]^2 form cancels
    catastrophically there; the two-pass centered form must match the
    unsharded two-pass jnp.std closely."""
    lw = (-500.0 + jax.random.normal(jax.random.PRNGKey(5), (80000,),
                                     dtype=jnp.float64)).astype(jnp.float32)
    s_sharded = sharded_log_weight_stats(shard_over(lw, mesh, 'sample'), mesh)
    s_local = log_weight_stats(lw)
    np.testing.assert_allclose(float(s_sharded['std_lw']),
                               float(s_local['std_lw']), rtol=1e-3)
    np.testing.assert_allclose(float(s_sharded['std_lw']), 1.0, rtol=2e-2)


def test_sharded_all_bounds_reuses_compiled_program(mesh):
    """Repeated sharded_all_bounds calls with the same model/family/sizes
    must hit the cached compiled program, not rebuild a fresh jitted closure
    per call (the CLAUDE.md `_pad_objective` convention)."""
    from viabel_tpu.parallel import sharded_bounds as sb
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    vp = jnp.asarray([0.0, 0.0, 0.0, 0.0], dtype=jnp.float64)
    sb._build_local_estimate.cache_clear()
    sharded_all_bounds(model.log_prob, fam, vp, 8000,
                       jax.random.PRNGKey(0), mesh)
    sharded_all_bounds(model.log_prob, fam, vp, 8000,
                       jax.random.PRNGKey(1), mesh)
    info = sb._build_local_estimate.cache_info()
    assert info.misses == 1 and info.hits == 1


def test_sharded_sample_stats_matches_local(mesh):
    from viabel_tpu.bounds import central_moments
    x = jax.random.normal(jax.random.PRNGKey(1), (40000, 3),
                          dtype=jnp.float64)
    xs = shard_over(x, mesh, 'sample')
    s = sharded_sample_stats(xs, mesh)
    loc = central_moments(x)
    np.testing.assert_allclose(float(s['C2']), float(loc['C2']), rtol=1e-12)
    np.testing.assert_allclose(float(s['C4']), float(loc['C4']), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(s['cov']), np.asarray(loc['cov']),
                               rtol=1e-10)


def test_sharded_all_bounds_matches_unsharded(mesh):
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    var_param = jnp.asarray([0.0, 0.0, 0.3, -0.2], dtype=jnp.float64)
    n = 160000
    key = jax.random.PRNGKey(2)

    res, lw_sharded = sharded_all_bounds(
        model.log_prob, fam, var_param, n, key, mesh,
        return_log_weights=True)
    assert lw_sharded.shape == (n,)

    # reproduce the same draw: per-device folded keys, concatenated
    parts = []
    for idx in range(8):
        k = jax.random.fold_in(key, idx)
        s = fam.sample(k, var_param, n // 8)
        parts.append(s)
    samples = jnp.concatenate(parts)
    lw = model.log_prob(samples) - fam.log_prob(var_param, samples)
    np.testing.assert_allclose(np.asarray(lw_sharded), np.asarray(lw),
                               rtol=1e-10)

    res_local = all_bounds(lw, samples)
    for k_ in ['d2', 'W1', 'W2', 'mean_error', 'std_error', 'cov_error',
               'log_norm_bound']:
        np.testing.assert_allclose(res[k_], res_local[k_], rtol=1e-8,
                                   err_msg=k_)


@pytest.mark.slow
def test_sharded_psislw_matches_unsharded(mesh):
    lw = 1.5 * jax.random.normal(jax.random.PRNGKey(3), (80000,),
                                 dtype=jnp.float64)
    smoothed_local, khat_local = psislw(lw)

    lw_sharded = shard_over(lw, mesh, 'sample')
    smoothed_sharded, khat_sharded = psislw_sharded(lw_sharded, mesh)
    np.testing.assert_allclose(float(khat_sharded), float(khat_local),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(smoothed_sharded),
                               np.asarray(smoothed_local), rtol=1e-8)


@pytest.mark.slow
def test_sharded_psislw_2d_columns_matches_unsharded(mesh):
    """Column-stacked log-weights (the psisloo layout) smooth per column
    and match the unsharded 2-D path."""
    lw = 1.2 * jax.random.normal(jax.random.PRNGKey(11), (16000, 3),
                                 dtype=jnp.float64)
    s_local, k_local = psislw(lw)
    s_sh, k_sh = psislw_sharded(shard_over(lw, mesh, 'sample'), mesh)
    assert np.asarray(k_sh).shape == (3,)
    np.testing.assert_allclose(np.asarray(k_sh), np.asarray(k_local),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_local),
                               rtol=1e-8)


@pytest.mark.slow
def test_sharded_psisloo_matches_unsharded(mesh):
    from viabel_tpu.psis import psisloo
    from viabel_tpu.parallel import psisloo_sharded
    key = jax.random.PRNGKey(3)
    log_lik = -0.5 * jax.random.normal(key, (16000, 5),
                                       dtype=jnp.float64) ** 2
    loo, loos, ks = psisloo(log_lik)
    loo_sh, loos_sh, ks_sh = psisloo_sharded(
        shard_over(log_lik, mesh, 'sample'), mesh)
    np.testing.assert_allclose(loo_sh, loo, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(loos_sh), np.asarray(loos),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(ks_sh), np.asarray(ks),
                               rtol=1e-10)


@pytest.mark.slow
def test_sharded_psislw_single_device_mesh():
    """A 1-device mesh must behave like the unsharded path (the gathered
    candidate pool must still contain the cutoff element)."""
    mesh1 = make_mesh(axis_names=('sample',), shape=(1,),
                      devices=jax.devices()[:1])
    lw = 1.5 * jax.random.normal(jax.random.PRNGKey(9), (8000,),
                                 dtype=jnp.float64)
    s_local, k_local = psislw(lw)
    s_sh, k_sh = psislw_sharded(shard_over(lw, mesh1, 'sample'), mesh1)
    np.testing.assert_allclose(float(k_sh), float(k_local), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_local),
                               rtol=1e-8)


@pytest.mark.slow
def test_sharded_psislw_no_smoothing_branch(mesh):
    lw = 0.3 * jax.random.normal(jax.random.PRNGKey(4), (8000,),
                                 dtype=jnp.float64)
    s_local, k_local = psislw(lw)
    s_sh, k_sh = psislw_sharded(shard_over(lw, mesh, 'sample'), mesh)
    assert float(k_local) < 1 / 3
    np.testing.assert_allclose(float(k_sh), float(k_local), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(s_sh), np.asarray(s_local),
                               rtol=1e-10)


def test_sharded_psis_moments(mesh):
    key = jax.random.PRNGKey(5)
    x = jax.random.normal(key, (40000, 2), dtype=jnp.float64) + jnp.asarray(
        [1.0, -2.0])
    lw = 0.5 * jax.random.normal(jax.random.PRNGKey(6), (40000,),
                                 dtype=jnp.float64)
    slw, _ = psislw(lw)

    mean_sh, cov_sh = sharded_psis_moments(
        shard_over(x, mesh, 'sample'), shard_over(slw, mesh, 'sample'), mesh)

    w = np.exp(np.asarray(slw))
    w = w / w.sum()
    x_np = np.asarray(x)
    mean_np = (w[:, None] * x_np).sum(axis=0)
    c = x_np - mean_np
    cov_np = (w[:, None] * c).T @ c
    np.testing.assert_allclose(np.asarray(mean_sh), mean_np, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(cov_sh), cov_np, rtol=1e-8)


def test_chain_sharded_optimizer_matches_unsharded(chain_mesh):
    """Chains sharded over the mesh produce identical trajectories to the
    plain vmapped run (sharding is a placement decision, not a numeric
    one)."""
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    obj = black_box_klvi(fam, model.log_prob, 30)
    init = jnp.zeros(4, dtype=jnp.float64)

    out_plain = rmsprop_IA_optimize_with_rhat(
        200, obj, init, 2, key=jax.random.PRNGKey(7), n_optimisers=4,
        rhat_window=50, tail_avg_iters=100)
    out_sharded = rmsprop_IA_optimize_with_rhat(
        200, obj, init, 2, key=jax.random.PRNGKey(7), n_optimisers=4,
        rhat_window=50, tail_avg_iters=100, mesh=chain_mesh)
    np.testing.assert_allclose(out_sharded[1], out_plain[1], rtol=1e-12)
    np.testing.assert_allclose(out_sharded[0], out_plain[0], rtol=1e-12)


def test_chain_sharded_segmented_driver_matches_unsharded(chain_mesh,
                                                          tmp_path):
    """mesh= combined with checkpoint_path routes through the segmented
    driver, which must re-place its state with the chain-axis sharding
    after the host round-trip through the checkpoint template (and produce
    the same trajectories as the plain run)."""
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    obj = black_box_klvi(fam, model.log_prob, 30)
    init = jnp.zeros(4, dtype=jnp.float64)
    kw = dict(key=jax.random.PRNGKey(7), n_optimisers=4, rhat_window=50,
              tail_avg_iters=100)

    out_plain = rmsprop_IA_optimize_with_rhat(200, obj, init, 2, **kw)
    out_seg = rmsprop_IA_optimize_with_rhat(
        200, obj, init, 2, mesh=chain_mesh,
        checkpoint_path=str(tmp_path / 'seg.npz'), save_every=80, **kw)
    np.testing.assert_allclose(out_seg[1], out_plain[1], rtol=1e-12)
    np.testing.assert_allclose(out_seg[0], out_plain[0], rtol=1e-12)


def test_every_sharded_builder_returns_a_jitted_program(mesh):
    """Eager (un-jitted) shard_map application re-lowers, i.e. compiles
    again, on EVERY call.  Every cached builder must hand back a
    jax.jit-wrapped program so repeated calls hit the executable cache."""
    from viabel_tpu.parallel.sharded_bounds import (_build_local_estimate,
                                                    _build_log_weight_stats,
                                                    _build_sample_stats)
    from viabel_tpu.parallel.sharded_psis import (_build_colsumlogs,
                                                  _build_psis_moments,
                                                  _build_psislw)
    progs = [
        _build_log_weight_stats(mesh, 2.0, 'sample', 800),
        _build_sample_stats(mesh, 'sample', 800),
        _build_psislw(mesh, 'sample', 20, -80.0, 1),
        _build_psislw(mesh, 'sample', 20, -80.0, 2),
        _build_colsumlogs(mesh, 'sample'),
        _build_psis_moments(mesh, 'sample'),
        _build_local_estimate(
            funnel_model().log_prob,
            mean_field_gaussian_variational_family(2), mesh, 'sample',
            100, 800, 2.0, True, True, False),
    ]
    for prog in progs:
        assert isinstance(prog, jax.stages.Wrapped), prog


def test_shard_chain_inputs_accepts_typed_keys(chain_mesh):
    """Review finding: the chain-input placement hardcoded a rank-2 key
    spec and crashed on new-style typed PRNG keys."""
    from viabel_tpu.parallel import shard_chain_inputs
    inits = jnp.zeros((4, 6))
    typed = jax.random.split(jax.random.key(0), 4)       # (4,) typed
    raw = jax.random.split(jax.random.PRNGKey(0), 4)     # (4, 2) uint32
    for keys in (typed, raw):
        s_inits, s_keys = shard_chain_inputs(inits, keys, chain_mesh)
        assert s_inits.shape == inits.shape
        assert s_keys.shape == keys.shape


def test_auto_mesh_placement_rules():
    """The shared CLI/serve placement rule (round-4 review: the two had
    diverged): K runs take a (gcd(K, N), N/gcd) mesh, a single run takes
    the full sample mesh, and indivisible sizes DEGRADE (largest usable
    sample axis / chain-only placement) rather than abandoning the mesh —
    attached devices are never skipped or degraded silently."""
    from viabel_tpu.parallel import auto_mesh

    mesh, note = auto_mesh(1, 4096)
    assert mesh.axis_names == ('sample',) and mesh.devices.shape == (8,)
    assert 'sample axis' in note

    mesh, note = auto_mesh(4, 4096)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == dict(
        chain=4, sample=2)
    assert '(4x2)' in note

    mesh, note = auto_mesh(8, 4096)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == dict(
        chain=8, sample=1)
    assert 'chain axis' in note

    # degradations carry the reason (round-4 review: indivisible sizes
    # used to abandon all attached devices)
    mesh, note = auto_mesh(3, 4096)  # gcd(3, 8) == 1: chain axis of 1,
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == dict(
        chain=1, sample=8)           # bound passes still shard 8-way
    mesh, note = auto_mesh(1, 4097)  # 4097 = 17*241: no divisor <= 8
    assert mesh is None and 'share no factor' in note
    mesh, note = auto_mesh(4, 4097)  # sample axis would be 2; 4097 is odd
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == dict(
        chain=4, sample=1)           # keeps the (4, 1) chain placement
    assert 'using 4 of the 8' in note and '4097' in note
    mesh, note = auto_mesh(1, 4098)  # 4098 = 2*3*683: degrade 8 -> 6
    assert mesh.axis_names == ('sample',) and mesh.devices.shape == (6,)
    assert 'degraded to 6 devices' in note

    # single device: nothing to place, nothing to report
    mesh, note = auto_mesh(4, 4096, devices=jax.devices()[:1])
    assert mesh is None and note is None


def test_mesh_entry_points_reject_missing_axes():
    """Round-4 review: a mesh without the expected axis name must raise an
    informative ValueError, not a bare KeyError, at every mesh-taking
    entry point."""
    import jax.numpy as jnp

    from viabel_tpu import (validated_vi, validated_vi_multistart,
                            validated_vi_sweep)
    from viabel_tpu.mcmc import hmc_sample
    from viabel_tpu.models import funnel_model
    from viabel_tpu import mean_field_gaussian_variational_family

    model = funnel_model()
    fam = mean_field_gaussian_variational_family(model.dim)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    sample_only = make_mesh(axis_names=('sample',), shape=(8,))
    chain_only = make_mesh(axis_names=('chain',), shape=(8,))

    with pytest.raises(ValueError, match="axis named 'sample'.*'chain'"):
        validated_vi(model.log_prob, fam, init, 50, mesh=chain_only)
    with pytest.raises(ValueError, match="axis named 'chain'"):
        validated_vi_multistart(model.log_prob, fam, init, 50, n_starts=2,
                                mesh=sample_only)
    with pytest.raises(ValueError, match="axis named 'chain'"):
        validated_vi_sweep(model.log_prob, fam, init, 50,
                           learning_rates=[0.01, 0.02], mesh=sample_only)
    with pytest.raises(ValueError, match="axis named 'chain'"):
        hmc_sample(model.log_prob, jnp.zeros(model.dim), mesh=sample_only,
                   n_samples=10, n_warmup=10)


def test_auto_mesh_invariants_property():
    """For every (K, n) shape: a returned mesh uses at most the pool (all
    of it when sizes divide), the chain axis divides K, the sample axis
    divides n, a degraded placement says so in the note, and a None mesh
    always carries a reason."""
    from viabel_tpu.parallel import auto_mesh
    for k in range(1, 13):
        for n in (1000, 4096, 4097, 4098, 999983):
            mesh, note = auto_mesh(k, n)
            if mesh is None:
                assert note is not None and len(note) > 0, (k, n)
                continue
            sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
            used = int(np.prod(mesh.devices.shape))
            assert 2 <= used <= 8, (k, n)
            if used < 8:  # degradations are never silent
                assert 'degraded' in note or 'using {} of'.format(
                    used) in note, (k, n, note)
            if k == 1:
                assert set(sizes) == {'sample'}
                assert n % sizes['sample'] == 0, (k, n)
            else:
                assert k % sizes['chain'] == 0, (k, n)
                if sizes['sample'] > 1:
                    assert n % sizes['sample'] == 0, (k, n)


def test_sharded_bound_psis_fused_matches_two_program(mesh):
    """The fused single-dispatch bound+PSIS program (`sharded_bound_psis`,
    the pass serve /bounds and the bench sentinel run) must reproduce the
    composed `sharded_all_bounds` + `psislw_sharded` path exactly — same
    per-device keys, same statistics, same smoothed weights and khat —
    both with closed-form family moments and through the empirical
    fallback."""
    from viabel_tpu.bounds import family_moment_bounds
    from viabel_tpu.parallel import sharded_bound_psis
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    vp = jnp.asarray([0.0, 0.0, 0.3, 0.6], dtype=jnp.float64)
    mb = family_moment_bounds(fam, vp)
    qv = np.asarray(fam.mean_and_cov(vp)[1])
    key = jax.random.PRNGKey(3)

    res2, lw = sharded_all_bounds(model.log_prob, fam, vp, 16000, key, mesh,
                                  moment_bound_fn=mb, q_var=qv,
                                  return_log_weights=True)
    slw2, kh2 = psislw_sharded(lw, mesh)
    res1, slw1, kh1 = sharded_bound_psis(model.log_prob, fam, vp, 16000,
                                         key, mesh, moment_bound_fn=mb,
                                         q_var=qv)
    for k in res2:
        np.testing.assert_allclose(res1[k], res2[k], rtol=1e-9, err_msg=k)
    np.testing.assert_allclose(np.asarray(slw1), np.asarray(slw2),
                               rtol=1e-12)
    np.testing.assert_allclose(kh1, float(kh2), rtol=1e-9)
    # the smoothed weights keep the sample-axis sharding
    assert len(slw1.sharding.device_set) == 8
    # empirical-moment fallback (no moment_bound_fn, no q_var)
    r1, s1, k1 = sharded_bound_psis(model.log_prob, fam, vp, 16000, key,
                                    mesh)
    r2 = sharded_all_bounds(model.log_prob, fam, vp, 16000, key, mesh)
    for k in r2:
        np.testing.assert_allclose(r1[k], r2[k], rtol=1e-9, err_msg=k)


def test_sharded_psis_ties_in_tail(mesh):
    """Tied weight values inside the tail: the tail-only scatter rewrite
    (round-5) must keep the module's documented tie semantics — exactly
    equal tail values receive the SAME smoothed quantile (value-order
    ranks; the unsharded argsort instead breaks such ties by index, a
    measure-zero divergence for continuous weights) — and the result must
    stay correctly renormalized and close to the unsharded smoothing."""
    from jax.scipy.special import logsumexp
    key = jax.random.PRNGKey(11)
    lw = jax.random.normal(key, (8000,), dtype=jnp.float64)
    tied_val = float(jnp.sort(lw)[-200])
    lw = lw.at[:64].set(tied_val)  # plant exact ties inside the tail
    slw_sh, kh_sh = psislw_sharded(shard_over(lw, mesh, 'sample'), mesh)
    slw, kh = psislw(lw)
    np.testing.assert_allclose(float(kh_sh), float(kh), rtol=1e-9)
    out = np.asarray(slw_sh)
    # all ties share one smoothed value; self-normalization holds
    assert np.unique(out[:64]).size == 1
    np.testing.assert_allclose(float(logsumexp(slw_sh)), 0.0, atol=1e-9)
    # away from the ties the two smoothings agree up to the (tiny)
    # renormalization shift the tie convention induces
    np.testing.assert_allclose(out[64:], np.asarray(slw)[64:], atol=5e-3)
