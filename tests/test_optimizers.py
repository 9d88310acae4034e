"""Optimizer tests: schedule parity with the reference generator semantics,
convergence on a conjugate-posterior oracle, and the IA/R-hat pipeline's
output contract (coverage the reference never had; SURVEY.md section 4).
"""
import jax
import jax.numpy as jnp
import numpy as np

from viabel_tpu import (adagrad_optimize, adam_IA_optimize_with_rhat,
                        black_box_klvi, compute_posterior_moments,
                        learning_rate_schedule,
                        mean_field_gaussian_variational_family,
                        rmsprop_IA_optimize_with_rhat)
from viabel_tpu.models import linear_regression_model
import pytest


def _reference_schedule(n_iters, learning_rate, learning_rate_end):
    """Python replica of the reference's generator semantics
    (reference: viabel/vb.py:324-342) used as the test oracle."""
    if learning_rate_end is not None:
        b = n_iters * learning_rate_end / (2 * (learning_rate
                                                - learning_rate_end))
        a = learning_rate * b
        start = n_iters // 4
        end = 3 * n_iters // 4
    for i in range(n_iters):
        if learning_rate_end is None or i < start:
            yield learning_rate
        elif i < end:
            yield a / (b + i - start + 1)
        else:
            yield learning_rate_end


def test_learning_rate_schedule_matches_reference():
    for n_iters, lr, lr_end in [(100, .01, .001), (1000, .1, .001),
                                (57, .05, .02), (100, .01, None)]:
        expected = np.array(list(_reference_schedule(n_iters, lr, lr_end)))
        got = np.array([float(learning_rate_schedule(i, n_iters, lr, lr_end))
                        for i in range(n_iters)])
        np.testing.assert_allclose(got, expected, rtol=1e-12)


def test_learning_rate_schedule_validation():
    import pytest
    with pytest.raises(ValueError):
        learning_rate_schedule(0, 100, -1.0)
    with pytest.raises(ValueError):
        learning_rate_schedule(0, 100, .001, .01)
    # concrete non-Python-float rates must still be validated eagerly
    # (regression: an isinstance guard once let np.float32(-0.5) through)
    with pytest.raises(ValueError):
        learning_rate_schedule(0, 100, np.float32(-0.5))
    with pytest.raises(ValueError):
        learning_rate_schedule(0, 100, jnp.asarray(.001), .01)
    # learning_rate_end <= 0 freezes the final quarter (lr = 0) or puts
    # the harmonic pole inside the decay phase (negative rates) — rejected
    with pytest.raises(ValueError):
        learning_rate_schedule(0, 100, .01, 0.0)
    with pytest.raises(ValueError):
        learning_rate_schedule(0, 100, .01, -.001)
    # traced rates defer validation to the caller (the sweep runner)
    out = jax.jit(lambda lr: learning_rate_schedule(5, 100, lr))(0.02)
    assert float(out) == 0.02


def _conjugate_problem(seed=0):
    rs = np.random.RandomState(seed)
    N, D = 50, 2
    x = rs.randn(N, D)
    w = np.array([1.0, -2.0])
    y = x @ w + 0.5 * rs.randn(N)
    model = linear_regression_model(x, y)
    return model


def test_adagrad_converges_on_conjugate_posterior():
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 50)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    opt_param, history, values, log_norms = adagrad_optimize(
        3000, obj, init, key=jax.random.PRNGKey(0), learning_rate=.05,
        learning_rate_end=.001)
    assert history.shape == (3000 - 3 * 3000 // 4, fam.var_param_dim)
    assert values.shape == (3000,)
    mean, cov = fam.mean_and_cov(opt_param)
    np.testing.assert_allclose(np.asarray(mean), model.true_mean, atol=0.05)
    # mean-field variances should match the true marginal variances roughly
    np.testing.assert_allclose(np.sqrt(np.diag(np.asarray(cov))),
                               np.sqrt(np.diag(model.true_cov)), rtol=0.35)
    # loss decreased
    assert np.mean(np.asarray(values)[-100:]) < np.mean(
        np.asarray(values)[:100])


def test_adagrad_window_rescaling_runs_with_log_norm():
    """has_log_norm path: the windowed min-log-norm rescaling executes
    (reference: viabel/vb.py:359-374).  CHIVI is started near the optimum,
    as the reference notebooks do (robust-regression.ipynb cell 23 warm-
    starts CHIVI from the KLVI solution)."""
    from viabel_tpu import black_box_chivi
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_chivi(2, fam, model.log_prob, 200)
    init = jnp.asarray(np.concatenate([
        model.true_mean, 0.5 * np.log(np.diag(model.true_cov)) + 1.0]))
    opt_param, _, values, log_norms = adagrad_optimize(
        500, obj, init, key=jax.random.PRNGKey(1), learning_rate=.01)
    assert np.asarray(log_norms).shape == (500,)
    assert np.any(np.asarray(log_norms) != 0)
    mean, _ = fam.mean_and_cov(opt_param)
    np.testing.assert_allclose(np.asarray(mean), model.true_mean, atol=0.3)


def test_rmsprop_ia_with_rhat_contract_and_convergence():
    model = _conjugate_problem()
    K = model.dim
    fam = mean_field_gaussian_variational_family(K)
    obj = black_box_klvi(fam, model.log_prob, 50)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    n_iters, n_chains = 1200, 3
    (final_param, chains, avg_means, avg_sigmas, values, log_norms,
     log) = rmsprop_IA_optimize_with_rhat(
        n_iters, obj, init, K, key=jax.random.PRNGKey(2), learning_rate=.02,
        n_optimisers=n_chains, rhat_window=200, tail_avg_iters=400)
    assert chains.shape == (n_chains, n_iters, fam.var_param_dim)
    assert values.shape == (n_chains * n_iters,)
    assert len(avg_means) == n_chains
    assert log['r_hat_mean'].shape[1] == K
    assert log['r_hat_mean_halfway'].shape[1] == K
    assert 0 <= log['start_avg_mean_iters'] < n_iters
    # averaged posterior mean close to truth for every chain
    for o in range(n_chains):
        np.testing.assert_allclose(avg_means[o][-1], model.true_mean,
                                   atol=0.1)


@pytest.mark.slow
def test_presampled_objective_bit_identical():
    """presampled=True runs produce bit-identical trajectories to the
    key-threaded path (same fold_in keys feed one batched base_sample)."""
    from viabel_tpu.models import funnel_model
    from viabel_tpu import mean_field_t_variational_family
    model = funnel_model()
    fam = mean_field_t_variational_family(2, 40)
    init = jnp.zeros(4, dtype=jnp.float64)
    key = jax.random.PRNGKey(7)
    obj_keyed = black_box_klvi(fam, model.log_prob, 50)
    obj_pre = black_box_klvi(fam, model.log_prob, 50, presampled=True)
    out_keyed = adagrad_optimize(300, obj_keyed, init, key=key)
    out_pre = adagrad_optimize(300, obj_pre, init, key=key)
    np.testing.assert_array_equal(np.asarray(out_keyed[0]),
                                  np.asarray(out_pre[0]))
    np.testing.assert_array_equal(np.asarray(out_keyed[2]),
                                  np.asarray(out_pre[2]))

    # IA optimizers too
    out_ia_keyed = rmsprop_IA_optimize_with_rhat(
        200, obj_keyed, init, 2, key=key, n_optimisers=2, rhat_window=50,
        tail_avg_iters=50)
    out_ia_pre = rmsprop_IA_optimize_with_rhat(
        200, obj_pre, init, 2, key=key, n_optimisers=2, rhat_window=50,
        tail_avg_iters=50)
    np.testing.assert_array_equal(out_ia_keyed[1], out_ia_pre[1])


def test_ia_short_run_does_not_crash():
    """n_iters below the halfway-R-hat interval (100) and below
    tail_avg_iters must not crash (review findings: empty halfway array,
    negative averaging start)."""
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    out = rmsprop_IA_optimize_with_rhat(
        50, obj, init, model.dim, key=jax.random.PRNGKey(5),
        n_optimisers=2, rhat_window=25, tail_avg_iters=2000)
    assert out[1].shape == (2, 50, fam.var_param_dim)
    assert out[6]['r_hat_mean_halfway'].shape[0] == 0


def test_ia_returns_post_update_param():
    """The first tuple element is the post-final-update parameter
    (reference: viabel/vb.py:547), not the stale pre-update history tail."""
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    out = rmsprop_IA_optimize_with_rhat(
        100, obj, init, model.dim, key=jax.random.PRNGKey(6),
        n_optimisers=1, rhat_window=50, tail_avg_iters=50)
    final_param, chains = out[0], out[1]
    assert not np.allclose(final_param, chains[-1, -1])  # one step newer


def test_resumable_supports_presampled(tmp_path):
    """adagrad_optimize_resumable honors presampled objectives and matches
    the non-resumable presampled run exactly (review finding: it previously
    fed PRNG keys to transform, yielding NaNs)."""
    from viabel_tpu.checkpoint import adagrad_optimize_resumable
    from viabel_tpu.models import funnel_model
    from viabel_tpu import mean_field_t_variational_family
    model = funnel_model()
    fam = mean_field_t_variational_family(2, 40)
    obj = black_box_klvi(fam, model.log_prob, 30, presampled=True)
    init = jnp.zeros(4, dtype=jnp.float64)
    key = jax.random.PRNGKey(8)
    direct = adagrad_optimize(300, obj, init, key=key)
    resumable = adagrad_optimize_resumable(
        300, obj, init, checkpoint_path=str(tmp_path / 'p.npz'), key=key,
        save_every=100)
    np.testing.assert_allclose(np.asarray(resumable[0]),
                               np.asarray(direct[0]), rtol=1e-10)
    assert np.all(np.isfinite(np.asarray(resumable[0])))


def test_adam_ia_with_rhat_converges():
    model = _conjugate_problem()
    K = model.dim
    fam = mean_field_gaussian_variational_family(K)
    obj = black_box_klvi(fam, model.log_prob, 50)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    (final_param, chains, avg_means, avg_sigmas, values, _,
     log) = adam_IA_optimize_with_rhat(
        1200, obj, init, K, key=jax.random.PRNGKey(3), learning_rate=.02,
        n_optimisers=2, rhat_window=200, tail_avg_iters=400)
    np.testing.assert_allclose(avg_means[0][-1], model.true_mean, atol=0.1)
    np.testing.assert_allclose(avg_means[1][-1], model.true_mean, atol=0.1)


def test_ia_history_cap():
    """window caps the retained history at 100*window iterates per chain
    (reference: viabel/vb.py:476-477, 629-630); the retained block is the
    chronological tail of the uncapped history."""
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    kw = dict(key=jax.random.PRNGKey(9), n_optimisers=2, rhat_window=50,
              tail_avg_iters=50)
    full = rmsprop_IA_optimize_with_rhat(300, obj, init, model.dim,
                                         window=None, **kw)
    capped = rmsprop_IA_optimize_with_rhat(300, obj, init, model.dim,
                                           window=2, **kw)
    assert full[1].shape == (2, 300, fam.var_param_dim)
    assert capped[1].shape == (2, 200, fam.var_param_dim)
    np.testing.assert_array_equal(capped[1], full[1][:, 100:])
    # value/log-norm histories stay full-length (reference keeps them full)
    assert capped[4].shape == (2 * 300,)


def test_ia_online_tail_average():
    """averaging=True maintains a running mean of post-update parameters
    over iterations > n_iters // 1.3 inside the compiled scan and returns
    it via optimisation_log (reference: viabel/vb.py:624-627 computes this
    but drops it; the recursion bug there is fixed — see PARITY.md)."""
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    n_iters = 260
    out = adam_IA_optimize_with_rhat(
        n_iters, obj, init, model.dim, key=jax.random.PRNGKey(10),
        n_optimisers=1, rhat_window=50, tail_avg_iters=50, averaging=True)
    final_param, chains, log = out[0], out[1], out[6]
    avg = log['averaged_variational_param']
    assert avg.shape == (1, fam.var_param_dim)
    # expected: mean of post-update params over i in (n_iters//1.3, n_iters)
    avg_start = int(n_iters // 1.3)
    posts = np.concatenate([chains[0, 1:], final_param[None]], axis=0)
    expected = posts[avg_start + 1:].mean(axis=0)
    np.testing.assert_allclose(avg[0], expected, rtol=1e-10)

    out_off = adam_IA_optimize_with_rhat(
        n_iters, obj, init, model.dim, key=jax.random.PRNGKey(10),
        n_optimisers=1, rhat_window=50, tail_avg_iters=50, averaging=False)
    assert 'averaged_variational_param' not in out_off[6]


def test_ia_segmented_matches_single_scan(tmp_path):
    """checkpoint_path/progress runs execute in compiled segments that are
    bit-identical to the single-scan path."""
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    kw = dict(key=jax.random.PRNGKey(11), n_optimisers=2, rhat_window=50,
              tail_avg_iters=50)
    fast = rmsprop_IA_optimize_with_rhat(250, obj, init, model.dim, **kw)
    seg = rmsprop_IA_optimize_with_rhat(
        250, obj, init, model.dim, checkpoint_path=str(tmp_path / 'c.npz'),
        save_every=100, **kw)
    np.testing.assert_array_equal(fast[0], seg[0])
    np.testing.assert_array_equal(fast[1], seg[1])
    np.testing.assert_array_equal(fast[4], seg[4])
    np.testing.assert_array_equal(
        fast[6]['averaged_variational_param'],
        seg[6]['averaged_variational_param'])


def test_ia_interrupt_partial_results_and_resume(tmp_path, monkeypatch):
    """KeyboardInterrupt mid-run returns partial histories (reference:
    viabel/vb.py:476-481, 638-643) and a later identical call resumes from
    the checkpoint and reproduces the uninterrupted run exactly."""
    import viabel_tpu.optimizers as optimizers_mod
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    kw = dict(key=jax.random.PRNGKey(12), n_optimisers=2, rhat_window=50,
              tail_avg_iters=50)
    ckpt = str(tmp_path / 'resume.npz')
    fast = adam_IA_optimize_with_rhat(300, obj, init, model.dim, **kw)

    real_segment = optimizers_mod._chains_segment
    calls = {'n': 0}

    def interrupting(*args, **kwargs):
        if calls['n'] >= 2:
            raise KeyboardInterrupt
        calls['n'] += 1
        return real_segment(*args, **kwargs)

    monkeypatch.setattr(optimizers_mod, '_chains_segment', interrupting)
    partial = adam_IA_optimize_with_rhat(
        300, obj, init, model.dim, checkpoint_path=ckpt, save_every=100,
        **kw)
    monkeypatch.setattr(optimizers_mod, '_chains_segment', real_segment)

    # partial results cover the 200 completed iterations and match
    assert partial[1].shape == (2, 200, fam.var_param_dim)
    np.testing.assert_array_equal(partial[1], fast[1][:, :200])
    assert partial[4].shape == (2 * 200,)

    # resuming completes the run and reproduces the uninterrupted output
    resumed = adam_IA_optimize_with_rhat(
        300, obj, init, model.dim, checkpoint_path=ckpt, save_every=100,
        **kw)
    np.testing.assert_array_equal(resumed[0], fast[0])
    np.testing.assert_array_equal(resumed[1], fast[1])
    np.testing.assert_array_equal(resumed[4], fast[4])


def test_ia_interrupt_before_first_segment_reraises(monkeypatch):
    """An interrupt before any segment completes has no partial results to
    return; the KeyboardInterrupt must propagate instead of crashing the
    R-hat post-pass on an empty history."""
    import viabel_tpu.optimizers as optimizers_mod
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)

    def interrupt_immediately(*args, **kwargs):
        raise KeyboardInterrupt

    monkeypatch.setattr(optimizers_mod, '_chains_segment',
                        interrupt_immediately)
    import pytest
    with pytest.raises(KeyboardInterrupt):
        adam_IA_optimize_with_rhat(
            300, obj, init, model.dim, key=jax.random.PRNGKey(12),
            n_optimisers=2, rhat_window=50, tail_avg_iters=50,
            progress=True, save_every=100)


def test_many_distinct_objectives_warns():
    """Constructing objectives in a loop (a fresh static jit argument per
    instance => a full recompile per run) triggers a one-time warning."""
    import warnings
    import viabel_tpu.optimizers as opt
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)

    # reset the wrapper caches so the miss counter is at a known zero
    # (other tests in the suite also create objectives)
    opt._pad_objective.cache_clear()
    opt._truncate_objective.cache_clear()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        for _ in range(opt._RECOMPILE_WARN_AT + 1):
            obj = black_box_klvi(fam, model.log_prob, 4)  # fresh instance
            opt._wrap_objective(obj, None)
    msgs = [str(w.message) for w in caught]
    assert any('recompile' in m for m in msgs)
    assert sum('recompile' in m for m in msgs) == 1  # one-time


def test_ia_segmented_history_cap_with_long_segments(tmp_path):
    """Segments longer than the history cap (save_every > 100*window) keep
    exactly the last `cap` iterates, matching the single-scan ring buffer
    (regression test: the ring write previously relied on numpy's
    unspecified duplicate-fancy-index assignment order)."""
    model = _conjugate_problem()
    fam = mean_field_gaussian_variational_family(model.dim)
    obj = black_box_klvi(fam, model.log_prob, 20)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    kw = dict(key=jax.random.PRNGKey(13), n_optimisers=2, rhat_window=50,
              tail_avg_iters=50, window=1)   # cap = 100 < save_every
    fast = rmsprop_IA_optimize_with_rhat(350, obj, init, model.dim, **kw)
    seg = rmsprop_IA_optimize_with_rhat(
        350, obj, init, model.dim, checkpoint_path=str(tmp_path / 'c.npz'),
        save_every=250, **kw)
    assert fast[1].shape == (2, 100, fam.var_param_dim)
    np.testing.assert_array_equal(seg[1], fast[1])
    np.testing.assert_array_equal(seg[0], fast[0])


def test_adagrad_no_history_mode():
    """return_history=False must reproduce the history-mean tail average
    without materializing the (tail, P) stack (the large-P mode; a
    full-rank d=300 family over 40k iterations needs 7+ GB of history)."""
    from viabel_tpu.models import funnel_model
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    obj = black_box_klvi(fam, model.log_prob, 20, presampled=True)
    init = jnp.zeros(4, dtype=jnp.float64)
    kw = dict(key=jax.random.PRNGKey(3), learning_rate=.05, unroll=1)
    full = adagrad_optimize(400, obj, init, **kw)
    lean = adagrad_optimize(400, obj, init, return_history=True, **kw)
    np.testing.assert_array_equal(np.asarray(full[0]), np.asarray(lean[0]))
    lean = adagrad_optimize(400, obj, init, return_history=False, **kw)
    assert lean[1] is None
    # identical trajectories -> identical value/log-norm histories
    np.testing.assert_array_equal(np.asarray(full[2]), np.asarray(lean[2]))
    np.testing.assert_array_equal(np.asarray(full[3]), np.asarray(lean[3]))
    # both modes read the smoothed param off the SAME in-scan running sum,
    # so they agree bit-for-bit (the history MEAN may differ from it in
    # summation order; the cross-mode contract is the bitwise one)
    np.testing.assert_array_equal(np.asarray(lean[0]), np.asarray(full[0]))


def test_resolve_unroll():
    """unroll='auto' resolves to the one measured-best constant (8 on the
    H100 at both P = 20 and P = 5,150; benchmarks/unroll_sweep.py);
    explicit ints pass through so bit-identity callers (unroll=1) are
    never silently changed."""
    from viabel_tpu.optimizers import _AUTO_UNROLL, resolve_unroll
    assert _AUTO_UNROLL == 8
    assert resolve_unroll('auto') == _AUTO_UNROLL
    assert resolve_unroll(1) == 1
    assert resolve_unroll(16) == 16
    with pytest.raises(ValueError, match="positive int or 'auto'"):
        resolve_unroll('fast')
    with pytest.raises(ValueError, match='>= 1'):
        resolve_unroll(0)


def test_adagrad_auto_unroll_matches_explicit_small_p():
    """At small P the default unroll='auto' is exactly unroll=8 — same
    resolved static argument, so it hits the SAME compiled program and
    the trajectories are bitwise identical."""
    from viabel_tpu.models import funnel_model
    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    obj = black_box_klvi(fam, model.log_prob, 20, presampled=True)
    init = jnp.zeros(4, dtype=jnp.float64)
    kw = dict(key=jax.random.PRNGKey(5), learning_rate=.05)
    auto = adagrad_optimize(200, obj, init, **kw)
    eight = adagrad_optimize(200, obj, init, unroll=8, **kw)
    np.testing.assert_array_equal(np.asarray(auto[0]), np.asarray(eight[0]))
    np.testing.assert_array_equal(np.asarray(auto[2]), np.asarray(eight[2]))
