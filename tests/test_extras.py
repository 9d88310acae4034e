"""Tests for the auxiliary subsystems: chivi-neff / perturbed objectives,
checkpoint-resume, throughput metrics, and the native C++ model backend.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viabel_tpu import (adagrad_optimize, black_box_chivi,
                        black_box_chivi_neff, black_box_klvi,
                        mean_field_gaussian_variational_family,
                        perturbed_black_box_vi)
from viabel_tpu.distributions import diag_normal_logpdf


def _gaussian_target(mean, log_std):
    return lambda x: diag_normal_logpdf(x, mean, log_std)


def test_chivi_neff_matches_chivi_up_to_normalization():
    fam = mean_field_gaussian_variational_family(2)
    log_density = _gaussian_target(jnp.asarray([1.0, -1.0]),
                                   jnp.asarray([0.1, 0.2]))
    n = 256
    obj = black_box_chivi(2, fam, log_density, n)
    obj_neff = black_box_chivi_neff(2, fam, log_density, n)
    param = jnp.asarray([0.5, -0.5, 0.0, 0.0])
    key = jax.random.PRNGKey(0)
    v1, g1, ln1 = obj(param, key)
    v2, g2, ln2, neff = obj_neff(param, key)
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-12)
    np.testing.assert_allclose(float(ln1), float(ln2), rtol=1e-12)
    assert 1.0 <= float(neff) <= n
    # same direction, damped by neff/n (full ESS recovers plain CHIVI;
    # degenerate weights shrink the step instead of amplifying it)
    np.testing.assert_allclose(np.asarray(g2),
                               np.asarray(g1) * float(neff) / n, rtol=1e-10)


def test_chivi_neff_runs_in_optimizer():
    fam = mean_field_gaussian_variational_family(1)
    log_density = _gaussian_target(jnp.asarray([0.5]), jnp.asarray([0.0]))
    obj = black_box_chivi_neff(2, fam, log_density, 100)
    init = jnp.asarray([0.4, 0.1])
    opt, _, values, log_norms = adagrad_optimize(
        300, obj, init, key=jax.random.PRNGKey(1), learning_rate=.02)
    assert np.all(np.isfinite(np.asarray(opt)))
    assert np.any(np.asarray(log_norms) != 0)


def test_perturbed_vi_gradient_centered_on_klvi():
    fam = mean_field_gaussian_variational_family(1)
    log_density = _gaussian_target(jnp.asarray([0.5]), jnp.asarray([0.0]))
    obj_p = perturbed_black_box_vi(fam, log_density, 200,
                                   perturbation_scale=0.05)
    obj_k = black_box_klvi(fam, log_density, 200)
    param = jnp.asarray([0.0, 0.2])
    keys = jax.random.split(jax.random.PRNGKey(2), 400)
    gp = np.asarray(jax.jit(jax.vmap(lambda k: obj_p(param, k)[1]))(keys))
    gk = np.asarray(jax.jit(jax.vmap(lambda k: obj_k(param, k)[1]))(keys))
    se = gp.std(axis=0) / np.sqrt(len(gp))
    np.testing.assert_allclose(gp.mean(axis=0), gk.mean(axis=0),
                               atol=6 * se.max() + 0.02)


def test_checkpoint_save_load_roundtrip(tmp_path):
    from viabel_tpu.checkpoint import load_checkpoint, save_checkpoint
    tree = dict(a=np.arange(5.0), b=dict(c=np.eye(2), d=np.float64(3.5)))
    path = str(tmp_path / 'ckpt.npz')
    save_checkpoint(path, tree)
    loaded = load_checkpoint(path, like=tree)
    np.testing.assert_allclose(loaded['a'], tree['a'])
    np.testing.assert_allclose(loaded['b']['c'], tree['b']['c'])
    np.testing.assert_allclose(loaded['b']['d'], tree['b']['d'])


def test_adagrad_resumable_matches_unresumed(tmp_path, monkeypatch):
    import shutil

    import viabel_tpu.checkpoint as ckpt
    fam = mean_field_gaussian_variational_family(1)
    log_density = _gaussian_target(jnp.asarray([0.5]), jnp.asarray([0.0]))
    obj = black_box_klvi(fam, log_density, 50)
    init = jnp.zeros(2, dtype=jnp.float64)
    key = jax.random.PRNGKey(3)
    n_iters = 400
    path = str(tmp_path / 'opt.npz')
    snap = str(tmp_path / 'snap_200.npz')

    direct = adagrad_optimize(n_iters, obj, init, key=key)

    # snapshot the mid-run checkpoint (segment boundary at i = 200) so a
    # crash at that point can be simulated faithfully
    real_save = ckpt.save_checkpoint

    def spying_save(p, tree):
        out = real_save(p, tree)
        if p == path and int(tree['i']) == 200:
            shutil.copy(path, snap)
        return out

    monkeypatch.setattr(ckpt, 'save_checkpoint', spying_save)
    full = ckpt.adagrad_optimize_resumable(n_iters, obj, init,
                                           checkpoint_path=path, key=key,
                                           save_every=100)
    np.testing.assert_allclose(np.asarray(full[0]), np.asarray(direct[0]),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(full[2]), np.asarray(direct[2]),
                               rtol=1e-10)

    # crash-and-resume: restore the i=200 snapshot; the resumed run must
    # reproduce the completed run exactly
    shutil.copy(snap, path)
    resumed = ckpt.adagrad_optimize_resumable(n_iters, obj, init,
                                              checkpoint_path=path, key=key,
                                              save_every=100)
    np.testing.assert_allclose(np.asarray(resumed[2]), np.asarray(full[2]),
                               rtol=1e-10)
    np.testing.assert_allclose(np.asarray(resumed[0]), np.asarray(full[0]),
                               rtol=1e-10)


def test_adagrad_resumable_no_history_large_p(tmp_path, monkeypatch):
    """The large-P resumable mode (round-3 review): a d=100 full-rank run
    (P = 5150) checkpoints O(window * P), not O(n_iters * P), survives a
    crash-and-resume mid-tail (the restored running tail sum is nonzero),
    and its smoothed parameter is BIT-identical to the whole-run driver's
    in-scan tail sum (same accumulation order;
    `adagrad_optimize(return_history=False, unroll=1)`)."""
    import os
    import shutil

    import viabel_tpu.checkpoint as ckpt
    from viabel_tpu import t_variational_family

    d = 100
    fam = t_variational_family(d, 40)
    target_mean = jnp.linspace(-0.5, 0.5, d)
    target_log_std = jnp.zeros(d)
    log_density = _gaussian_target(target_mean, target_log_std)
    obj = black_box_klvi(fam, log_density, 10)
    init = jnp.zeros(fam.var_param_dim, dtype=jnp.float64)
    key = jax.random.PRNGKey(5)
    n_iters = 300  # tail averaging starts at 225
    path = str(tmp_path / 'bigp.npz')
    snap = str(tmp_path / 'snap_250.npz')

    direct = adagrad_optimize(n_iters, obj, init, key=key,
                              return_history=False, unroll=1)

    # snapshot the i=250 checkpoint: 25 tail iterations already accumulated,
    # so the resume below restores a NONZERO running tail sum
    real_save = ckpt.save_checkpoint

    def spying_save(p, tree):
        out = real_save(p, tree)
        if p == path and int(tree['i']) == 250:
            shutil.copy(path, snap)
        return out

    monkeypatch.setattr(ckpt, 'save_checkpoint', spying_save)
    full = ckpt.adagrad_optimize_resumable(
        n_iters, obj, init, checkpoint_path=path, key=key, save_every=50,
        return_history=False)
    assert full[1] is None
    np.testing.assert_array_equal(np.asarray(full[0]), np.asarray(direct[0]))
    np.testing.assert_array_equal(np.asarray(full[2]), np.asarray(direct[2]))

    # checkpoint carries no iterate history: size is O(window * P), far
    # below the 12+ MB an (n_iters, P) f64 history would cost
    with np.load(path) as data:
        names = {k.split(':', 1)[1].split('/')[-1] for k in data.files
                 if ':' in k}
    assert 'params' not in names and 'tail_sum' in names
    assert os.path.getsize(path) < 2 * 1024 * 1024

    # crash-and-resume: restore the i=250 snapshot; the resumed run must
    # reproduce the completed run bit-for-bit
    shutil.copy(snap, path)
    resumed = ckpt.adagrad_optimize_resumable(
        n_iters, obj, init, checkpoint_path=path, key=key, save_every=50,
        return_history=False)
    np.testing.assert_array_equal(np.asarray(resumed[0]),
                                  np.asarray(full[0]))
    np.testing.assert_array_equal(np.asarray(resumed[2]),
                                  np.asarray(full[2]))


def test_adagrad_resumable_wrong_mode_names_the_flag(tmp_path):
    """Round-4 review: resuming a checkpoint in the other return_history
    mode must name the mode flag, not surface a baffling shape mismatch
    blaming n_iters/window."""
    import viabel_tpu.checkpoint as ckpt
    fam = mean_field_gaussian_variational_family(1)
    log_density = _gaussian_target(jnp.asarray([0.5]), jnp.asarray([0.0]))
    obj = black_box_klvi(fam, log_density, 20)
    init = jnp.zeros(2, dtype=jnp.float64)
    path = str(tmp_path / 'mode.npz')
    ckpt.adagrad_optimize_resumable(100, obj, init, checkpoint_path=path,
                                    key=jax.random.PRNGKey(0),
                                    save_every=50)
    with pytest.raises(ValueError, match='return_history=True.*'
                                         'return_history=False'):
        ckpt.adagrad_optimize_resumable(100, obj, init,
                                        checkpoint_path=path,
                                        key=jax.random.PRNGKey(0),
                                        save_every=50,
                                        return_history=False)
    path2 = str(tmp_path / 'mode2.npz')
    ckpt.adagrad_optimize_resumable(100, obj, init, checkpoint_path=path2,
                                    key=jax.random.PRNGKey(0),
                                    save_every=50, return_history=False)
    with pytest.raises(ValueError, match='return_history=False'):
        ckpt.adagrad_optimize_resumable(100, obj, init,
                                        checkpoint_path=path2,
                                        key=jax.random.PRNGKey(0),
                                        save_every=50)


def test_resumable_rejects_changed_hyperparameters(tmp_path):
    """Round-4 review: the resume validation checked shapes and the PRNG
    key but not the optimizer hyperparameters, so resuming a run at a
    different learning rate silently spliced two schedules into one
    'smoothed' trajectory.  Both resumable drivers must reject it."""
    import viabel_tpu.checkpoint as ckpt
    from viabel_tpu import rmsprop_IA_optimize_with_rhat
    from viabel_tpu.optimizers import adam_IA_optimize_with_rhat

    fam = mean_field_gaussian_variational_family(1)
    log_density = _gaussian_target(jnp.asarray([0.5]), jnp.asarray([0.0]))
    obj = black_box_klvi(fam, log_density, 20)
    init = jnp.zeros(2, dtype=jnp.float64)
    key = jax.random.PRNGKey(0)

    path = str(tmp_path / 'hp.npz')
    ckpt.adagrad_optimize_resumable(100, obj, init, checkpoint_path=path,
                                    key=key, save_every=50,
                                    learning_rate=0.01)
    with pytest.raises(ValueError, match='learning_rate'):
        ckpt.adagrad_optimize_resumable(100, obj, init,
                                        checkpoint_path=path, key=key,
                                        save_every=50, learning_rate=0.05)
    with pytest.raises(ValueError, match='learning_rate_end'):
        ckpt.adagrad_optimize_resumable(100, obj, init,
                                        checkpoint_path=path, key=key,
                                        save_every=50, learning_rate=0.01,
                                        learning_rate_end=0.001)
    # the original values resume fine (completed run: no-op segments)
    ckpt.adagrad_optimize_resumable(100, obj, init, checkpoint_path=path,
                                    key=key, save_every=50,
                                    learning_rate=0.01)

    # the segmented chains driver: same gap, plus the update-rule kind —
    # resuming an RMSProp checkpoint with the Adam driver must fail
    path2 = str(tmp_path / 'hp_chains.npz')
    rmsprop_IA_optimize_with_rhat(60, obj, init, 1, key=key,
                                  n_optimisers=2, rhat_window=20,
                                  tail_avg_iters=20, checkpoint_path=path2,
                                  save_every=30, learning_rate=0.01)
    with pytest.raises(ValueError, match='learning_rate'):
        rmsprop_IA_optimize_with_rhat(60, obj, init, 1, key=key,
                                      n_optimisers=2, rhat_window=20,
                                      tail_avg_iters=20,
                                      checkpoint_path=path2,
                                      save_every=30, learning_rate=0.02)
    with pytest.raises(ValueError, match='kind'):
        adam_IA_optimize_with_rhat(60, obj, init, 1, key=key,
                                   n_optimisers=2, rhat_window=20,
                                   tail_avg_iters=20,
                                   checkpoint_path=path2,
                                   save_every=30, learning_rate=0.01)


def test_resumable_accepts_typed_prng_keys(tmp_path):
    """Round-4 review: the checkpoint templates' bare np.asarray(key)
    crashed for typed keys (`jax.random.key`); the key-data view handles
    both flavors, and the two flavors' checkpoints are interchangeable
    (identical stored uint32 data for the same seed)."""
    import viabel_tpu.checkpoint as ckpt
    from viabel_tpu import rmsprop_IA_optimize_with_rhat

    fam = mean_field_gaussian_variational_family(1)
    log_density = _gaussian_target(jnp.asarray([0.5]), jnp.asarray([0.0]))
    obj = black_box_klvi(fam, log_density, 20)
    init = jnp.zeros(2, dtype=jnp.float64)

    path = str(tmp_path / 'typed.npz')
    out_t = ckpt.adagrad_optimize_resumable(100, obj, init,
                                            checkpoint_path=path,
                                            key=jax.random.key(0),
                                            save_every=50)
    # the old-style flavor of the same seed resumes the typed-key
    # checkpoint (completed run: validation passes, no-op segments)
    out_o = ckpt.adagrad_optimize_resumable(100, obj, init,
                                            checkpoint_path=path,
                                            key=jax.random.PRNGKey(0),
                                            save_every=50)
    np.testing.assert_array_equal(np.asarray(out_t[0]),
                                  np.asarray(out_o[0]))

    # the segmented IA chains driver with a typed key
    path2 = str(tmp_path / 'typed_chains.npz')
    out = rmsprop_IA_optimize_with_rhat(
        60, obj, init, 1, key=jax.random.key(1), n_optimisers=2,
        rhat_window=20, tail_avg_iters=20, checkpoint_path=path2,
        save_every=30)
    assert np.all(np.isfinite(out[1]))


def test_throughput_meter():
    from viabel_tpu.utils import ThroughputMeter
    meter = ThroughputMeter(reps=2)
    f = jax.jit(lambda x: x * 2.0)
    out, rec = meter.measure('double', f, jnp.ones(16), iters=100,
                             evals_per_iter=10, samples=1000)
    assert rec['it_per_s'] > 0
    np.testing.assert_allclose(rec['evals_per_s'], rec['it_per_s'] * 10,
                               rtol=1e-9)
    assert 'double' in meter.report()


def test_native_backend_matches_jax_model():
    from viabel_tpu.native import (build_native_library,
                                   native_eight_schools_cp_log_density)
    try:
        build_native_library()
    except RuntimeError:
        pytest.skip('no C++ toolchain available')
    from viabel_tpu.models import eight_schools_cp_model
    native = native_eight_schools_cp_log_density()
    model = eight_schools_cp_model()
    x = np.random.RandomState(2).randn(6, 10)
    np.testing.assert_allclose(np.asarray(native(jnp.asarray(x))),
                               np.asarray(model.log_prob(jnp.asarray(x))),
                               rtol=1e-10)
    g_native = jax.grad(lambda z: jnp.sum(native(z)))(jnp.asarray(x))
    g_jax = jax.grad(lambda z: jnp.sum(model.log_prob(z)))(jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(g_native), np.asarray(g_jax),
                               rtol=1e-8)


@pytest.mark.slow
def test_native_backend_in_full_vi_loop():
    """The native C++ density drives a complete KLVI optimization — the
    reference's Stan-bridge workflow (reference: viabel/vb.py:314-321 +
    notebooks/robust-regression.ipynb cell 13) with a real native backend."""
    from viabel_tpu.native import (build_native_library,
                                   native_eight_schools_cp_log_density)
    try:
        build_native_library()
    except RuntimeError:
        pytest.skip('no C++ toolchain available')
    from viabel_tpu import mean_field_t_variational_family
    native = native_eight_schools_cp_log_density()
    fam = mean_field_t_variational_family(10, 40)
    obj = black_box_klvi(fam, native, 20)
    init = jnp.zeros(20, dtype=jnp.float64)
    opt, _, values, _ = adagrad_optimize(100, obj, init,
                                         key=jax.random.PRNGKey(4),
                                         learning_rate=.05)
    assert np.all(np.isfinite(np.asarray(opt)))
    assert np.mean(np.asarray(values)[-20:]) < np.mean(
        np.asarray(values)[:20])


def _write_trace(root, events):
    import gzip
    import json
    d = root / 'plugins' / 'profile' / 'run1'
    d.mkdir(parents=True)
    with gzip.open(str(d / 'host.trace.json.gz'), 'wt') as f:
        json.dump({'traceEvents': events}, f)


def test_trace_device_time_parses_perfetto_json(tmp_path):
    """trace_device_time reads a GPU capture's layout (one process per
    device, one thread per CUDA stream): busy time is the union of the
    device's kernel/copy intervals — overlap across streams counts once —
    and host events are excluded."""
    from viabel_tpu.utils import trace_device_time
    events = [
        {'ph': 'M', 'pid': 1, 'name': 'process_name',
         'args': {'name': '/device:GPU:0'}},
        {'ph': 'M', 'pid': 1, 'tid': 13, 'name': 'thread_name',
         'args': {'name': 'Stream #13(MemcpyD2D,Compute)'}},
        {'ph': 'M', 'pid': 1, 'tid': 14, 'name': 'thread_name',
         'args': {'name': 'Stream #14(MemcpyH2D)'}},
        {'ph': 'M', 'pid': 701, 'name': 'process_name',
         'args': {'name': '/host:CPU'}},
        {'ph': 'M', 'pid': 701, 'tid': 9, 'name': 'thread_name',
         'args': {'name': 'python'}},
        # compute stream: kernels at [100, 105) and [110, 117)
        {'ph': 'X', 'pid': 1, 'tid': 13, 'ts': 100.0, 'dur': 5.0,
         'name': 'loop_add_fusion'},
        {'ph': 'X', 'pid': 1, 'tid': 13, 'ts': 110.0, 'dur': 7.0,
         'name': 'input_reduce_fusion'},
        # a copy overlapping the first kernel by 2 us: adds 1 us
        {'ph': 'X', 'pid': 1, 'tid': 14, 'ts': 103.0, 'dur': 3.0,
         'name': 'MemcpyH2D'},
        # host events never count
        {'ph': 'X', 'pid': 701, 'tid': 9, 'ts': 90.0, 'dur': 100.0,
         'name': 'python'},
    ]
    _write_trace(tmp_path, events)
    assert trace_device_time(str(tmp_path)) == pytest.approx(13.0 / 1e6)


def test_trace_device_time_reads_recorded_h100_trace():
    """A capture recorded on an H100 (NVIDIA H100 80GB HBM3, 700 W) around
    one 2.5e6-sample eight-schools draw+score pass, reduced to its device
    process plus one host event: 2.798 ms of kernels and copies on two
    streams, whose small overlap counts once."""
    from viabel_tpu.utils import trace_device_time
    here = os.path.dirname(os.path.abspath(__file__))
    busy = trace_device_time(os.path.join(here, 'data', 'h100_trace'))
    assert busy == pytest.approx(2797.656e-6, rel=1e-6)


def test_trace_device_time_raises_without_device_events(tmp_path):
    """A capture with host events only (a CPU-backend trace) or no capture
    at all is an error, not a zero device time."""
    from viabel_tpu.utils import trace_device_time
    _write_trace(tmp_path, [
        {'ph': 'M', 'pid': 701, 'name': 'process_name',
         'args': {'name': '/host:CPU'}},
        {'ph': 'X', 'pid': 701, 'tid': 9, 'ts': 0.0, 'dur': 10.0,
         'name': 'python'}])
    with pytest.raises(ValueError, match='no device events'):
        trace_device_time(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        trace_device_time(str(tmp_path / 'nothing'))


def test_native_library_keyed_on_sources_and_flags(tmp_path, monkeypatch):
    """The native library's file name is a function of the source text,
    the compiler flags and the architecture: editing a source or changing
    a flag names a different file, so a stale or foreign build is never
    loaded; the build directory is git-ignored."""
    import viabel_tpu.native as nat
    srcs = []
    for src in nat._SRCS:
        dst = tmp_path / os.path.basename(src)
        dst.write_bytes(open(src, 'rb').read())
        srcs.append(str(dst))
    monkeypatch.setattr(nat, '_SRCS', srcs)
    base = nat._library_path(nat._FLAGS)
    assert base == nat._library_path(tuple(nat._FLAGS))
    assert os.path.dirname(base) == nat._BUILD_DIR
    assert nat._library_path(nat._FLAGS + ('-fopenmp',)) != base
    with open(srcs[0], 'a') as f:
        f.write('\n// edited\n')
    assert nat._library_path(nat._FLAGS) != base
    assert '-march=native' not in nat._FLAGS
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, '.gitignore')) as f:
        assert 'viabel_tpu/native/build/' in f.read().split()


def test_native_robust_regression_rejects_partial_data():
    """x without y (or vice versa) must error, not crash or silently use
    the notebook default for the missing half."""
    from viabel_tpu.native import native_robust_regression_log_density
    X = np.ones((5, 2))
    with pytest.raises(ValueError, match='both x and y'):
        native_robust_regression_log_density(x=X)
    with pytest.raises(ValueError, match='both x and y'):
        native_robust_regression_log_density(y=np.ones(5))
    with pytest.raises(ValueError, match='one response per row'):
        native_robust_regression_log_density(x=X, y=np.ones(4))
