"""Tests for the config system, CLI, and posterior-serving layers."""
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viabel_tpu.config import ExperimentConfig, build


def test_config_roundtrip_and_validation():
    cfg = ExperimentConfig(model='funnel', family='mean_field_t',
                           n_iters=100)
    cfg2 = ExperimentConfig.from_json(cfg.to_json())
    assert cfg2 == cfg
    with pytest.raises(ValueError):
        ExperimentConfig(model='nope')
    with pytest.raises(ValueError):
        ExperimentConfig(family='nope')
    with pytest.raises(ValueError):
        ExperimentConfig(objective='nope')


@pytest.mark.parametrize('model_name', ['funnel', 'robust_regression',
                                        'eight_schools_ncp',
                                        'linear_regression'])
def test_config_builds_all_models(model_name):
    cfg = ExperimentConfig(model=model_name, n_mc=10)
    model, family, objective = build(cfg)
    assert family.dim == model.dim
    # configs default to the presampled fast path: direct calls consume
    # base_sample draws, and a PRNG key is rejected (not silently
    # broadcast into the transform)
    assert objective.presampled
    draws = family.base_sample(jax.random.PRNGKey(0), 10)
    out = objective(family.init_param(), draws)
    assert np.isfinite(float(out[0]))
    with pytest.raises(TypeError, match='presampled'):
        objective(family.init_param(), jax.random.PRNGKey(0))


def test_config_builds_all_objectives():
    for obj_name in ('klvi', 'klvi_pd', 'klvi_pd2', 'chivi', 'chivi_neff'):
        cfg = ExperimentConfig(model='funnel', objective=obj_name, n_mc=10)
        _, family, objective = build(cfg)
        draws = family.base_sample(jax.random.PRNGKey(0), 10)
        out = objective(family.init_param(), draws)
        assert np.isfinite(float(out[0]))
    # key-consuming construction still available by config
    cfg = ExperimentConfig(model='funnel', presampled=False, n_mc=10)
    _, family, objective = build(cfg)
    out = objective(family.init_param(), jax.random.PRNGKey(0))
    assert np.isfinite(float(out[0]))


def test_cli_run_smoke(capsys):
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
          '--bound-samples', '5000', '--quiet'])
    out = capsys.readouterr().out
    assert 'posterior mean estimate' in out
    assert 'khat' in out
    assert '"presampled": true' in out
    # 5000 divides over the 8-device test pool: the plain run's bound
    # stage must shard over the sample axis too (the last mesh-blind CLI
    # path after the round-4 --fused fix)
    assert 'mesh: 8 devices on the sample axis (bound stage)' in out


def test_cli_run_no_presampled(capsys):
    """--no-presampled routes the key-threaded (in-scan sampling) path."""
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
          '--bound-samples', '5000', '--quiet', '--no-presampled'])
    out = capsys.readouterr().out
    assert '"presampled": false' in out
    assert 'khat' in out


def test_cli_run_fused(capsys):
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
          '--bound-samples', '5000', '--fused'])
    out = capsys.readouterr().out
    assert 'posterior mean estimate' in out
    assert 'khat' in out
    assert 'PSIS-corrected mean' in out
    # 5000 divides over the 8-device test pool: the fused bound stage must
    # shard over the sample axis (round-3 review: --fused was mesh-blind)
    assert 'mesh: 8 devices on the sample axis' in out


def test_cli_run_fused_notes_indivisible_bound_samples(capsys):
    """900 does not divide over all 8 devices; the placement degrades to
    the largest divisor (6) instead of abandoning the mesh, and the
    degradation is surfaced (round-4 review)."""
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '100', '--n-mc', '10',
          '--bound-samples', '900', '--fused'])
    out = capsys.readouterr().out
    assert 'mesh: 900 bound samples do not divide over all 8 devices; ' \
           'degraded to 6 devices on the sample axis' in out
    assert 'khat' in out


def test_cli_run_fused_rejects_unsupported_flags():
    from viabel_tpu.__main__ import main
    with pytest.raises(SystemExit, match='bound-samples'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--bound-samples', '0', '--fused'])
    with pytest.raises(SystemExit, match='checkpoint'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--checkpoint-path', '/tmp/x.npz', '--fused'])


def test_cli_run_ia_optimizer(capsys):
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'linear_regression', '--family',
          'mean_field_gaussian', '--optimizer', 'rmsprop_ia',
          '--n-chains', '2', '--n-iters', '300', '--n-mc', '20',
          '--bound-samples', '5000', '--quiet'])
    out = capsys.readouterr().out
    assert 'iterate-averaging start' in out
    assert 'mean error' in out  # ground truth known for linear_regression


def test_cli_run_with_checkpoint(tmp_path, capsys):
    from viabel_tpu.__main__ import main
    path = str(tmp_path / 'cli_ckpt.npz')
    main(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
          '--bound-samples', '2000', '--checkpoint-path', path, '--quiet'])
    import os
    assert os.path.exists(path)
    from viabel_tpu.checkpoint import load_checkpoint_entry
    assert load_checkpoint_entry(path, 'param').shape == (4,)


def test_cli_configs(capsys):
    from viabel_tpu.__main__ import main
    main(['configs'])
    cfg = json.loads(capsys.readouterr().out)
    assert cfg['model'] == 'funnel'


def test_posterior_service_endpoints():
    from viabel_tpu.serve import PosteriorService, start_server
    from viabel_tpu import mean_field_gaussian_variational_family
    from viabel_tpu.models import funnel_model

    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    var_param = jnp.asarray([0.0, 0.0, -0.4, -0.4], dtype=jnp.float64)
    service = PosteriorService(model, fam, var_param)

    # direct API
    s = service.sample(100)
    assert s.shape == (100, 2)
    m = service.moments()
    np.testing.assert_allclose(m['mean'], [0.0, 0.0], atol=1e-12)
    lp = service.log_prob([[0.0, 0.0]])
    assert np.isfinite(lp).all()
    b = service.bounds(20000)
    assert 'W2' in b and 'd2' in b and 'khat' in b

    # HTTP surface
    httpd, t = start_server(service, port=0)
    port = httpd.server_address[1]
    base = 'http://127.0.0.1:{}'.format(port)
    try:
        health = json.loads(urllib.request.urlopen(base + '/health').read())
        assert health['status'] == 'ok' and health['dim'] == 2
        got = json.loads(
            urllib.request.urlopen(base + '/sample?n=5').read())
        assert np.asarray(got['samples']).shape == (5, 2)
        mom = json.loads(urllib.request.urlopen(base + '/moments').read())
        assert len(mom['mean']) == 2
        req = urllib.request.Request(
            base + '/log_prob',
            data=json.dumps({'x': [[0.0, 0.0]]}).encode(),
            headers={'Content-Type': 'application/json'})
        lp = json.loads(urllib.request.urlopen(req).read())
        assert np.isfinite(lp['log_prob']).all()
        # server-side fused re-fit: runs validated_vi and swaps in the fit
        req = urllib.request.Request(
            base + '/fit',
            data=json.dumps({'n_iters': 500, 'n_mc_samples': 50,
                             'n_bound_samples': 20000}).encode(),
            headers={'Content-Type': 'application/json'})
        fit = json.loads(urllib.request.urlopen(req).read())
        assert 'khat' in fit and 'd2' in fit['bounds']
        assert np.isfinite(fit['bounds']['d2'])
        # the served posterior now reflects the new fit
        assert not np.allclose(service.moments()['cov'], m['cov'])
        np.testing.assert_allclose(service.moments()['mean'], fit['mean'])
        for bad_body in (json.dumps({'bogus': 1}),      # unknown option
                         json.dumps({'n_bound_samples': 0}),  # bad value
                         # n_iters * n_mc_samples above max_fit_evals: the
                         # presampled pipeline would materialize an
                         # (n_iters, n_mc, dim) draw array
                         json.dumps({'n_iters': 1000,
                                     'n_mc_samples': 1000000}),
                         '"abc"', '[1, 2]'):            # non-object payload
            bad_fit = urllib.request.Request(
                base + '/fit', data=bad_body.encode(),
                headers={'Content-Type': 'application/json'})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bad_fit)
            assert e.value.code == 400, bad_body
        # invalid sample/bounds sizes are rejected with 400, not silently
        # truncated to empty results or surfaced as 500s
        for bad_url in ('/sample?n=0', '/sample?n=-3', '/bounds?n=1',
                        '/bounds?n=-1',
                        # malformed input is a client error, not a 500
                        '/sample?n=abc', '/bounds?n=1e6'):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + bad_url)
            assert e.value.code == 400, bad_url
        # error paths
        for payload in (b'{}',                       # missing "x"
                        b'{"x": ["not", "numbers"]}',  # non-numeric x
                        b'{bad json'):               # malformed JSON
            bad = urllib.request.Request(
                base + '/log_prob', data=payload,
                headers={'Content-Type': 'application/json'})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(bad)
            assert e.value.code == 400, payload
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + '/nope')
        assert e.value.code == 404
    finally:
        httpd.shutdown()


def test_posterior_service_fit_limits():
    """The service bounds its compile caches: oversized fit requests are
    rejected, and only `max_distinct_fit_configs` distinct static fit
    configurations are admitted (each compiles a cached device program)."""
    from viabel_tpu.serve import PosteriorService
    from viabel_tpu import mean_field_gaussian_variational_family
    from viabel_tpu.models import funnel_model

    service = PosteriorService(
        funnel_model(), mean_field_gaussian_variational_family(2),
        jnp.asarray([0.0, 0.0, -0.4, -0.4], dtype=jnp.float64),
        max_fit_iters=1000, max_bound_samples=50000,
        max_distinct_fit_configs=2)
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.fit(n_iters=2000)
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.fit(n_iters=10, n_bound_samples=10 ** 10)
    service.fit(n_iters=50, n_mc_samples=20, n_bound_samples=1000)
    service.fit(n_iters=60, n_mc_samples=20, n_bound_samples=1000)
    # a repeat of an admitted config is fine; a third distinct one is not
    service.fit(n_iters=50, n_mc_samples=20, n_bound_samples=1000)
    with pytest.raises(ValueError, match='fit-configuration limit'):
        service.fit(n_iters=70, n_mc_samples=20, n_bound_samples=1000)
    # sample/bounds sizes are bucketed: result still has the asked size
    assert service.sample(37).shape == (37, 2)


def test_posterior_service_failed_fit_releases_config_slot():
    """A fit that fails hyperparameter validation must not permanently
    consume one of the bounded distinct-config slots."""
    from viabel_tpu.serve import PosteriorService
    from viabel_tpu import mean_field_gaussian_variational_family
    from viabel_tpu.models import funnel_model

    service = PosteriorService(
        funnel_model(), mean_field_gaussian_variational_family(2),
        jnp.asarray([0.0, 0.0, -0.4, -0.4], dtype=jnp.float64),
        max_fit_iters=1000, max_bound_samples=50000,
        max_distinct_fit_configs=2)
    for lr_end in (0.5, 0.6):  # two distinct invalid configs
        with pytest.raises(ValueError):
            service.fit(n_iters=50, n_mc_samples=20, n_bound_samples=1000,
                        learning_rate=0.01, learning_rate_end=lr_end)
    # both slots must still be free for valid configurations
    service.fit(n_iters=50, n_mc_samples=20, n_bound_samples=1000)
    service.fit(n_iters=60, n_mc_samples=20, n_bound_samples=1000)


def _make_service(**kwargs):
    from viabel_tpu.serve import PosteriorService
    from viabel_tpu import mean_field_gaussian_variational_family
    from viabel_tpu.models import funnel_model
    return PosteriorService(
        funnel_model(), mean_field_gaussian_variational_family(2),
        jnp.asarray([0.0, 0.0, -0.4, -0.4], dtype=jnp.float64), **kwargs)


def test_fit_busy_rejected_not_queued():
    """A concurrent /fit is rejected with ServiceBusyError (HTTP 503), not
    silently queued behind the running one."""
    import urllib.error
    from viabel_tpu.serve import ServiceBusyError, start_server

    service = _make_service()
    # deterministically simulate an in-flight fit
    assert service._fit_lock.acquire(blocking=False)
    try:
        with pytest.raises(ServiceBusyError, match='already running'):
            service.fit(n_iters=10, n_mc_samples=10, n_bound_samples=1000)
        httpd, _ = start_server(service, port=0)
        base = 'http://127.0.0.1:{}'.format(httpd.server_address[1])
        try:
            req = urllib.request.Request(
                base + '/fit',
                data=json.dumps({'n_iters': 10, 'n_mc_samples': 10,
                                 'n_bound_samples': 1000}).encode(),
                headers={'Content-Type': 'application/json'})
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 503
        finally:
            httpd.shutdown()
    finally:
        service._fit_lock.release()
    # once released, the same request succeeds
    out = service.fit(n_iters=10, n_mc_samples=10, n_bound_samples=1000)
    assert np.isfinite(out['bounds']['d2'])


def test_log_prob_bucket_clamped_to_limit():
    """The padded /log_prob batch never exceeds max_bound_samples even when
    the power-of-two bucket would (n=600 would pad to 1024)."""
    service = _make_service(max_bound_samples=1000)
    x = np.random.RandomState(0).randn(600, 2)
    lp = service.log_prob(x)
    assert lp.shape == (600,)
    from viabel_tpu import mean_field_gaussian_variational_family
    fam = mean_field_gaussian_variational_family(2)
    expected = np.asarray(fam.log_prob(service.var_param,
                                       jnp.asarray(x, dtype=jnp.float32)))
    np.testing.assert_allclose(lp, expected, rtol=1e-5)
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.log_prob(np.zeros((1001, 2)))


def test_sample_bucket_clamped_to_limit():
    """/sample's draw bucket never exceeds max_bound_samples even when the
    power-of-two bucket would (round-4 review: n=600 on a limit of 1000
    drew a 1024-sample program, ~2x past the cap for n just under it),
    mirroring the /log_prob clamp above."""
    service = _make_service(max_bound_samples=1000)
    drawn = []
    real_sample = service._sample
    service._sample = lambda key, vp, n: drawn.append(n) or real_sample(
        key, vp, n)
    out = service.sample(600)
    assert out.shape == (600, 2)
    assert drawn == [1000]
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.sample(1001)


def test_param_from_checkpoint_kinds(tmp_path):
    """`serve --param` disambiguates checkpoint kinds: the multichain IA
    checkpoint's (n_chains, P) 'params' entry must NOT be tail-averaged by
    iteration index (that yields an all-NaN served parameter)."""
    from viabel_tpu.serve import _param_from_checkpoint
    from viabel_tpu import (black_box_klvi,
                            mean_field_gaussian_variational_family,
                            rmsprop_IA_optimize_with_rhat)
    from viabel_tpu.checkpoint import adagrad_optimize_resumable
    from viabel_tpu.models import funnel_model

    model = funnel_model()
    fam = mean_field_gaussian_variational_family(2)
    obj = black_box_klvi(fam, model.log_prob, 10)
    init = fam.init_param()

    # multichain IA checkpoint (the CLI's rmsprop_ia --checkpoint-path path)
    multi = str(tmp_path / 'multi.npz')
    out = rmsprop_IA_optimize_with_rhat(
        60, obj, init, 2, n_optimisers=2, rhat_window=20, tail_avg_iters=20,
        checkpoint_path=multi, save_every=30)
    vp = _param_from_checkpoint(multi)
    assert vp.shape == (4,)
    assert np.all(np.isfinite(vp)), 'multichain checkpoint served NaN'
    # it equals the tail-quarter mean of the retained chain history
    chains = np.asarray(out[1])
    np.testing.assert_allclose(
        vp, chains[:, 3 * chains.shape[1] // 4:].mean(axis=(0, 1)),
        rtol=1e-6)

    # adagrad resumable checkpoint: tail-quarter mean of the iterate history
    single = str(tmp_path / 'single.npz')
    sm, _, _, _ = adagrad_optimize_resumable(
        40, obj, init, checkpoint_path=single, save_every=20)
    np.testing.assert_allclose(_param_from_checkpoint(single),
                               np.asarray(sm), rtol=1e-6)

    # no-history (return_history=False) adagrad resumable checkpoint: the
    # served parameter is the tail-sum mean — the same smoothed fit the
    # driver returns (round-4 review: this format used to fall through to
    # the raw last iterate)
    lean = str(tmp_path / 'lean.npz')
    sm2, hist2, _, _ = adagrad_optimize_resumable(
        40, obj, init, checkpoint_path=lean, save_every=20,
        return_history=False)
    assert hist2 is None
    np.testing.assert_allclose(_param_from_checkpoint(lean),
                               np.asarray(sm2), rtol=1e-6)

    # a no-history checkpoint saved BEFORE tail averaging starts serves
    # the current iterate (the tail sum is still all zeros)
    from viabel_tpu.checkpoint import save_checkpoint
    partial = str(tmp_path / 'partial.npz')
    cur = np.full(4, 7.0)
    save_checkpoint(partial, dict(
        i=np.asarray(10), key=np.zeros(2, np.uint32), param=cur,
        grads=np.zeros((10, 4)), log_norms=np.zeros(10),
        values=np.zeros(40), lns=np.zeros(40), tail_sum=np.zeros(4)))
    np.testing.assert_allclose(_param_from_checkpoint(partial), cur)

    # plain npz with a single parameter vector
    raw = str(tmp_path / 'raw.npz')
    np.savez(raw, w=np.asarray(init))
    np.testing.assert_allclose(_param_from_checkpoint(raw),
                               np.asarray(init))

    # round-5: every writer stamps an explicit self-describing `format`
    # entry, dispatched in ONE shared helper; the name heuristics survive
    # only as the legacy fallback for pre-format checkpoints
    from viabel_tpu.checkpoint import (FORMAT_ADAGRAD_HISTORY,
                                       FORMAT_ADAGRAD_TAIL, FORMAT_CHAINS,
                                       checkpoint_format)
    assert checkpoint_format(multi) == FORMAT_CHAINS
    assert checkpoint_format(single) == FORMAT_ADAGRAD_HISTORY
    assert checkpoint_format(lean) == FORMAT_ADAGRAD_TAIL
    # the hand-written 'partial' file has no format entry -> legacy
    # heuristic identifies it; a bare parameter npz is no format at all
    assert checkpoint_format(partial) == FORMAT_ADAGRAD_TAIL
    assert checkpoint_format(raw) is None
    # an unknown explicit id (a future format) errors instead of silently
    # falling through to the heuristics
    unknown = str(tmp_path / 'unknown.npz')
    save_checkpoint(unknown, dict(format=np.asarray('chains/v999'),
                                  param=cur))
    with pytest.raises(ValueError, match='declares format'):
        checkpoint_format(unknown)


def test_bounds_fall_back_for_df_le_4_families(monkeypatch, capsys):
    """Round-4 review: a Student-t family with 2 < df <= 4 has no finite
    closed-form 4th moment and `family_moment_bounds` raised out of serve
    /bounds and the CLI bound stage; it now returns None and every bound
    pass falls back to empirical central moments of the bound samples."""
    from viabel_tpu import mean_field_t_variational_family
    from viabel_tpu.bounds import family_moment_bounds
    from viabel_tpu.models import funnel_model
    from viabel_tpu.serve import PosteriorService

    fam = mean_field_t_variational_family(2, 3.0)
    vp = jnp.asarray([0.0, 0.0, -0.3, -0.3], dtype=jnp.float64)
    assert family_moment_bounds(fam, vp) is None

    service = PosteriorService(funnel_model(), fam, vp)
    out = service.bounds(65536)          # sharded (8-device) branch
    assert np.isfinite(out['log_norm_bound']) and np.isfinite(out['khat'])
    monkeypatch.setattr(service, '_fit_mesh', lambda *a: None)
    out1 = service.bounds(65536)         # unsharded branch
    assert np.isfinite(out1['log_norm_bound']) and np.isfinite(out1['khat'])

    # the CLI bound stage end to end with the same family
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--df', '3', '--n-iters', '100',
          '--n-mc', '10', '--bound-samples', '4000'])
    assert 'khat' in capsys.readouterr().out


def test_serve_json_sanitizes_nonfinite():
    """Round-4 review: a vacuous bound (inf) or degenerate khat (NaN) must
    still serialize as valid RFC-8259 JSON — `Infinity`/`NaN` tokens break
    strict clients on exactly the responses reporting the vacuous case.
    Round-5 advisor: the replacement must keep a STABLE per-field schema
    (`number | null`), never change a field's JSON type to string on the
    degenerate responses."""
    import math

    from viabel_tpu.serve import _null_nonfinite
    obj = dict(bounds=dict(W2=math.inf, d2=0.5, mean_error=-math.inf),
               khat=math.nan, xs=[1.0, math.inf])
    body = json.dumps(_null_nonfinite(obj), allow_nan=False)
    back = json.loads(body)
    assert back['bounds'] == dict(W2=None, d2=0.5, mean_error=None)
    assert back['khat'] is None
    assert back['xs'] == [1.0, None]


def test_service_sample_is_capped():
    """Round-4 review: the resource guard must live in the service class
    (the docstring's contract), not only in the HTTP handler's clamp."""
    service = _make_service()
    with pytest.raises(ValueError, match='exceeds the service limit'):
        service.sample(service.max_bound_samples + 1)


def test_serve_fit_from_config_honors_optimizer():
    """Round-4 review: `serve --config` without --param used to silently
    fit with adagrad on an unsplit key regardless of cfg.optimizer; the
    fit must mirror the CLI (same optimizer, same 3-way key split) so one
    config yields one posterior from either entry point."""
    import jax

    from viabel_tpu import adagrad_optimize
    from viabel_tpu.config import ExperimentConfig, build
    from viabel_tpu.serve import _fit_from_config

    cfg = ExperimentConfig(model='funnel', family='mean_field_gaussian',
                           optimizer='rmsprop_ia', n_chains=2,
                           n_iters=300, n_mc=10)
    model, family, objective = build(cfg)
    vp = _fit_from_config(cfg, model, family, objective)
    assert np.all(np.isfinite(np.asarray(vp)))

    cfg2 = ExperimentConfig(model='funnel', family='mean_field_gaussian',
                            n_iters=80, n_mc=10)
    model2, family2, objective2 = build(cfg2)
    vp2 = _fit_from_config(cfg2, model2, family2, objective2)
    opt_key, _, _ = jax.random.split(jax.random.PRNGKey(cfg2.seed), 3)
    ref = adagrad_optimize(80, objective2, family2.init_param(),
                           key=opt_key,
                           learning_rate=cfg2.learning_rate)[0]
    np.testing.assert_array_equal(np.asarray(vp2), np.asarray(ref))


def test_cli_run_multistart(capsys):
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
          '--bound-samples', '4000', '--starts', '4',
          '--perturb-scale', '0.1'])
    out = capsys.readouterr().out
    assert 'start 0 (unperturbed)' in out
    assert 'best by validated d2 bound' in out
    assert 'khat =' in out
    # 4 starts on the 8-device test pool: the shared auto_mesh rule places
    # them on a (4, 2) (chain, sample) mesh — the round-4 review closed
    # the gap where the CLI ran this single-device while serve partitioned
    assert 'mesh: (4x2) (chain, sample) mesh' in out


def test_cli_run_multistart_uses_mesh_when_divisible(capsys):
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '100', '--n-mc', '10',
          '--bound-samples', '4000', '--starts', '8',
          '--perturb-scale', '0.1'])
    out = capsys.readouterr().out
    assert 'mesh: 8 devices on the chain axis' in out
    assert 'best by validated d2 bound' in out


def test_cli_run_multistart_no_common_factor_says_so(capsys):
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '100', '--n-mc', '10',
          '--bound-samples', '4000', '--starts', '3',
          '--perturb-scale', '0.1'])
    out = capsys.readouterr().out
    # gcd(3, 8) == 1: the starts stay vmapped (chain axis of 1) but the
    # bound passes still shard 8-way — and the placement is surfaced
    # (round-4 review: this used to abandon the mesh entirely)
    assert 'mesh: (1x8) (chain, sample) mesh: 3 runs per device group, ' \
           'bound passes 8-way sharded' in out
    assert 'best by validated d2 bound' in out


def test_cli_run_sweep(capsys):
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
          '--bound-samples', '4000', '--sweep-lr', '0.1,0.01'])
    out = capsys.readouterr().out
    assert 'lr 0.1' in out and 'lr 0.01' in out
    assert 'best by validated d2 bound' in out
    # 2 rates on the 8-device test pool take a (2, 4) (chain, sample)
    # mesh via the shared auto_mesh rule
    assert 'mesh: (2x4) (chain, sample) mesh' in out


def test_cli_run_sweep_uses_mesh_when_divisible(capsys):
    from viabel_tpu.__main__ import main
    main(['run', '--model', 'funnel', '--n-iters', '100', '--n-mc', '10',
          '--bound-samples', '4000', '--sweep-lr',
          '0.1,0.07,0.05,0.03,0.02,0.01,0.007,0.005'])
    out = capsys.readouterr().out
    assert 'mesh: 8 devices on the chain axis (rate axis)' in out
    assert 'best by validated d2 bound' in out


def test_cli_run_batched_flag_validation():
    from viabel_tpu.__main__ import main
    with pytest.raises(SystemExit, match='mutually exclusive'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--starts', '2', '--sweep-lr', '0.1,0.01'])
    with pytest.raises(SystemExit, match='adagrad'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--optimizer', 'adam_ia', '--starts', '2'])
    with pytest.raises(SystemExit, match='checkpoint'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--starts', '2', '--checkpoint-path', '/tmp/x.npz'])
    with pytest.raises(SystemExit, match='bound-samples'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--starts', '2', '--bound-samples', '0'])


def test_posterior_service_fit_multistart():
    """/fit with n_starts > 1 runs the fused multistart pipeline and swaps
    in the best start."""
    service = _make_service()
    out = service.fit(n_iters=300, n_mc_samples=20, n_bound_samples=4000,
                      n_starts=4, perturb_scale=0.1)
    assert out['n_starts'] == 4
    assert 0 <= out['best'] < 4
    assert np.isfinite(out['bounds']['d2'])
    # the served posterior reflects the winning start
    np.testing.assert_allclose(service.moments()['mean'], out['mean'])
    # resource limits account for the start multiplier
    with pytest.raises(ValueError, match='n_starts \\* n_bound_samples'):
        service.fit(n_iters=10, n_mc_samples=10, n_bound_samples=2000000,
                    n_starts=4)
    with pytest.raises(ValueError, match='must all be positive'):
        service.fit(n_starts=0)


def test_posterior_service_fit_uses_mesh(monkeypatch):
    """On a multi-device host /fit must exploit the attached devices
    (round-3 review: the service ran the vmapped multistart single-device
    while the CLI partitioned).  4 starts on the 8-device pool take a
    (4, 2) (chain, sample) mesh; a single-start fit takes the full
    8-device sample mesh; indivisible sizes degrade to the largest
    usable placement instead of abandoning the mesh."""
    import viabel_tpu.pipeline as pl
    service = _make_service()

    # the placement rule itself
    mesh = service._fit_mesh(4, 4000)
    assert mesh is not None and dict(zip(mesh.axis_names, mesh.devices.shape)) \
        == {'chain': 4, 'sample': 2}
    mesh1 = service._fit_mesh(1, 4000)
    assert mesh1 is not None and mesh1.devices.shape == (8,)
    # degradations (round-4 review: indivisible sizes used to abandon the
    # mesh entirely): gcd(3, 8) == 1 still shards the bound passes 8-way
    # on a (1, 8) mesh, and 4001 odd samples degrade the sample axis to 1
    # while keeping the (4, 1) chain placement
    mesh3 = service._fit_mesh(3, 4000)
    assert dict(zip(mesh3.axis_names, mesh3.devices.shape)) \
        == {'chain': 1, 'sample': 8}
    mesh41 = service._fit_mesh(4, 4001)
    assert dict(zip(mesh41.axis_names, mesh41.devices.shape)) \
        == {'chain': 4, 'sample': 1}
    # 4001 is prime: a single run has no usable sample axis at all
    assert service._fit_mesh(1, 4001) is None

    # the mesh actually reaches the pipeline calls
    seen = {}
    real_ms = pl.validated_vi_multistart
    real_single = pl.validated_vi

    def spy_ms(*args, **kwargs):
        seen['ms_mesh'] = kwargs.get('mesh')
        return real_ms(*args, **kwargs)

    def spy_single(*args, **kwargs):
        seen['vi_mesh'] = kwargs.get('mesh')
        return real_single(*args, **kwargs)

    monkeypatch.setattr(pl, 'validated_vi_multistart', spy_ms)
    monkeypatch.setattr(pl, 'validated_vi', spy_single)
    out = service.fit(n_iters=200, n_mc_samples=20, n_bound_samples=4000,
                      n_starts=4, perturb_scale=0.1)
    assert seen['ms_mesh'] is not None
    assert np.isfinite(out['bounds']['d2'])
    out1 = service.fit(n_iters=200, n_mc_samples=20, n_bound_samples=4000)
    assert seen['vi_mesh'] is not None
    assert np.isfinite(out1['bounds']['d2'])


def test_posterior_service_bounds_uses_mesh(monkeypatch):
    """/bounds on a multi-device host shards the MC pass over the sample
    axis (the last mesh-blind endpoint after round 3's /fit fix) and
    returns the same statistics the single-device path computes (same
    estimator, different draw partitioning -> MC-level agreement)."""
    import viabel_tpu.parallel as par
    service = _make_service()
    called = {}
    real = par.sharded_bound_psis

    def spy(*args, **kwargs):
        called['mesh'] = args[5] if len(args) > 5 else kwargs.get('mesh')
        return real(*args, **kwargs)

    # round 5: /bounds runs the FUSED single-program pass
    monkeypatch.setattr(par, 'sharded_bound_psis', spy)
    out = service.bounds(65536)  # power-of-two bucket divides 8 devices
    assert called['mesh'] is not None
    assert np.isfinite(out['d2']) and np.isfinite(out['khat'])
    assert {'W1', 'W2', 'mean_error', 'd2', 'khat'} <= set(out)

    # single-device agreement at MC level: run the unsharded estimator on
    # the same service state
    from viabel_tpu.bounds import all_bounds, family_moment_bounds
    var_param, _, cov = service._snapshot()
    import jax
    _, lw = service._lw(var_param, jax.random.PRNGKey(0), 65536)
    ref = all_bounds(lw, q_var=cov,
                     moment_bound_fn=family_moment_bounds(service.family,
                                                          var_param))
    # d2/W2 are tail-dominated and can swing by factors between draw
    # schemes (the test_multistart_2d_mesh lesson); the log-normalizer
    # bound is the concentrated statistic
    assert out['log_norm_bound'] == pytest.approx(
        float(ref['log_norm_bound']), rel=0.05, abs=0.05)


def test_cli_run_batched_input_validation():
    """Review findings: --starts <= 0 must exit cleanly (not crash in
    MLIR / silently run single-start), and --sweep-lr-end must match the
    --sweep-lr count (not surface a raw traceback)."""
    from viabel_tpu.__main__ import main
    with pytest.raises(SystemExit, match='positive'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--starts', '-2'])
    with pytest.raises(SystemExit, match='positive'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--starts', '0'])
    with pytest.raises(SystemExit, match='one end rate per'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--sweep-lr', '0.1,0.01', '--sweep-lr-end', '0.001'])
    with pytest.raises(SystemExit, match='empty list'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--sweep-lr', ','])


def test_cli_run_sweep_single_lr_end_broadcasts(capsys, monkeypatch):
    """--learning-rate-end without --sweep-lr-end applies to every swept
    rate instead of being silently ignored — verified by capturing the
    learning_rate_ends actually passed to validated_vi_sweep."""
    import viabel_tpu.pipeline as pipeline
    from viabel_tpu.__main__ import main
    seen = {}
    real = pipeline.validated_vi_sweep

    def spy(*args, **kw):
        seen['learning_rate_ends'] = kw.get('learning_rate_ends')
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, 'validated_vi_sweep', spy)
    main(['run', '--model', 'funnel', '--n-iters', '200', '--n-mc', '10',
          '--bound-samples', '4000', '--sweep-lr', '0.1,0.01',
          '--learning-rate-end', '0.001'])
    assert seen['learning_rate_ends'] == [0.001, 0.001]
    out = capsys.readouterr().out
    assert 'lr 0.1' in out and 'best by validated d2 bound' in out


def test_cli_run_sweep_lr_end_dominance_validated():
    """A broadcast end rate >= one of the swept rates exits cleanly
    instead of surfacing validated_vi_sweep's ValueError traceback."""
    from viabel_tpu.__main__ import main
    with pytest.raises(SystemExit, match='0 < end < rate'):
        main(['run', '--model', 'funnel', '--n-iters', '100',
              '--sweep-lr', '0.1,0.001', '--learning-rate-end', '0.001'])
