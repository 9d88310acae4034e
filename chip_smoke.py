"""Bring-up check: the validated-VI main path on NVIDIA GPUs.

Runs in ONE process, through the entry points a user calls, at the
reference protocol's sizes:

0. device gate: a GPU or nothing (no CPU fallback);
1. the flagship fused fit (eight-schools centered, mean-field t(40), KLVI,
   n_mc = 100, 10,000 iterations, 2.5e6 bound samples) through
   `config.build` + `validated_vi`, compared with the same call on the
   host CPU; the CLI's ``run --fused`` and its progress-reporting
   non-fused path;
2. the batched and multi-call paths: 8-start multistart, adagrad ->
   draw+score -> `all_bounds` -> `psislw`, and 4-chain RMSProp-IA;
3. the d = 100 full-rank fit of `examples/large_d.py`, plus a float32
   precision check of the full-rank family against numpy float64;
4. the HTTP posterior service on a thread of this process (localhost);
5. exact checkpoint resume of the adagrad driver.

``--four-gpus`` runs only the mesh paths on four GPUs, each compared with
the same call on GPU 0 without a mesh.

Usage::

    python chip_smoke.py               # one GPU
    python chip_smoke.py --four-gpus   # four GPUs of one host

Every phase prints its results, tolerances, wall time and compile time
beside the card's name and power limit.  Any failure exits non-zero.  The
last line of standard output is::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}
"""
import argparse
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import re
import subprocess
import tempfile
import time
import urllib.request

# khat of the flagship fit: 16-seed band from benchmarks/KHAT_NOISE.md
# (eight-schools CP KLVI, f32), accepted within 3 sd
KHAT_BAND_MEAN, KHAT_BAND_SD, KHAT_BAND_NSD = 0.942, 0.047, 3.0


class SmokeFailure(AssertionError):
    """A phase's result fell outside its stated tolerance."""


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


@dataclasses.dataclass(frozen=True)
class Sizes:
    n_mc: int = 100              # KLVI gradient samples (reference protocol)
    n_iters: int = 10000         # bench.py's fused-pipeline protocol
    n_bound: int = 2500000       # bound samples (bench.py N_BOUND)
    n_starts: int = 8            # `run --starts 8`
    ia_iters: int = 11000        # examples/eight_schools_ia.py, NCP
    ia_window: int = 500
    ia_tail: int = 3000
    large_d: int = 100           # examples/large_d.py
    large_n_mc: int = 800
    large_iters: int = 10000
    large_bound: int = 1000000
    precision_n: int = 100000
    fit_iters: int = 2000        # the service's small /fit
    fit_bound: int = 100000
    resume_iters: int = 4000
    mesh_bound: int = 10000000   # --four-gpus: single fit, sharded pass
    mesh_starts: int = 4
    mesh_start_bound: int = 2500000
    perturb_scale: float = 0.5   # multistart init spread (reference scheme)
    # the flagship khat must sit in the seed band (only meaningful at the
    # protocol's sizes); sharded-vs-1-device khat is held to 2 seed sds
    check_khat_band: bool = True
    mesh_khat_tol: float = 2 * KHAT_BAND_SD


FULL = Sizes()


# ----------------------------------------------------------------- timing

_COMPILE_EVENTS = ('/jax/core/compile/jaxpr_trace_duration',
                   '/jax/core/compile/jaxpr_to_mlir_module_duration',
                   '/jax/core/compile/backend_compile_duration')
_compile_seconds = [0.0]
_listening = [False]


def _listen_compile_time():
    """Sum JAX's own trace/lower/compile durations (process-wide)."""
    if _listening[0]:
        return
    import jax.monitoring

    def on_event(name, secs, **_):
        if name in _COMPILE_EVENTS:
            _compile_seconds[0] += secs
    jax.monitoring.register_event_duration_secs_listener(on_event)
    _listening[0] = True


def run_phase(name, card, fn, *args):
    """Run one phase; print its wall and compile time beside the card."""
    _listen_compile_time()
    c0, t0 = _compile_seconds[0], time.perf_counter()
    out = fn(*args)
    wall = time.perf_counter() - t0
    print('[{}] ok: wall {:.2f} s, compile {:.2f} s  ({})'.format(
        name, wall, _compile_seconds[0] - c0, card), flush=True)
    return out


def report(label, value, tol=None, why=None):
    line = '  {}: {}'.format(label, value)
    if tol is not None:
        line += '  (tolerance {})'.format(tol)
    if why:
        line += '  -- ' + why
    print(line, flush=True)


# ------------------------------------------------------------ phase 0

def card_label():
    """`nvidia-smi` name and power limit of every card, read in a child
    process that stays off JAX."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    check(lines, 'nvidia-smi reported no GPU')
    return lines


def device_gate(n_devices=1):
    """The GPUs this run uses; exits non-zero on any other platform."""
    import jax
    devices = jax.devices()
    if devices[0].platform != 'gpu':
        raise SystemExit('chip_smoke: needs an NVIDIA GPU, but JAX found '
                         'platform {!r} ({} device(s)); there is no CPU '
                         'fallback'.format(devices[0].platform,
                                           len(devices)))
    if len(devices) < n_devices:
        raise SystemExit('chip_smoke: needs {} GPUs, JAX found {}'.format(
            n_devices, len(devices)))
    return devices[:n_devices]


# ------------------------------------------------------------ phase 1

def flagship_config(sz):
    from viabel_tpu.config import ExperimentConfig
    return ExperimentConfig(
        model='eight_schools_cp', family='mean_field_t', df=40.0,
        objective='klvi', n_mc=sz.n_mc, n_iters=sz.n_iters,
        learning_rate=0.01, learning_rate_end=0.001,
        bound_samples=sz.n_bound, seed=0)


@functools.lru_cache(maxsize=None)
def _flagship(sz):
    """(cfg, model, family, objective, optimizer key) as `run` builds them.

    Cached: the objective is a static argument of the compiled pipeline, so
    a second build would compile the same program again."""
    import jax
    from viabel_tpu.config import build
    cfg = flagship_config(sz)
    model, family, objective = build(cfg)
    opt_key = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[0]
    return cfg, model, family, objective, opt_key


def fused_fit(sz, device=None, mesh=None, n_bound=None):
    """`run --fused`'s call, with its inputs placed on `device` if given."""
    import jax
    from viabel_tpu.pipeline import validated_vi
    cfg, model, family, objective, opt_key = _flagship(sz)
    init = family.init_param()
    if device is not None:
        init, opt_key = jax.device_put((init, opt_key), device)
    return validated_vi(
        model.log_prob, family, init, cfg.n_iters,
        objective_and_grad=objective,
        n_bound_samples=n_bound or cfg.bound_samples, key=opt_key,
        learning_rate=cfg.learning_rate,
        learning_rate_end=cfg.learning_rate_end, mesh=mesh)


def _cli(argv):
    """Run ``python -m viabel_tpu`` in-process; return its stdout."""
    from viabel_tpu.__main__ import main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def _cli_khat(text):
    found = re.findall(r'^khat = ([-+0-9.einfa]+)', text, re.M)
    check(found, 'CLI printed no khat line:\n' + text[-2000:])
    return float(found[-1])


def phase_fused(sz, device, ref_device):
    """Flagship fused fit on `device` vs the same call on `ref_device`."""
    import numpy as np
    gpu = fused_fit(sz, device)
    t0 = time.perf_counter()
    again = fused_fit(sz, device)
    report('second call, compiled (bring-up observation)', '{:.3f} s, '
           'khat repeats {}'.format(time.perf_counter() - t0,
                                    'exactly' if again['khat'] == gpu['khat']
                                    else 'to {:.2g}'.format(
                                        abs(again['khat'] - gpu['khat']))))
    ref = fused_fit(sz, ref_device)
    khat, khat_ref = gpu['khat'], ref['khat']
    report('khat', '{:.4f} (reference device {:.4f})'.format(khat, khat_ref))
    check(math.isfinite(khat), 'khat is not finite')
    # Threefry draws are bit-identical across backends, so the two runs
    # see the same random numbers; what remains is transcendental
    # (exp/log/erfinv) and reduction-order rounding in float32, carried
    # through 10k stochastic-gradient steps.  On an H100 that came to
    # about 1e-5 on q_mean and khat and 1e-6 relative on d2 and W2; each
    # tolerance allows 100x or more of that while staying at a tenth of
    # the statistic's seed-to-seed spread or less, so a systematic defect
    # (a TF32 matmul, a wrong fusion) still fails.
    dq = float(np.max(np.abs(np.asarray(gpu['q_mean'])
                             - np.asarray(ref['q_mean']))))
    report('max |q_mean - reference|', '{:.3g}'.format(dq), 1e-3,
           'f32 rounding through 10k steps; posterior sds are O(1)')
    check(dq <= 1e-3, 'q_mean differs from the CPU reference')
    dk = abs(khat - khat_ref)
    report('|khat - reference|', '{:.3g}'.format(dk), 5e-3,
           'a tenth of the 16-seed sd {}'.format(KHAT_BAND_SD))
    check(dk <= 5e-3, 'khat differs from the CPU reference')
    for name in ('d2', 'W2'):
        a, b = gpu['bounds'][name], ref['bounds'][name]
        rel = abs(a - b) / max(abs(b), 1e-12)
        report('{} {:.5g} vs reference {:.5g}, rel diff'.format(name, a, b),
               '{:.3g}'.format(rel), 1e-3, 'same draws, f32 rounding')
        check(math.isfinite(a) and rel <= 1e-3,
              '{} differs from the CPU reference'.format(name))
    lo = KHAT_BAND_MEAN - KHAT_BAND_NSD * KHAT_BAND_SD
    hi = KHAT_BAND_MEAN + KHAT_BAND_NSD * KHAT_BAND_SD
    if sz.check_khat_band:
        report('khat seed band', '[{:.3f}, {:.3f}]'.format(lo, hi),
               why='benchmarks/KHAT_NOISE.md, 3 sd')
        check(lo <= khat <= hi,
              'khat {:.3f} outside the seed band'.format(khat))
    return gpu


def phase_cli(sz, fused_khat):
    """``run --fused`` and the non-fused path with in-scan progress; the
    fused command must print the khat of the library call it wraps."""
    cfg = flagship_config(sz)
    argv = ['run', '--model', cfg.model, '--family', cfg.family,
            '--df', str(cfg.df), '--n-mc', str(cfg.n_mc),
            '--n-iters', str(cfg.n_iters),
            '--learning-rate', str(cfg.learning_rate),
            '--learning-rate-end', str(cfg.learning_rate_end),
            '--bound-samples', str(cfg.bound_samples), '--seed', '0']
    fused = _cli(argv + ['--fused'])
    khat = _cli_khat(fused)
    report('CLI run --fused khat', khat, 1e-3,
           'the same program as phase 1; printed to 3 decimals')
    check(abs(khat - fused_khat) <= 1e-3, 'CLI khat differs from the '
          'library call')
    plain = _cli(argv)
    final = '{}/{}'.format(cfg.n_iters, cfg.n_iters)
    check(final in plain, 'progress never reported iteration ' + final)
    report('CLI run (progress on) khat', _cli_khat(plain),
           why='in-scan progress reached ' + final)
    return khat


# ------------------------------------------------------------ phase 2

def phase_batched(sz):
    """Multistart, the multi-call path and 4-chain RMSProp-IA."""
    import jax
    import numpy as np
    from viabel_tpu import (adagrad_optimize, all_bounds, black_box_klvi,
                            init_from_moments,
                            mean_field_gaussian_variational_family,
                            rmsprop_IA_optimize_with_rhat,
                            validated_vi_multistart)
    from viabel_tpu.bounds import family_moment_bounds
    from viabel_tpu.experiments import get_samples_and_log_weights
    from viabel_tpu.models import eight_schools_ncp_model
    from viabel_tpu.psis import psislw
    cfg, model, family, objective, opt_key = _flagship(sz)
    init = family.init_param()
    lr = dict(learning_rate=cfg.learning_rate,
              learning_rate_end=cfg.learning_rate_end)

    ms = validated_vi_multistart(
        model.log_prob, family, init, cfg.n_iters, n_starts=sz.n_starts,
        perturb_scale=sz.perturb_scale, objective_and_grad=objective,
        n_bound_samples=cfg.bound_samples, key=opt_key, **lr)
    d2 = [b['d2'] for b in ms['bounds']]
    report('multistart d2 per start', ['{:.4g}'.format(v) for v in d2])
    report('multistart khat per start',
           ['{:.3f}'.format(k) for k in ms['khat']])
    check(all(math.isfinite(v) for v in d2), 'a multistart bound is '
          'not finite')
    check(ms['best'] == int(np.argmin(d2)), 'best is not the smallest d2')
    report('multistart best', ms['best'])

    bound_key = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)[1]
    opt = adagrad_optimize(cfg.n_iters, objective, init, key=opt_key, **lr)
    _, lw = get_samples_and_log_weights(
        model.log_prob, family, opt[0], cfg.bound_samples, bound_key)
    _, cov = family.mean_and_cov(opt[0])
    res = all_bounds(lw, q_var=np.asarray(cov),
                     moment_bound_fn=family_moment_bounds(family, opt[0]))
    khat = float(psislw(lw)[1])
    report('multi-call d2 / W2 / khat', '{:.4g} / {:.4g} / {:.3f}'.format(
        res['d2'], res['W2'], khat))
    check(all(math.isfinite(res[k]) for k in ('d2', 'W2', 'mean_error'))
          and math.isfinite(khat), 'multi-call bounds are not finite')

    ncp = eight_schools_ncp_model()
    fam_g = mean_field_gaussian_variational_family(ncp.dim)
    obj = black_box_klvi(fam_g, ncp.log_prob, sz.n_mc)
    init_g = init_from_moments(fam_g, ncp.true_mean, np.diag(np.diag(
        ncp.true_cov))).astype(np.float32)
    ia = rmsprop_IA_optimize_with_rhat(
        sz.ia_iters, obj, init_g, ncp.dim, key=jax.random.PRNGKey(1),
        learning_rate=0.01, n_optimisers=4, rhat_window=sz.ia_window,
        tail_avg_iters=sz.ia_tail)
    rhat = np.asarray(ia[6]['r_hat_mean'])
    report('IA (4 chains) final-window R-hat max', '{:.4f}'.format(
        float(np.max(rhat[-1]))))
    check(rhat.size and np.all(np.isfinite(rhat)), 'R-hat is not finite')
    return ms


# ------------------------------------------------------------ phase 3

def phase_large_d(sz):
    """examples/large_d.py's protocol at d = 100, against analytic truth."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from viabel_tpu import (full_rank_gaussian_variational_family,
                            init_from_moments, validated_vi)
    from viabel_tpu.models import (data_generator_linear,
                                   linear_regression_model)
    d = sz.large_d
    data = data_generator_linear(N=4 * d, D=d, alpha=1.0,
                                 noise_variance=0.25, rho=0.5, seed=7)
    model = linear_regression_model(data['X'], data['Y'], noise_scale=0.5,
                                    prior_std=3.0)
    fam = full_rank_gaussian_variational_family(d)
    init = init_from_moments(fam, np.zeros(d),
                             3.0 ** 2 * np.eye(d)).astype(jnp.float32)
    out = validated_vi(model.log_prob, fam, init, sz.large_iters,
                       n_mc_samples=sz.large_n_mc,
                       n_bound_samples=sz.large_bound,
                       key=jax.random.PRNGKey(0), learning_rate=0.05,
                       learning_rate_end=0.001)
    err = float(np.linalg.norm(np.asarray(out['q_mean']) - model.true_mean))
    report('d = {} (P = {}) khat'.format(d, fam.var_param_dim),
           '{:+.3f}'.format(out['khat']), '< 0.7', 'PSIS certifies')
    report('|q_mean - truth|', '{:.4f}'.format(err), '< 0.05',
           'examples/large_d.py acceptance')
    check(out['khat'] < 0.7 and err < 0.05, 'large-d fit not certified')
    return out


def full_rank_precision(d, n, seed=0):
    """Max relative error of the full-rank family's `transform` and
    `log_prob` in float32 on the default device against numpy float64.
    Also returns the error of the same transform with a default-precision
    matmul, which a GPU may run in TF32."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from scipy.linalg import solve_triangular
    from viabel_tpu import full_rank_gaussian_variational_family
    from viabel_tpu.families import _unpack_chol, init_from_moments
    rs = np.random.RandomState(seed)
    a = rs.randn(d, d) / np.sqrt(d)
    cov = 0.5 * a @ a.T + 0.5 * np.eye(d)
    fam = full_rank_gaussian_variational_family(d)
    vp = init_from_moments(fam, rs.randn(d), cov).astype(jnp.float32)
    z = jax.random.normal(jax.random.PRNGKey(seed), (n, d), jnp.float32)
    x = jax.jit(fam.transform)(vp, z)
    lp = jax.jit(fam.log_prob)(vp, x)
    mu, L = (np.asarray(v, np.float64) for v in _unpack_chol(vp, d))
    z64, x64 = np.asarray(z, np.float64), np.asarray(x, np.float64)
    x_ref = mu + z64 @ L.T
    w = solve_triangular(L, (x64 - mu).T, lower=True)
    lp_ref = -0.5 * (np.sum(w * w, axis=0) + 2 * np.sum(np.log(np.diag(L)))
                     + d * np.log(2 * np.pi))
    x_default = jax.jit(lambda v, e: _unpack_chol(v, d)[0]
                        + jnp.matmul(e, _unpack_chol(v, d)[1].T))(vp, z)

    def rel(a_, b_):
        return float(np.max(np.abs(np.asarray(a_, np.float64) - b_))
                     / np.max(np.abs(b_)))
    return dict(transform=rel(x, x_ref), log_prob=rel(lp, lp_ref),
                default_matmul=rel(x_default, x_ref))


def phase_precision(sz):
    errs = full_rank_precision(sz.large_d, sz.precision_n)
    why = 'float32 level; TF32 would give about 1e-3'
    report('full-rank transform rel err vs float64',
           '{:.3g}'.format(errs['transform']), 1e-5, why)
    report('full-rank log_prob rel err vs float64',
           '{:.3g}'.format(errs['log_prob']), 1e-5, why)
    report('same transform, default-precision matmul',
           '{:.3g}'.format(errs['default_matmul']),
           why='not pinned: shows what the pin buys')
    check(errs['transform'] <= 1e-5 and errs['log_prob'] <= 1e-5,
          'full-rank family is not float32-accurate')
    return errs


# ------------------------------------------------------------ phase 4

def _get(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={
        'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=600) as r:
        check(r.status == 200, '{} answered {}'.format(path, r.status))
        return json.loads(r.read())


def _all_finite(obj):
    if isinstance(obj, dict):
        return all(_all_finite(v) for v in obj.values())
    if isinstance(obj, list):
        return all(_all_finite(v) for v in obj)
    if isinstance(obj, (int, float)):
        return math.isfinite(obj)
    return obj is not None


def phase_service(sz, var_param):
    """`PosteriorService` behind `start_server` on localhost."""
    from viabel_tpu.serve import PosteriorService, start_server
    _, model, family, _, _ = _flagship(sz)
    service = PosteriorService(model, family, var_param, seed=0)
    httpd, thread = start_server(service, port=0)
    base = 'http://127.0.0.1:{}'.format(httpd.server_address[1])
    try:
        replies = {
            'health': _get(base, '/health'),
            'moments': _get(base, '/moments'),
            'sample': _get(base, '/sample?n=1000'),
            'bounds': _get(base, '/bounds?n={}'.format(sz.fit_bound)),
        }
        replies['log_prob'] = _get(base, '/log_prob',
                                   {'x': replies['sample']['samples'][:16]})
        replies['fit'] = _get(base, '/fit', {
            'n_iters': sz.fit_iters, 'n_bound_samples': sz.fit_bound,
            'learning_rate': 0.01})
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    for name, reply in replies.items():
        check(_all_finite(reply), '/{} reply has a non-finite or null '
              'value'.format(name))
    check(len(replies['sample']['samples']) == 1000, '/sample size')
    check(len(replies['log_prob']['log_prob']) == 16, '/log_prob size')
    report('/bounds d2 / khat', '{:.4g} / {:.3f}'.format(
        replies['bounds']['d2'], replies['bounds']['khat']))
    report('/fit d2 / khat', '{:.4g} / {:.3f}'.format(
        replies['fit']['bounds']['d2'], replies['fit']['khat']))
    report('endpoints', 'all 200 with finite values: ' + ', '.join(replies))
    return replies


# ------------------------------------------------------------ phase 5

class _Interrupted(Exception):
    pass


def phase_resume(sz):
    """Whole adagrad run vs one interrupted after its first checkpoint and
    resumed from it."""
    import jax
    import numpy as np
    from viabel_tpu import adagrad_optimize, checkpoint
    _, _, family, objective, opt_key = _flagship(sz)
    init = family.init_param()
    n = sz.resume_iters
    kw = dict(key=opt_key, learning_rate=0.01, learning_rate_end=0.001,
              return_history=False)
    whole = adagrad_optimize(n, objective, init, unroll=1, **kw)
    save = checkpoint.save_checkpoint

    def save_then_stop(path, tree):
        save(path, tree)
        raise _Interrupted

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'adagrad.npz')
        checkpoint.save_checkpoint = save_then_stop
        try:
            checkpoint.adagrad_optimize_resumable(
                n, objective, init, checkpoint_path=path,
                save_every=n // 2, **kw)
        except _Interrupted:
            pass
        finally:
            checkpoint.save_checkpoint = save
        done = int(checkpoint.load_checkpoint_entry(path, 'i'))
        check(done == n // 2, 'interrupted run saved i = {}'.format(done))
        resumed = checkpoint.adagrad_optimize_resumable(
            n, objective, init, checkpoint_path=path, save_every=n // 2,
            **kw)
    names = ('smoothed param', 'value history', 'log-norm history')
    worst = 0.0
    identical = True
    for name, a, b in zip(names, (whole[0], whole[2], whole[3]),
                          (resumed[0], resumed[2], resumed[3])):
        a, b = np.asarray(a), np.asarray(b)
        same = np.array_equal(a, b)
        diff = float(np.max(np.abs(a - b) / (1 + np.abs(b))))
        identical &= same
        worst = max(worst, diff)
        report('resume vs whole run, ' + name,
               'bit-identical' if same else 'max rel diff {:.3g}'.format(
                   diff))
    report('resumed at iteration {} of {} on {}'.format(
        n // 2, n, jax.devices()[0].platform),
        'bit-identical' if identical else 'NOT bit-identical', 0.0)
    check(identical, 'resumed run differs from the whole run')
    return identical


# ------------------------------------------------------- --four-gpus

def phase_mesh(sz, devices):
    """The mesh paths on len(devices) devices, each against the same call
    on devices[0] without a mesh and with the same keys."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from viabel_tpu import (black_box_klvi, init_from_moments,
                            mean_field_gaussian_variational_family,
                            rmsprop_IA_optimize_with_rhat,
                            validated_vi_multistart)
    from viabel_tpu.bounds import all_bounds, family_moment_bounds
    from viabel_tpu.experiments import get_samples_and_log_weights
    from viabel_tpu.models import eight_schools_ncp_model
    from viabel_tpu.parallel import make_mesh, sharded_bound_psis
    from viabel_tpu.psis import psislw
    n_dev = len(devices)
    half = n_dev // 2
    sample_mesh = make_mesh(axis_names=('sample',), shape=(n_dev,),
                            devices=devices)
    chain_mesh = make_mesh(axis_names=('chain',), shape=(n_dev,),
                           devices=devices)
    grid = make_mesh(axis_names=('chain', 'sample'), shape=(half, 2),
                     devices=devices)

    def spans(x):
        return len(x.sharding.device_set)

    # The optimizer stage runs replicated: the same program on the same
    # inputs, so its output must agree to float32 rounding.  Bound samples
    # are drawn with per-device keys, so the sharded statistics are an
    # independent Monte Carlo estimate of the same quantity: the ELBO-based
    # log-normalizer bound (a mean of log-weights) is held to 5 standard
    # errors of the difference, khat to `sz.mesh_khat_tol`.
    param_tol, khat_tol = 1e-4, sz.mesh_khat_tol

    def stderr(lw):
        lw = jnp.ravel(lw)
        return float(jnp.std(lw)) / math.sqrt(lw.shape[0])

    def compare(label, a, b, se):
        dp = float(np.max(np.abs(np.asarray(a['param']) - np.asarray(
            b['param'])) / (1 + np.abs(np.asarray(b['param'])))))
        dk = abs(a['khat'] - b['khat'])
        dl, lnb_tol = abs(a['lnb'] - b['lnb']), 5 * math.sqrt(2) * se
        report(label + ' opt param rel diff', '{:.3g}'.format(dp),
               param_tol, 'replicated optimizer')
        report(label + ' khat {:.4f} vs {:.4f}'.format(a['khat'], b['khat']),
               '{:.3g}'.format(dk), khat_tol, 'independent draws')
        report(label + ' log_norm_bound diff', '{:.3g}'.format(dl),
               '{:.3g}'.format(lnb_tol), 'independent draws, 5 se')
        check(dp <= param_tol and dk <= khat_tol and dl <= lnb_tol,
              label + ' differs from the 1-GPU call')

    def single(o):
        return dict(param=o['opt_param'], khat=o['khat'],
                    lnb=o['bounds']['log_norm_bound'])

    with jax.default_device(devices[0]):
        # validated_vi(mesh=): bound/PSIS stage over a 4-way sample mesh
        sharded = fused_fit(sz, mesh=sample_mesh, n_bound=sz.mesh_bound)
        check(spans(sharded['log_weights']) == n_dev,
              'validated_vi log-weights do not span the mesh')
        plain = fused_fit(sz, n_bound=sz.mesh_bound)
        compare('validated_vi(mesh)', single(sharded), single(plain),
                stderr(plain['log_weights']))

        # sharded_bound_psis vs all_bounds + psislw at the same parameter
        _, model, family, objective, opt_key = _flagship(sz)
        vp = plain['opt_param']
        mb = family_moment_bounds(family, vp)
        key = jax.random.PRNGKey(7)
        res, slw, khat = sharded_bound_psis(
            model.log_prob, family, vp, sz.mesh_bound, key, sample_mesh,
            moment_bound_fn=mb)
        check(spans(slw) == n_dev, 'sharded_bound_psis does not span')
        _, lw = get_samples_and_log_weights(model.log_prob, family, vp,
                                            sz.mesh_bound, key)
        ref = all_bounds(lw, moment_bound_fn=mb)
        compare('sharded_bound_psis',
                dict(param=vp, khat=khat, lnb=res['log_norm_bound']),
                dict(param=vp, khat=float(psislw(lw)[1]),
                     lnb=ref['log_norm_bound']), stderr(lw))

        # multistart on a (chain, sample) grid vs no mesh
        kw = dict(n_starts=sz.mesh_starts, perturb_scale=sz.perturb_scale,
                  objective_and_grad=objective,
                  n_bound_samples=sz.mesh_start_bound, key=opt_key,
                  learning_rate=0.01, learning_rate_end=0.001)
        init = family.init_param()
        ms = validated_vi_multistart(model.log_prob, family, init,
                                     sz.n_iters, mesh=grid, **kw)
        check(spans(ms['log_weights']) == n_dev,
              'multistart log-weights do not span the mesh')
        check(tuple(ms['log_weights'].sharding.spec) == ('chain', 'sample'),
              'multistart is not sharded over both axes')
        ms0 = validated_vi_multistart(model.log_prob, family, init,
                                      sz.n_iters, **kw)
        for k in range(sz.mesh_starts):
            compare('multistart start {}'.format(k),
                    dict(param=ms['opt_param'][k], khat=ms['khat'][k],
                         lnb=ms['bounds'][k]['log_norm_bound']),
                    dict(param=ms0['opt_param'][k], khat=ms0['khat'][k],
                         lnb=ms0['bounds'][k]['log_norm_bound']),
                    stderr(ms0['log_weights'][k]))

        # RMSProp-IA chains over a 4-way chain mesh vs no mesh
        ncp = eight_schools_ncp_model()
        fam_g = mean_field_gaussian_variational_family(ncp.dim)
        obj = black_box_klvi(fam_g, ncp.log_prob, sz.n_mc)
        init_g = init_from_moments(fam_g, ncp.true_mean, np.diag(np.diag(
            ncp.true_cov))).astype(np.float32)
        ia_kw = dict(key=jax.random.PRNGKey(1), learning_rate=0.01,
                     n_optimisers=n_dev, rhat_window=sz.ia_window,
                     tail_avg_iters=sz.ia_tail)
        ia = rmsprop_IA_optimize_with_rhat(sz.ia_iters, obj, init_g,
                                           ncp.dim, mesh=chain_mesh,
                                           **ia_kw)
        ia0 = rmsprop_IA_optimize_with_rhat(sz.ia_iters, obj, init_g,
                                            ncp.dim, **ia_kw)
        d_ia = float(np.max(np.abs(np.asarray(ia[1]) - np.asarray(ia0[1]))
                            / (1 + np.abs(np.asarray(ia0[1])))))
        report('IA chain histories rel diff', '{:.3g}'.format(d_ia),
               param_tol, 'chain axis is placement only')
        check(d_ia <= param_tol, 'IA chains differ from the 1-GPU run')
    return dict(validated_vi=sharded, multistart=ms)


# ----------------------------------------------------------------- main

def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--four-gpus', action='store_true',
                   help='run only the mesh paths, on four GPUs')
    args = p.parse_args(argv)
    n_dev = 4 if args.four_gpus else 1

    import jax
    devices = device_gate(n_dev)
    cards = card_label()
    card = cards[0]
    import jaxlib
    print('device_kind: {}, devices: {}, jax {}, jaxlib {}'.format(
        devices[0].device_kind, len(jax.devices()), jax.__version__,
        jaxlib.__version__), flush=True)
    for line in cards:
        print('nvidia-smi: ' + line, flush=True)

    from viabel_tpu.utils import enable_compile_cache
    print('compile cache: {}'.format(enable_compile_cache()))
    print('XLA_FLAGS: {!r}'.format(os.environ.get('XLA_FLAGS', '')))
    import warnings
    from viabel_tpu.bounds import MonteCarloErrorWarning
    warnings.simplefilter('ignore', MonteCarloErrorWarning)

    sz = FULL
    if args.four_gpus:
        run_phase('mesh x{}'.format(n_dev), card, phase_mesh, sz, devices)
    else:
        cpu = jax.devices('cpu')[0]
        gpu = run_phase('1 fused fit vs CPU', card, phase_fused, sz,
                        devices[0], cpu)
        run_phase('1 CLI', card, phase_cli, sz, gpu['khat'])
        run_phase('2 batched + multi-call', card, phase_batched, sz)
        run_phase('3 large-d full rank', card, phase_large_d, sz)
        run_phase('3 precision', card, phase_precision, sz)
        run_phase('4 service', card, phase_service, sz, gpu['opt_param'])
        run_phase('5 resume', card, phase_resume, sz)
    print('card: ' + card)
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform, 'kind': devices[0].device_kind,
        'count': len(jax.devices())}}), flush=True)


if __name__ == '__main__':
    main()
