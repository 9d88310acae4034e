"""Posterior serving: an HTTP service over a fitted variational posterior.

The reference has no serving layer (SURVEY.md section 1 "absent layers").
This module provides a minimal production-shaped one: load a fitted
variational parameter (from an `ExperimentConfig` + checkpoint or an
explicit vector), compile the samplers once, and serve

* ``GET /health``            — liveness + model/family metadata
* ``GET /moments``           — posterior mean and covariance (JSON)
* ``GET /sample?n=K``        — K posterior draws (JSON array)
* ``POST /log_prob``         — log q(x) for a JSON batch of points
* ``GET /bounds?n=K``        — validated error bounds + PSIS khat from K
  fresh MC log-weights (the library's headline capability, as a service)
* ``POST /fit``              — re-fit server-side with the fused
  single-dispatch pipeline (`viabel_tpu.validated_vi`), warm-starting
  from the currently served parameter; atomically swaps in the new fit
  and returns its validated bounds + khat

Built on the stdlib ``http.server`` (no extra dependencies); requests are
served from a single compiled JAX program per endpoint.  Response schema
contract: every numeric field is ``number | null`` — null exactly when the
value is non-finite (a vacuous ``inf`` bound, an undefined NaN khat), so
typed clients parse degenerate responses with the same schema as healthy
ones.  On a multi-device
host the service exploits every attached device: ``/fit`` places K starts
on a ``(gcd(K, N), N/gcd)`` (chain, sample) mesh and ``/bounds`` shards
its Monte Carlo pass over the sample axis (`PosteriorService._fit_mesh`;
indivisible sizes degrade to the largest usable placement).  Start with::

    python -m viabel_tpu.serve --config cfg.json --param ckpt.npz --port 8080
"""
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

__all__ = ['PosteriorService', 'ServiceBusyError', 'serve']


class ServiceBusyError(RuntimeError):
    """A `/fit` is already running; the request was rejected, not queued
    (mapped to HTTP 503 by the handler).  Re-fits hold the device for
    seconds to minutes, so silently serializing concurrent fits behind a
    lock would stall every later request with no backpressure signal."""


class PosteriorService:
    """Compiled query layer over (model, family, var_param).

    Sizes that become static jit arguments are bounded: `/sample`,
    `/bounds`, and `/log_prob` round the requested count (or point batch)
    up to the next power of two before
    compiling (so at most ~log2(max) programs ever compile per endpoint),
    and `/fit` admits at most `max_distinct_fit_configs` distinct
    (n_iters, n_mc, n_bound, lr, lr_end, n_starts, perturb_scale) tuples
    — each distinct tuple
    compiles and permanently caches a pipeline executable, so an unbounded
    variety would grow server memory without limit.  `/fit`'s total draw
    volume is also bounded: the presampled pipeline materializes an
    ``(n_iters, n_mc_samples, dim)`` array, so ``n_iters * n_mc_samples``
    is capped at `max_fit_evals` to keep one request from exhausting
    device memory.
    """

    def __init__(self, model, family, var_param, seed=0,
                 max_fit_iters=200000, max_bound_samples=4000000,
                 max_distinct_fit_configs=8, max_fit_evals=20000000):
        import jax
        import jax.numpy as jnp
        self.model = model
        self.family = family
        self.var_param = jnp.asarray(var_param)
        self.max_fit_iters = int(max_fit_iters)
        self.max_bound_samples = int(max_bound_samples)
        self.max_fit_evals = int(max_fit_evals)
        self.max_distinct_fit_configs = int(max_distinct_fit_configs)
        self._fit_configs = set()
        self._mesh_notes = set()  # (n_runs, n) shapes whose placement was logged
        self._key = jax.random.PRNGKey(seed)
        self._lock = threading.Lock()
        self._fit_lock = threading.Lock()  # held for a /fit's full duration

        self._sample = jax.jit(family.sample, static_argnums=2)
        self._log_prob = jax.jit(family.log_prob)
        mean, cov = family.mean_and_cov(self.var_param)
        self.mean = np.asarray(mean)
        self.cov = np.asarray(cov)

        def lw(vp, key, n):
            s = family.sample(key, vp, n)
            # samples ride along (on device) for the empirical-moment
            # fallback when the family has no closed-form 4th moment
            return s, model.log_prob(s) - family.log_prob(vp, s)
        self._lw = jax.jit(lw, static_argnums=2)

    def _next_key(self):
        import jax
        with self._lock:
            self._key, sub = jax.random.split(self._key)
        return sub

    def _snapshot(self):
        """Consistent (var_param, mean, cov) triple.  `/fit` swaps all
        three under the lock, so readers must take them together — reading
        the fields piecemeal during a concurrent fit would mix posteriors
        (e.g. bounds drawn from the old parameter but scaled by the new
        covariance)."""
        with self._lock:
            return self.var_param, self.mean, self.cov

    @staticmethod
    def _bucket(n):
        """Round a requested size up to the next power of two so the count
        of compiled programs per endpoint stays O(log max), not O(distinct
        requests)."""
        return 1 << max(int(n) - 1, 0).bit_length()

    def sample(self, n):
        n = int(n)
        # the resource guard lives here, not only in the HTTP handler: a
        # library caller (or a future binding) gets the same bound the
        # class docstring promises for every endpoint size
        if n > self.max_bound_samples:
            raise ValueError('n = {} exceeds the service limit {}'.format(
                n, self.max_bound_samples))
        var_param, _, _ = self._snapshot()
        # clamp the bucket to the declared limit, like /log_prob and
        # /bounds — an unclamped bucket for a request just under the cap
        # would compile and draw a program ~2x past it
        draws = self._sample(self._next_key(), var_param,
                             min(self._bucket(n), self.max_bound_samples))
        return np.asarray(draws[:n])

    def moments(self):
        _, mean, cov = self._snapshot()
        return dict(mean=mean.tolist(), cov=cov.tolist())

    def log_prob(self, x):
        import jax.numpy as jnp
        var_param, _, _ = self._snapshot()
        x = np.atleast_2d(np.asarray(x, dtype=np.float32))
        n = x.shape[0]
        if n > self.max_bound_samples:
            raise ValueError('batch of {} points exceeds the service limit '
                             '{}'.format(n, self.max_bound_samples))
        # pad the batch to a power-of-two bucket: every distinct shape
        # traces and permanently caches a new executable, so an unbucketed
        # batch axis would grow server memory without bound (the same
        # resource rule /sample and /bounds follow — class docstring).
        # The bucket is clamped to the declared limit — otherwise a batch
        # just under the cap would compile a program ~2x past it
        padded = np.zeros((min(self._bucket(n), self.max_bound_samples),
                           x.shape[1]), dtype=x.dtype)
        padded[:n] = x
        return np.asarray(self._log_prob(var_param, jnp.asarray(padded))[:n])

    def bounds(self, n):
        from .bounds import all_bounds, family_moment_bounds
        from .psis import psislw
        var_param, _, cov = self._snapshot()
        # rounding the MC size up to a bucket only tightens the estimates
        n = min(self._bucket(n), self.max_bound_samples)
        # mb is None for families without a finite closed-form 4th moment
        # (t with df <= 4): both branches then fall back to empirical
        # central moments of the bound samples
        mb = family_moment_bounds(self.family, var_param)
        mesh = self._fit_mesh(1, n)
        if mesh is not None:
            # multi-device host: the MC pass shards over the sample axis
            # (each device draws/scores its own shard; psum'd statistics,
            # tail-only PSIS gather) — draw, score, stats, AND the PSIS
            # smooth run as ONE fused program (`sharded_bound_psis`: the
            # two-program compose paid an extra dispatch and a device-
            # memory round-trip of the log-weights); builders are cached
            # per (model, family, mesh, n), so repeated /bounds hit the
            # executable cache
            from .parallel import sharded_bound_psis
            res, _slw, khat = sharded_bound_psis(
                self.model.log_prob, self.family, var_param, n,
                self._next_key(), mesh, q_var=cov, moment_bound_fn=mb)
            res['khat'] = khat
            return {k: float(v) for k, v in res.items()}
        samples_dev, lw_dev = self._lw(var_param, self._next_key(), n)
        res = all_bounds(lw_dev,
                         samples=samples_dev if mb is None else None,
                         q_var=cov, moment_bound_fn=mb)
        res['khat'] = psislw(lw_dev)[1]
        return {k: float(v) for k, v in res.items()}

    def fit(self, n_iters=2000, n_mc_samples=100, n_bound_samples=100000,
            learning_rate=0.01, learning_rate_end=None, n_starts=1,
            perturb_scale=0.5):
        """Re-fit with the fused pipeline, warm-starting from the served
        parameter, and atomically swap in the result.  Returns the new
        fit's validated bounds, khat, and moments.  Raises
        `ServiceBusyError` (HTTP 503) if another fit is in flight.

        With ``n_starts > 1`` the fused multistart pipeline runs K complete
        pipelines in one program (start 0 = the served parameter
        unperturbed; `validated_vi_multistart`), swaps in the start with
        the tightest validated 2-divergence bound, and reports its index as
        ``best``.  Device memory scales with ``n_starts *
        max(n_bound_samples, n_iters * n_mc_samples)``, so `n_starts`
        multiplies the resource checks."""
        n_iters, n_mc_samples, n_bound_samples, n_starts = (
            int(n_iters), int(n_mc_samples), int(n_bound_samples),
            int(n_starts))
        if min(n_iters, n_mc_samples, n_bound_samples, n_starts) <= 0:
            raise ValueError('n_iters, n_mc_samples, n_bound_samples, and '
                             'n_starts must all be positive')
        if n_iters > self.max_fit_iters:
            raise ValueError('n_iters {} exceeds the service limit {}'
                             .format(n_iters, self.max_fit_iters))
        if n_starts * n_bound_samples > self.max_bound_samples:
            raise ValueError('n_starts * n_bound_samples = {} exceeds the '
                             'service limit {}'.format(
                                 n_starts * n_bound_samples,
                                 self.max_bound_samples))
        if n_starts * n_iters * n_mc_samples > self.max_fit_evals:
            raise ValueError(
                'n_starts * n_iters * n_mc_samples = {} exceeds the '
                'service limit {} (the presampled pipeline materializes '
                'an (n_iters, n_mc_samples, dim) draw array per '
                'start)'.format(n_starts * n_iters * n_mc_samples,
                                self.max_fit_evals))
        lr = float(learning_rate)
        lr_end = None if learning_rate_end is None else float(
            learning_rate_end)
        pscale = float(perturb_scale)
        # reject (not queue) a concurrent fit: the caller gets an immediate
        # 503 instead of an unbounded wait behind the running one
        if not self._fit_lock.acquire(blocking=False):
            raise ServiceBusyError(
                'a fit is already running; retry when it completes '
                '(concurrent fits are rejected, not queued)')
        try:
            return self._fit_locked(n_iters, n_mc_samples, n_bound_samples,
                                    lr, lr_end, n_starts, pscale)
        finally:
            self._fit_lock.release()

    def _fit_mesh(self, n_starts, n_bound_samples):
        """Mesh placement for a /fit (or /bounds) on a multi-device host
        (round-3 review: the service was mesh-blind while the CLI
        partitioned): the shared `parallel.auto_mesh` rule — K starts take
        a ``(gcd(K, N), N/gcd)`` (chain, sample) mesh, a single run puts
        all devices on the sample axis.  The placement (or the reason for
        a single-device fallback) is printed once per distinct request
        shape — never skip attached devices silently."""
        from .parallel import auto_mesh
        mesh, note = auto_mesh(n_starts, n_bound_samples)
        if note is not None:
            key = (n_starts, n_bound_samples)
            with self._lock:
                first_time = key not in self._mesh_notes
                self._mesh_notes.add(key)
            if first_time:
                print('[serve] K={}, n={}: {}'.format(
                    n_starts, n_bound_samples, note), flush=True)
        return mesh

    def _fit_locked(self, n_iters, n_mc_samples, n_bound_samples, lr,
                    lr_end, n_starts, pscale):
        import jax.numpy as jnp
        from .pipeline import validated_vi, validated_vi_multistart
        cfg = (n_iters, n_mc_samples, n_bound_samples, lr, lr_end,
               n_starts, pscale)
        with self._lock:
            is_new_cfg = cfg not in self._fit_configs
            if is_new_cfg:
                if len(self._fit_configs) >= self.max_distinct_fit_configs:
                    raise ValueError(
                        'distinct fit-configuration limit ({}) reached — '
                        'each distinct (n_iters, n_mc_samples, '
                        'n_bound_samples, learning_rate, '
                        'learning_rate_end, n_starts, perturb_scale) '
                        'tuple compiles and caches a new device program; '
                        'reuse one of the existing configurations'.format(
                            self.max_distinct_fit_configs))
                self._fit_configs.add(cfg)
        var_param, _, _ = self._snapshot()
        mesh = self._fit_mesh(n_starts, n_bound_samples)
        best = None
        try:
            if n_starts > 1:
                ms = validated_vi_multistart(
                    self.model.log_prob, self.family, var_param, n_iters,
                    n_starts=n_starts, perturb_scale=pscale,
                    n_mc_samples=n_mc_samples,
                    n_bound_samples=n_bound_samples, key=self._next_key(),
                    learning_rate=lr, learning_rate_end=lr_end, mesh=mesh)
                best = ms['best']
                # project the winning start's slices into the
                # single-fit result layout
                out = dict(
                    opt_param=ms['opt_param'][best],
                    q_mean=ms['q_mean'][best], q_cov=ms['q_cov'][best],
                    bounds=ms['bounds'][best], khat=ms['khat'][best],
                    value_history=ms['value_history'][best])
            else:
                out = validated_vi(
                    self.model.log_prob, self.family, var_param, n_iters,
                    n_mc_samples=n_mc_samples,
                    n_bound_samples=n_bound_samples, key=self._next_key(),
                    learning_rate=lr, learning_rate_end=lr_end, mesh=mesh)
        except (ValueError, TypeError):
            # Validation / trace-time errors are raised before anything
            # compiled, so the config slot can be returned.  Failures from
            # later stages (device OOM, runtime errors) keep their slot:
            # the compiled executable may already be cached, and freeing
            # the slot would let repeated fail-after-compile requests grow
            # the compiled-program cache past max_distinct_fit_configs.
            if is_new_cfg:
                with self._lock:
                    self._fit_configs.discard(cfg)
            raise
        # fetch_global, not bare np.asarray: with a multi-start fit the
        # pipeline outputs are chain-sharded, and under a multi-controller
        # runtime their shards span processes (CLAUDE.md fetch convention;
        # the CLI's _run_batched routes the identical outputs the same way)
        from .parallel import fetch_global
        mean = fetch_global(out['q_mean'])
        cov = fetch_global(out['q_cov'])
        with self._lock:
            self.var_param = jnp.asarray(fetch_global(out['opt_param']))
            self.mean = mean
            self.cov = cov
        res = dict(
            bounds={k: float(v) for k, v in out['bounds'].items()},
            khat=float(out['khat']),
            mean=mean.tolist(),
            # device-side index: fetch one scalar, not the whole history
            final_loss=float(fetch_global(out['value_history'][-1])))
        if best is not None:
            res['best'] = int(best)
            res['n_starts'] = n_starts
        return res


def _null_nonfinite(obj):
    """Replace non-finite floats with ``None`` (JSON ``null``) so the
    payload is valid (RFC-8259) JSON with a STABLE per-field schema: every
    numeric field is ``number | null``, where null means the value was
    non-finite (a vacuous inf bound, or an undefined NaN khat on a
    degenerate tail).  An earlier version emitted the strings
    ``'inf'``/``'nan'`` instead, which changed the field's JSON type
    exactly on the degenerate responses a typed client (Go structs, JSON
    schema validators) most needs to read (round-5 advisor finding)."""
    import math
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _null_nonfinite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_null_nonfinite(v) for v in obj]
    return obj


def _make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, obj, status=200):
            # Non-finite floats are legitimate payloads here (a vacuous
            # Wasserstein bound is inf by design, khat can be NaN on a
            # degenerate tail) but `Infinity`/`NaN` are not valid JSON —
            # a strict client (JavaScript JSON.parse, Go encoding/json)
            # would fail to parse exactly the responses that report a
            # vacuous bound.  Fast path: standard dump with allow_nan
            # off; only on failure walk the object and null out the
            # non-finite leaves.  Schema contract: every numeric field is
            # `number | null`, null = non-finite (see `_null_nonfinite`).
            try:
                body = json.dumps(obj, allow_nan=False).encode()
            except ValueError:
                body = json.dumps(_null_nonfinite(obj)).encode()
            self.send_response(status)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            try:
                if url.path == '/health':
                    self._json(dict(status='ok',
                                    model=service.model.name,
                                    family=service.family.name,
                                    dim=service.model.dim))
                elif url.path == '/moments':
                    self._json(service.moments())
                elif url.path == '/sample':
                    n = min(int(q.get('n', ['1'])[0]), 1000000)
                    if n <= 0:
                        return self._json(dict(
                            error='n must be positive, got {}'.format(n)),
                            400)
                    self._json(dict(samples=service.sample(n).tolist()))
                elif url.path == '/bounds':
                    n = min(int(q.get('n', ['100000'])[0]), 10000000)
                    if n < 2:  # PSIS khat needs at least two log-weights
                        return self._json(dict(
                            error='n must be at least 2, got {}'.format(n)),
                            400)
                    self._json(service.bounds(n))
                else:
                    self._json(dict(error='unknown endpoint'), 404)
            except (ValueError, TypeError) as e:  # malformed client input
                self._json(dict(error=str(e)), 400)
            except Exception as e:  # surface errors as JSON, keep serving
                self._json(dict(error=str(e)), 500)

        def do_POST(self):
            url = urlparse(self.path)
            try:
                length = int(self.headers.get('Content-Length', 0))
                payload = json.loads(self.rfile.read(length) or b'{}')
                if not isinstance(payload, dict):
                    return self._json(dict(
                        error='payload must be a JSON object'), 400)
                if url.path == '/log_prob':
                    x = payload.get('x')
                    if x is None:
                        return self._json(dict(error='missing "x"'), 400)
                    try:
                        lp = service.log_prob(x)
                    except (ValueError, TypeError) as e:  # non-numeric x
                        return self._json(dict(error=str(e)), 400)
                    self._json(dict(log_prob=lp.tolist()))
                elif url.path == '/fit':
                    allowed = {'n_iters', 'n_mc_samples', 'n_bound_samples',
                               'learning_rate', 'learning_rate_end',
                               'n_starts', 'perturb_scale'}
                    unknown = set(payload) - allowed
                    if unknown:
                        return self._json(dict(
                            error='unknown fit options: {}'.format(
                                sorted(unknown))), 400)
                    try:
                        self._json(service.fit(**payload))
                    except ServiceBusyError as e:  # a fit is in flight
                        self._json(dict(error=str(e)), 503)
                    except (ValueError, TypeError) as e:  # bad option values
                        self._json(dict(error=str(e)), 400)
                else:
                    self._json(dict(error='unknown endpoint'), 404)
            except (ValueError, TypeError) as e:  # malformed JSON/input
                self._json(dict(error=str(e)), 400)
            except Exception as e:
                self._json(dict(error=str(e)), 500)

    return Handler


def serve(service, port=8080, host='127.0.0.1'):
    """Run the HTTP server (blocking).  Use `start_server` to run it on a
    background thread instead."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(service))
    httpd.serve_forever()


def start_server(service, port=8080, host='127.0.0.1'):
    """Start the server on a daemon thread; returns (server, thread)."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, t


def _param_from_checkpoint(path):
    """Served variational parameter from an optimizer checkpoint.

    Dispatches on the checkpoint's explicit ``format`` entry
    (`checkpoint.checkpoint_format`; every writer stamps one — pre-round-5
    checkpoints without it are identified by the legacy leaf-name
    heuristics inside that one shared helper).  The three formats and
    their serving rules:

    * ``adagrad-history/v1`` (`checkpoint.adagrad_optimize_resumable`):
      ``params`` is the full ``(n_iters, P)`` iterate history and ``i`` the
      completed count — serve the tail-quarter mean, the same fit
      `adagrad_optimize` reports (reference tail averaging:
      viabel/vb.py:375-376).
    * ``adagrad-tail/v1`` (``return_history=False``, the large-P format):
      no iterate history exists; ``tail_sum`` is the running sum of
      post-update parameters from the tail quarter of the FULL run
      (``3 * n_iters // 4``, with ``n_iters = values.shape[0]``).  Once the
      run is past that point the served parameter is
      ``tail_sum / (i - 3 * n_iters // 4)`` — the same smoothed fit the
      driver returns; before it, ``tail_sum`` is all zeros and the current
      iterate ``param`` is the best available estimate.
    * ``chains/v1`` (`optimizers._chains_run_segmented`, written by the
      CLI's ``rmsprop_ia``/``adam_ia`` with ``--checkpoint-path``): ``params``
      is the *current per-chain* ``(n_chains, P)`` parameters and ``hist``
      the per-chain ring-buffer history — tail-quarter-averaging ``params``
      by iteration index would silently yield an all-NaN parameter (empty
      slice mean).  The served parameter is instead the tail-quarter mean of
      the chronologically-ordered retained history, pooled over chains.

    Plain ``.npz`` files holding a single parameter vector (format None)
    are served as-is.
    """
    from .checkpoint import (FORMAT_ADAGRAD_HISTORY, FORMAT_ADAGRAD_TAIL,
                             FORMAT_CHAINS, checkpoint_format,
                             load_checkpoint_entry)
    fmt = checkpoint_format(path)
    if fmt == FORMAT_CHAINS:
        hist = load_checkpoint_entry(path, 'hist')  # (n_chains, cap, P)
        i_done = int(load_checkpoint_entry(path, 'i'))
        if i_done <= 0:
            raise ValueError(
                '{!r} is a multichain checkpoint with no completed '
                'iterations; nothing to serve'.format(path))
        cap = hist.shape[1]
        kept = min(i_done, cap)
        # chronological order of the ring buffer (same reconstruction as
        # optimizers._chains_run_segmented's post-pass)
        order = (i_done - kept + np.arange(kept)) % cap
        tail = hist[:, order][:, 3 * kept // 4:]
        return tail.mean(axis=(0, 1))
    if fmt == FORMAT_ADAGRAD_HISTORY:
        params = load_checkpoint_entry(path, 'params')
        i_done = int(load_checkpoint_entry(path, 'i'))
        if 0 < i_done <= params.shape[0]:
            return params[3 * i_done // 4:i_done].mean(axis=0)
        return load_checkpoint_entry(path, 'param')
    if fmt == FORMAT_ADAGRAD_TAIL:
        # round-4 review: this format used to fall through to the raw last
        # iterate even for a completed run
        i_done = int(load_checkpoint_entry(path, 'i'))
        n_iters = load_checkpoint_entry(path, 'values').shape[0]
        tail_start = 3 * n_iters // 4
        if i_done > tail_start:
            return (load_checkpoint_entry(path, 'tail_sum')
                    / (i_done - tail_start))
        # tail accumulation has not started: the current iterate is the
        # best available estimate
        return load_checkpoint_entry(path, 'param')
    # not an optimizer checkpoint: a bare parameter vector
    with np.load(path) as d:
        names = {k.split(':', 1)[1].split('/')[-1]
                 for k in d.files if ':' in k}
        if 'param' in names:
            return load_checkpoint_entry(path, 'param')
        return d[d.files[0]]


def _fit_from_config(cfg, model, family, objective):
    """Fit the served parameter the way the CLI would for the same config
    (round-4 review: this path used to silently run adagrad on an unsplit
    key for every config, then duplicated the CLI's dispatch by hand —
    parity is now structural: both entry points call `config.fit`)."""
    from .config import fit
    return fit(cfg, model, family, objective)[0]


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(prog='python -m viabel_tpu.serve')
    p.add_argument('--config', required=True, help='ExperimentConfig JSON')
    p.add_argument('--param', help='checkpoint .npz with the fitted param '
                                   '(defaults to fitting from scratch)')
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--host', default='127.0.0.1')
    args = p.parse_args(argv)

    from .config import ExperimentConfig, build
    from .utils import enable_compile_cache
    enable_compile_cache()

    with open(args.config) as f:
        cfg = ExperimentConfig.from_json(f.read())
    model, family, objective = build(cfg)
    if args.param:
        var_param = _param_from_checkpoint(args.param)
    else:
        print('no --param given; fitting {} iters with {}...'.format(
            cfg.n_iters, cfg.optimizer))
        var_param = _fit_from_config(cfg, model, family, objective)
    service = PosteriorService(model, family, var_param, seed=cfg.seed)
    print('serving {} / {} on {}:{}'.format(model.name, family.name,
                                            args.host, args.port))
    serve(service, port=args.port, host=args.host)


if __name__ == '__main__':
    main()
