"""Single-dispatch validated VI: the whole workflow in one XLA program.

The reference's workflow — optimize, then draw bound samples, then compute
bounds, then PSIS-correct (reference: notebooks/experiments.py:138-180) —
issues many separate device programs, each with its own dispatch and
host round trip.  This module
compiles the *entire* pipeline — the full optimizer `lax.scan`, the fused
draw+score pass, the log-weight/moment statistics, and PSIS smoothing —
into ONE program, so the host pays a single dispatch and the device runs
everything back-to-back out of HBM.

Only scalar bound arithmetic (`divergence_bound` -> `wasserstein_bounds`
-> `error_bounds` assembly) runs on the host afterwards, on already-reduced
statistics.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

from .bounds import (divergence_bound, error_bounds, log_weight_stats,
                     wasserstein_bounds)
from .objectives import black_box_klvi
from .optimizers import _adagrad_run, _wrap_objective, resolve_unroll
from .psis import _psislw_1d, _tail_len, weighted_moments

__all__ = ['validated_vi', 'validated_vi_multistart',
           'validated_vi_sweep', 'DivergedRunWarning']


class DivergedRunWarning(UserWarning):
    """An optimizer run produced a non-finite fit.

    The validated pipeline degrades a diverged run to infinite bounds and
    a NaN khat instead of raising (`_assemble_bounds`); this category
    makes the event loud on the single-run path so a user is told the fit
    — not the Monte Carlo noise — is the problem.  Typical cause at large
    d: the CHIVI objective, whose naive-MC CUBO estimator degenerates
    once the per-batch log-weight spread exceeds a few nats (measured
    onset d >= 30 full-rank; benchmarks/DIM_SCALING.md) — use KLVI (+
    PSIS correction) there instead.
    """


@lru_cache(maxsize=256)
def _default_objective(var_family, log_density, n_mc_samples):
    """Cached KLVI factory so repeated `validated_vi` calls with the same
    (family, density, n) reuse one objective instance — a distinct instance
    is a distinct static jit argument and would recompile the pipeline
    (see CLAUDE.md conventions / `optimizers._wrap_objective`)."""
    presampled = var_family.base_sample is not None
    return black_box_klvi(var_family, log_density, n_mc_samples,
                          presampled=presampled)


from .utils import _hashable_log_density  # noqa: E402  (shared unwrap)


def _optimize_and_average(obj, n_iters, window, learning_rate, epsilon,
                          learning_rate_end, unroll, init_param, opt_key):
    """Shared pipeline prologue: the whole-loop adagrad scan plus the
    reference's tail-quarter iterate averaging (viabel/vb.py:375-376).

    Calls the scan body unjitted (`__wrapped__`): every caller is already
    inside a jit, and the sweep runner passes *traced* learning rates,
    which the jitted wrapper's static `learning_rate` argument would
    reject.  ``keep_history=False``: the pipeline only needs the averaged
    parameter, so the (n_iters, P) iterate stack is never materialized —
    with K vmapped starts at d = 100 that stack would be
    K x n_iters x 5150 floats (1.6 GB for 8 x 10k) of dead weight.  The
    in-scan running sum is the same one `adagrad_optimize` returns, so
    pipeline results stay bit-identical to composing the stages by hand."""
    values, log_norms, opt_param = _adagrad_run.__wrapped__(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, opt_key, False, unroll, keep_history=False)
    return values, log_norms, opt_param


def _closed_form_moments(var_family, opt_param, alpha):
    """Closed-form C2/C4 moment bounds for the Wasserstein formulas, or
    None when unavailable: for alpha != 2 the moments are unused (nan
    placeholders keep the host pack's layout fixed), and a Student-t family
    with df <= 4 has no finite closed-form 4th moment — the caller then
    falls back to empirical central moments of the bound samples, exactly
    as `all_bounds` does when no `moment_bound_fn` is given."""
    from .families import NoClosedFormMomentError
    if alpha != 2:
        nan = jnp.asarray(jnp.nan, dtype=opt_param.dtype)
        return {2: nan, 4: nan}
    try:
        return {2: var_family.pth_moment(opt_param, 2),
                4: var_family.pth_moment(opt_param, 4)}
    except NoClosedFormMomentError:
        # only the dedicated no-closed-form signal maps to the empirical
        # fallback; a plain ValueError from a custom family's pth_moment is
        # a real defect and propagates (round-5 advisor finding)
        return None


def _result_dict(var_family, values, log_norms, opt_param, stats, moments,
                 lw, slw, khat, psis_mean, psis_cov):
    """Shared pipeline epilogue: q's moments plus the single packed array
    carrying every host-facing statistic."""
    q_mean, q_cov = var_family.mean_and_cov(opt_param)
    return dict(opt_param=opt_param, value_history=values,
                log_norm_history=log_norms, q_mean=q_mean, q_cov=q_cov,
                log_weights=lw, smoothed_log_weights=slw, khat=khat,
                psis_mean=psis_mean, psis_cov=psis_cov,
                host_pack=_pack_host_scalars(stats, moments, khat, q_cov))


# order of the scalar pack fetched to the host in ONE transfer (each
# device->host scalar fetch is a blocking transfer; see CLAUDE.md); the
# field list is owned by bounds.log_weight_stats so the two modules cannot
# drift
from .bounds import _STAT_KEYS as _PACK_FIELDS


def _pack_host_scalars(stats, moments, khat, q_cov):
    scalars = jnp.stack([stats[f] for f in _PACK_FIELDS]
                        + [moments[2], moments[4], khat])
    return jnp.concatenate([scalars, jnp.ravel(q_cov).astype(scalars.dtype)])


def _unpack_host_scalars(pack, n, dim):
    from .parallel import fetch_global
    pack = fetch_global(pack)  # multi-controller-safe np.asarray
    nf = len(_PACK_FIELDS)
    head = [float(v) for v in pack[:nf + 3]]
    stats = dict(zip(_PACK_FIELDS, head[:nf]), n=n)
    moments = {2: head[nf], 4: head[nf + 1]}
    q_cov = pack[nf + 3:].reshape(dim, dim)
    return stats, moments, head[nf + 2], q_cov


def _pipeline_core(obj, var_family, log_density, n_iters, n_bound_samples,
                   window, learning_rate, epsilon, learning_rate_end,
                   alpha, unroll, tail_len, init_param, key):
    """The fused program body: optimize -> draw -> score -> stats -> PSIS.

    Covers the same work as `adagrad_optimize` +
    `experiments.get_samples_and_log_weights` + `bounds.log_weight_stats` +
    `psis.psislw` + `experiments.improve_with_psis`'s weighted moments
    (reference: notebooks/experiments.py:138-180), fused end to end.
    Untraced; jitted by `_pipeline_run` (one start) and vmapped+jitted by
    `_multistart_runner` (a batch of starts in one program).
    """
    opt_key, draw_key = jax.random.split(key)
    values, log_norms, opt_param = _optimize_and_average(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        unroll, init_param, opt_key)

    samples = var_family.sample(draw_key, opt_param, n_bound_samples)
    lw = log_density(samples) - var_family.log_prob(opt_param, samples)
    stats = log_weight_stats(lw, alpha=alpha)
    moments = _closed_form_moments(var_family, opt_param, alpha)
    if moments is None:  # e.g. t family with df <= 4: empirical fallback
        # only the C2/C4 scalars are needed here — skip central_moments'
        # (d, d) sample covariance (q_cov comes from the family closed form)
        x = jnp.atleast_2d(samples.T).T
        c = x - jnp.mean(x, axis=0, keepdims=True)
        norm2 = jnp.sum(c ** 2, axis=1)
        # C4 is the norm moment E[||c||^4], matching the closed forms
        # (the reference's empirical fallback drops the cross terms — a
        # bug fixed in bounds.central_moments, see PARITY.md)
        moments = {2: jnp.mean(norm2), 4: jnp.mean(norm2 ** 2)}

    slw, khat = _psislw_1d(lw, tail_len)
    psis_mean, psis_cov = weighted_moments(samples, slw)

    return _result_dict(var_family, values, log_norms, opt_param, stats,
                        moments, lw, slw, khat, psis_mean, psis_cov)


_pipeline_run = partial(jax.jit, static_argnames=(
    'obj', 'var_family', 'log_density', 'n_iters', 'n_bound_samples',
    'window', 'learning_rate', 'epsilon', 'learning_rate_end', 'alpha',
    'unroll', 'tail_len'))(_pipeline_core)


@lru_cache(maxsize=256)
def _multistart_runner(obj, var_family, log_density, n_iters,
                       n_bound_samples, window, learning_rate, epsilon,
                       learning_rate_end, alpha, unroll, tail_len):
    """Compiled batch-of-starts program: `_pipeline_core` vmapped over the
    (init_param, key) start axis.  Cached per static configuration so
    repeated sweeps reuse the executable."""
    def run_one(init_param, key):
        return _pipeline_core(obj, var_family, log_density, n_iters,
                              n_bound_samples, window, learning_rate,
                              epsilon, learning_rate_end, alpha, unroll,
                              tail_len, init_param, key)
    return jax.jit(jax.vmap(run_one))


@partial(jax.jit, static_argnames=(
    'obj', 'var_family', 'log_density', 'n_iters', 'n_bound_samples',
    'window', 'learning_rate', 'epsilon', 'learning_rate_end', 'alpha',
    'unroll', 'mesh', 'axis'))
def _pipeline_run_sharded(obj, var_family, log_density, n_iters,
                          n_bound_samples, window, learning_rate, epsilon,
                          learning_rate_end, alpha, unroll, mesh, axis,
                          init_param, key):
    """Mesh-sharded single program: the optimizer scan runs replicated
    (variational parameters are tiny), then each device draws and scores
    only its shard of the bound samples; statistics, the PSIS tail fit, and
    the corrected moments ride collectives (`viabel_tpu.parallel`).
    Same per-device key discipline as `sharded_all_bounds`, so results are
    bit-identical to composing the sharded estimators by hand.
    """
    from jax.sharding import PartitionSpec as P
    from .parallel.sharded_bounds import _draw_and_score_locals
    from .parallel.sharded_psis import psislw_sharded, sharded_psis_moments

    opt_key, draw_key = jax.random.split(key)
    values, log_norms, opt_param = _optimize_and_average(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        unroll, init_param, opt_key)

    moments = _closed_form_moments(var_family, opt_param, alpha)
    need_empirical = moments is None  # static: df <= 4 t family
    n_local = n_bound_samples // mesh.shape[axis]

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P()),
             out_specs=(P(), P(axis), P(axis, None)))
    def local_draw(vp, k):
        samples, lw_local, stats, cm = _draw_and_score_locals(
            var_family, log_density, vp, k, n_local, n_bound_samples, axis,
            alpha, need_empirical)
        if need_empirical:
            # psum-reduced central moments (the sharded counterpart of the
            # single-device empirical fallback)
            stats['C2'], stats['C4'] = cm['C2'], cm['C4']
        return stats, lw_local, samples

    stats, lw, samples = local_draw(opt_param, draw_key)
    if need_empirical:
        moments = {2: stats.pop('C2'), 4: stats.pop('C4')}
    slw, khat = psislw_sharded(lw, mesh, axis=axis)
    psis_mean, psis_cov = sharded_psis_moments(samples, slw, mesh, axis=axis)
    return _result_dict(var_family, values, log_norms, opt_param, stats,
                        moments, lw, slw, khat, psis_mean, psis_cov)


def validated_vi(log_density, var_family, init_param, n_iters, *,
                 objective_and_grad=None, n_mc_samples=100,
                 n_bound_samples=1000000, alpha=2.0, key=None,
                 has_log_norm=None, window=10, learning_rate=0.01,
                 epsilon=0.1, learning_rate_end=None, unroll='auto',
                 log_norm_bound=None, mesh=None, axis='sample'):
    """Run the full validated-VI pipeline as one compiled device program.

    Optimizes with windowed adagrad, estimates the error bounds from
    `n_bound_samples` Monte Carlo log-weights, and PSIS-corrects the
    posterior moments — the complete workflow of the reference harness
    (reference: notebooks/experiments.py:138-180) in a single dispatch.

    Parameters
    ----------
    objective_and_grad : optional
        Objective to optimize; defaults to KLVI on (`var_family`,
        `log_density`, `n_mc_samples`), pre-sampled when the family
        supports it.  Pass `black_box_chivi(...)` (with `log_norm_bound`
        from a KLVI run) for the reference's CHIVI stage
        (reference: notebooks/experiments.py:205-208).
    n_mc_samples : int
        Monte Carlo samples per gradient (the reference's protocol
        default of 100; reference: viabel/vb.py:345-347).  Gradient
        variance falls as 1/n_mc; `examples/large_d.py` uses 800 at
        d = 100.
    unroll : int or 'auto'
        `lax.scan` unroll for the optimizer stage; 'auto' (default)
        resolves to the measured best (`optimizers.resolve_unroll`).
    log_norm_bound : optional float
        Log-normalizer lower bound for the divergence bound; defaults to
        the run's own ELBO estimate (reference: viabel/bounds.py:174-176).
    mesh : optional jax.sharding.Mesh
        Shard the bound pass, PSIS, and moment correction over the mesh's
        `axis` (one fused program across all devices; samples and
        log-weights never leave their device).  `axis` must divide
        `n_bound_samples`.

    Returns
    -------
    dict with keys ``opt_param``, ``value_history``, ``log_norm_history``,
    ``bounds`` (the `all_bounds` dict), ``khat``, ``psis_mean``,
    ``psis_cov``, ``q_mean``, ``q_cov``, ``log_weights``,
    ``smoothed_log_weights``.  Array entries are device arrays; bound
    entries are floats.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    log_density = _hashable_log_density(log_density)
    if objective_and_grad is None:
        objective_and_grad = _default_objective(var_family, log_density,
                                                n_mc_samples)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = jnp.asarray(init_param)
    unroll = resolve_unroll(unroll)
    if mesh is not None:
        if axis not in mesh.axis_names:
            raise ValueError(
                'the bound pass shards over a mesh axis named {!r}; the '
                'given mesh has axes {} (build it with '
                "make_mesh(axis_names=('sample',)) or pass axis=)".format(
                    axis, mesh.axis_names))
        if n_bound_samples % mesh.shape[axis]:
            raise ValueError('the mesh axis size ({}) must divide '
                             'n_bound_samples ({})'.format(
                                 mesh.shape[axis], n_bound_samples))
        out = _pipeline_run_sharded(
            obj, var_family, log_density, n_iters, n_bound_samples, window,
            learning_rate, epsilon, learning_rate_end, alpha, unroll, mesh,
            axis, init_param, key)
    else:
        tail_len = _tail_len(n_bound_samples, 1.0)
        out = _pipeline_run(obj, var_family, log_density, n_iters,
                            n_bound_samples, window, learning_rate, epsilon,
                            learning_rate_end, alpha, unroll, tail_len,
                            init_param, key)

    # host: scalar bound assembly from the already-reduced statistics,
    # fetched in a single device->host transfer
    bounds, khat, diverged = _assemble_bounds(
        out.pop('host_pack'), n_bound_samples, var_family.dim, alpha,
        log_norm_bound)
    # the divergence signal is non-finite LOG-WEIGHT STATISTICS — khat
    # alone cannot discriminate: +inf khat is also the legitimate
    # short-tail outcome of a tiny, healthy bound pass (round-5 review)
    if diverged:
        import warnings
        warnings.warn(
            'the optimizer run diverged (non-finite log-weights at the '
            'fitted parameter): bounds are vacuous. Reduce the learning '
            'rate — or, if the objective is CHIVI at large d, switch to '
            'KLVI: the exponentiated CUBO estimator cannot be Monte-Carlo '
            'estimated once the batch log-weight spread exceeds a few '
            'nats (benchmarks/DIM_SCALING.md)', DivergedRunWarning)
    out['bounds'] = bounds
    out['khat'] = khat
    return out


def _assemble_bounds(host_pack, n, dim, alpha, log_norm_bound):
    """Host-side `all_bounds`-equivalent assembly from one packed fetch.

    A diverged run (non-finite statistics or covariance — possible for a
    badly perturbed multistart init) degrades to infinite bounds instead of
    raising (numpy's spectral-norm SVD does not converge on non-finite
    matrices)."""
    stats, moments, khat, q_cov = _unpack_host_scalars(host_pack, n, dim)
    if not np.all(np.isfinite(q_cov)):
        q_cov = np.inf
    finite_stats = all(np.isfinite(v) for k_, v in stats.items()
                       if k_ != 'n')
    d2, log_norm_bound = divergence_bound(
        None, alpha=alpha, log_norm_bound=log_norm_bound,
        return_log_norm_bound=True, _stats=stats) if finite_stats \
        else (np.inf, log_norm_bound if log_norm_bound is not None
              else -np.inf)
    bounds = {}
    if alpha == 2:
        # Wasserstein / moment-error bounds are 2-divergence bounds only
        # (see `all_bounds`); for other orders just the divergence is valid
        moment_fn = (moments.get if all(np.isfinite(v) for v in
                                        moments.values())
                     else lambda p: np.inf)
        bounds = wasserstein_bounds(np.inf if not np.isfinite(d2) else d2,
                                    moment_bound_fn=moment_fn)
        bounds.update(error_bounds(q_var=q_cov, **bounds))
    bounds['d2' if alpha == 2 else 'dalpha'] = d2
    bounds['log_norm_bound'] = log_norm_bound
    return bounds, khat, not finite_stats


def _one_sharded_run(obj, var_family, log_density, n_iters, n_bound_samples,
                     window, learning_rate, epsilon, learning_rate_end,
                     alpha, unroll, tail_len, sample_axis, n_local,
                     need_empirical, init_param, key):
    """One complete pipeline run (optimize -> sample-sharded bound/PSIS)
    executing *inside* a shard_map over a 2-D mesh — the shared body of
    `_multistart_sharded2d` (per-start static learning rate) and
    `_sweep_sharded2d` (per-rate traced learning rate).

    The optimizer scan is replicated along `sample_axis` (identical inputs
    -> identical trajectory on every member, no communication needed — the
    variational parameters are tiny, so recomputing beats communicating);
    the bound stage draws/scores only ``n_local`` samples per device and
    its statistics, PSIS tail fit, and corrected moments ride `sample_axis`
    collectives.
    """
    from .parallel.sharded_bounds import _draw_and_score_locals
    from .parallel.sharded_psis import _psis_moments_local, _smooth_local

    opt_key, draw_key = jax.random.split(key)
    values, log_norms, opt_param = _optimize_and_average(
        obj, n_iters, window, learning_rate, epsilon,
        learning_rate_end, unroll, init_param, opt_key)

    samples, lw_local, stats, cm = _draw_and_score_locals(
        var_family, log_density, opt_param, draw_key, n_local,
        n_bound_samples, sample_axis, alpha, need_empirical)
    if need_empirical:
        moments = {2: cm['C2'], 4: cm['C4']}
    else:
        moments = _closed_form_moments(var_family, opt_param, alpha)

    cutoffmin = jnp.log(jnp.finfo(lw_local.dtype).tiny)
    slw, khat = _smooth_local(lw_local, sample_axis, tail_len,
                              cutoffmin)
    psis_mean, psis_cov = _psis_moments_local(samples, slw,
                                              sample_axis)
    return _result_dict(var_family, values, log_norms, opt_param,
                        stats, moments, lw_local, slw, khat,
                        psis_mean, psis_cov)


def _sharded2d_out_specs(chain_axis, sample_axis):
    """Output partitioning of the batched 2-D pipelines: per-run arrays over
    `chain_axis`, per-sample arrays additionally over `sample_axis`.  The
    scalar pack every host decision reads (`host_pack` -> bounds, khat,
    best-run selection) is all_gather'ed inside the program and comes out
    replicated, so it is addressable by every process of a
    multi-controller run — fetching a chain-sharded array with
    `np.asarray` would fail on the processes that do not own it."""
    from jax.sharding import PartitionSpec as P
    return dict(
        opt_param=P(chain_axis, None),
        value_history=P(chain_axis, None),
        log_norm_history=P(chain_axis, None),
        q_mean=P(chain_axis, None),
        q_cov=P(chain_axis, None, None),
        log_weights=P(chain_axis, sample_axis),
        smoothed_log_weights=P(chain_axis, sample_axis),
        khat=P(chain_axis),
        psis_mean=P(chain_axis, None),
        psis_cov=P(chain_axis, None, None),
        host_pack=P(None, None),
    )


@partial(jax.jit, static_argnames=(
    'obj', 'var_family', 'log_density', 'n_iters', 'n_bound_samples',
    'window', 'learning_rate', 'epsilon', 'learning_rate_end', 'alpha',
    'unroll', 'tail_len', 'mesh', 'chain_axis', 'sample_axis'))
def _multistart_sharded2d(obj, var_family, log_density, n_iters,
                          n_bound_samples, window, learning_rate, epsilon,
                          learning_rate_end, alpha, unroll, tail_len, mesh,
                          chain_axis, sample_axis, init_params, keys):
    """Both mesh axes active in ONE fused program: the start axis is
    partitioned over `chain_axis` and every start's bound/PSIS stage is
    sharded over `sample_axis`.

    On a (C, S) mesh, each device runs ``n_starts / C`` complete optimizer
    scans (replicated along the sample axis — the variational parameters
    are tiny, so recomputing beats communicating) and then draws/scores
    only ``n_bound_samples / S`` of each of its starts' bound samples; the
    log-weight statistics, PSIS tail fit, and corrected moments ride
    `sample_axis` collectives *inside* a vmap over the local starts.  This
    is the production pod layout SURVEY.md section 2.4 calls for: K starts
    x sample-sharded 2.5e6-sample bounds in a single dispatch
    (reference anchors: viabel/vb.py:417 — the sequential start loop —
    and viabel/bounds.py:169-176 — the sample reduction being sharded).
    """
    from jax.sharding import PartitionSpec as P

    n_local = n_bound_samples // mesh.shape[sample_axis]
    # static probe: does the family have closed-form C2/C4 moments?
    # (ValueError is raised at trace time for e.g. a t family with df <= 4,
    # independent of the parameter value — same static branch as
    # `_pipeline_run_sharded`)
    need_empirical = _closed_form_moments(var_family, init_params[0],
                                          alpha) is None

    # check_vma=False for the same reason as parallel/sharded_psis: the
    # tail statistics are recomputed identically on every sample-axis
    # member from the all_gather'ed candidates, which the replication
    # checker cannot infer statically.
    # keys spec is rank-dependent: new-style typed PRNG keys are rank-1
    # (K,) while raw uint32 keys are (K, 2) — same discipline as the 1-D
    # multistart path below
    keys_spec = P(*([chain_axis] + [None] * (keys.ndim - 1)))

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(chain_axis, None), keys_spec),
             out_specs=_sharded2d_out_specs(chain_axis, sample_axis),
             check_vma=False)
    def run(local_inits, local_keys):
        def one_start(init_param, key):
            return _one_sharded_run(
                obj, var_family, log_density, n_iters, n_bound_samples,
                window, learning_rate, epsilon, learning_rate_end, alpha,
                unroll, tail_len, sample_axis, n_local, need_empirical,
                init_param, key)

        out = jax.vmap(one_start)(local_inits, local_keys)
        # replicate the host-facing scalar pack across the chain axis (tiny:
        # (n_starts, n_stats + d^2) floats) so every process of a
        # multi-controller run can assemble bounds and pick the best start
        out['host_pack'] = jax.lax.all_gather(
            out['host_pack'], chain_axis, axis=0, tiled=True)
        return out

    return run(init_params, keys)


@partial(jax.jit, static_argnames=(
    'obj', 'var_family', 'log_density', 'n_iters', 'n_bound_samples',
    'window', 'epsilon', 'alpha', 'unroll', 'tail_len', 'mesh',
    'chain_axis', 'sample_axis', 'has_lr_end'))
def _sweep_sharded2d(obj, var_family, log_density, n_iters, n_bound_samples,
                     window, epsilon, alpha, unroll, tail_len, mesh,
                     chain_axis, sample_axis, has_lr_end, init_param, key,
                     lrs, lr_ends):
    """The learning-rate sweep with both mesh axes active in ONE fused
    program: the rate axis is partitioned over `chain_axis` (each device
    runs ``n_rates / C`` complete optimizer scans) and every rate's
    bound/PSIS stage is sharded over `sample_axis` — the sweep counterpart
    of `_multistart_sharded2d`, sharing its body (`_one_sharded_run`) with
    the learning rate traced per element instead of static.  The init and
    key are replicated (common random numbers, as in the unsharded sweep).
    """
    from jax.sharding import PartitionSpec as P

    n_local = n_bound_samples // mesh.shape[sample_axis]
    need_empirical = _closed_form_moments(var_family, init_param,
                                          alpha) is None
    keys_spec = P(*([None] * key.ndim))
    lr_specs = (P(chain_axis), P(chain_axis)) if has_lr_end \
        else (P(chain_axis),)

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(None), keys_spec) + lr_specs,
             out_specs=_sharded2d_out_specs(chain_axis, sample_axis),
             check_vma=False)
    def run(init, k, *local_lr_args):
        def one_rate(lr, lr_end):
            return _one_sharded_run(
                obj, var_family, log_density, n_iters, n_bound_samples,
                window, lr, epsilon, lr_end, alpha, unroll, tail_len,
                sample_axis, n_local, need_empirical, init, k)

        if has_lr_end:
            out = jax.vmap(one_rate)(*local_lr_args)
        else:
            out = jax.vmap(lambda lr: one_rate(lr, None))(local_lr_args[0])
        out['host_pack'] = jax.lax.all_gather(
            out['host_pack'], chain_axis, axis=0, tiled=True)
        return out

    args = (init_param, key, lrs) + ((lr_ends,) if has_lr_end else ())
    return run(*args)


def validated_vi_multistart(log_density, var_family, init_param, n_iters, *,
                            n_starts=4, perturb_scale=0.5, init_params=None,
                            objective_and_grad=None, n_mc_samples=100,
                            n_bound_samples=1000000, alpha=2.0, key=None,
                            has_log_norm=None, window=10, learning_rate=0.01,
                            epsilon=0.1, learning_rate_end=None,
                            unroll='auto', log_norm_bound=None, mesh=None,
                            axis='chain',
                            sample_axis='sample'):
    """K independent validated-VI runs batched into ONE compiled program.

    The reference runs multi-start optimization as a sequential Python loop
    (reference: viabel/vb.py:417, 582); here the starts are `vmap`-ed over
    the batch axis, so K complete pipelines (optimize + bounds + PSIS) cost
    roughly one pipeline's wall-clock on a chip with headroom.  Start 0
    uses `init_param` unperturbed; start o >= 1 uses ``init + N(0,1) *
    (o+1) * perturb_scale`` (the reference's perturbation scheme,
    viabel/vb.py:417-421), unless explicit `init_params` (K, P) are given.

    `n_bound_samples` is per start: device memory scales with
    ``n_starts * n_bound_samples``.

    With `mesh=`, the start axis is placed on the mesh's `axis` (default
    ``chain``) and GSPMD partitions the batch across devices — N starts on
    N devices run in one start's wall-clock, the same pattern
    `parallel.shard_chain_inputs` applies to the IA chains runner.  When
    the mesh *also* carries `sample_axis` (default ``sample``) with more
    than one member — e.g. a 2x4 ``(chain, sample)`` mesh — both axes run
    in one fused program: starts partition over `axis` AND each start's
    bound/PSIS stage shards over `sample_axis` (`_multistart_sharded2d`),
    so a (C, S) mesh runs C start-groups x S-way-sharded bound passes
    simultaneously.  `sample_axis` must then divide `n_bound_samples`; the
    per-start optimizer trajectories are identical to the unsharded run
    (same keys), only the bound-stage Monte Carlo draws differ (per-device
    fold_in keys, the `validated_vi(mesh=)` discipline).  Pass
    ``sample_axis=None`` to force the start-axis-only placement.

    Returns
    -------
    dict like `validated_vi`'s but with a leading start axis on every
    array, ``bounds`` a list of K dicts, ``khat`` a list of K floats, and
    ``best`` the index of the start with the smallest validated
    2-divergence bound (ties to the lowest index).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    log_density = _hashable_log_density(log_density)
    if objective_and_grad is None:
        objective_and_grad = _default_objective(var_family, log_density,
                                                n_mc_samples)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = jnp.asarray(init_param)
    unroll = resolve_unroll(unroll)
    perturb_key, run_key = jax.random.split(key)
    if init_params is None:
        from .optimizers import _perturbed_inits
        init_params = _perturbed_inits(init_param, n_starts, perturb_scale,
                                       perturb_key)
    else:
        init_params = jnp.asarray(init_params)
        n_starts = init_params.shape[0]
    keys = jax.vmap(lambda i: jax.random.fold_in(run_key, i))(
        jnp.arange(n_starts))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if axis not in mesh.axis_names:
            raise ValueError(
                'the multistart partitions starts over a mesh axis named '
                '{!r}; the given mesh has axes {} (build it with '
                "make_mesh(axis_names=('chain', ...)) or pass "
                'axis=)'.format(axis, mesh.axis_names))
        if n_starts % mesh.shape[axis]:
            raise ValueError('the mesh axis size ({}) must divide n_starts '
                             '({})'.format(mesh.shape[axis], n_starts))
        init_params = jax.device_put(
            init_params, NamedSharding(mesh, P(axis, None)))
        keys = jax.device_put(
            keys, NamedSharding(mesh, P(*([axis] + [None] * (keys.ndim
                                                             - 1)))))
        if (sample_axis is not None and sample_axis != axis
                and sample_axis in mesh.axis_names
                and mesh.shape[sample_axis] > 1):
            # both mesh axes in one fused program (sample_axis == axis is
            # a 1-axis mesh named like the sample axis: the run axis owns
            # it, so the 1-D placement below applies — a 2-D spec would be
            # PartitionSpec(axis, axis), a DuplicateSpecError)
            if n_bound_samples % mesh.shape[sample_axis]:
                raise ValueError(
                    'the mesh {} axis size ({}) must divide '
                    'n_bound_samples ({})'.format(
                        sample_axis, mesh.shape[sample_axis],
                        n_bound_samples))
            out = _multistart_sharded2d(
                obj, var_family, log_density, n_iters, n_bound_samples,
                window, learning_rate, epsilon, learning_rate_end, alpha,
                unroll, _tail_len(n_bound_samples, 1.0), mesh, axis,
                sample_axis, init_params, keys)
            return _finalize_batch(out, n_starts, n_bound_samples,
                                   var_family.dim, alpha, log_norm_bound)
    tail_len = _tail_len(n_bound_samples, 1.0)
    runner = _multistart_runner(obj, var_family, log_density, n_iters,
                                n_bound_samples, window, learning_rate,
                                epsilon, learning_rate_end, alpha, unroll,
                                tail_len)
    out = runner(init_params, keys)
    return _finalize_batch(out, n_starts, n_bound_samples, var_family.dim,
                           alpha, log_norm_bound)


def _finalize_batch(out, n_runs, n_bound_samples, dim, alpha,
                    log_norm_bound):
    """Host assembly for batched pipelines: per-run bounds from the stacked
    pack (one fetch), plus best-run selection by the validated divergence
    bound — diverged runs (non-finite d) never win; all-diverged falls back
    to run 0.  The pack fetch goes through `parallel.fetch_global` so a
    multi-controller run (chain axis spanning processes) assembles the
    same bounds and picks the same best run on every rank."""
    from .parallel import fetch_global
    packs = fetch_global(out.pop('host_pack'))
    bounds, khats, diverged_flags = [], [], []
    for k in range(n_runs):
        b, kh, dv = _assemble_bounds(packs[k], n_bound_samples, dim, alpha,
                                     log_norm_bound)
        bounds.append(b)
        khats.append(kh)
        diverged_flags.append(dv)
    d_key = 'd2' if alpha == 2 else 'dalpha'
    out['bounds'] = bounds
    out['khat'] = khats
    d_vals = np.asarray([b[d_key] for b in bounds])
    d_vals = np.where(np.isfinite(d_vals), d_vals, np.inf)
    out['best'] = int(np.argmin(d_vals))
    if all(diverged_flags):
        # individual perturbed starts may legitimately diverge (that is
        # what the perturbation probes); ALL of them diverging means the
        # configuration, not the init, is broken — say so once
        import warnings
        warnings.warn(
            'every run in this batch diverged (non-finite log-weights): '
            'bounds are vacuous and `best` is arbitrary. Reduce the '
            'learning rate or switch objective (CHIVI at large d: see '
            'benchmarks/DIM_SCALING.md)', DivergedRunWarning)
    return out


@lru_cache(maxsize=256)
def _sweep_runner(obj, var_family, log_density, n_iters, n_bound_samples,
                  window, epsilon, alpha, unroll, tail_len, has_lr_end):
    """Compiled learning-rate-sweep program: `_pipeline_core` vmapped over
    traced learning rates with the init and key held fixed (common random
    numbers, so per-rate differences are purely the rate's effect)."""
    def run_one(init_param, key, lr, lr_end):
        return _pipeline_core(obj, var_family, log_density, n_iters,
                              n_bound_samples, window, lr, epsilon,
                              lr_end, alpha, unroll, tail_len, init_param,
                              key)
    if has_lr_end:
        return jax.jit(jax.vmap(run_one, in_axes=(None, None, 0, 0)))
    return jax.jit(jax.vmap(lambda i, k, lr: run_one(i, k, lr, None),
                            in_axes=(None, None, 0)))


def validated_vi_sweep(log_density, var_family, init_param, n_iters, *,
                       learning_rates, learning_rate_ends=None,
                       objective_and_grad=None, n_mc_samples=100,
                       n_bound_samples=100000, alpha=2.0, key=None,
                       has_log_norm=None, window=10, epsilon=0.1,
                       unroll='auto', log_norm_bound=None, mesh=None,
                       axis='chain', sample_axis='sample'):
    """Learning-rate sweep: one compiled program runs the complete
    validated pipeline once per rate and reports which rate's fit carries
    the tightest validated bound.

    All runs share the same init and PRNG key (common random numbers —
    identical draws per iteration), so per-rate differences in the bounds
    are the rate's effect alone, not Monte Carlo noise.  The reference has
    no sweep machinery; its notebooks re-run cells per configuration.

    Parameters
    ----------
    learning_rates : array-like of float
        Rates to sweep (all > 0).
    learning_rate_ends : optional array-like of float
        Per-rate schedule endpoints (each < its rate); None runs
        constant-rate schedules.
    mesh : optional jax.sharding.Mesh
        Partition the rate axis over the mesh's `axis` (default ``chain``)
        — N rates on N devices run in one rate's wall-clock, exactly like
        `validated_vi_multistart(mesh=)`.  When the mesh also carries
        `sample_axis` with more than one member (a 2-D ``(chain, sample)``
        mesh), each rate's bound/PSIS stage additionally shards over
        `sample_axis` in the same fused program (`_sweep_sharded2d`);
        `axis` must divide the number of rates and `sample_axis` must
        divide `n_bound_samples`.  Pass ``sample_axis=None`` to force the
        rate-axis-only placement.

    Returns
    -------
    dict like `validated_vi_multistart`'s (leading sweep axis, per-rate
    ``bounds``/``khat`` lists, ``best``) plus ``learning_rates`` echoed.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    log_density = _hashable_log_density(log_density)
    if objective_and_grad is None:
        objective_and_grad = _default_objective(var_family, log_density,
                                                n_mc_samples)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = jnp.asarray(init_param)
    unroll = resolve_unroll(unroll)
    lrs = np.asarray(learning_rates, dtype=np.float64)
    if lrs.ndim != 1 or lrs.size == 0:
        raise ValueError('learning_rates must be a non-empty 1-D array')
    if np.any(lrs <= 0):
        raise ValueError('learning rates must be positive')
    lr_ends = None
    if learning_rate_ends is not None:
        lr_ends = np.asarray(learning_rate_ends, dtype=np.float64)
        if lr_ends.shape != lrs.shape:
            raise ValueError('learning_rate_ends must match learning_rates')
        if np.any(lr_ends <= 0) or np.any(lrs <= lr_ends):
            raise ValueError('each end rate must satisfy '
                             '0 < learning_rate_end < learning_rate')
    tail_len = _tail_len(n_bound_samples, 1.0)
    dtype = init_param.dtype
    lrs_dev = jnp.asarray(lrs, dtype=dtype)
    lr_ends_dev = None if lr_ends is None else jnp.asarray(lr_ends,
                                                           dtype=dtype)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if axis not in mesh.axis_names:
            raise ValueError(
                'the sweep partitions rates over a mesh axis named {!r}; '
                'the given mesh has axes {} (build it with '
                "make_mesh(axis_names=('chain', ...)) or pass "
                'axis=)'.format(axis, mesh.axis_names))
        if lrs.size % mesh.shape[axis]:
            raise ValueError('the mesh axis size ({}) must divide the '
                             'number of learning rates ({})'.format(
                                 mesh.shape[axis], lrs.size))
        lr_sharding = NamedSharding(mesh, P(axis))
        lrs_dev = jax.device_put(lrs_dev, lr_sharding)
        if lr_ends_dev is not None:
            lr_ends_dev = jax.device_put(lr_ends_dev, lr_sharding)
        if (sample_axis is not None and sample_axis != axis
                and sample_axis in mesh.axis_names
                and mesh.shape[sample_axis] > 1):
            # both mesh axes in one fused program (sample_axis == axis is
            # a 1-axis mesh named like the sample axis: the run axis owns
            # it, so the 1-D placement below applies — a 2-D spec would be
            # PartitionSpec(axis, axis), a DuplicateSpecError)
            if n_bound_samples % mesh.shape[sample_axis]:
                raise ValueError(
                    'the mesh {} axis size ({}) must divide '
                    'n_bound_samples ({})'.format(
                        sample_axis, mesh.shape[sample_axis],
                        n_bound_samples))
            out = _sweep_sharded2d(
                obj, var_family, log_density, n_iters, n_bound_samples,
                window, epsilon, alpha, unroll, tail_len, mesh, axis,
                sample_axis, lr_ends is not None, init_param, key, lrs_dev,
                lr_ends_dev)
            out = _finalize_batch(out, lrs.size, n_bound_samples,
                                  var_family.dim, alpha, log_norm_bound)
            out['learning_rates'] = lrs
            return out
    runner = _sweep_runner(obj, var_family, log_density, n_iters,
                           n_bound_samples, window, epsilon, alpha, unroll,
                           tail_len, lr_ends is not None)
    args = (init_param, key, lrs_dev)
    if lr_ends_dev is not None:
        args += (lr_ends_dev,)
    out = runner(*args)
    out = _finalize_batch(out, lrs.size, n_bound_samples, var_family.dim,
                          alpha, log_norm_bound)
    out['learning_rates'] = lrs
    return out
