"""Sample-axis-sharded Monte Carlo bound estimation.

Mesh scaling of the reference's single-pass numpy bound estimation
(reference: viabel/bounds.py:169-176, notebooks/experiments.py:159-166,
which draw up to 2.5e6 samples on one host).  Under `jax.shard_map` each
device draws and scores only its shard of the samples (keys derived by
folding in the device's mesh index), and the CUBO/ELBO/moment statistics are
combined with `pmax`/`psum` collectives (NCCL on GPUs) — samples and
log-weights are never gathered to one device.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..bounds import divergence_bound, error_bounds, wasserstein_bounds

__all__ = [
    'sharded_log_weight_stats',
    'sharded_sample_stats',
    'sharded_all_bounds',
    'sharded_bound_psis',
]


def _stats_from_locals(lw_local, alpha, n_total, axis):
    """Collective reduction of log-weight statistics (runs per device).

    Second moments are two-pass (centered): the one-pass E[x^2] - E[x]^2
    form cancels catastrophically in f32 when |mean| >> std, which is
    routine for log-weights (mean ~ -500, std ~ 1).  This matches the
    two-pass `jnp.std` used by the unsharded `bounds.log_weight_stats`.
    Each pass stacks both scalars into ONE psum, so the collective count
    stays at 1 pmax + 2 psums.
    """
    gmax = jax.lax.pmax(jnp.max(lw_local), axis)
    w = jnp.exp(lw_local - gmax) ** alpha
    n = jnp.asarray(n_total, lw_local.dtype)
    mean_w, mean_lw = jax.lax.psum(
        jnp.stack([jnp.sum(w), jnp.sum(lw_local)]), axis) / n
    var_w, var_lw = jax.lax.psum(
        jnp.stack([jnp.sum((w - mean_w) ** 2),
                   jnp.sum((lw_local - mean_lw) ** 2)]), axis) / n
    return dict(
        log_rescale=gmax,
        mean_rescaled_alpha=mean_w,
        std_rescaled_alpha=jnp.sqrt(jnp.maximum(var_w, 0.0)),
        mean_lw=mean_lw,
        std_lw=jnp.sqrt(jnp.maximum(var_lw, 0.0)),
    )


def _central_moments_from_locals(samples_local, n_total, axis, with_cov=True):
    """psum-reduced centered moments C2/C4 (+ covariance when `with_cov`)
    of mesh-sharded samples (runs per device; the collective counterpart of
    `bounds.central_moments`).  Callers that already hold ``q_var`` pass
    ``with_cov=False`` to skip the dead per-device covariance matmul and
    its (d, d) psum (round-4 review)."""
    nf = jnp.asarray(n_total, samples_local.dtype)
    mean = jax.lax.psum(jnp.sum(samples_local, axis=0), axis) / nf
    c = samples_local - mean
    norm2 = jnp.sum(c ** 2, axis=1)
    out = dict(
        C2=jax.lax.psum(jnp.sum(norm2), axis) / nf,
        C4=jax.lax.psum(jnp.sum(norm2 ** 2), axis) / nf,
    )
    if with_cov:
        out['cov'] = jax.lax.psum(jnp.matmul(
            c.T, c, precision=jax.lax.Precision.HIGHEST), axis) / (nf - 1)
    return out


@lru_cache(maxsize=64)
def _build_log_weight_stats(mesh, alpha, axis, n_total):
    """Compiled-closure cache: shard_map programs are cached on their
    defining function's identity, so rebuilding the closure per call would
    recompile per call (see CLAUDE.md's `_pad_objective` convention).

    The `jax.jit` wrapper is load-bearing, not cosmetic: an eager
    (un-jitted) shard_map application re-lowers on every call, which
    costs a full compile per call.  `tests/test_parallel.py` asserts every
    builder returns a jitted program."""

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis), out_specs=P())
    def stats(lw_local):
        return _stats_from_locals(lw_local, alpha, n_total, axis)

    return stats


def sharded_log_weight_stats(log_weights, mesh, alpha=2.0, axis='sample'):
    """`viabel_tpu.bounds.log_weight_stats` over a mesh-sharded array.

    `log_weights` must be sharded along `axis` at dim 0 (see
    `viabel_tpu.parallel.shard_over`).  Returns a replicated stats dict
    consumable by `divergence_bound(..., _stats=...)`.

    Like the unsharded counterpart (which ravels), a multi-dimensional
    input is treated as one flat pool of log-weights: the local reductions
    already run over every element, and `n` is the total element count —
    round-4 review: using ``shape[0]`` here silently scaled every statistic
    of an (n, m) input by m.
    """
    n_total = int(np.prod(log_weights.shape))
    stats = _build_log_weight_stats(mesh, float(alpha), axis, n_total)
    out = stats(log_weights)
    out['n'] = n_total
    return out


@lru_cache(maxsize=64)
def _build_sample_stats(mesh, axis, n):
    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis, None), out_specs=P())
    def stats(x_local):
        return _central_moments_from_locals(x_local, n, axis)

    return stats


def sharded_sample_stats(samples, mesh, axis='sample'):
    """Centered moments C2/C4 and covariance of mesh-sharded samples.

    Two-collective pass: global mean first, then centered reductions
    (the sharded counterpart of `viabel_tpu.bounds.central_moments`).
    """
    return _build_sample_stats(mesh, axis, samples.shape[0])(samples)


def _draw_and_score_locals(family, log_density, vp, key, n_local, n_total,
                           axis, alpha, with_moments, with_cov=False):
    """The per-device fused draw -> score -> psum-stats body (must run
    inside a `shard_map` over `axis`): per-device keys via `fold_in` of the
    mesh index, `n_local` family draws, log-weights against `log_density`,
    and the collective statistics (+ central moments when `with_moments`,
    + the sample covariance when additionally `with_cov` — only
    `sharded_all_bounds` without a caller-supplied ``q_var`` needs it; the
    fused pipelines use C2/C4 only, so the default skips the dead matmul).

    One definition shared by `sharded_all_bounds`, `validated_vi(mesh=)`'s
    bound stage, and the 2-D batched pipelines (round-4 review: the body
    was written three times and fixes had to land in three places).
    """
    idx = jax.lax.axis_index(axis)
    k_local = jax.random.fold_in(key, idx)
    samples = family.sample(k_local, vp, n_local)
    lw_local = log_density(samples) - family.log_prob(vp, samples)
    stats = _stats_from_locals(lw_local, alpha, n_total, axis)
    cm = (_central_moments_from_locals(samples, n_total, axis, with_cov)
          if with_moments else None)
    return samples, lw_local, stats, cm


@lru_cache(maxsize=64)
def _build_local_estimate(model_log_prob, family, mesh, axis, n_local,
                          n_samples, alpha, compute_moments, with_cov,
                          return_samples):
    """Cached fused sample->score->reduce program for `sharded_all_bounds`.

    Keyed on the model/family identities (like `optimizers._pad_objective`):
    repeated calls with the same model, family, mesh, and sizes hit the same
    jitted program instead of recompiling (each compile costs seconds).
    """
    out_specs = (P(), P(axis), P(axis, None)) if return_samples \
        else (P(), P(axis))

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P()),
             out_specs=out_specs)
    def local_estimate(vp, k):
        samples, lw_local, stats, cm = _draw_and_score_locals(
            family, model_log_prob, vp, k, n_local, n_samples, axis, alpha,
            compute_moments, with_cov)
        if cm is not None:
            stats.update(cm)
        if return_samples:
            return stats, lw_local, samples
        return stats, lw_local

    return local_estimate


def sharded_all_bounds(model_log_prob, family, var_param, n_samples, key,
                       mesh, alpha=2.0, axis='sample', log_norm_bound=None,
                       moment_bound_fn=None, q_var=None, p_var=None,
                       return_log_weights=False, return_samples=False):
    """Fused sharded sample->score->reduce bound estimation.

    Each device generates ``n_samples / n_devices`` samples from the family
    (per-device keys via `fold_in` of the mesh index), scores them against
    `model_log_prob`, and the bound statistics are psum-reduced — the
    mesh-scaled version of `get_samples_and_log_weights` + `all_bounds`
    (reference: notebooks/experiments.py:60-63, 159-166).

    Returns the `all_bounds` results dict; with `return_log_weights=True`
    also returns the still-sharded log-weights (for `psislw_sharded`).
    """
    if alpha != 2:
        # same guard as the unsharded `all_bounds` (bounds.py): the
        # Wasserstein / moment-error formulas are 2-divergence bounds only;
        # use sharded_log_weight_stats + divergence_bound for other orders
        raise ValueError('sharded_all_bounds requires alpha == 2 (the '
                         'Wasserstein and moment-error bounds are only '
                         'valid for the 2-divergence); use '
                         'sharded_log_weight_stats with divergence_bound '
                         'for other alpha values')
    n_dev = mesh.shape[axis]
    if n_samples % n_dev:
        raise ValueError('the mesh axis size ({}) must divide n_samples '
                         '({})'.format(n_dev, n_samples))
    n_local = n_samples // n_dev
    var_param = jnp.asarray(var_param)

    from ..utils import _hashable_log_density
    compute_moments = moment_bound_fn is None
    # the covariance is only needed as the q_var fallback; with a
    # caller-supplied q_var the per-device matmul + (d, d) psum are dead
    with_cov = compute_moments and q_var is None
    local_estimate = _build_local_estimate(
        _hashable_log_density(model_log_prob), family, mesh, axis, n_local,
        n_samples, float(alpha), compute_moments, with_cov, return_samples)
    out = local_estimate(var_param, key)
    stats, lw_sharded = out[0], out[1]
    samples_sharded = out[2] if return_samples else None
    # copy before adding 'n': the dict came out of the cached program
    stats = dict(stats)
    stats['n'] = n_samples
    results = _host_bound_assembly(stats, alpha, log_norm_bound,
                                   moment_bound_fn, compute_moments,
                                   with_cov, q_var, p_var)
    extras = []
    if return_log_weights:
        extras.append(lw_sharded)
    if return_samples:
        extras.append(samples_sharded)
    if extras:
        return (results, *extras)
    return results


def _host_bound_assembly(stats, alpha, log_norm_bound, moment_bound_fn,
                         compute_moments, with_cov, q_var, p_var):
    """Shared host epilogue of the sharded bound passes: the scalar bound
    algebra (`divergence_bound` -> `wasserstein_bounds` -> `error_bounds`)
    from the already-psum-reduced statistics dict."""
    d2, log_norm_bound = divergence_bound(
        None, alpha=alpha, log_norm_bound=log_norm_bound,
        return_log_norm_bound=True, _stats=stats)
    moments = None
    if compute_moments:
        moments = dict(C2=stats['C2'], C4=stats['C4'])
        if with_cov:
            moments['cov'] = stats['cov']
    results = wasserstein_bounds(d2, samples=None,
                                 moment_bound_fn=moment_bound_fn,
                                 _moments=moments)
    if q_var is None and moments is not None and with_cov:
        q_var = np.asarray(moments['cov'])
        if q_var.shape == (1, 1):
            q_var = q_var[0, 0]
    results.update(error_bounds(W1=results['W1'], W2=results['W2'],
                                q_var=np.inf if q_var is None else q_var,
                                p_var=np.inf if p_var is None else p_var))
    results['d2'] = d2
    results['log_norm_bound'] = log_norm_bound
    return results


@lru_cache(maxsize=64)
def _build_bound_psis(model_log_prob, family, mesh, axis, n_local, n_samples,
                      alpha, compute_moments, with_cov, tail_len):
    """Cached fused draw -> score -> stats -> PSIS program: the complete
    sharded bound+PSIS pass in ONE dispatch.

    The two-program path (`sharded_all_bounds` then `psislw_sharded`)
    round-trips the full log-weight vector through device memory between
    programs and pays two dispatches; fusing lets XLA keep the
    log-weights hot and halves the dispatch count.  `check_vma=False` for the PSIS tail recompute, exactly as in
    `parallel.sharded_psis._build_psislw`.
    """
    from .sharded_psis import _smooth_local

    out_specs = (P(), P(axis), P())

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P()),
             out_specs=out_specs, check_vma=False)
    def bound_psis(vp, k):
        samples, lw_local, stats, cm = _draw_and_score_locals(
            family, model_log_prob, vp, k, n_local, n_samples, axis, alpha,
            compute_moments, with_cov)
        if cm is not None:
            stats.update(cm)
        # cutoffmin from the LOG-WEIGHT dtype (which the model log-density
        # may have promoted past var_param's), exactly as psislw_sharded
        # and the fused pipelines derive it — a var_param-dtype value
        # would clamp the f64 tail cutoff at log(f32 tiny) (round-5
        # review)
        cutoffmin = jnp.log(jnp.finfo(lw_local.dtype).tiny)
        slw, khat = _smooth_local(lw_local, axis, tail_len, cutoffmin)
        return stats, slw, khat

    return bound_psis


def sharded_bound_psis(model_log_prob, family, var_param, n_samples, key,
                       mesh, alpha=2.0, axis='sample', Reff=1.0,
                       log_norm_bound=None, moment_bound_fn=None,
                       q_var=None, p_var=None):
    """Fused sharded draw -> score -> bound statistics -> PSIS in ONE
    compiled program.

    The workflow serve ``/bounds`` and the bench's sharded pass run —
    previously composed as `sharded_all_bounds` + `psislw_sharded`, i.e.
    two dispatches with the log-weight vector written to and re-read from
    HBM in between; fused, the chip runs the whole pass back to back
    (reference workload: viabel/bounds.py:169-176 +
    notebooks/psis.py:112-199, here scaled over the mesh `axis`).

    Returns ``(results, smoothed_log_weights, khat)``: the `all_bounds`
    results dict (host floats), the still-sharded smoothed log-weights,
    and the PSIS tail index as a host float.  Every host-facing scalar
    (the five log-weight statistics, khat, and the empirical C2/C4 when no
    `moment_bound_fn` is given) crosses device->host in ONE packed
    transfer (CLAUDE.md fetch convention).
    """
    if alpha != 2:
        raise ValueError('sharded_bound_psis requires alpha == 2 (the '
                         'Wasserstein and moment-error bounds are only '
                         'valid for the 2-divergence)')
    n_dev = mesh.shape[axis]
    if n_samples % n_dev:
        raise ValueError('the mesh axis size ({}) must divide n_samples '
                         '({})'.format(n_dev, n_samples))
    if n_samples <= 1:
        raise ValueError('More than one log-weight needed.')
    n_local = n_samples // n_dev
    var_param = jnp.asarray(var_param)

    from ..bounds import _STAT_KEYS
    from ..psis import _tail_len
    from ..utils import _hashable_log_density
    compute_moments = moment_bound_fn is None
    with_cov = compute_moments and q_var is None
    tail_len = _tail_len(n_samples, Reff)
    prog = _build_bound_psis(
        _hashable_log_density(model_log_prob), family, mesh, axis, n_local,
        n_samples, float(alpha), compute_moments, with_cov, tail_len)
    stats, slw, khat = prog(var_param, key)
    stats = dict(stats)

    # ONE packed device->host transfer for every scalar the host algebra
    # reads (the `bounds._fetch_stats` discipline, extended with khat and
    # the empirical moments)
    names = list(_STAT_KEYS) + ['khat'] + (
        ['C2', 'C4'] if compute_moments else [])
    arrs = [jnp.asarray(v) for v in
            ([stats[k] for k in _STAT_KEYS] + [khat]
             + ([stats['C2'], stats['C4']] if compute_moments else []))]
    dt = jnp.result_type(*arrs)
    packed = np.asarray(jnp.stack([a.astype(dt) for a in arrs]))
    host = dict(zip(names, (float(v) for v in packed)))
    host_stats = {k: host[k] for k in _STAT_KEYS}
    host_stats['n'] = n_samples
    if compute_moments:
        host_stats['C2'], host_stats['C4'] = host['C2'], host['C4']
        if with_cov:
            host_stats['cov'] = stats['cov']  # (d, d); one small fetch
    results = _host_bound_assembly(host_stats, alpha, log_norm_bound,
                                   moment_bound_fn, compute_moments,
                                   with_cov, q_var, p_var)
    return results, slw, host['khat']
