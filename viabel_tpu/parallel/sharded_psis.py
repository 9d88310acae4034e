"""Distributed Pareto-smoothed importance sampling.

Scales `viabel_tpu.psis.psislw` over a mesh-sharded log-weight vector.
The reference's PSIS globally argsorts all n weights on one host
(reference: notebooks/psis.py:157-174); but only the largest
``tail_len = ceil(min(0.2 n, 3 sqrt(n/Reff)))`` weights participate in the
GPD fit, so the sharded design is:

1. each device takes `lax.top_k(tail_len)` of its local shard,
2. an `all_gather` moves only those ``n_devices * tail_len`` candidates
   (not the n weights) to every device,
3. the global tail, cutoff, GPD fit, and smoothed quantiles are computed
   replicated (tiny arrays),
4. each device rewrites its own above-cutoff weights with the smoothed
   values matching their global rank — body weights never move,
5. renormalization is a `psum` of exponentials.

Ties at the cutoff: ranks are assigned by value order with index-free
comparison, so exactly-equal tail values receive the same smoothed quantile
(the reference's argsort breaks such ties by index; for continuous weights
this is measure-zero).
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..psis import _tail_len, gpdfit, gpinv

__all__ = ['psislw_sharded', 'psisloo_sharded', 'sharded_psis_moments']


def _smooth_local(lw_local, axis, tail_len, cutoffmin):
    """Per-device PSIS smoothing body: the local shard of log-weights in,
    the smoothed local shard plus the (replicated) khat out.

    Runs inside any `shard_map` whose mesh carries the named `axis` —
    `psislw_sharded` wraps it directly, and the 2-D multistart pipeline
    (`pipeline._multistart_sharded2d`) vmaps it per start with the sample
    collectives riding the same axis.
    """
    gmax = jax.lax.pmax(jnp.max(lw_local), axis)
    x = lw_local - gmax

    # (1)-(2): local top-k, gather only the candidates.  Each device
    # contributes its top tail_len+1 so the gathered pool provably
    # contains the global top tail_len+1 (tail plus cutoff element),
    # including on a single-device mesh.
    local_top, local_idx = jax.lax.top_k(x, min(tail_len + 1, x.shape[0]))
    cands = jax.lax.all_gather(local_top, axis).reshape(-1)
    # (3): replicated global tail (descending) and cutoff
    g_top, _ = jax.lax.top_k(cands, tail_len + 1)
    xcutoff = jnp.maximum(g_top[tail_len], cutoffmin)
    tail_desc = g_top[:tail_len]
    tail_asc = tail_desc[::-1]
    mask = tail_asc > xcutoff
    n2 = jnp.sum(mask)

    expxcutoff = jnp.exp(xcutoff)
    exceedances = jnp.exp(tail_asc) - expxcutoff
    k, sigma = gpdfit(exceedances, mask, n2)
    khat = jnp.where(n2 <= 4, jnp.inf, k)
    do_smooth = (n2 > 4) & (k >= 1.0 / 3.0) & jnp.isfinite(k)

    pos_in_valid = jnp.arange(tail_len) - (tail_len - n2)
    n2f = jnp.maximum(n2, 1).astype(x.dtype)
    sti = jnp.clip((pos_in_valid.astype(x.dtype) + 0.5) / n2f,
                   1e-12, 1 - 1e-12)
    qq = jnp.log(gpinv(sti, k, sigma) + expxcutoff)     # ascending

    # (4): rewrite ONLY the local top-k candidates, then scatter them back
    # by their saved indices — the unsharded `_psislw_1d` discipline.
    # Every local above-cutoff weight is provably among the local top
    # tail_len+1 (at most tail_len weights exceed the global cutoff in
    # TOTAL, and locally they are by definition the largest), so the
    # ranks only ever matter for those candidates: ranking all n_local
    # elements with a full-array searchsorted does n_local / (tail_len+1)
    # times the work for the same answer.  Rank of a
    # candidate among the ascending valid tail = searchsorted position:
    # for v > xcutoff every invalid (<= cutoff) tail entry is strictly
    # below v, so the position counts exactly #{tail values < v}.
    cand_in_tail = local_top > xcutoff
    rank = jnp.clip(jnp.searchsorted(tail_asc, local_top), 0, tail_len - 1)
    cand_new = jnp.where(cand_in_tail & do_smooth, qq[rank], local_top)
    # candidates not rewritten scatter their original value back (no-op)
    x_new = x.at[local_idx].set(cand_new)
    x_new = jnp.where(do_smooth, jnp.minimum(x_new, 0.0), x_new)

    # (5): distributed logsumexp renormalization
    m = jax.lax.pmax(jnp.max(x_new), axis)
    z = jax.lax.psum(jnp.sum(jnp.exp(x_new - m)), axis)
    x_new = x_new - (jnp.log(z) + m)
    return x_new, khat


@lru_cache(maxsize=64)
def _build_psislw(mesh, axis, tail_len, cutoffmin, ndim=1):
    """Compiled-closure cache (shard_map programs are keyed on function
    identity; a per-call closure would recompile per call — CLAUDE.md's
    `_pad_objective` convention).  The returned program is `jax.jit`-wrapped:
    eager shard_map re-lowers, i.e. compiles again, on every call.

    ``ndim=2`` handles column-stacked log-weight vectors (the `psisloo`
    layout, draws x points): the single-vector body is vmapped over the
    replicated column axis — the collectives act on the named mesh axis,
    which is orthogonal to the vmapped one.
    """
    # check_vma=False: the tail statistics are computed identically on every
    # device from the all_gather'ed candidates, but the replication checker
    # cannot infer that statically.
    def smooth_one(lw_local):
        return _smooth_local(lw_local, axis, tail_len, cutoffmin)

    if ndim == 1:
        smooth = partial(jax.shard_map, mesh=mesh, in_specs=P(axis),
                         out_specs=(P(axis), P()),
                         check_vma=False)(smooth_one)
    else:
        @partial(jax.shard_map, mesh=mesh, in_specs=P(axis, None),
                 out_specs=(P(axis, None), P()), check_vma=False)
        def smooth(lw_local):
            return jax.vmap(smooth_one, in_axes=1,
                            out_axes=(1, 0))(lw_local)

    return jax.jit(smooth)


def psislw_sharded(log_weights, mesh, Reff=1.0, axis='sample'):
    """PSIS over a mesh-sharded log-weight array.

    1-D input: returns ``(smoothed_log_weights, khat)``.  2-D input
    (draws x columns, sharded over the draw axis): each column is smoothed
    independently and `khat` has shape ``(n_columns,)`` — the `psisloo`
    layout, matching `viabel_tpu.psis.psislw`'s 2-D semantics.  Smoothed
    weights keep the input's sharding; khat is replicated.
    """
    # same input contract as the unsharded `psislw` (psis.py) — without
    # these guards bad input dies deep inside top_k / shard_map instead
    log_weights = jnp.asarray(log_weights)  # no-op on sharded device arrays
    if log_weights.ndim not in (1, 2):
        raise ValueError('Argument `lw` must be 1 or 2 dimensional.')
    n = log_weights.shape[0]
    if n <= 1:
        raise ValueError('More than one log-weight needed.')
    tail_len = _tail_len(n, Reff)
    cutoffmin = float(np.log(np.finfo(np.dtype(log_weights.dtype)).tiny))
    return _build_psislw(mesh, axis, tail_len, cutoffmin,
                         log_weights.ndim)(log_weights)


@lru_cache(maxsize=64)
def _build_colsumlogs(mesh, axis):
    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=P(axis, None), out_specs=P())
    def colsumlogs(lw_local):
        m = jax.lax.pmax(jnp.max(lw_local, axis=0), axis)
        z = jax.lax.psum(jnp.sum(jnp.exp(lw_local - m), axis=0), axis)
        return jnp.log(z) + m

    return colsumlogs


def psisloo_sharded(log_lik, mesh, axis='sample', **kwargs):
    """PSIS leave-one-out log predictive densities over a mesh-sharded
    ``(n_draws, n_points)`` log-likelihood matrix.

    Distributed version of `viabel_tpu.psis.psisloo` (reference:
    notebooks/psis.py:68-109): draws stay sharded over the mesh; each
    point's importance-weight tail is gathered via the top-k path of
    `psislw_sharded`.  Returns ``(loo, loos, ks)`` with `loos`/`ks`
    replicated ``(n_points,)`` arrays.
    """
    log_lik = jnp.asarray(log_lik)
    lw, ks = psislw_sharded(-log_lik, mesh, axis=axis, **kwargs)
    loos = _build_colsumlogs(mesh, axis)(lw + log_lik)
    # ONE packed host transfer for the scalar total and both (m,) vectors
    # (the unsharded `psis.psisloo` discipline; a bare float(jnp.sum())
    # pays an extra dispatch-floor fetch), routed through `fetch_global`
    # so a multi-controller mesh gathers instead of raising
    from .mesh import fetch_global
    packed = fetch_global(jnp.concatenate(
        [jnp.sum(loos)[None], loos, ks.astype(loos.dtype)]))
    m = loos.shape[0]
    return float(packed[0]), packed[1:1 + m], packed[1 + m:]


def _psis_moments_local(x_local, slw_local, axis):
    """Per-device body of the importance-weighted moment reduction (shared
    by `sharded_psis_moments` and the 2-D multistart pipeline)."""
    m = jax.lax.pmax(jnp.max(slw_local), axis)
    w = jnp.exp(slw_local - m)
    wsum = jax.lax.psum(jnp.sum(w), axis)
    w = w / wsum
    mean = jax.lax.psum(jnp.sum(w[:, None] * x_local, axis=0), axis)
    c = x_local - mean
    cov = jax.lax.psum(jnp.matmul((w[:, None] * c).T, c,
        precision=jax.lax.Precision.HIGHEST), axis)
    return mean, cov


@lru_cache(maxsize=64)
def _build_psis_moments(mesh, axis):
    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(axis, None), P(axis)),
             out_specs=P())
    def moments(x_local, slw_local):
        mean, cov = _psis_moments_local(x_local, slw_local, axis)
        return dict(mean=mean, cov=cov)

    return moments


def sharded_psis_moments(samples, smoothed_log_weights, mesh, axis='sample'):
    """Self-normalized importance-weighted mean and covariance from sharded
    samples and smoothed log-weights.

    Mesh-scaled version of `improve_with_psis`'s moment estimation
    (reference: notebooks/experiments.py:80-87: exp-normalize weights,
    weighted mean, `np.cov(..., aweights=wts, ddof=0)`).
    """
    out = _build_psis_moments(mesh, axis)(samples, smoothed_log_weights)
    return out['mean'], out['cov']
