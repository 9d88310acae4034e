"""Recompile sentinels: repeated calls must hit the executable cache.

The framework's whole performance premise is that every hot entry point
compiles once per (static config, shape) and then replays the cached
executable — a single stray re-lowering costs a full compile per call
(seconds to minutes for the fused programs; an eager shard_map
application re-lowers on every call).  CPU correctness tests cannot see that class of defect, so these tests count
XLA compilations directly (via `jax_log_compiles`) and assert the second
invocation of each public entry point compiles NOTHING.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from viabel_tpu import (adagrad_optimize, all_bounds, black_box_klvi,
                        mean_field_t_variational_family,
                        rmsprop_IA_optimize_with_rhat, t_variational_family,
                        validated_vi, validated_vi_multistart)
from viabel_tpu.bounds import family_moment_bounds
from viabel_tpu.models import funnel_model
from viabel_tpu.parallel import (make_mesh, psislw_sharded,
                                 sharded_all_bounds, sharded_psis_moments,
                                 shard_over)
from viabel_tpu.psis import psislw
from viabel_tpu.utils import count_compilations


def _assert_second_call_cached(call, *variants):
    """`call(key)` twice (fresh data, same statics): the second call must
    trigger zero XLA compilations.  Counting via the public
    `viabel_tpu.utils.count_compilations` helper — one implementation of
    the log-listening mechanism, tested here and usable by users."""
    with count_compilations() as first:
        call(jax.random.PRNGKey(0))  # compile everything
    assert first[0] > 0, 'sanity: the first call should have compiled'
    with count_compilations() as again:
        for k in variants or (jax.random.PRNGKey(1),):
            call(k)
    assert again[0] == 0, (
        'the repeated call recompiled ({} compilations)'.format(again[0]))


MODEL = funnel_model()
FAM = mean_field_t_variational_family(2, 40)
OBJ = black_box_klvi(FAM, MODEL.log_prob, 10, presampled=True)
TFAM = t_variational_family(2, 50)


def test_adagrad_repeated_calls_cached():
    init = FAM.init_param()
    _assert_second_call_cached(
        lambda k: jax.block_until_ready(
            adagrad_optimize(50, OBJ, init, key=k, learning_rate=.01)[0]))


def test_ia_optimizer_repeated_calls_cached():
    init = FAM.init_param()
    _assert_second_call_cached(
        lambda k: jax.block_until_ready(rmsprop_IA_optimize_with_rhat(
            60, OBJ, init, 2, n_optimisers=2, key=k, rhat_window=20,
            tail_avg_iters=20)[0]))


def test_bound_pass_repeated_calls_cached():
    vp = FAM.init_param()

    def one_pass(k):
        samples = FAM.sample(k, vp, 4096)
        lw = MODEL.log_prob(samples) - FAM.log_prob(vp, samples)
        res = all_bounds(lw, q_var=np.asarray(FAM.mean_and_cov(vp)[1]),
                         moment_bound_fn=family_moment_bounds(FAM, vp))
        slw, khat = psislw(lw)
        jax.block_until_ready(slw)
        return res

    _assert_second_call_cached(one_pass)


def test_full_rank_bound_pass_repeated_calls_cached():
    vp = TFAM.init_param()

    def one_pass(k):
        samples = TFAM.sample(k, vp, 4096)
        lw = MODEL.log_prob(samples) - TFAM.log_prob(vp, samples)
        slw, khat = psislw(lw)
        jax.block_until_ready(slw)

    _assert_second_call_cached(one_pass)


def test_sharded_bound_and_psis_repeated_calls_cached():
    """THE regression test for the eager-shard_map defect: before the
    builders were jit-wrapped, every call here re-lowered (compiled) the
    shard_map program again."""
    mesh = make_mesh(axis_names=('sample',), shape=(8,))
    vp = FAM.init_param()

    def one_pass(k):
        res, lw = sharded_all_bounds(
            MODEL.log_prob, FAM, vp, 4096, k, mesh,
            moment_bound_fn=family_moment_bounds(FAM, vp),
            return_log_weights=True)
        slw, khat = psislw_sharded(lw, mesh)
        jax.block_until_ready(slw)

    _assert_second_call_cached(one_pass,
                               jax.random.PRNGKey(1), jax.random.PRNGKey(2))


def test_sharded_psis_moments_repeated_calls_cached():
    mesh = make_mesh(axis_names=('sample',), shape=(8,))

    def one_pass(k):
        x = jax.random.normal(k, (4096, 2))
        slw = jnp.zeros(4096) - np.log(4096.0)
        x_s = shard_over(x, mesh, 'sample')
        slw_s = shard_over(slw, mesh, 'sample')
        jax.block_until_ready(
            sharded_psis_moments(x_s, slw_s, mesh)[0])

    _assert_second_call_cached(one_pass)


def test_validated_vi_repeated_calls_cached():
    _assert_second_call_cached(
        lambda k: validated_vi(MODEL.log_prob, FAM, FAM.init_param(), 50,
                               objective_and_grad=OBJ, n_mc_samples=10,
                               n_bound_samples=4096, key=k))


def test_validated_vi_mesh_repeated_calls_cached():
    mesh = make_mesh(axis_names=('sample',), shape=(8,))
    _assert_second_call_cached(
        lambda k: validated_vi(MODEL.log_prob, FAM, FAM.init_param(), 50,
                               objective_and_grad=OBJ, n_mc_samples=10,
                               n_bound_samples=4096, key=k, mesh=mesh))


def test_validated_vi_multistart_repeated_calls_cached():
    _assert_second_call_cached(
        lambda k: validated_vi_multistart(
            MODEL.log_prob, FAM, FAM.init_param(), 50, n_starts=2,
            objective_and_grad=OBJ, n_mc_samples=10, n_bound_samples=4096,
            key=k))


def test_rebuilt_mesh_hits_the_jit_cache():
    """serve's /fit and the CLI build a FRESH Mesh object per call; Mesh
    hashing is content-based, so a rebuilt identical mesh must hit both
    the lru_cache'd shard_map builders and the jitted pipeline programs.
    If JAX ever switched Mesh to identity hashing, every /fit would
    recompile its pipeline — this pins the assumption."""
    init = jnp.zeros(FAM.var_param_dim, dtype=jnp.float64)

    def call(k, mesh=None):
        if mesh is None:
            mesh = make_mesh(axis_names=('chain', 'sample'), shape=(2, 4))
        out = validated_vi_multistart(
            MODEL.log_prob, FAM, init, 40, n_starts=2,
            objective_and_grad=OBJ, n_bound_samples=8192, key=k, mesh=mesh)
        jax.block_until_ready(out['opt_param'])

    with count_compilations() as first:
        call(jax.random.PRNGKey(0))
    assert first[0] > 0
    with count_compilations() as again:
        call(jax.random.PRNGKey(1))  # fresh, equal mesh rebuilt inside
    assert again[0] == 0, (
        'a rebuilt identical mesh recompiled ({})'.format(again[0]))


def test_public_count_compilations_utility():
    """The public observability helper detects both a fresh compile and a
    cached replay (viabel_tpu.utils.count_compilations)."""
    from viabel_tpu.utils import count_compilations

    @jax.jit
    def f(x):
        return (x * 3.0).sum()

    x = jnp.arange(7, dtype=jnp.float32)
    x2 = x + 1  # pre-compile the eager add outside the counted blocks
    with count_compilations() as n_first:
        jax.block_until_ready(f(x))
    assert n_first[0] >= 1
    with count_compilations() as n_again:
        jax.block_until_ready(f(x2))
    assert n_again[0] == 0
