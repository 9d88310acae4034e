"""Stochastic optimizers for variational parameters.

JAX rebuild of the reference optimizers
(reference: viabel/vb.py:324-712).  The reference runs a Python loop calling
`objective_and_grad` once per iteration (~250 host dispatches/second is its
throughput ceiling; reference: viabel/vb.py:357-380).  Here the *entire*
optimization loop — sampling, density evaluation, reparameterization
gradient, windowed rescaling, and parameter update — is a single
`jax.lax.scan` compiled into one XLA program, so iterations run at device
speed with zero per-step host round-trips.  Multi-start "chains"
(`n_optimisers`), sequential in the reference (reference: viabel/vb.py:417,
582), are `vmap`-ed here and shard over a device mesh (see
`viabel_tpu.parallel`).

All optimizers accept `objective_and_grad(var_param, key)` returning
``(value, grad)`` or ``(value, grad, log_norm)``; pass `has_log_norm=True`
(or use an objective carrying the ``has_log_norm`` attribute, e.g.
`black_box_chivi`) for the 3-output form.
"""
import os
from functools import lru_cache, partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .diagnostics import (compute_R_hat_adaptive, compute_R_hat_halfway,
                          stochastic_iterate_averaging)

__all__ = [
    'learning_rate_schedule',
    'resolve_unroll',
    'adagrad_optimize',
    'rmsprop_IA_optimize_with_rhat',
    'adam_IA_optimize_with_rhat',
    'rmsprop_IA_optimize',
    'adam_IA_optimize',
]


def learning_rate_schedule(i, n_iters, learning_rate, learning_rate_end=None):
    """Learning rate at iteration `i` (pure function of `i`).

    Constant for the first quarter, harmonic ``a/(b + i)`` decay over the
    middle half, constant `learning_rate_end` for the last quarter —
    the reference expresses the same schedule as a generator
    (reference: viabel/vb.py:324-342).

    `learning_rate` (and `learning_rate_end`) may be traced scalars — the
    sweep runner (`pipeline.validated_vi_sweep`) vmaps over them; the
    eager validation below then falls to the caller (the sweep validates
    on the host before tracing).
    """
    traced = (isinstance(learning_rate, jax.core.Tracer)
              or isinstance(learning_rate_end, jax.core.Tracer))
    if not traced:
        if learning_rate <= 0:
            raise ValueError('learning rate must be positive')
        # learning_rate_end <= 0 would freeze the final quarter (lr = 0)
        # or put the harmonic pole b inside the decay phase (negative and
        # sign-flipping rates) — reject it, don't let the run silently
        # stall or diverge
        if (learning_rate_end is not None
                and not (0 < learning_rate_end < learning_rate)):
            raise ValueError('final learning rate must satisfy '
                             '0 < learning_rate_end < learning_rate')
    if learning_rate_end is None:
        return jnp.asarray(learning_rate)
    b = n_iters * learning_rate_end / (2 * (learning_rate - learning_rate_end))
    a = learning_rate * b
    start_decrease_at = n_iters // 4
    end_decrease_at = 3 * n_iters // 4
    i = jnp.asarray(i)
    mid = a / (b + i - start_decrease_at + 1)
    return jnp.where(i < start_decrease_at, learning_rate,
                     jnp.where(i < end_decrease_at, mid, learning_rate_end))


def _copy_obj_attrs(src, dst):
    for attr in ('presampled', 'make_draws', 'make_draws_range'):
        if hasattr(src, attr):
            setattr(dst, attr, getattr(src, attr))
    return dst


@lru_cache(maxsize=256)
def _pad_objective(objective_and_grad):
    def wrapped(var_param, key):
        out = objective_and_grad(var_param, key)
        value, grad = out[0], out[1]
        return value, grad, jnp.zeros_like(value)
    return _copy_obj_attrs(objective_and_grad, wrapped)


@lru_cache(maxsize=256)
def _truncate_objective(objective_and_grad):
    def wrapped(var_param, key):
        out = objective_and_grad(var_param, key)
        return out[0], out[1], out[2]
    return _copy_obj_attrs(objective_and_grad, wrapped)


_RECOMPILE_WARN_AT = 32


def _warn_if_many_objectives():
    """One-time warning when many distinct objective instances have been
    wrapped: each distinct instance is a distinct static jit argument, so
    it costs a full optimizer recompile.  Catches the construct-objectives-
    in-a-loop pattern that silently recompiles per call."""
    misses = (_pad_objective.cache_info().misses
              + _truncate_objective.cache_info().misses)
    if misses == _RECOMPILE_WARN_AT:
        import warnings
        warnings.warn(
            '{} distinct objective instances have been passed to the '
            'optimizers this process; every distinct instance triggers a '
            'full recompile of the optimizer scan.  Construct each '
            'objective once (outside loops) and reuse it so repeated runs '
            'hit the jit cache.'.format(_RECOMPILE_WARN_AT),
            stacklevel=4)


def _wrap_objective(objective_and_grad, has_log_norm):
    """Normalize an objective to the 3-output (value, grad, log_norm) form.

    Objectives may return (value, grad), (value, grad, log_norm), or longer
    tuples with extra diagnostics (e.g. `black_box_chivi_neff`'s n_eff).
    The wrappers are cached per underlying objective so the compiled
    optimizer runners (which treat the objective as a static argument) hit
    the jit cache on repeated calls.
    """
    if has_log_norm is None:
        has_log_norm = getattr(objective_and_grad, 'has_log_norm', False)
    wrapped = (_truncate_objective(objective_and_grad) if has_log_norm
               else _pad_objective(objective_and_grad))
    _warn_if_many_objectives()
    return wrapped


class _WindowState(NamedTuple):
    """Ring buffer of recent gradients and log-norms
    (the reference keeps Python lists; reference: viabel/vb.py:364-373)."""
    grads: jnp.ndarray      # (window, P)
    log_norms: jnp.ndarray  # (window,)


def _window_accum(state, i, grad, log_norm, window):
    """Insert (grad, log_norm) and return (new_state, accum_sum).

    accum_sum = sum over the valid window of (exp(min log_norm - log_norm)
    * grad)^2, matching the reference's min-rescaled windowed adagrad
    denominator (reference: viabel/vb.py:371-373).  Slots not yet filled are
    masked out of the min and contribute zero.
    """
    slot = jnp.mod(i, window)
    grads = state.grads.at[slot].set(grad)
    log_norms = state.log_norms.at[slot].set(log_norm)
    valid = jnp.arange(window) < jnp.minimum(i + 1, window)
    masked_ln = jnp.where(valid, log_norms, jnp.inf)
    scale = jnp.where(valid, jnp.exp(jnp.min(masked_ln) - log_norms), 0.0)
    scaled = scale[:, None] * grads
    accum_sum = jnp.sum(scaled ** 2, axis=0)
    return _WindowState(grads, log_norms), accum_sum


# `lax.scan` unroll of the windowed-adagrad body that 'auto' resolves to.
# Measured on an H100 (benchmarks/unroll_sweep.py, 5,000 iterations): 8
# was fastest at both P = 20 (eight-schools mean-field t) and P = 5,150
# (d = 100 full-rank), ahead of 4 by 5.5 % and 7.3 % and of 1 by 44 % and
# 51 %, so one constant serves every size.
_AUTO_UNROLL = 8


def resolve_unroll(unroll):
    """Resolve ``unroll='auto'`` to the measured-best `lax.scan` unroll.

    The reference has no analogous knob (its loop is a Python `for`;
    reference: viabel/vb.py:357-380).  On the GPU each scan iteration
    launches its own kernels, and unrolling lets XLA fuse across
    iterations and run fewer loop trips.  Integers pass through unchanged,
    so explicit values (including the bit-identity-sensitive
    ``unroll=1``) are always honored.
    """
    if isinstance(unroll, str):
        if unroll != 'auto':
            raise ValueError(
                "unroll must be a positive int or 'auto', got {!r}"
                .format(unroll))
        return _AUTO_UNROLL
    unroll = int(unroll)
    if unroll < 1:
        raise ValueError('unroll must be >= 1, got {}'.format(unroll))
    return unroll


def _make_adagrad_step(obj, n_iters, window, learning_rate, epsilon,
                       learning_rate_end, dtype):
    """Single windowed-adagrad iteration (reference: viabel/vb.py:357-376),
    shared by the whole-run driver (`_adagrad_run`) and the segmented
    resumable driver (`checkpoint.adagrad_optimize_resumable`) so the
    update rule lives in exactly one place."""

    def step(carry, xs):
        i, rng_or_draws = xs
        param, wstate = carry
        value, grad, log_norm = obj(param, rng_or_draws)
        # a float64 model (x64 data) may emit float64 outputs while the
        # param and window ring buffers carry float32; optimizer state and
        # emitted histories stay in the param dtype (the segmented/
        # checkpoint driver allocates its history templates in the param
        # dtype, so both drivers record the same dtypes; for exact
        # whole-run/resumable trajectory correspondence also pass
        # ``unroll=1`` to `adagrad_optimize` — its default ('auto' -> 8)
        # lets XLA fuse across iterations differently than the
        # resumable driver's plain scan, which can differ in the low bits)
        value = value.astype(dtype)
        grad = grad.astype(dtype)
        log_norm = log_norm.astype(dtype)
        wstate, accum_sum = _window_accum(wstate, i, grad, log_norm, window)
        lr = learning_rate_schedule(i, n_iters, learning_rate,
                                    learning_rate_end).astype(dtype)
        param = param - lr * grad / jnp.sqrt(epsilon + accum_sum)
        return (param, wstate), (value, log_norm, param)

    return step


def _progress_report(i, n_iters, value):
    """Host-side progress line (the reference uses tqdm with a running
    average-loss description; reference: viabel/vb.py:377-380)."""
    print('\r  iter {:>7d}/{} | loss = {:<12.6g}'.format(
        int(i) + 1, int(n_iters), float(value)),
        end='' if int(i) + 1 < int(n_iters) else '\n', flush=True)


@partial(jax.jit, static_argnames=('obj', 'n_iters', 'window',
                                   'learning_rate', 'epsilon',
                                   'learning_rate_end', 'progress',
                                   'unroll', 'keep_history'))
def _adagrad_run(obj, n_iters, window, learning_rate, epsilon,
                 learning_rate_end, init_param, key, progress=False,
                 unroll=4, keep_history=True):
    """Compiled whole-loop adagrad.  Static over the objective (a hashable
    function) and hyperparameters, so repeated calls with fresh
    params/keys hit the jit cache.

    The tail-quarter average is accumulated in the scan carry in BOTH
    modes (one (P,) add per iteration), so the smoothed parameter is
    bit-identical whether or not the history is kept.  With
    ``keep_history=False`` (the large-P mode) the (n_iters, P) parameter
    stack is never emitted at all — 7.3 GB at P = 45,450 / 40k iters, more
    HBM than the chip has — and the third return value is the averaged
    parameter instead of the stack."""
    dtype = init_param.dtype
    P = init_param.shape[0]
    presampled = getattr(obj, 'presampled', False)
    base_step = _make_adagrad_step(obj, n_iters, window, learning_rate,
                                   epsilon, learning_rate_end, dtype)
    tail_start = 3 * n_iters // 4

    def step(carry, xs):
        (inner, tail_sum) = carry
        inner, out = base_step(inner, xs)
        if progress:
            i, value = xs[0], out[0]
            report_now = (jnp.mod(i, max(n_iters // 100, 1)) == 0) \
                | (i == n_iters - 1)
            jax.lax.cond(
                report_now,
                lambda: jax.debug.callback(_progress_report, i, n_iters,
                                           value),
                lambda: None)
        i = xs[0]
        value, log_norm, param = out
        tail_sum = tail_sum + jnp.where(i >= tail_start, param, 0.0)
        if keep_history:
            return (inner, tail_sum), out
        return (inner, tail_sum), (value, log_norm)

    iters = jnp.arange(n_iters)
    if presampled:
        # all randomness generated in one batched call, outside the scan
        xs = (iters, obj.make_draws(key, n_iters, dtype))
    else:
        xs = (iters, jax.vmap(lambda i: jax.random.fold_in(key, i))(iters))
    wstate = _WindowState(jnp.zeros((window, P), dtype),
                          jnp.zeros((window,), dtype))
    tail_sum = jnp.zeros((P,), dtype)
    # unroll > 1 trims lax.scan's per-step overhead on this small body
    # (`resolve_unroll`)
    carry, outs = jax.lax.scan(
        step, ((init_param, wstate), tail_sum), xs, unroll=unroll)
    tail_mean = carry[1] / jnp.asarray(n_iters - tail_start, dtype)
    if keep_history:
        values, log_norms, params = outs
        return values, log_norms, params, tail_mean
    values, log_norms = outs
    return values, log_norms, tail_mean


def adagrad_optimize(n_iters, objective_and_grad, init_param, *, key=None,
                     has_log_norm=None, window=10, learning_rate=.01,
                     epsilon=.1, learning_rate_end=None, progress=False,
                     unroll='auto', return_history=True):
    """Windowed adagrad with min-log-norm gradient rescaling and
    tail-quarter iterate averaging (reference: viabel/vb.py:345-389).

    The loop is one `lax.scan`; per-iteration PRNG keys are derived with
    `fold_in` from `key`.  Returns
    ``(smoothed_opt_param, variational_param_history, value_history,
    log_norm_history)`` where the parameter history covers the last quarter
    of iterations, as in the reference (reference: viabel/vb.py:375-376,
    386-388).

    ``return_history=False`` is the large-P mode: the (tail_iters, P)
    parameter history is never materialized (7+ GB for a full-rank d = 300
    family over 40k iterations) and the second return value is ``None``.
    In both modes the smoothed parameter comes from the same in-scan
    running sum, so the two modes agree bit-for-bit
    (`tests/test_optimizers.py::test_adagrad_no_history_mode`); the
    in-scan sum equals the history mean up to summation order.

    ``unroll='auto'`` (the default) resolves to the measured-best scan
    unroll via `resolve_unroll`.  Pass an explicit int to pin it
    (``unroll=1`` for bit-exact correspondence with the resumable driver).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = jnp.asarray(init_param)
    unroll = resolve_unroll(unroll)
    if not return_history:
        values, log_norms, tail_mean = _adagrad_run(
            obj, n_iters, window, learning_rate, epsilon,
            learning_rate_end, init_param, key, progress, unroll,
            keep_history=False)
        return tail_mean, None, values, log_norms
    values, log_norms, params, tail_mean = _adagrad_run(
        obj, n_iters, window, learning_rate, epsilon, learning_rate_end,
        init_param, key, progress, unroll)
    tail = params[3 * n_iters // 4:]
    return tail_mean, tail, values, log_norms


def _perturbed_inits(init_param, n_optimisers, scale, key):
    """Chain inits: chain 0 unperturbed; chain o >= 1 gets
    ``init + N(0,1) * (o+1) * scale`` (reference: viabel/vb.py:417-421 with
    scale 0.5 for RMSProp, viabel/vb.py:582-586 with scale 0.2 for Adam)."""
    init_param = jnp.asarray(init_param)
    noise = jax.random.normal(key, (n_optimisers, init_param.shape[0]),
                              dtype=init_param.dtype)
    mult = (jnp.arange(n_optimisers, dtype=init_param.dtype) + 1) * scale
    mult = mult.at[0].set(0.0)
    return init_param[None, :] + noise * mult[:, None]


def _make_chain_step(obj, kind, n_iters, learning_rate, epsilon,
                     learning_rate_end, avg_start, dtype):
    """Per-iteration update shared by the whole-run and segmented chain
    runners.  `kind` selects the rule: 'rmsprop' (EMA of squared grads,
    alpha=0.9; reference: viabel/vb.py:446-464) or 'adam' (bias-corrected
    moments with power i+2; reference: viabel/vb.py:611-623).

    Carry is ``(param, v, m, avg)``; `avg` is a running mean of the
    post-update parameters over iterations ``i > avg_start`` (the online
    tail average the reference maintains when ``averaging=True``;
    reference: viabel/vb.py:624-627 — the reference's recursion erroneously
    averages only the last two iterates, see PARITY.md; implemented here as
    the running mean it was intended to be).  With ``avg_start=None`` the
    avg slot is carried through untouched.

    The emitted history entry is the *pre-update* parameter
    (reference: viabel/vb.py:466, 628).
    """
    alpha, beta1, beta2 = 0.9, 0.9, 0.999

    def step(carry, xs):
        i, rng_or_draws = xs
        param, v, m, avg = carry
        value, grad, log_norm = obj(param, rng_or_draws)
        # keep optimizer state and emitted histories in the param dtype even
        # when a float64 model (x64 data) emits float64 outputs; the
        # segmented/checkpoint drivers allocate their history templates in
        # the param dtype, and bit-identity across drivers is guaranteed
        value = value.astype(dtype)
        grad = grad.astype(dtype)
        log_norm = log_norm.astype(dtype)
        lr = learning_rate_schedule(i, n_iters, learning_rate,
                                    learning_rate_end).astype(dtype)
        if kind == 'rmsprop':
            v = jnp.where(i == 0, grad ** 2,
                          v * alpha + (1. - alpha) * grad ** 2)
            new_param = param - lr * grad / jnp.sqrt(epsilon + v)
        else:  # adam
            v = jnp.where(i == 0, 0.9 * grad ** 2,
                          v * beta2 + (1. - beta2) * grad ** 2)
            m = jnp.where(i == 0, 0.9 * grad,
                          m * beta1 + (1. - beta1) * grad)
            fi = (i + 2).astype(dtype)
            m_hat = m / (1 - beta1 ** fi)
            v_hat = v / (1 - beta2 ** fi)
            new_param = param - lr * m_hat / jnp.sqrt(epsilon + v_hat)
        if avg_start is not None:
            count = jnp.maximum(i - avg_start, 1).astype(dtype)
            avg = jnp.where(i > avg_start,
                            avg + (new_param - avg) / count,
                            new_param)
        return (new_param, v, m, avg), (value, log_norm, param)

    return step


def _chain_xs(obj, chain_key, i0, length, dtype):
    """Per-iteration scan inputs for iterations [i0, i0 + length)."""
    iters = jnp.arange(length) + i0
    if getattr(obj, 'presampled', False):
        return (iters, obj.make_draws_range(chain_key, i0, length, dtype))
    return (iters,
            jax.vmap(lambda i: jax.random.fold_in(chain_key, i))(iters))


@partial(jax.jit, static_argnames=('obj', 'kind', 'n_iters', 'learning_rate',
                                   'epsilon', 'learning_rate_end', 'hist_cap',
                                   'avg_start', 'unroll'))
def _chains_run(obj, kind, n_iters, learning_rate, epsilon,
                learning_rate_end, inits, keys, hist_cap=None,
                avg_start=None, unroll=1):
    """vmapped per-chain lax.scan, compiled once per (objective, config).

    Replacement for the reference's sequential
    ``for o in range(n_optimisers)`` loop (reference: viabel/vb.py:417, 582).

    `unroll` stays at 1 by default: unrolling reorders the step's floating
    point ops, which would break the guaranteed bit-identity with the
    segmented checkpoint/progress driver (`_chains_run_segmented`), and the
    vmapped chain axis already amortizes scan-step overhead.

    `hist_cap` bounds the retained parameter history: when it is smaller
    than `n_iters`, the scan carries a ``(hist_cap, P)`` ring buffer instead
    of emitting a full ``(n_iters, P)`` history, matching the reference's
    ``100 * window`` history cap (reference: viabel/vb.py:476-477, 629-630)
    and keeping device memory bounded for long runs.  Returns
    ``((values, log_norms, chains), final_params, avg_params)`` where
    `chains` holds the last ``min(n_iters, hist_cap)`` pre-update parameters
    in chronological order.
    """
    use_ring = hist_cap is not None and hist_cap < n_iters
    # presampling is handled entirely by _chain_xs: it feeds the scan
    # per-iteration draws instead of keys when obj.presampled is set

    def one_chain(init_param, chain_key):
        dtype = init_param.dtype
        P = init_param.shape[0]
        step = _make_chain_step(obj, kind, n_iters, learning_rate, epsilon,
                                learning_rate_end, avg_start, dtype)

        if use_ring:
            def ring_step(carry, xs):
                inner, ring = carry
                i = xs[0]
                inner, (value, log_norm, param) = step(inner, xs)
                ring = ring.at[jnp.mod(i, hist_cap)].set(param)
                return (inner, ring), (value, log_norm)
        else:
            ring_step = None

        xs = _chain_xs(obj, chain_key, 0, n_iters, dtype)
        zeros = jnp.zeros((P,), dtype)
        carry0 = (init_param, zeros, zeros, zeros)
        if use_ring:
            ring0 = jnp.zeros((hist_cap, P), dtype)
            (carry, ring), (values, log_norms) = jax.lax.scan(
                ring_step, (carry0, ring0), xs, unroll=unroll)
            chains = jnp.roll(ring, -(n_iters % hist_cap), axis=0)
        else:
            carry, (values, log_norms, chains) = jax.lax.scan(
                step, carry0, xs, unroll=unroll)
        return (values, log_norms, chains), carry[0], carry[3]

    return jax.vmap(one_chain)(inits, keys)


@partial(jax.jit, static_argnames=('obj', 'kind', 'n_iters', 'learning_rate',
                                   'epsilon', 'learning_rate_end',
                                   'avg_start', 'length'))
def _chains_segment(obj, kind, n_iters, learning_rate, epsilon,
                    learning_rate_end, avg_start, length, i0, params, v, m,
                    avg, keys):
    """One compiled segment of the chains run: iterations [i0, i0+length).

    `i0` is a traced scalar so every equal-length segment reuses the same
    executable.  Carry state is explicit, which is what makes the segmented
    driver checkpointable and resumable (see
    `rmsprop_IA_optimize_with_rhat(checkpoint_path=...)`).
    """
    def one_chain(param, v, m, avg, chain_key):
        dtype = param.dtype
        step = _make_chain_step(obj, kind, n_iters, learning_rate, epsilon,
                                learning_rate_end, avg_start, dtype)
        xs = _chain_xs(obj, chain_key, i0, length, dtype)
        carry, ys = jax.lax.scan(step, (param, v, m, avg), xs)
        return carry, ys

    return jax.vmap(one_chain)(params, v, m, avg, keys)


@partial(jax.jit, static_argnames=('obj', 'n_iters', 'window',
                                   'learning_rate', 'epsilon',
                                   'learning_rate_end', 'length',
                                   'keep_history'))
def _adagrad_segment(obj, n_iters, window, learning_rate, epsilon,
                     learning_rate_end, length, i0, param, wstate, tail_sum,
                     key, keep_history=True):
    """One compiled segment of the windowed-adagrad run: iterations
    [i0, i0+length).

    Module-level jit with the objective static (the `_chains_segment`
    pattern) so every call of the resumable driver — including each resume
    of the same run — reuses the cached executable instead of re-tracing;
    `i0` is traced so equal-length segments share one program.

    `tail_sum` carries the running sum of post-update parameters over the
    tail quarter (iterations >= 3*n_iters//4) across segments — the same
    one-add-per-iteration accumulation `_adagrad_run` keeps in its scan
    carry, in the same order, so the resumable driver's smoothed parameter
    is bit-identical to the whole-run driver's (at ``unroll=1``).  With
    ``keep_history=False`` the (length, P) parameter stack is never
    emitted — the large-P resumable mode."""
    dtype = param.dtype
    base_step = _make_adagrad_step(obj, n_iters, window, learning_rate,
                                   epsilon, learning_rate_end, dtype)
    tail_start = 3 * n_iters // 4

    def step(carry, xs):
        inner, ts = carry
        inner, out = base_step(inner, xs)
        i = xs[0]
        value, log_norm, new_param = out
        if keep_history:
            # history mode returns the mean of the emitted history; the
            # running sum would be dead O(P) work per iteration
            return (inner, ts), out
        ts = ts + jnp.where(i >= tail_start, new_param, 0.0)
        return (inner, ts), (value, log_norm)

    xs = _chain_xs(obj, key, i0, length, dtype)
    ((param, wstate), tail_sum), ys = jax.lax.scan(
        step, ((param, wstate), tail_sum), xs)
    return param, wstate, tail_sum, ys


def _segment_progress(i_done, n_iters, tail_values):
    """Reference-style running-average-loss progress line
    (reference: viabel/vb.py:469-473, 631-635 print
    ``Average Loss = mean(value_history[i-1000:i+1])`` via tqdm).
    `tail_values` holds only the trailing ~1000 iterations' losses."""
    avg_loss = float(np.mean(tail_values))
    print('\r  iter {:>7d}/{} | average loss = {:<12,.6g}'.format(
        i_done, n_iters, avg_loss),
        end='' if i_done < n_iters else '\n', flush=True)


def _chains_run_segmented(obj, kind, n_iters, learning_rate, epsilon,
                          learning_rate_end, inits, keys, hist_cap,
                          avg_start, save_every, checkpoint_path, progress,
                          mesh=None):
    """Segmented chains driver: progress reporting, checkpoint/resume, and
    interrupt-safe partial results.

    The reference's Python loop is tqdm-instrumented and returns partial
    histories on KeyboardInterrupt (reference: viabel/vb.py:469-481,
    631-643); a single compiled scan can do neither, so this driver runs the
    same math (bit-identical: same per-iteration keys, same update rule) in
    `save_every`-iteration compiled segments with the carry held explicitly.
    After each segment the state is checkpointed (if `checkpoint_path`), a
    progress line is printed (if `progress`), and a KeyboardInterrupt
    between segments returns everything computed so far.

    Returns ``((values, log_norms, chains), final_params, avg_params,
    i_done)`` with histories truncated to the `i_done` completed iterations.
    """
    inits = jnp.asarray(inits)
    n_chains, P = inits.shape
    np_dtype = np.dtype(inits.dtype)  # no device fetch: dtype is metadata
    cap = min(hist_cap, n_iters) if hist_cap is not None else n_iters

    from .checkpoint import FORMAT_CHAINS, _host_key_data
    template = dict(
        # explicit self-describing format id (see `checkpoint_format`)
        format=np.asarray(FORMAT_CHAINS),
        i=np.zeros((), np.int64),
        keys=_host_key_data(keys),
        params=np.zeros((n_chains, P), np_dtype),
        v=np.zeros((n_chains, P), np_dtype),
        m=np.zeros((n_chains, P), np_dtype),
        avg=np.zeros((n_chains, P), np_dtype),
        values=np.zeros((n_chains, n_iters), np_dtype),
        lns=np.zeros((n_chains, n_iters), np_dtype),
        hist=np.zeros((n_chains, cap, P), np_dtype),
        # run configuration beyond what the shapes above pin, value-checked
        # on resume: a changed rate/epsilon/averaging-start — or resuming
        # an RMSProp checkpoint with the Adam driver — would silently
        # splice two different update rules into one trajectory
        # (round-4 review)
        kind=np.asarray(str(kind)),
        learning_rate=np.asarray(float(learning_rate)),
        epsilon=np.asarray(float(epsilon)),
        learning_rate_end=np.asarray(
            np.nan if learning_rate_end is None else float(
                learning_rate_end)),
        avg_start=np.asarray(-1 if avg_start is None else int(avg_start),
                             np.int64),
    )
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        from .checkpoint import _load_resume_state, _validate_resume
        state = _load_resume_state(checkpoint_path, template)
        # reject a changed configuration or PRNG key stream — either would
        # silently corrupt the resumed trajectory (see checkpoint.py)
        _validate_resume(state, template, checkpoint_path, 'keys',
                         value_entries=('format', 'kind', 'learning_rate',
                                        'epsilon', 'learning_rate_end',
                                        'avg_start'))
        start = int(state['i'])
    else:
        state = template
        from .parallel import fetch_global
        state['params'] = fetch_global(inits)  # inits may be chain-sharded
        start = 0

    params = jnp.asarray(state['params'])
    v = jnp.asarray(state['v'])
    m = jnp.asarray(state['m'])
    avg = jnp.asarray(state['avg'])
    if mesh is not None:
        # the host round-trip through the checkpoint template dropped the
        # chain-axis placement; restore it so the jitted segments partition
        # chains over the mesh exactly like the whole-run driver (`keys`
        # never round-trips and keeps its placement from the caller)
        from jax.sharding import NamedSharding, PartitionSpec
        sharding = NamedSharding(mesh, PartitionSpec('chain', None))
        params, v, m, avg = (jax.device_put(x, sharding)
                             for x in (params, v, m, avg))

    i = start
    try:
        while i < n_iters:
            length = min(save_every, n_iters - i)
            (params, v, m, avg), (vals, lns, hist_seg) = _chains_segment(
                obj, kind, n_iters, learning_rate, epsilon,
                learning_rate_end, avg_start, length, jnp.asarray(i),
                params, v, m, avg, keys)
            # fetch_global: with a multi-controller mesh the chain axis
            # spans processes and np.asarray would raise; every rank keeps
            # the full (identical) host state, so checkpoints written on
            # each host of a pod slice are interchangeable
            from .parallel import fetch_global
            state['values'][:, i:i + length] = fetch_global(vals)
            state['lns'][:, i:i + length] = fetch_global(lns)
            # ring-write the parameter history into the capped host buffer;
            # only the trailing min(length, cap) iterations can survive the
            # cap, and restricting to them keeps the slot indices unique
            # (numpy fancy-index assignment with duplicates is unordered)
            keep = min(length, cap)
            slots = np.arange(i + length - keep, i + length) % cap
            state['hist'][:, slots] = fetch_global(hist_seg)[:,
                                                            length - keep:]
            i += length
            state['i'] = np.asarray(i)
            if checkpoint_path is not None:
                # the optimizer-state fetches are only needed when a
                # checkpoint is actually written: in progress-only mode
                # they would pay 4 device->host syncs per segment for
                # nothing — the final state is fetched once after the loop
                state['params'] = fetch_global(params)
                state['v'] = fetch_global(v)
                state['m'] = fetch_global(m)
                state['avg'] = fetch_global(avg)
                from .checkpoint import save_checkpoint
                save_checkpoint(checkpoint_path, state)
            if progress:
                _segment_progress(
                    i, n_iters, state['values'][:, max(i - 1000, 0):i])
    except KeyboardInterrupt:
        if progress:
            print()
        if i == 0:
            # interrupted before the first segment completed (likely during
            # its compile): there are no partial results to return, and the
            # empty history would crash the R-hat post-pass — propagate the
            # interrupt instead
            raise
        # partial results: truncate to completed iterations (reference:
        # viabel/vb.py:476-481, 638-643 return partial histories)

    i_done = i
    values = state['values'][:, :i_done]
    lns = state['lns'][:, :i_done]
    kept = min(i_done, cap)
    first_kept = i_done - kept
    order = (first_kept + np.arange(kept)) % cap
    chains = state['hist'][:, order]
    # host numpy straight through: the only caller (_ia_optimize) fetches
    # every one of these to the host immediately, so re-wrapping the
    # run's largest buffers in jnp.asarray would pay a pointless
    # host->device->host round trip; `params`/`avg` are the live device
    # carries, fetched once
    # here (fetch_global: they may be chain-sharded across processes)
    from .parallel import fetch_global
    return ((values, lns, chains),
            fetch_global(params), fetch_global(avg), i_done)


def _ia_postprocess(K, chains, values, log_norms, rhat_window,
                    r_mean_threshold, r_sigma_threshold, tail_avg_iters):
    """R-hat-driven iterate-averaging post-pass shared by the RMSProp and
    Adam IA optimizers (reference: viabel/vb.py:487-549, 649-709).

    `chains` has shape (n_chains, hist_len, P) with the location block in
    ``[:, :, :K]`` and the scale block in ``[:, :, K:]``; `hist_len` may be
    shorter than `n_iters` when the ``100 * window`` history cap applied
    (reference: viabel/vb.py:629-630) or the run was interrupted — indices
    (R-hat windows, averaging starts) are then relative to the retained
    history, as in the reference's post-pass over the truncated list.

    The fetches go through `parallel.fetch_global`: under a
    multi-controller runtime the chain axis spans processes and a naive
    ``np.asarray`` raises; every process gathers the full (small) history
    so the R-hat gates and averaging windows are computed identically on
    every rank.
    """
    from .parallel import fetch_global
    chains = fetch_global(chains)
    values = fetch_global(values)
    log_norms = fetch_global(log_norms)
    hist_len = chains.shape[1]
    rhats = compute_R_hat_adaptive(chains, window_size=rhat_window)
    rhats_halfway = compute_R_hat_halfway(chains, interval=100, start=200)

    rhat_mean_windows, rhat_sigma_windows = rhats[:, :K], rhats[:, K:]
    rhat_mean_halfway = rhats_halfway[:, :K]
    rhat_sigma_halfway = rhats_halfway[:, K:]

    # First window index where two consecutive windows have all dims below
    # threshold sets the start of averaging (reference: viabel/vb.py:495-512;
    # clamped at 0 — the reference crashes when tail_avg_iters > n_iters).
    def find_start(windows, threshold):
        start = max(hist_len - tail_avg_iters, 0)
        for ee in range(windows.shape[0] - 1):
            if (windows[ee] < threshold).all() and \
               (windows[ee + 1] < threshold).all():
                return ee * rhat_window
        return start

    start_swa_m_iters = find_start(rhat_mean_windows, r_mean_threshold)
    start_swa_s_iters = find_start(rhat_sigma_windows, r_sigma_threshold)

    averaged_variational_mean_list = []
    averaged_variational_sigmas_list = []
    for o in range(chains.shape[0]):
        means_iters, _ = stochastic_iterate_averaging(
            chains[o, :, :K], start_swa_m_iters)
        sigmas_iters, _ = stochastic_iterate_averaging(
            chains[o, :, K:], start_swa_s_iters)
        averaged_variational_mean_list.append(means_iters)
        averaged_variational_sigmas_list.append(sigmas_iters)

    optimisation_log = dict(
        start_avg_mean_iters=start_swa_m_iters,
        start_avg_sigma_iters=start_swa_s_iters,
        r_hat_mean=rhat_mean_windows,
        r_hat_sigma=rhat_sigma_windows,
        r_hat_mean_halfway=rhat_mean_halfway,
        r_hat_sigma_halfway=rhat_sigma_halfway,
    )
    # the gathered host copy of `chains` rides along so the caller's return
    # does not pay a SECOND full gather of the largest buffer in the
    # routine (n_chains x hist_cap x P — and a second cross-process
    # allgather of it under a multi-controller mesh)
    return (averaged_variational_mean_list, averaged_variational_sigmas_list,
            np.asarray(values).reshape(-1), np.asarray(log_norms).reshape(-1),
            optimisation_log, chains)


def _ia_optimize(kind, perturb_scale, n_iters, objective_and_grad,
                 init_param, K, key, has_log_norm, window, learning_rate,
                 epsilon, rhat_window, averaging, n_optimisers,
                 r_mean_threshold, r_sigma_threshold, tail_avg_iters,
                 learning_rate_end, mesh, checkpoint_path, save_every,
                 progress):
    """Shared driver for the RMSProp-IA and Adam-IA optimizers."""
    if key is None:
        key = jax.random.PRNGKey(0)
    obj = _wrap_objective(objective_and_grad, has_log_norm)
    init_param = jnp.asarray(init_param)

    init_key, *chain_keys = jax.random.split(key, n_optimisers + 1)
    inits = _perturbed_inits(init_param, n_optimisers, perturb_scale,
                             init_key)
    chain_keys = jnp.stack(chain_keys)
    if mesh is not None:
        from .parallel.sharded_chains import shard_chain_inputs
        inits, chain_keys = shard_chain_inputs(inits, chain_keys, mesh)

    # history cap: keep at most 100*window iterates per chain
    # (reference: viabel/vb.py:476-477, 629-630)
    hist_cap = 100 * window if window is not None else None
    # online tail average from n_iters // 1.3 when averaging is on
    # (reference: viabel/vb.py:624-627)
    avg_start = int(n_iters // 1.3) if averaging else None

    if checkpoint_path is not None or progress:
        ((values, log_norms, chains), final_params, avg_params,
         _i_done) = _chains_run_segmented(
            obj, kind, n_iters, learning_rate, epsilon, learning_rate_end,
            inits, chain_keys, hist_cap, avg_start, save_every,
            checkpoint_path, progress, mesh=mesh)
    else:
        (values, log_norms, chains), final_params, avg_params = _chains_run(
            obj, kind, n_iters, learning_rate, epsilon, learning_rate_end,
            inits, chain_keys, hist_cap=hist_cap, avg_start=avg_start)

    (avg_means, avg_sigmas, value_history, log_norm_history,
     optimisation_log, host_chains) = _ia_postprocess(
        K, chains, values, log_norms, rhat_window,
        r_mean_threshold, r_sigma_threshold, tail_avg_iters)
    from .parallel import fetch_global
    if averaging:
        optimisation_log['averaged_variational_param'] = \
            fetch_global(avg_params)
    # post-final-update parameter of the last chain, matching the reference
    # return (reference: viabel/vb.py:547); `host_chains` is the post-pass's
    # already-gathered copy — do not gather the device array a second time
    return (fetch_global(final_params)[-1], host_chains, avg_means,
            avg_sigmas, value_history, log_norm_history, optimisation_log)


def rmsprop_IA_optimize_with_rhat(n_iters, objective_and_grad, init_param, K,
                                  *, key=None, has_log_norm=None, window=500,
                                  learning_rate=.01, epsilon=.000001,
                                  rhat_window=500, averaging=True,
                                  n_optimisers=1, r_mean_threshold=1.15,
                                  r_sigma_threshold=1.20, tail_avg_iters=2000,
                                  learning_rate_end=None, mesh=None,
                                  checkpoint_path=None, save_every=1000,
                                  progress=False):
    """RMSProp with R-hat-gated iterate averaging over parallel chains
    (reference: viabel/vb.py:392-549).

    The per-step rule is an EMA of squared gradients (alpha = 0.9) as the
    adaptive denominator (reference: viabel/vb.py:446-464); the history
    records *pre-update* parameters (reference: viabel/vb.py:466).  The
    reference's ``avg_grad_norm=True`` branch is a no-op bug
    (``grad_norm*a+(1-a)*grad_norm``; reference: viabel/vb.py:454) and is
    intentionally not replicated.  Chains run vmapped, not sequentially.

    `window` caps the retained per-chain parameter history at
    ``100 * window`` iterates (reference: viabel/vb.py:476-477); pass
    ``window=None`` to keep the full history.  With ``averaging=True`` an
    online running mean of the post-update parameters over the last ~23% of
    iterations is maintained in the compiled scan and returned as
    ``optimisation_log['averaged_variational_param']`` (shape
    ``(n_chains, P)``) — the reference computes this (Adam variant only,
    viabel/vb.py:624-627) but drops it; see PARITY.md.

    With `checkpoint_path` and/or ``progress=True`` the run executes in
    `save_every`-iteration compiled segments: state is checkpointed after
    each segment (and resumed from `checkpoint_path` if it exists), a
    running-average-loss progress line is printed (reference:
    viabel/vb.py:469-473), and a KeyboardInterrupt returns partial
    histories (reference: viabel/vb.py:476-481).  Segmented runs are
    bit-identical to the single-scan path.

    Returns the reference's 7-tuple:
    ``(variational_param, chains, averaged_means_list, averaged_sigmas_list,
    value_history, log_norm_history, optimisation_log)``.

    Large-P guidance (measured at d = 300 full-rank, P = 45,450;
    benchmarks/DIM_SCALING.md): the returned first element is the
    reference-parity RAW last iterate of the last chain — read the fit
    from ``optimisation_log['averaged_variational_param']`` (0.5-0.8
    better khat at large d).  The R-hat post-pass gathers the
    ``(n_chains, 100*window, P)`` retained history to the host, so pass a
    small `window` when P is large (the default retains 727 MB for four
    d = 300 chains), and use `checkpoint_path`/`save_every` to bound the
    length of each device dispatch on runtimes that limit it.
    """
    return _ia_optimize('rmsprop', 0.5, n_iters, objective_and_grad,
                        init_param, K, key, has_log_norm, window,
                        learning_rate, epsilon, rhat_window, averaging,
                        n_optimisers, r_mean_threshold, r_sigma_threshold,
                        tail_avg_iters, learning_rate_end, mesh,
                        checkpoint_path, save_every, progress)


def adam_IA_optimize_with_rhat(n_iters, objective_and_grad, init_param, K,
                               *, key=None, has_log_norm=None, window=500,
                               learning_rate=.01, epsilon=.000001,
                               rhat_window=500, averaging=True,
                               n_optimisers=1, r_mean_threshold=1.15,
                               r_sigma_threshold=1.20, tail_avg_iters=2000,
                               learning_rate_end=None, mesh=None,
                               checkpoint_path=None, save_every=1000,
                               progress=False):
    """Adam with R-hat-gated iterate averaging over parallel chains
    (reference: viabel/vb.py:554-712).

    Per-step rule: Adam moments with beta1=0.9, beta2=0.999, initialized at
    ``0.9*g`` / ``0.9*g^2`` and bias-corrected with power ``i+2``
    (reference: viabel/vb.py:611-623).  Chain inits perturbed with scale 0.2
    (reference: viabel/vb.py:586).  `window`, `averaging`,
    `checkpoint_path`, `save_every` and `progress` behave as in
    `rmsprop_IA_optimize_with_rhat` (history cap: viabel/vb.py:629-630;
    online tail average: viabel/vb.py:624-627; progress:
    viabel/vb.py:631-635; partial results: viabel/vb.py:638-643).  Returns
    the same 7-tuple; `rmsprop_IA_optimize_with_rhat`'s large-P guidance
    (read the fit from ``optimisation_log['averaged_variational_param']``,
    small `window`, segmented execution) applies unchanged.
    """
    return _ia_optimize('adam', 0.2, n_iters, objective_and_grad,
                        init_param, K, key, has_log_norm, window,
                        learning_rate, epsilon, rhat_window, averaging,
                        n_optimisers, r_mean_threshold, r_sigma_threshold,
                        tail_avg_iters, learning_rate_end, mesh,
                        checkpoint_path, save_every, progress)


def rmsprop_IA_optimize(n_iters, objective_and_grad, init_param, K, *,
                        key=None, has_log_norm=None, learning_rate=.01,
                        epsilon=.000001, n_optimisers=1, tail_avg_iters=2000,
                        learning_rate_end=None):
    """RMSProp with plain tail iterate averaging — the non-R-hat variant the
    reference notebooks import from a sibling branch
    (reference: notebooks/robust-regression-model-example.ipynb cells 40-45;
    absent from the reference package — see SURVEY.md section 2.3)."""
    out = rmsprop_IA_optimize_with_rhat(
        n_iters, objective_and_grad, init_param, K, key=key,
        has_log_norm=has_log_norm, learning_rate=learning_rate,
        epsilon=epsilon, n_optimisers=n_optimisers,
        tail_avg_iters=tail_avg_iters, learning_rate_end=learning_rate_end,
        rhat_window=max(n_iters, 1))  # window > n_iters => no R-hat gating
    return out


def adam_IA_optimize(n_iters, objective_and_grad, init_param, K, *,
                     key=None, has_log_norm=None, learning_rate=.01,
                     epsilon=.000001, n_optimisers=1, tail_avg_iters=2000,
                     learning_rate_end=None):
    """Adam with plain tail iterate averaging (non-R-hat variant; see
    `rmsprop_IA_optimize`)."""
    return adam_IA_optimize_with_rhat(
        n_iters, objective_and_grad, init_param, K, key=key,
        has_log_norm=has_log_norm, learning_rate=learning_rate,
        epsilon=epsilon, n_optimisers=n_optimisers,
        tail_avg_iters=tail_avg_iters, learning_rate_end=learning_rate_end,
        rhat_window=max(n_iters, 1))
