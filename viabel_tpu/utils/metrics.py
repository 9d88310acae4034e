"""Profiling and throughput metrics.

The reference's only observability is a wall-clock context manager and tqdm
iteration rates (SURVEY.md section 5).  This module adds the device-side
equivalents: `jax.profiler` trace capture and throughput meters reporting
the BASELINE.md north-star counters (iterations/s, density+gradient
evaluations/s/chip, samples/s).
"""
import contextlib
from time import perf_counter

import jax

__all__ = ['profile_trace', 'ThroughputMeter', 'trace_device_time',
           'count_compilations']


@contextlib.contextmanager
def profile_trace(log_dir):
    """Capture a `jax.profiler` device trace (viewable in TensorBoard /
    Perfetto) around the enclosed block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class ThroughputMeter:
    """Measure steady-state throughput of a device computation.

    `measure(fn, *args)` runs `fn` once to compile/warm, then `reps` timed
    runs with `block_until_ready`, and records the best time.  Counters are
    derived from the supplied work amounts.
    """

    def __init__(self, reps=3):
        self.reps = reps
        self.records = {}

    def measure(self, name, fn, *args, iters=None, evals_per_iter=None,
                samples=None):
        out = fn(*args)
        jax.block_until_ready(out)
        best = float('inf')
        for _ in range(self.reps):
            t0 = perf_counter()
            out = fn(*args)
            jax.block_until_ready(out)
            best = min(best, perf_counter() - t0)
        rec = dict(seconds=best)
        if iters is not None:
            rec['it_per_s'] = iters / best
            if evals_per_iter is not None:
                rec['evals_per_s'] = iters * evals_per_iter / best
        if samples is not None:
            rec['samples_per_s'] = samples / best
        self.records[name] = rec
        return out, rec

    def report(self):
        lines = []
        for name, rec in self.records.items():
            parts = ['{:.4g}s'.format(rec['seconds'])]
            for k in ('it_per_s', 'evals_per_s', 'samples_per_s'):
                if k in rec:
                    parts.append('{} = {:.4g}'.format(k, rec[k]))
            lines.append('{}: {}'.format(name, ', '.join(parts)))
        return '\n'.join(lines)


def trace_device_time(log_dir):
    """Device busy time (seconds) in the newest `profile_trace` capture
    under `log_dir`.

    Reads the ``*.trace.json.gz`` the profiler writes.  On a GPU each
    device is a process named ``/device:GPU:<n>`` whose threads are its
    CUDA streams (``Stream #<id>(<kinds>)``), with one complete event per
    kernel or copy.  A device's busy time is the union of its events'
    intervals, so work overlapping on two streams counts once; the result
    sums over devices and excludes host Python, dispatch and idle gaps.

    Raises FileNotFoundError when `log_dir` holds no capture and
    ValueError when the capture has no device events (for instance a
    trace taken on the CPU backend), rather than reporting zero.
    """
    import glob
    import gzip
    import json
    import os
    paths = sorted(glob.glob(os.path.join(
        log_dir, 'plugins', 'profile', '*', '*.trace.json.gz')))
    if not paths:
        raise FileNotFoundError('no profiler trace under {}'.format(log_dir))
    with gzip.open(paths[-1]) as f:
        events = json.load(f).get('traceEvents', [])
    device_pids = {
        e['pid'] for e in events
        if e.get('ph') == 'M' and e.get('name') == 'process_name'
        and str(e.get('args', {}).get('name', '')).startswith('/device:')}
    spans = {}
    for e in events:
        if e.get('ph') == 'X' and e.get('pid') in device_pids:
            spans.setdefault(e['pid'], []).append(
                (float(e['ts']), float(e['ts']) + float(e.get('dur', 0))))
    if not spans:
        raise ValueError('the trace in {} has no device events'.format(
            paths[-1]))
    total_us = 0.0
    for intervals in spans.values():
        end = -float('inf')
        for start, stop in sorted(intervals):
            if stop > end:
                total_us += stop - max(start, end)
                end = stop
    return total_us / 1e6


@contextlib.contextmanager
def count_compilations():
    """Count XLA compilations inside the block (yields a one-element
    mutable counter; read ``counter[0]`` after the block).

    The framework's performance model assumes every hot entry point
    compiles once per (static config, shape) and then replays the cached
    executable — a stray per-call re-lowering costs a full compile per call
    (an eager shard_map application does exactly that).  Wrap a
    steady-state loop in this context to verify it compiles nothing:

        with count_compilations() as n:
            result = my_fitted_pipeline(fresh_key)
        assert n[0] == 0, 'recompile storm'

    Implementation: listens to JAX's compilation log (`jax_log_compiles`),
    the same mechanism `tests/test_recompile.py` pins the library's own
    entry points with.

    .. note:: This couples to JAX internals (verified against the pinned
       jax 0.9: the "Compiling <name>" message is emitted from
       ``jax._src.interpreters.pxla``; older JAX emitted it from
       ``jax._src.dispatch``, so both loggers are watched).  A JAX upgrade
       that moves or rewords the log would make this silently count 0 —
       `tests/test_recompile.py::test_public_count_compilations_utility`
       guards against that by asserting a fresh compile IS counted.  The
       context manager also toggles the process-global `jax_log_compiles`
       flag, so it is not reentrant or thread-safe; use it from one thread
       at a time.
    """
    import logging

    counter = [0]

    class _Handler(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith('Compiling '):
                counter[0] += 1

    handler = _Handler()
    # both the current (pxla) and historical (dispatch) homes of the log
    loggers = [logging.getLogger('jax._src.interpreters.pxla'),
               logging.getLogger('jax._src.dispatch')]
    old_levels = [lg.level for lg in loggers]
    old_flag = jax.config.jax_log_compiles
    for lg in loggers:
        lg.addHandler(handler)
        lg.setLevel(logging.WARNING)
    jax.config.update('jax_log_compiles', True)
    try:
        yield counter
    finally:
        jax.config.update('jax_log_compiles', old_flag)
        for lg, lvl in zip(loggers, old_levels):
            lg.removeHandler(handler)
            lg.setLevel(lvl)
