"""Wall-clock timing utilities.

JAX counterpart of the reference harness timer
(reference: notebooks/utils.py:5-29).  Adds `block_until_ready`-aware timing
so asynchronous XLA dispatch does not produce misleading numbers.
"""
from time import perf_counter

import jax

__all__ = ['Timer', 'format_seconds']


def format_seconds(secs):
    """Human format for seconds (reference: notebooks/utils.py:5-12)."""
    if secs < 1e-3:
        t, u = secs * 1e6, 'microsec'
    elif secs < 1e0:
        t, u = secs * 1e3, 'millisec'
    else:
        t, u = secs, 'sec'
    return '{:.03f} {}'.format(t, u)


class Timer:
    """Context manager measuring wall clock time.

    Unlike the reference (notebooks/utils.py:15-28), `Timer` optionally
    synchronizes on a pytree of device arrays on exit so that XLA's async
    dispatch is included in the measured interval.

    Parameters
    ----------
    descr : str, optional
        If given, a message is printed on exit.
    sync : pytree holder, optional
        Callable returning a pytree to `jax.block_until_ready` on exit.
    """

    def __init__(self, descr=None, sync=None):
        self.description = descr
        self._sync = sync
        self.interval = None

    def __enter__(self):
        self.start = perf_counter()
        return self

    def __exit__(self, *args):
        if self._sync is not None:
            jax.block_until_ready(self._sync())
        self.end = perf_counter()
        self.interval = self.end - self.start
        if self.description is not None:
            print('{} took {} to run'.format(self.description,
                                             format_seconds(self.interval)))
