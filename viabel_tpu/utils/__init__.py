from .timers import Timer, format_seconds
from .cache import enable_compile_cache
from .metrics import (ThroughputMeter, count_compilations,
                      profile_trace, trace_device_time)

__all__ = ['Timer', 'format_seconds', 'ThroughputMeter', 'profile_trace',
           'trace_device_time', 'count_compilations', 'enable_compile_cache']


def _hashable_log_density(log_density):
    """Densities are static jit arguments, so they must be hashable; a
    `Model` instance (NamedTuple holding numpy arrays) is not — unwrap its
    `log_prob`, the same fallback `experiments.get_samples_and_log_weights`
    applies.  Shared by the fused pipelines and the sharded estimators
    (round-4 review: `sharded_all_bounds` used to leak an opaque
    unhashable-type error from its cache key for the same input)."""
    try:
        hash(log_density)
        return log_density
    except TypeError:
        if hasattr(log_density, 'log_prob'):
            return log_density.log_prob
        raise
