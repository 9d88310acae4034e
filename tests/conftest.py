"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

Multi-device sharding is tested without GPUs by forcing the host platform
to expose 8 virtual devices.  x64 gives the analytic-oracle bound tests the
same Monte Carlo tolerances the reference test suite uses
(reference: tests/test_bounds.py:7-8).  The persistent compilation cache is
off: the entry points under test turn it on, and test runs should leave
nothing behind in the checkout.
"""
import os
import sys

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                           + ' --xla_force_host_platform_device_count=8')

import jax

jax.config.update('jax_enable_x64', True)
jax.config.update('jax_enable_compilation_cache', False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_collection_modifyitems(config, items):
    # Deliberately small-sample harness runs would otherwise spam the
    # MC-error warning (threshold 0.01 matches the reference and is tuned
    # for its 1e6-sample production passes); the warning's own unit test
    # opts back in with pytest.warns.
    config.addinivalue_line(
        'filterwarnings',
        'ignore::viabel_tpu.bounds.MonteCarloErrorWarning')
    # The one-time many-distinct-objectives warning counts instances
    # process-wide; a test session legitimately constructs dozens across
    # tests, so whichever test happens to cross the threshold would leak
    # it.  Its own unit test opts back in with pytest.warns.
    config.addinivalue_line(
        'filterwarnings',
        'ignore:.*distinct objective instances.*:UserWarning')


def pytest_runtest_teardown(item, nextitem):
    # Release compiled executables at module boundaries.  The full suite
    # compiles enough distinct XLA CPU programs that the process crosses
    # the kernel's vm.max_map_count (65530 default): each loaded
    # executable holds mmap'ed code pages, and once the map count is
    # exhausted LLVM's next allocation aborts/segfaults mid-compile
    # (observed at ~65.1k maps, deterministic late-suite crash in whatever
    # test compiles next).  Dropping the caches between modules keeps the
    # map count bounded; within-module compile reuse (the expensive kind)
    # is unaffected.
    # getattr on BOTH sides: non-Python test items (doctests, file-based
    # collectors) have no .module property and would raise in teardown
    if nextitem is None or getattr(item, 'module', None) is not getattr(
            nextitem, 'module', None):
        import jax
        jax.clear_caches()
