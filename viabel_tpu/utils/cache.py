"""Persistent XLA compilation cache for the entry points.

The command-line interface, the posterior service, the benchmark and
`chip_smoke.py` call `enable_compile_cache()` once at start-up; importing
the library never touches the cache setting.
"""
import os

import jax

__all__ = ['enable_compile_cache', 'DEFAULT_CACHE_DIR']

# <repo>/.jax_cache (listed in .gitignore).  The path is fixed, never
# temporary or per-process: the cache directory is part of what a later
# process must find again for a hit.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), '.jax_cache')


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    sets nothing; likewise if the process already configured a directory.
    Otherwise the cache goes to `DEFAULT_CACHE_DIR`.
    """
    env = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env:
        return env
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    jax.config.update('jax_compilation_cache_dir', DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
