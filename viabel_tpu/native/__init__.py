"""Native (C++) compiled log-density providers.

The reference's only native component is the Stan C++ model backend reached
through `make_stan_log_density` (reference: viabel/vb.py:314-321; SURVEY.md
section 2.1).  This package demonstrates that pathway with a real
ahead-of-time-compiled C++ evaluator: the eight-schools centered
log posterior + analytic gradient, built with g++ into a shared library,
loaded over ctypes, and bridged into JAX (jit/grad-compatible) through
`make_callback_log_density`.

For the benchmark workloads the pure-JAX model zoo is strictly faster (the
density compiles into the same XLA program as the sampler); the native path
exists for models that can only be evaluated by external compiled code —
the exact situation the reference's Stan bridge serves.
"""
import ctypes
import hashlib
import os
import platform
import subprocess

import numpy as np

__all__ = ['build_native_library', 'native_eight_schools_cp_log_density',
           'native_robust_regression_log_density']

_SRCS = [os.path.join(os.path.dirname(__file__), f)
         for f in ('eight_schools.cpp', 'regression.cpp')]
# git-ignored; libraries are named by `_library_path`'s key
_BUILD_DIR = os.path.join(os.path.dirname(__file__), 'build')
# portable code: no -march=native, so the key below fully describes it
_FLAGS = ('-O3', '-shared', '-fPIC')


def _library_path(flags):
    """Where the library built from today's sources with `flags` lives.

    The file name carries a hash of the sources, the flags and the CPU
    architecture, so a library left over from other sources, other flags
    or another kind of machine is never found, let alone loaded."""
    h = hashlib.sha256()
    for src in _SRCS:
        with open(src, 'rb') as f:
            h.update(f.read())
    h.update('\0'.join(flags).encode())
    h.update(platform.machine().encode())
    return os.path.join(_BUILD_DIR,
                        'libviabel_native-{}.so'.format(h.hexdigest()[:16]))


def build_native_library(force=False):
    """Compile the native library with g++ (cached by `_library_path`).
    Returns the .so path or raises RuntimeError if no toolchain is
    available.  OpenMP batch parallelism is used when the toolchain
    supports it."""
    variants = [_FLAGS + ('-fopenmp',), _FLAGS]
    if not force:
        for flags in variants:
            if os.path.exists(_library_path(flags)):
                return _library_path(flags)
    os.makedirs(_BUILD_DIR, exist_ok=True)
    err = None
    for flags in variants:
        lib = _library_path(flags)
        # build under a private name, then rename: concurrent builders
        # never load a half-written file
        tmp = '{}.{}.tmp'.format(lib, os.getpid())
        try:
            subprocess.run(['g++', *flags, *_SRCS, '-o', tmp], check=True,
                           capture_output=True)
        except (OSError, subprocess.CalledProcessError) as e:
            err = e
            continue
        os.replace(tmp, lib)
        return lib
    raise RuntimeError('failed to build native library: {}'.format(err))


def _load():
    lib = ctypes.CDLL(build_native_library())
    dp = ctypes.POINTER(ctypes.c_double)
    i64, f64 = ctypes.c_int64, ctypes.c_double
    for name in ('es_cp_log_prob', 'es_cp_grad_log_prob'):
        fn = getattr(lib, name)
        fn.restype = None
        fn.argtypes = [dp, i64, i64, dp, dp, dp]
    lib.robust_reg_log_prob.restype = None
    lib.robust_reg_log_prob.argtypes = [dp, i64, i64, i64, dp, dp, f64,
                                        f64, f64, f64, dp]
    lib.robust_reg_grad_log_prob.restype = None
    lib.robust_reg_grad_log_prob.argtypes = [dp, i64, i64, i64, dp, dp,
                                             f64, f64, f64, dp]
    return lib


def native_eight_schools_cp_log_density(y=None, sigma=None):
    """JAX-differentiable eight-schools CP log density backed by the C++
    library (the `make_stan_log_density` counterpart with a real native
    evaluator; reference: viabel/vb.py:314-321)."""
    from ..models import (EIGHT_SCHOOLS_SIGMA, EIGHT_SCHOOLS_Y,
                          make_callback_log_density)
    y = np.ascontiguousarray(EIGHT_SCHOOLS_Y if y is None else y,
                             dtype=np.float64)
    sigma = np.ascontiguousarray(EIGHT_SCHOOLS_SIGMA if sigma is None
                                 else sigma, dtype=np.float64)
    J = len(y)
    dim = 2 + J
    lib = _load()
    dp = ctypes.POINTER(ctypes.c_double)
    y_p = y.ctypes.data_as(dp)
    s_p = sigma.ctypes.data_as(dp)

    def log_prob(x):
        x = np.ascontiguousarray(x, dtype=np.float64).reshape(-1, dim)
        out = np.empty(x.shape[0], dtype=np.float64)
        lib.es_cp_log_prob(x.ctypes.data_as(dp), x.shape[0], J, y_p, s_p,
                           out.ctypes.data_as(dp))
        return out

    def grad_log_prob(x):
        x = np.ascontiguousarray(x, dtype=np.float64).reshape(-1, dim)
        out = np.empty_like(x)
        lib.es_cp_grad_log_prob(x.ctypes.data_as(dp), x.shape[0], J, y_p,
                                s_p, out.ctypes.data_as(dp))
        return out

    return make_callback_log_density(log_prob, grad_log_prob, dim,
                                     batched=True)


def native_robust_regression_log_density(x=None, y=None, df=40.0,
                                         noise_scale=1.0, prior_std=10.0):
    """JAX-differentiable robust-regression log density backed by the C++
    library (reference: notebooks/robust-regression.ipynb cell 3 Stan
    program via viabel/vb.py:314-321).  Defaults to the notebook's
    seed-5039 data."""
    from scipy.special import gammaln

    from ..models import make_callback_log_density
    from ..models.regression import robust_regression_notebook_data
    if (x is None) != (y is None):
        raise ValueError('pass both x and y, or neither (notebook data)')
    if x is None:
        x, y = robust_regression_notebook_data()
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64).reshape(-1)
    N, D = x.shape
    if y.shape != (N,):
        raise ValueError('y must have one response per row of x '
                         '(got {} responses for {} rows)'.format(
                             y.shape[0], N))
    lognorm = float(gammaln(0.5 * (df + 1.0)) - gammaln(0.5 * df)
                    - 0.5 * np.log(df * np.pi))
    lib = _load()
    dp = ctypes.POINTER(ctypes.c_double)
    x_p = x.ctypes.data_as(dp)
    y_p = y.ctypes.data_as(dp)

    def log_prob(b):
        b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, D)
        out = np.empty(b.shape[0], dtype=np.float64)
        lib.robust_reg_log_prob(b.ctypes.data_as(dp), b.shape[0], N, D,
                                x_p, y_p, df, noise_scale, prior_std,
                                lognorm, out.ctypes.data_as(dp))
        return out

    def grad_log_prob(b):
        b = np.ascontiguousarray(b, dtype=np.float64).reshape(-1, D)
        out = np.empty_like(b)
        lib.robust_reg_grad_log_prob(b.ctypes.data_as(dp), b.shape[0], N,
                                     D, x_p, y_p, df, noise_scale,
                                     prior_std, out.ctypes.data_as(dp))
        return out

    return make_callback_log_density(log_prob, grad_log_prob, D,
                                     batched=True)
