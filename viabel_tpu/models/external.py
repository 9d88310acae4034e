"""Bridge for external (host-side) log-density providers.

The reference wraps a compiled Stan model's `log_prob` / `grad_log_prob`
into autograd via a custom-VJP primitive applied per-sample with
`np.apply_along_axis` (reference: viabel/vb.py:301-321).  The JAX
model zoo removes the need for this on the benchmark workloads, but the
capability — plugging an arbitrary external evaluator (a Stan model, a C++
library, a legacy numpy density) into the JAX compute path — is preserved
here with `jax.pure_callback` plus `jax.custom_vjp`.

The callback evaluates whole batches on the host in one round trip (the
reference crosses Python->C++ once *per sample*).  Inside `jit` the callback
is a host call, so use this only for genuinely external models; prefer
writing the density in JAX.
"""
import jax
import numpy as np

__all__ = ['make_callback_log_density']


def make_callback_log_density(log_prob_fn, grad_log_prob_fn, dim,
                              batched=False):
    """Wrap host functions into a differentiable JAX log density.

    Parameters
    ----------
    log_prob_fn : callable
        ``(dim,) -> float`` (or ``(n, dim) -> (n,)`` if `batched`).
    grad_log_prob_fn : callable
        ``(dim,) -> (dim,)`` (or ``(n, dim) -> (n, dim)`` if `batched`).
    dim : int
        Parameter dimension.
    batched : bool
        Whether the host functions already accept batches.

    Returns
    -------
    log_density : callable
        ``(n, dim) -> (n,)``, usable inside jit/grad like any zoo model.
    """

    def _host_logp(x):
        x = np.asarray(x)
        if batched:
            return np.asarray(log_prob_fn(x), dtype=x.dtype).reshape(x.shape[0])
        return np.array([log_prob_fn(row) for row in x], dtype=x.dtype)

    def _host_grad(x):
        x = np.asarray(x)
        if batched:
            return np.asarray(grad_log_prob_fn(x), dtype=x.dtype)
        return np.stack([np.asarray(grad_log_prob_fn(row)) for row in x]
                        ).astype(x.dtype)

    @jax.custom_vjp
    def log_density(x):
        out_shape = jax.ShapeDtypeStruct(x.shape[:-1], x.dtype)
        return jax.pure_callback(_host_logp, out_shape, x, vmap_method='sequential')

    def fwd(x):
        return log_density(x), x

    def bwd(x, g):
        grad_shape = jax.ShapeDtypeStruct(x.shape, x.dtype)
        grads = jax.pure_callback(_host_grad, grad_shape, x,
                                  vmap_method='sequential')
        return (g[..., None] * grads,)

    log_density.defvjp(fwd, bwd)
    return log_density
