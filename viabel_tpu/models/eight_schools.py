"""Eight-schools hierarchical models, centered and non-centered.

JAX equivalents of the reference Stan programs
(reference: notebooks/eight_schools_cp.stan:1-18 and
eight_schools_ncp.stan:1-24) evaluated through pystan's `fit.log_prob` on the
unconstrained scale (reference: viabel/vb.py:314-321).  Stan reparameterizes
the constrained scale ``tau > 0`` as ``tau = exp(zeta)`` and adds the
log-Jacobian ``+zeta``; these models do the same, so log densities differ
from Stan's only by parameter-independent constants (Stan drops lpdf
normalizers under ``~`` sampling statements), which cancels in log-weight
differences, bounds, and khat.

Unconstrained parameter layout (matching the notebook's naming
``['mu', 'log_tau', theta...]``; reference: notebooks/eight-schools.ipynb
cell 14):

* CP:  ``[mu, log_tau, theta_1..theta_8]``
* NCP: ``[mu, log_tau, theta_tilde_1..theta_tilde_8]``
"""
import jax.numpy as jnp
import numpy as np

from ..distributions import normal_logpdf
from .base import Model

__all__ = [
    'EIGHT_SCHOOLS_Y',
    'EIGHT_SCHOOLS_SIGMA',
    'eight_schools_cp_model',
    'eight_schools_ncp_model',
    'eight_schools_ncp_to_cp',
]

# Classic eight-schools data (reference: notebooks/eight-schools.ipynb cell 9)
EIGHT_SCHOOLS_Y = np.array([28., 8., -3., 7., -1., 1., 18., 12.])
EIGHT_SCHOOLS_SIGMA = np.array([15., 10., 16., 11., 9., 11., 10., 18.])


def _load_ground_truth(prefix):
    """Posterior mean/cov generated by the in-repo adaptive HMC sampler
    (`viabel_tpu.mcmc`): 8 chains x 50k draws on the NCP, max split
    R-hat 1.0001, CP moments via `eight_schools_ncp_to_cp` — the same
    transformed-draw construction the reference uses for its Stan-NUTS
    ground truth (reference: notebooks/eight-schools.ipynb cells 10-16).
    Regenerate with ``python benchmarks/ground_truth.py``.
    """
    import os
    path = os.path.join(os.path.dirname(__file__), '_ground_truth.npz')
    with np.load(path) as data:
        return data[prefix + '_mean'], data[prefix + '_cov']


def _half_cauchy_logpdf_with_jacobian(log_tau, scale):
    """Stan's ``tau ~ cauchy(0, 5)`` with ``tau = exp(log_tau)`` declared
    ``<lower=0>``: cauchy lpdf at tau plus the log-Jacobian log_tau."""
    tau = jnp.exp(log_tau)
    cauchy = -jnp.log(jnp.pi * scale * (1.0 + (tau / scale) ** 2))
    return cauchy + log_tau


def eight_schools_cp_model(y=None, sigma=None):
    """Centered parameterization (reference: notebooks/eight_schools_cp.stan):
    ``mu ~ N(0,5); tau ~ cauchy(0,5) [tau>0]; theta ~ N(mu, tau);
    y ~ N(theta, sigma)``."""
    y = EIGHT_SCHOOLS_Y if y is None else np.asarray(y)
    sigma = EIGHT_SCHOOLS_SIGMA if sigma is None else np.asarray(sigma)
    J = len(y)
    yj, sj = jnp.asarray(y), jnp.asarray(sigma)

    def log_prob(z):
        z2 = jnp.atleast_2d(z)
        mu, log_tau, theta = z2[:, 0], z2[:, 1], z2[:, 2:]
        tau = jnp.exp(log_tau)
        lp = normal_logpdf(mu, 0.0, 5.0)
        lp += _half_cauchy_logpdf_with_jacobian(log_tau, 5.0)
        lp += jnp.sum(normal_logpdf(theta, mu[:, None], tau[:, None]), axis=-1)
        lp += jnp.sum(normal_logpdf(yj[None, :], theta, sj[None, :]), axis=-1)
        return lp[0] if jnp.ndim(z) == 1 else lp

    names = ('mu', 'log_tau') + tuple(
        'theta[{}]'.format(j + 1) for j in range(J))
    true_mean = true_cov = None
    if (np.array_equal(y, EIGHT_SCHOOLS_Y)
            and np.array_equal(sigma, EIGHT_SCHOOLS_SIGMA)):
        true_mean, true_cov = _load_ground_truth('eight_schools_cp')
    return Model(log_prob, 2 + J, 'eight_schools_cp', true_mean, true_cov,
                 names)


def eight_schools_ncp_model(y=None, sigma=None):
    """Non-centered parameterization
    (reference: notebooks/eight_schools_ncp.stan): ``theta_tilde ~ N(0,1)``
    with ``theta = mu + tau * theta_tilde``."""
    y = EIGHT_SCHOOLS_Y if y is None else np.asarray(y)
    sigma = EIGHT_SCHOOLS_SIGMA if sigma is None else np.asarray(sigma)
    J = len(y)
    yj, sj = jnp.asarray(y), jnp.asarray(sigma)

    def log_prob(z):
        z2 = jnp.atleast_2d(z)
        mu, log_tau, theta_tilde = z2[:, 0], z2[:, 1], z2[:, 2:]
        tau = jnp.exp(log_tau)
        theta = mu[:, None] + tau[:, None] * theta_tilde
        lp = normal_logpdf(mu, 0.0, 5.0)
        lp += _half_cauchy_logpdf_with_jacobian(log_tau, 5.0)
        lp += jnp.sum(normal_logpdf(theta_tilde, 0.0, 1.0), axis=-1)
        lp += jnp.sum(normal_logpdf(yj[None, :], theta, sj[None, :]), axis=-1)
        return lp[0] if jnp.ndim(z) == 1 else lp

    names = ('mu', 'log_tau') + tuple(
        'theta_tilde[{}]'.format(j + 1) for j in range(J))
    true_mean = true_cov = None
    if (np.array_equal(y, EIGHT_SCHOOLS_Y)
            and np.array_equal(sigma, EIGHT_SCHOOLS_SIGMA)):
        true_mean, true_cov = _load_ground_truth('eight_schools_ncp')
    return Model(log_prob, 2 + J, 'eight_schools_ncp', true_mean, true_cov,
                 names)


def eight_schools_ncp_to_cp(z):
    """Map NCP draws ``[mu, log_tau, theta_tilde]`` to the CP scale
    ``[mu, log_tau, theta]`` (reference: notebooks/eight-schools.ipynb
    cell 14 builds the transformed-sample ground truth this way)."""
    z = np.atleast_2d(np.asarray(z))
    mu, log_tau, theta_tilde = z[:, :1], z[:, 1:2], z[:, 2:]
    theta = mu + np.exp(log_tau) * theta_tilde
    return np.concatenate([mu, log_tau, theta], axis=1)
