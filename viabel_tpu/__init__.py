"""viabel-tpu: validated variational inference in JAX.

A brand-new JAX/XLA framework with the capabilities of the reference
`viabel` package (Huggins et al., "Validated Variational Inference via
Practical Posterior Error Bounds", AISTATS 2020): KLVI/CHIVI black-box
variational inference with reparameterization gradients, validated posterior
error bounds (alpha-divergence, Wasserstein, moment errors), Pareto-smoothed
importance sampling, and R-hat-gated iterate averaging — redesigned for
accelerators with compiled `lax.scan` optimization loops, rejection-free
samplers, and mesh-sharded Monte Carlo estimation, all in plain JAX.

Like the reference, the bounds core is the default API surface
(reference: viabel/__init__.py:1 exports only the bounds); everything else is
importable from the submodules or from the names re-exported here.
"""
from .bounds import (all_bounds, divergence_bound, error_bounds,
                     wasserstein_bounds)
from .distributions import multivariate_t_logpdf
from .families import (NoClosedFormMomentError, VariationalFamily,
                       full_rank_gaussian_variational_family,
                       init_from_moments,
                       mean_field_gaussian_variational_family,
                       mean_field_t_variational_family,
                       t_variational_family)
from .objectives import (black_box_chivi, black_box_chivi_neff,
                         black_box_klvi, black_box_klvi_pd,
                         black_box_klvi_pd2, perturbed_black_box_vi,
                         vectorize_log_density)
from .optimizers import (adagrad_optimize, adam_IA_optimize,
                         adam_IA_optimize_with_rhat, learning_rate_schedule,
                         resolve_unroll, rmsprop_IA_optimize,
                         rmsprop_IA_optimize_with_rhat)
from .diagnostics import (compute_posterior_moments, compute_R_hat,
                          compute_R_hat_adaptive, compute_R_hat_halfway,
                          effective_sample_size,
                          stochastic_iterate_averaging)
from .mcmc import hmc_ground_truth, hmc_sample
from .pipeline import (validated_vi, validated_vi_multistart,
                       validated_vi_sweep)
from .transforms import (ParameterTransforms, identity_transform,
                         interval_transform, lower_bounded_transform,
                         positive_transform)

__version__ = '0.1.0'

__all__ = [
    # bounds core (the reference's installable default; viabel/bounds.py)
    'all_bounds', 'error_bounds', 'wasserstein_bounds', 'divergence_bound',
    # families (viabel/vb.py:42-233)
    'VariationalFamily', 'NoClosedFormMomentError',
    'mean_field_gaussian_variational_family',
    'mean_field_t_variational_family',
    'full_rank_gaussian_variational_family',
    't_variational_family',
    'init_from_moments',
    # objectives (viabel/vb.py:236-298 + notebook-referenced variants)
    'black_box_klvi', 'black_box_klvi_pd', 'black_box_klvi_pd2',
    'black_box_chivi', 'black_box_chivi_neff', 'perturbed_black_box_vi',
    'vectorize_log_density',
    # optimizers (viabel/vb.py:324-712)
    'learning_rate_schedule', 'adagrad_optimize', 'resolve_unroll',
    'rmsprop_IA_optimize_with_rhat', 'adam_IA_optimize_with_rhat',
    'rmsprop_IA_optimize', 'adam_IA_optimize',
    # diagnostics (viabel/functions.py)
    'compute_R_hat', 'compute_R_hat_adaptive', 'compute_R_hat_halfway',
    'effective_sample_size',
    'stochastic_iterate_averaging', 'compute_posterior_moments',
    # distributions (viabel/_distributions.py)
    'multivariate_t_logpdf',
    # in-repo MCMC ground truth (replaces the reference's external Stan NUTS
    # anchors; notebooks/eight-schools.ipynb cells 10-16)
    'hmc_sample', 'hmc_ground_truth',
    # single-dispatch fused pipeline (no reference counterpart)
    'validated_vi', 'validated_vi_multistart', 'validated_vi_sweep',
    # constrained-parameter transforms (the Stan unconstraining layer)
    'ParameterTransforms', 'identity_transform', 'positive_transform',
    'lower_bounded_transform', 'interval_transform',
]
