"""JAX log-density model zoo.

JAX replacement for the reference's Stan C++ model backend
(reference: viabel/vb.py:301-321 bridges pystan `fit.log_prob` /
`grad_log_prob` into autograd with a per-sample host loop).  Every model here
is a pure `jax.numpy` log density over a batch of *unconstrained* parameters,
XLA-compiled and batched — the role Stan's compiled C++ evaluator plays in
the reference, without the Python->C++ per-sample round trip.

Models included (the reference's five benchmark workloads; SURVEY.md
sections 2.2 C28-C29 and 6):

* `funnel_model` — 2-D Neal-style funnel (notebooks/funnel-distribution.ipynb)
* `normal_mixture_model` — 1-D Gaussian mixture (notebooks/normal-mixture.ipynb)
* `robust_regression_model` — Student-t likelihood regression
  (notebooks/robust-regression.ipynb cell 3)
* `eight_schools_cp_model` / `eight_schools_ncp_model` — hierarchical models
  (notebooks/eight_schools_cp.stan, eight_schools_ncp.stan)
* `linear_regression_model` — Gaussian likelihood regression
  (notebooks/linear-regression-model-Iterate-Averaging-rhat.ipynb cell 7)

plus `data_generator_linear` (reconstruction of the generator the notebooks
import from a sibling branch; SURVEY.md section 2.3) and
`make_callback_log_density` (the escape hatch for external/host density
providers — the role `make_stan_log_density` plays in the reference).
"""
from .base import Model
from .external import make_callback_log_density
from .funnel import funnel_model
from .mixture import normal_mixture_model
from .regression import (data_generator_linear, linear_regression_model,
                         robust_regression_model, robust_regression_notebook_data)
from .eight_schools import (EIGHT_SCHOOLS_SIGMA, EIGHT_SCHOOLS_Y,
                            eight_schools_cp_model, eight_schools_ncp_model,
                            eight_schools_ncp_to_cp)

__all__ = [
    'Model',
    'funnel_model',
    'normal_mixture_model',
    'robust_regression_model',
    'robust_regression_notebook_data',
    'linear_regression_model',
    'data_generator_linear',
    'eight_schools_cp_model',
    'eight_schools_ncp_model',
    'eight_schools_ncp_to_cp',
    'EIGHT_SCHOOLS_Y',
    'EIGHT_SCHOOLS_SIGMA',
    'make_callback_log_density',
]
