"""Experiment configuration system.

The reference has no config layer — keyword arguments are threaded from
notebooks through `run_experiment(**kwargs)` (SURVEY.md section 5).  This
module provides the missing subsystem: a declarative, validated
`ExperimentConfig` that names a model, family, objective, and optimizer by
string (resolved against registries), serializes to/from JSON, and builds
the concrete objects.  The CLI (`python -m viabel_tpu`) drives experiments
from these configs.
"""
import dataclasses
import json
from typing import Optional

__all__ = ['ExperimentConfig', 'MODELS', 'FAMILIES', 'build', 'fit']


def _linear_model(m, cfg):
    data = m.data_generator_linear(cfg.data_n, cfg.data_dim,
                                   rho=cfg.data_rho, seed=cfg.seed)
    return m.linear_regression_model(data['X'], data['Y'])


def _model_registry():
    from . import models as m
    return {
        'funnel': lambda cfg: m.funnel_model(),
        'normal_mixture': lambda cfg: m.normal_mixture_model(),
        'robust_regression': lambda cfg: m.robust_regression_model(),
        'eight_schools_cp': lambda cfg: m.eight_schools_cp_model(),
        'eight_schools_ncp': lambda cfg: m.eight_schools_ncp_model(),
        'linear_regression': lambda cfg: _linear_model(m, cfg),
    }


MODELS = ('funnel', 'normal_mixture', 'robust_regression',
          'eight_schools_cp', 'eight_schools_ncp', 'linear_regression')
FAMILIES = ('mean_field_gaussian', 'mean_field_t', 'full_rank_gaussian',
            'full_rank_t')
OBJECTIVES = ('klvi', 'klvi_pd', 'klvi_pd2', 'chivi', 'chivi_neff')
OPTIMIZERS = ('adagrad', 'rmsprop_ia', 'adam_ia')


@dataclasses.dataclass
class ExperimentConfig:
    """Declarative description of a VI experiment."""
    model: str = 'funnel'
    family: str = 'mean_field_t'
    df: float = 40.0
    objective: str = 'klvi'
    alpha: float = 2.0
    n_mc: int = 100
    # pre-generate all per-iteration draws outside the optimizer scan (the
    # library default; substantially faster, costs an (n_iters, n_mc, dim)
    # draw array — disable for very long runs on tight device memory)
    presampled: bool = True
    optimizer: str = 'adagrad'
    n_iters: int = 5000
    learning_rate: float = 0.01
    learning_rate_end: Optional[float] = None
    n_chains: int = 1
    seed: int = 0
    bound_samples: int = 1000000
    psis_samples: int = 1000000
    data_n: int = 100
    data_dim: int = 5
    data_rho: float = 0.5
    checkpoint_path: Optional[str] = None

    def __post_init__(self):
        if self.model not in MODELS:
            raise ValueError('unknown model {!r}; choose from {}'.format(
                self.model, MODELS))
        if self.family not in FAMILIES:
            raise ValueError('unknown family {!r}; choose from {}'.format(
                self.family, FAMILIES))
        if self.objective not in OBJECTIVES:
            raise ValueError('unknown objective {!r}; choose from {}'.format(
                self.objective, OBJECTIVES))
        if self.optimizer not in OPTIMIZERS:
            raise ValueError('unknown optimizer {!r}; choose from {}'.format(
                self.optimizer, OPTIMIZERS))

    def to_json(self):
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text):
        return cls(**json.loads(text))


def build(cfg):
    """Resolve a config into (model, family, objective_and_grad)."""
    from . import families as fam_mod
    from . import objectives as obj_mod

    model = _model_registry()[cfg.model](cfg)

    if cfg.family == 'mean_field_gaussian':
        family = fam_mod.mean_field_gaussian_variational_family(model.dim)
    elif cfg.family == 'mean_field_t':
        family = fam_mod.mean_field_t_variational_family(model.dim, cfg.df)
    elif cfg.family == 'full_rank_gaussian':
        family = fam_mod.full_rank_gaussian_variational_family(model.dim)
    else:
        family = fam_mod.t_variational_family(model.dim, cfg.df)

    ps = cfg.presampled
    if cfg.objective == 'klvi':
        objective = obj_mod.black_box_klvi(family, model.log_prob, cfg.n_mc,
                                           presampled=ps)
    elif cfg.objective == 'klvi_pd':
        objective = obj_mod.black_box_klvi_pd(family, model.log_prob,
                                              cfg.n_mc, presampled=ps)
    elif cfg.objective == 'klvi_pd2':
        objective = obj_mod.black_box_klvi_pd2(family, model.log_prob,
                                               cfg.n_mc, presampled=ps)
    elif cfg.objective == 'chivi':
        objective = obj_mod.black_box_chivi(cfg.alpha, family,
                                            model.log_prob, cfg.n_mc,
                                            presampled=ps)
    else:
        objective = obj_mod.black_box_chivi_neff(cfg.alpha, family,
                                                 model.log_prob, cfg.n_mc,
                                                 presampled=ps)
    return model, family, objective


def fit(cfg, model, family, objective, *, key=None, progress=False):
    """Run the optimizer a config prescribes.

    The ONE fit dispatch shared by the CLI ``run`` command and serve
    ``/fit`` (round-4 review: the two entry points hand-duplicated the
    optimizer selection, key split, checkpoint wiring, and
    iterate-averaging projection, so the next change to either would
    silently re-open the serve-vs-CLI divergence the duplication was meant
    to prevent).  One config yields one fitted posterior regardless of the
    entry point.

    Parameters
    ----------
    key : optional PRNG key
        Optimizer key; defaults to the first of the 3-way split of
        ``PRNGKey(cfg.seed)`` — exactly the key every entry point derives.
    progress : bool
        In-scan progress reporting for the plain adagrad path.

    Returns
    -------
    (var_param, value_history, ia_log) — ``ia_log`` is the IA optimizers'
    ``optimisation_log`` dict (reference: viabel/vb.py:538-549), None for
    adagrad.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    if key is None:
        key, _, _ = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    init = family.init_param()
    if cfg.optimizer == 'adagrad':
        if cfg.checkpoint_path:
            from .checkpoint import adagrad_optimize_resumable
            var_param, _, values, _ = adagrad_optimize_resumable(
                cfg.n_iters, objective, init,
                checkpoint_path=cfg.checkpoint_path, key=key,
                learning_rate=cfg.learning_rate,
                learning_rate_end=cfg.learning_rate_end)
        else:
            from .optimizers import adagrad_optimize
            var_param, _, values, _ = adagrad_optimize(
                cfg.n_iters, objective, init, key=key,
                learning_rate=cfg.learning_rate,
                learning_rate_end=cfg.learning_rate_end,
                progress=progress)
        return var_param, values, None
    from .optimizers import (adam_IA_optimize_with_rhat,
                             rmsprop_IA_optimize_with_rhat)
    optimizer = (rmsprop_IA_optimize_with_rhat
                 if cfg.optimizer == 'rmsprop_ia'
                 else adam_IA_optimize_with_rhat)
    out = optimizer(cfg.n_iters, objective, init, model.dim,
                    key=key, learning_rate=cfg.learning_rate,
                    learning_rate_end=cfg.learning_rate_end,
                    n_optimisers=cfg.n_chains,
                    checkpoint_path=cfg.checkpoint_path)
    # serve the first chain's final iterate average (mean block ++ sigma
    # block) — the reference's per-chain averaging output
    # (reference: viabel/vb.py:516-536)
    avg_means, avg_sigmas = out[2], out[3]
    var_param = jnp.asarray(np.concatenate([np.asarray(avg_means[0][-1]),
                                            np.asarray(avg_sigmas[0][-1])]))
    return var_param, out[4], out[6]
