"""Variational objectives as pure, differentiable functions.

JAX rebuild of the reference objectives
(reference: viabel/vb.py:236-298).  Each factory returns a callable

    objective_and_grad(var_param, key) -> (value, grad[, log_norm])

that is pure and jittable, so optimizers can `lax.scan` over it and chains
can be vmapped/sharded.  Gradients are reparameterization gradients obtained
with `jax.value_and_grad` / `jax.vjp`; the reference's per-step seed-replay
hack for CHIVI (drawing a fresh numpy seed and passing it to both the primal
and the VJP so their samples match; reference: viabel/vb.py:257-263) is
unnecessary because JAX's VJP reuses the primal's samples by construction.

Returned callables carry a ``has_log_norm`` attribute that optimizers use to
decide whether a third `log_norm` output is present (the reference threads an
explicit `has_log_norm` flag instead; reference: viabel/vb.py:359-363).
"""
import jax
import jax.numpy as jnp

__all__ = [
    'black_box_klvi',
    'black_box_klvi_pd',
    'black_box_klvi_pd2',
    'black_box_chivi',
    'black_box_chivi_neff',
    'perturbed_black_box_vi',
    'vectorize_log_density',
]


def vectorize_log_density(log_density):
    """Lift a single-point log density ``f(x: (d,)) -> scalar`` to batches.

    JAX counterpart of the reference's `np.apply_along_axis` host loop
    (reference: viabel/vb.py:301-305): `jax.vmap` vectorizes the density once
    at trace time so XLA compiles a single batched kernel.
    """
    batched = jax.vmap(log_density)

    def wrapped(x):
        if x.ndim == 1:
            return log_density(x)
        return batched(x)

    return wrapped


def _attach_presampling(fn, var_family, n_samples):
    """Mark `fn` as consuming pre-generated standard draws and give it a
    batched draw generator.

    `make_draws(key, n_iters)` produces one iteration's worth of
    `base_sample` output per scan step, using exactly the per-iteration
    ``fold_in(key, i)`` keys the optimizers use — so a pre-sampled run is
    bit-identical to the key-threaded run, while the (rejection-sampled)
    draw generation is batched into one call instead of one per scan step.
    """
    fn.presampled = True

    def make_draws_range(key, start, length, dtype=jnp.float32):
        def one(i):
            return var_family.base_sample(jax.random.fold_in(key, i),
                                          n_samples, dtype)
        return jax.vmap(one)(jnp.arange(length) + start)

    def make_draws(key, n_iters, dtype=jnp.float32):
        return make_draws_range(key, 0, n_iters, dtype)

    fn.make_draws = make_draws
    fn.make_draws_range = make_draws_range
    return fn


def black_box_klvi(var_family, log_density, n_samples, presampled=False):
    """KLVI objective: ``-ELBO`` with closed-form entropy
    (reference: viabel/vb.py:236-245).

    `log_density` must map a batch of samples ``(n, d)`` to log densities
    ``(n,)`` (use `vectorize_log_density` for per-point densities).

    With ``presampled=True`` the returned objective consumes pre-generated
    standard draws instead of a PRNG key (see `_attach_presampling`) —
    optimizers then hoist all draw generation out of the scan, which
    removes the per-iteration rejection-sampler loops (Student-t / gamma)
    from the compiled step and substantially raises iterations/s.
    """

    def objective(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        lower_bound = (var_family.entropy(var_param)
                       + jnp.mean(log_density(samples)))
        return -lower_bound

    objective_and_grad = jax.value_and_grad(objective)
    objective_and_grad.has_log_norm = False
    objective_and_grad.objective = objective
    if presampled:
        _attach_presampling(objective_and_grad, var_family, n_samples)
    return objective_and_grad


def _sample_or_transform(var_family, n_samples, presampled, var_param,
                         rng_or_draws):
    if presampled:
        # a presampled objective consumes base_sample output (floating
        # draws), not a PRNG key; catch the mixed-convention call eagerly —
        # for low-dim families a (2,)-shaped uint32 key would otherwise
        # broadcast into the transform and compute garbage silently
        bad = [jnp.asarray(leaf).dtype
               for leaf in jax.tree.leaves(rng_or_draws)
               if not jnp.issubdtype(jnp.asarray(leaf).dtype, jnp.floating)]
        if bad:
            raise TypeError(
                'this objective was built with presampled=True and consumes '
                'pre-generated standard draws (floating point), but '
                'received dtype(s) {} — looks like a PRNG key.  Optimizers '
                'feed draws automatically (obj.make_draws); for direct '
                'calls pass var_family.base_sample(key, n_samples), or '
                'rebuild the objective with presampled=False to consume '
                'keys'.format(bad))
        return var_family.transform(var_param, rng_or_draws)
    return var_family.sample(rng_or_draws, var_param, n_samples)


def black_box_klvi_pd(var_family, log_density, n_samples, presampled=False):
    """KLVI with a Monte Carlo entropy term (path-derivative form 1):
    ``-(E[log p] - E[log q])`` with gradients through everything
    (reference: viabel/vb.py:270-280)."""

    def objective(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        lower_bound = (jnp.mean(log_density(samples))
                       - jnp.mean(var_family.log_prob(var_param, samples)))
        return -lower_bound

    objective_and_grad = jax.value_and_grad(objective)
    objective_and_grad.has_log_norm = False
    objective_and_grad.objective = objective
    if presampled:
        _attach_presampling(objective_and_grad, var_family, n_samples)
    return objective_and_grad


def black_box_klvi_pd2(var_family, log_density, n_samples,
                       presampled=False):
    """KLVI path-derivative ("sticking the landing") estimator.

    The reference's pd2 partially applies `var_param` into `logdensity`
    intending to exclude the score-function path
    (reference: viabel/vb.py:283-298) — but autograd still tracks the
    partially-applied value, so the intent is not realized there.  Here the
    intended semantics are implemented directly with `stop_gradient` on the
    density parameters (Roeder et al. 2017, "Sticking the Landing"), which
    yields the lower-variance estimator the reference was aiming for.
    """

    def objective(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        frozen = jax.lax.stop_gradient(var_param)
        lower_bound = (jnp.mean(log_density(samples))
                       - jnp.mean(var_family.log_prob(frozen, samples)))
        return -lower_bound

    objective_and_grad = jax.value_and_grad(objective)
    objective_and_grad.has_log_norm = False
    objective_and_grad.objective = objective
    if presampled:
        _attach_presampling(objective_and_grad, var_family, n_samples)
    return objective_and_grad


def black_box_chivi(alpha, var_family, log_density, n_samples,
                    presampled=False):
    """CHIVI (chi^2 / alpha-divergence) objective via the exponentiated CUBO.

    Returns ``(cubo_estimate, grad, log_norm)`` where `log_norm` is the
    max log-weight used for rescaling — optimizers use it for the windowed
    gradient rescaling (reference: viabel/vb.py:248-266, 371).  The gradient
    is ``alpha * J^T w_alpha / n`` with ``w_alpha = exp(lw - max lw)^alpha``
    held constant, exactly the reference's `vector_jacobian_product`
    construction (reference: viabel/vb.py:255, 263).  ``presampled=True``
    as in `black_box_klvi`.

    **Dimension limit.**  The naive-MC CUBO estimator degenerates once the
    per-batch log-weight spread exceeds a few nats: ``w_alpha`` collapses
    onto the argmax sample, the estimate reduces to ~``max lw``, and
    descent walks q away from p without bound at ANY learning rate.
    Measured onset (full-rank Gaussian, conjugate regression): divergence
    from d = 30 up, at every lr in {5e-3 .. 5e-4}; the alpha-weight ESS at
    the optimum is 58/1e5 by d = 300 (benchmarks/DIM_SCALING.md,
    dim_objectives.json).  This is a property of the objective — the
    reference's workloads (d <= 10, where CHIVI certifies) never reach it.
    At large d use KLVI + PSIS correction; a diverged pipeline run is
    reported via `pipeline.DivergedRunWarning` and vacuous (inf) bounds.
    """

    def compute_log_weights(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        return log_density(samples) - var_family.log_prob(var_param, samples)

    def objective_grad_and_log_norm(var_param, key):
        log_weights, vjp_fn = jax.vjp(
            lambda p: compute_log_weights(p, key), var_param)
        log_norm = jnp.max(log_weights)
        scaled_values = jnp.exp(log_weights - log_norm) ** alpha
        obj_value = jnp.log(jnp.mean(scaled_values)) / alpha + log_norm
        cotangent = jax.lax.stop_gradient(scaled_values)
        obj_grad = alpha * vjp_fn(cotangent)[0] / scaled_values.size
        return obj_value, obj_grad, log_norm

    objective_grad_and_log_norm.has_log_norm = True
    objective_grad_and_log_norm.compute_log_weights = compute_log_weights
    if presampled:
        _attach_presampling(objective_grad_and_log_norm, var_family,
                            n_samples)
    return objective_grad_and_log_norm


def black_box_chivi_neff(alpha, var_family, log_density, n_samples,
                         presampled=False):
    """CHIVI with an effective-sample-size-aware gradient.

    Reconstruction of `black_box_chivi_neff`, which the reference notebooks
    import but whose source is absent from the repo
    (reference: notebooks/chive_expts_3.ipynb cells 1 & 24; SURVEY.md
    section 2.3).  Identical to `black_box_chivi` except the gradient is
    scaled by ``n_eff / n_samples`` where
    ``n_eff = (sum w^alpha)^2 / sum w^(2 alpha)`` is the effective sample
    size of the exponentiated weights: a full-ESS weight set recovers the
    plain CHIVI gradient, while weight sets dominated by a few samples —
    whose MC gradient estimate is unreliable — are damped toward zero.

    At large d this damping is measured to arrest plain CHIVI's runaway
    divergence (finite with bounded drift at d = 100 where `black_box_chivi`
    hits NaN in 74 iterations) without restoring a certifying fit — the
    degenerate gradient carries no usable signal to damp
    (benchmarks/DIM_SCALING.md).
    (The opposite convention, *dividing* by ``n_eff``, amplifies the
    gradient by up to ``n_samples``x exactly when the estimate is worst and
    diverges on the chive_expts_3 workload itself; measured in
    benchmarks/CHIVI_PROTOCOLS.md.)  Also reports `n_eff` via a fourth
    output.
    """

    def compute_log_weights(var_param, rng_or_draws):
        samples = _sample_or_transform(var_family, n_samples, presampled,
                                       var_param, rng_or_draws)
        return log_density(samples) - var_family.log_prob(var_param, samples)

    def objective_grad_and_log_norm(var_param, key):
        log_weights, vjp_fn = jax.vjp(
            lambda p: compute_log_weights(p, key), var_param)
        log_norm = jnp.max(log_weights)
        scaled_values = jnp.exp(log_weights - log_norm) ** alpha
        obj_value = jnp.log(jnp.mean(scaled_values)) / alpha + log_norm
        neff = (jnp.sum(scaled_values) ** 2
                / jnp.sum(scaled_values ** 2))
        cotangent = jax.lax.stop_gradient(scaled_values)
        obj_grad = (alpha * vjp_fn(cotangent)[0]
                    * neff / (n_samples * n_samples))
        return obj_value, obj_grad, log_norm, neff

    objective_grad_and_log_norm.has_log_norm = True
    objective_grad_and_log_norm.compute_log_weights = compute_log_weights
    if presampled:
        _attach_presampling(objective_grad_and_log_norm, var_family,
                            n_samples)
    return objective_grad_and_log_norm


def perturbed_black_box_vi(var_family, log_density, n_samples,
                           perturbation_scale=0.1):
    """KLVI with Gaussian parameter-space perturbation (smoothed objective).

    Reconstruction of `perturbed_black_box_vi` / the perturb-optimize
    experiments, imported by the reference notebooks but absent from the
    repo (reference: notebooks/chivi_expts.ipynb cell 1; SURVEY.md
    section 2.3).  Each evaluation perturbs the variational parameters with
    ``N(0, perturbation_scale^2)`` noise before computing the KLVI
    objective — gradient smoothing that helps escape poor basins in the
    CHIVI experiments the notebooks run.
    """

    def objective(var_param, key):
        perturb_key, sample_key = jax.random.split(key)
        noise = perturbation_scale * jax.random.normal(
            perturb_key, var_param.shape, dtype=var_param.dtype)
        perturbed = var_param + noise
        samples = var_family.sample(sample_key, perturbed, n_samples)
        lower_bound = (var_family.entropy(perturbed)
                       + jnp.mean(log_density(samples)))
        return -lower_bound

    objective_and_grad = jax.value_and_grad(objective)
    objective_and_grad.has_log_norm = False
    objective_and_grad.objective = objective
    return objective_and_grad
