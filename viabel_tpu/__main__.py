"""Command-line interface: ``python -m viabel_tpu <command>``.

The reference has no CLI (experiments are driven from notebooks; SURVEY.md
section 1).  This provides the missing entry point:

* ``run`` — run a VI experiment from a config (flags or ``--config`` JSON),
  printing accuracy, bounds, and khat; optional checkpointing.
* ``bench`` — the throughput benchmark (same as bench.py).
* ``configs`` — print an example config with all fields.

Examples
--------
python -m viabel_tpu run --model funnel --family mean_field_t --n-iters 2000
python -m viabel_tpu run --config my_experiment.json
python -m viabel_tpu configs
"""
import argparse
import dataclasses
import sys

import numpy as np


def _report_mesh(mesh, note, context=''):
    """Surface `parallel.auto_mesh`'s placement decision (or the reason
    for a single-device fallback) — attached devices are never skipped
    silently."""
    if note:
        print(('mesh: ' if mesh is not None else 'note: ') + note + context)


def _cmd_run(args):
    import jax
    from .config import ExperimentConfig, build
    from .experiments import (check_approx_accuracy,
                              get_samples_and_log_weights, print_bounds)
    from .bounds import all_bounds, family_moment_bounds
    from .psis import psislw

    if args.config:
        with open(args.config) as f:
            cfg = ExperimentConfig.from_json(f.read())
    else:
        fields = {f.name for f in dataclasses.fields(ExperimentConfig)}
        overrides = {k: v for k, v in vars(args).items()
                     if k in fields and v is not None}
        cfg = ExperimentConfig(**overrides)
    print('config:', cfg.to_json())

    model, family, objective = build(cfg)
    key = jax.random.PRNGKey(cfg.seed)
    opt_key, bound_key, psis_key = jax.random.split(key, 3)
    init = family.init_param()

    n_starts = getattr(args, 'starts', None)
    sweep_lr = getattr(args, 'sweep_lr', None)
    # `is not None` (not truthiness): --starts 0 must reach the batched
    # runner's validation and fail loudly, not silently run single-start
    if n_starts is not None or sweep_lr:
        return _run_batched(args, cfg, model, family, objective, opt_key)

    if getattr(args, 'fused', False):
        # the whole workflow as one compiled device program
        if cfg.optimizer != 'adagrad':
            sys.exit('--fused supports the adagrad optimizer only')
        if not cfg.bound_samples:
            sys.exit('--fused runs the bound stage inside the fused '
                     'program; --bound-samples must be > 0 (drop --fused '
                     'for an optimization-only run)')
        if cfg.checkpoint_path:
            sys.exit('--fused does not support --checkpoint-path (the '
                     'fused program is a single device call; use the '
                     'non-fused path for resumable runs)')
        from .pipeline import validated_vi
        from .parallel import auto_mesh
        # shard the fused program's bound/PSIS stage over all attached
        # devices (the optimizer scan replicates; samples and log-weights
        # never leave their device)
        mesh, note = auto_mesh(1, cfg.bound_samples)
        _report_mesh(mesh, note)
        out = validated_vi(
            model.log_prob, family, init, cfg.n_iters,
            objective_and_grad=objective,
            n_bound_samples=cfg.bound_samples, key=opt_key,
            learning_rate=cfg.learning_rate,
            learning_rate_end=cfg.learning_rate_end, mesh=mesh)
        values = np.asarray(out['value_history'])
        print('final loss (tail mean): {:.6g}'.format(
            float(values[-max(len(values) // 10, 1):].mean())))
        print('posterior mean estimate:',
              np.round(np.asarray(out['q_mean']), 4))
        if model.true_mean is not None:
            check_approx_accuracy(family, out['opt_param'],
                                  model.true_mean, model.true_cov,
                                  verbose=True)
        print_bounds(out['bounds'])
        khat = out['khat']
        print('khat = {:.3f}{}'.format(
            khat, '  (> 0.7: unreliable)' if khat > 0.7 else ''))
        print('PSIS-corrected mean:',
              np.round(np.asarray(out['psis_mean']), 4))
        return

    from .config import fit as fit_config
    progress = (cfg.optimizer == 'adagrad' and not cfg.checkpoint_path
                and not args.quiet)
    opt_param, values, ia_log = fit_config(cfg, model, family, objective,
                                           key=opt_key, progress=progress)
    if ia_log is not None:
        print('iterate-averaging start: mean iter {}, sigma iter {}'.format(
            ia_log['start_avg_mean_iters'], ia_log['start_avg_sigma_iters']))

    print('final loss (tail mean): {:.6g}'.format(
        float(np.mean(np.asarray(values)[-max(len(values) // 10, 1):]))))
    mean, cov = family.mean_and_cov(opt_param)
    print('posterior mean estimate:', np.round(np.asarray(mean), 4))
    if model.true_mean is not None:
        check_approx_accuracy(family, opt_param, model.true_mean,
                              model.true_cov, verbose=True)

    if cfg.bound_samples:
        from .parallel import auto_mesh
        mesh, note = auto_mesh(1, cfg.bound_samples)
        _report_mesh(mesh, note, ' (bound stage)')
        # mb is None for families without a finite closed-form 4th moment
        # (t with df <= 4): both branches then fall back to empirical
        # central moments of the bound samples
        mb = family_moment_bounds(family, opt_param)
        if mesh is not None:
            # multi-device host: shard the MC bound pass over the sample
            # axis (each device draws/scores its shard; psum'd statistics,
            # tail-only PSIS gather)
            from .parallel import psislw_sharded, sharded_all_bounds
            res, lw = sharded_all_bounds(
                model.log_prob, family, opt_param, cfg.bound_samples,
                bound_key, mesh, q_var=np.asarray(cov),
                moment_bound_fn=mb, return_log_weights=True)
            khat = psislw_sharded(lw, mesh)[1]
        else:
            samples, lw = get_samples_and_log_weights(
                model.log_prob, family, opt_param, cfg.bound_samples,
                bound_key)
            # lw stays on device: all_bounds' statistics pass is a fused
            # device reduction, so only scalars cross to the host
            res = all_bounds(lw,
                             samples=samples if mb is None else None,
                             q_var=np.asarray(cov), moment_bound_fn=mb)
            khat = psislw(lw)[1]
        print_bounds(res)
        print('khat = {:.3f}{}'.format(
            float(khat), '  (> 0.7: unreliable)' if khat > 0.7 else ''))


def _run_batched(args, cfg, model, family, objective, opt_key):
    """``run --starts K`` / ``run --sweep-lr a,b,c``: the batched
    single-dispatch pipelines (`validated_vi_multistart` /
    `validated_vi_sweep`), mesh-aware when more than one device is
    attached (the start axis partitions over a ``chain`` mesh; on a
    multi-axis mesh each start's bound pass also shards over ``sample``).
    """
    import jax
    import numpy as np
    from .experiments import check_approx_accuracy, print_bounds

    n_starts = getattr(args, 'starts', None)
    sweep_lr = getattr(args, 'sweep_lr', None)
    if n_starts and sweep_lr:
        sys.exit('--starts and --sweep-lr are mutually exclusive (one '
                 'batched pipeline per run)')
    if n_starts is not None and n_starts < 1:
        sys.exit('--starts must be a positive integer')
    if getattr(args, 'fused', False):
        print('note: --starts/--sweep-lr are already single-dispatch fused '
              'pipelines; --fused adds nothing here')
    if cfg.optimizer != 'adagrad':
        sys.exit('--starts/--sweep-lr run the batched adagrad pipelines; '
                 'set --optimizer adagrad (or drop --optimizer)')
    if not cfg.bound_samples:
        sys.exit('--starts/--sweep-lr validate every run with bounds; '
                 '--bound-samples must be > 0')
    if cfg.checkpoint_path:
        sys.exit('--starts/--sweep-lr are single-dispatch programs and do '
                 'not support --checkpoint-path')

    init = family.init_param()
    common = dict(objective_and_grad=objective,
                  n_bound_samples=cfg.bound_samples, key=opt_key)

    if n_starts:
        from .pipeline import validated_vi_multistart
        from .parallel import auto_mesh
        # the shared placement rule (parallel.auto_mesh, also behind serve
        # /fit): starts take a (gcd(K, N), N/gcd) (chain, sample) mesh;
        # never skip attached devices silently — the fallback reason is
        # printed
        mesh, note = auto_mesh(n_starts, cfg.bound_samples)
        _report_mesh(mesh, note)
        out = validated_vi_multistart(
            model.log_prob, family, init, cfg.n_iters, n_starts=n_starts,
            perturb_scale=args.perturb_scale,
            learning_rate=cfg.learning_rate,
            learning_rate_end=cfg.learning_rate_end, mesh=mesh, **common)
        labels = ['start {}{}'.format(k, ' (unperturbed)' if k == 0 else '')
                  for k in range(n_starts)]
    else:
        from .pipeline import validated_vi_sweep
        try:
            lrs = [float(v) for v in sweep_lr.split(',') if v]
        except ValueError:
            sys.exit('--sweep-lr takes a comma-separated list of rates, '
                     'e.g. --sweep-lr 0.1,0.03,0.01')
        if not lrs:
            sys.exit('--sweep-lr got an empty list of rates')
        lr_ends = None
        if args.sweep_lr_end:
            try:
                lr_ends = [float(v) for v in args.sweep_lr_end.split(',')
                           if v]
            except ValueError:
                sys.exit('--sweep-lr-end takes a comma-separated list')
            if len(lr_ends) != len(lrs):
                sys.exit('--sweep-lr-end must list one end rate per '
                         '--sweep-lr rate ({} given for {} rates)'.format(
                             len(lr_ends), len(lrs)))
        elif cfg.learning_rate_end is not None:
            # a single --learning-rate-end applies to every swept rate
            lr_ends = [cfg.learning_rate_end] * len(lrs)
        if lr_ends is not None:
            bad = [(e, l) for e, l in zip(lr_ends, lrs) if not 0 < e < l]
            if bad:
                sys.exit('each end rate must satisfy 0 < end < rate; got '
                         'end {:g} for rate {:g}'.format(*bad[0]))
        from .parallel import auto_mesh
        mesh, note = auto_mesh(len(lrs), cfg.bound_samples)
        _report_mesh(mesh, note, ' (rate axis)')
        out = validated_vi_sweep(
            model.log_prob, family, init, cfg.n_iters, learning_rates=lrs,
            learning_rate_ends=lr_ends, mesh=mesh, **common)
        labels = ['lr {:g}'.format(lr) for lr in lrs]

    # the batched outputs are chain-sharded when a mesh is attached; under
    # a multi-controller runtime bare np.asarray on them raises (CLAUDE.md
    # fetch convention) — every host fetch goes through fetch_global
    from .parallel import fetch_global
    values = fetch_global(out['value_history'])
    for k, label in enumerate(labels):
        b, khat = out['bounds'][k], out['khat'][k]
        print('{:>22}: d2 = {:<10.4g} khat = {:+.3f}  final loss = '
              '{:.6g}'.format(label, b['d2'], khat,
                              float(values[k][-max(values.shape[1] // 10,
                                                   1):].mean())))
    best = out['best']
    print('best by validated d2 bound: {}'.format(labels[best]))
    best_param = fetch_global(out['opt_param'])[best]
    print('posterior mean estimate:',
          np.round(fetch_global(out['q_mean'])[best], 4))
    if model.true_mean is not None:
        check_approx_accuracy(family, best_param, model.true_mean,
                              model.true_cov, verbose=True)
    print_bounds(out['bounds'][best])
    khat = out['khat'][best]
    print('khat = {:.3f}{}'.format(
        khat, '  (> 0.7: unreliable)' if khat > 0.7 else ''))
    print('PSIS-corrected mean:',
          np.round(fetch_global(out['psis_mean'])[best], 4))


def _cmd_bench(args):
    import os
    import runpy
    bench_path = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'bench.py')
    sys.argv = [bench_path]
    runpy.run_path(bench_path, run_name='__main__')


def _cmd_configs(args):
    from .config import ExperimentConfig
    print(ExperimentConfig().to_json())


def main(argv=None):
    p = argparse.ArgumentParser(prog='python -m viabel_tpu')
    sub = p.add_subparsers(dest='cmd', required=True)

    # choices come from the config registries so the CLI cannot drift
    from .config import FAMILIES, MODELS, OBJECTIVES, OPTIMIZERS

    pr = sub.add_parser('run', help='run a VI experiment')
    pr.add_argument('--config', help='JSON config file')
    pr.add_argument('--model', choices=MODELS)
    pr.add_argument('--family', choices=FAMILIES)
    pr.add_argument('--objective', choices=OBJECTIVES)
    pr.add_argument('--optimizer', choices=OPTIMIZERS)
    pr.add_argument('--df', type=float)
    pr.add_argument('--alpha', type=float)
    pr.add_argument('--n-mc', dest='n_mc', type=int,
                    help='Monte Carlo samples per gradient (default 100, '
                         'the reference protocol); gradient variance '
                         'falls as 1/n_mc')
    pr.add_argument('--n-iters', dest='n_iters', type=int)
    pr.add_argument('--n-chains', dest='n_chains', type=int)
    pr.add_argument('--learning-rate', dest='learning_rate', type=float)
    pr.add_argument('--learning-rate-end', dest='learning_rate_end',
                    type=float)
    pr.add_argument('--seed', type=int)
    pr.add_argument('--bound-samples', dest='bound_samples', type=int)
    pr.add_argument('--no-presampled', dest='presampled',
                    action='store_const', const=False,
                    help='sample inside the optimizer scan instead of '
                         'batching all draws up front (saves the '
                         '(n_iters, n_mc, dim) draw array on very long '
                         'runs, at lower it/s)')
    pr.add_argument('--checkpoint-path', dest='checkpoint_path')
    pr.add_argument('--quiet', action='store_true')
    pr.add_argument('--fused', action='store_true',
                    help='run the whole workflow (optimize + bounds + PSIS)'
                         ' as one compiled device program (validated_vi)')
    pr.add_argument('--starts', type=int,
                    help='run K complete validated pipelines from perturbed '
                         'inits in ONE compiled program '
                         '(validated_vi_multistart; partitions over a '
                         'device mesh when several devices are attached) '
                         'and report the start with the tightest validated '
                         'bound')
    pr.add_argument('--perturb-scale', dest='perturb_scale', type=float,
                    default=0.5,
                    help='multistart init perturbation scale '
                         '(default 0.5, the reference scheme)')
    pr.add_argument('--sweep-lr', dest='sweep_lr',
                    help='comma-separated learning rates; runs the complete '
                         'validated pipeline once per rate in ONE compiled '
                         'program (validated_vi_sweep) with common random '
                         'numbers and reports the best rate')
    pr.add_argument('--sweep-lr-end', dest='sweep_lr_end',
                    help='comma-separated schedule end rates matching '
                         '--sweep-lr')
    pr.set_defaults(fn=_cmd_run)

    pb = sub.add_parser('bench', help='run the throughput benchmark')
    pb.set_defaults(fn=_cmd_bench)

    pc = sub.add_parser('configs', help='print an example config')
    pc.set_defaults(fn=_cmd_configs)

    args = p.parse_args(argv)
    from .utils import enable_compile_cache
    enable_compile_cache()
    args.fn(args)


if __name__ == '__main__':
    main()
