"""Multi-device / multi-host recipe: the production mesh layouts.

The reference is single-process numpy (SURVEY.md section 2.4); this
example is the multi-device playbook for `viabel_tpu.parallel` — runnable
as-is on a virtual CPU pool (``--devices 8``, the default here), on a
multi-GPU host, or one process per host with ``--distributed``.

Layouts demonstrated (placement guidance: starts/rates on `chain` first —
embarrassingly parallel; spill onto `sample` only when K < N and the bound
stage dominates):

1. sample-sharded bound + PSIS pass (`sharded_all_bounds` +
   `psislw_sharded`) — the 2.5e6-sample estimator on an N-way mesh;
2. the flagship 2-D fused multistart: K starts over `chain` x per-start
   bounds over `sample` in ONE compiled program
   (`validated_vi_multistart(mesh=)`);
3. mesh-sharded IA chains (`rmsprop_IA_optimize_with_rhat(mesh=)`) and
   HMC ground-truth chains (`hmc_sample(mesh=)`).

On several GPU hosts, run one copy of this script per host with
``--distributed`` (coordinator address via ``--coord host:port``, rank
via ``--rank``/``--nprocs``): `jax.devices()` then spans every host, the same
meshes form globally, and every host post-pass in the library fetches
through `parallel.fetch_global` — `tests/test_distributed.py` pins rank
agreement bit-for-bit over a real 2-process Gloo boundary.
"""
import argparse
import os
import sys

sys.path.insert(0, '.')


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--devices', type=int, default=8,
                   help='virtual CPU device count for the default '
                        'demonstration pool')
    p.add_argument('--accel', action='store_true',
                   help='use the attached accelerator pool as-is instead '
                        'of the virtual CPU pool (pick this on a real '
                        'multi-GPU host)')
    p.add_argument('--distributed', action='store_true',
                   help='call initialize_distributed() first (one process '
                        'per host; implies --accel)')
    p.add_argument('--coord', help='coordinator host:port')
    p.add_argument('--rank', type=int)
    p.add_argument('--nprocs', type=int)
    p.add_argument('--quick', action='store_true',
                   help='tiny sizes (smoke run / test suite)')
    args = p.parse_args(argv)

    if not (args.accel or args.distributed):
        # default: a virtual CPU pool — platform must be forced BEFORE the
        # first backend touch (jax.devices() would otherwise claim the
        # attached accelerator)
        os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                                   + ' --xla_force_host_platform_device_'
                                     'count={}'.format(args.devices))
    import jax
    if not (args.accel or args.distributed):
        jax.config.update('jax_platforms', 'cpu')
    if args.distributed:
        from viabel_tpu.parallel import initialize_distributed
        info = initialize_distributed(args.coord, args.nprocs, args.rank)
        print('process {}/{}: {} global devices'.format(
            info['process_index'] + 1, info['process_count'],
            info['global_devices']))

    import jax.numpy as jnp
    import numpy as np

    from viabel_tpu import (black_box_klvi,
                            mean_field_t_variational_family,
                            rmsprop_IA_optimize_with_rhat,
                            validated_vi_multistart)
    from viabel_tpu.bounds import family_moment_bounds
    from viabel_tpu.models import robust_regression_model
    from viabel_tpu.parallel import (fetch_global, make_mesh,
                                     psislw_sharded, sharded_all_bounds)

    n_dev = len(jax.devices())
    scale = 0.05 if args.quick else 1.0
    model = robust_regression_model()
    fam = mean_field_t_variational_family(model.dim, 40)
    obj = black_box_klvi(fam, model.log_prob, 100)
    init = jnp.asarray(np.concatenate([np.zeros(model.dim),
                                       np.ones(model.dim)]),
                       dtype=jnp.result_type(float))

    # 1) sample-sharded bound + PSIS pass on all devices
    sample_mesh = make_mesh(axis_names=('sample',), shape=(n_dev,))
    vp = init
    n = max(int(40000 * scale), 1024) * n_dev
    res, lw = sharded_all_bounds(
        model.log_prob, fam, vp, n, jax.random.PRNGKey(0), sample_mesh,
        moment_bound_fn=family_moment_bounds(fam, vp),
        q_var=np.asarray(fam.mean_and_cov(vp)[1]), return_log_weights=True)
    _, khat = psislw_sharded(lw, sample_mesh)
    print('[1] {}-way sharded bound pass (n = {:.0e}): d2 = {:.3g}, '
          'khat = {:.3f}'.format(n_dev, float(n), res['d2'], float(khat)))

    # 2) the 2-D fused multistart: starts over chain x bounds over sample
    c = 2 if n_dev % 2 == 0 and n_dev > 1 else 1
    mesh2d = make_mesh(axis_names=('chain', 'sample'),
                       shape=(c, n_dev // c))
    ms = validated_vi_multistart(
        model.log_prob, fam, init, max(int(1000 * scale), 50),
        n_starts=2 * c, perturb_scale=0.25, objective_and_grad=obj,
        n_bound_samples=8192 * (n_dev // c), key=jax.random.PRNGKey(1),
        mesh=mesh2d)
    print('[2] ({}x{}) mesh, {} starts in one program: best start {} '
          '(d2 = {:.3g})'.format(c, n_dev // c, 2 * c, ms['best'],
                                 ms['bounds'][ms['best']]['d2']))

    # 3) mesh-sharded IA chains (the reference's sequential loop, spread
    # over devices)
    n_ia = max(int(500 * scale), 40)
    out = rmsprop_IA_optimize_with_rhat(
        n_ia, obj, init, model.dim, key=jax.random.PRNGKey(2),
        n_optimisers=c, rhat_window=n_ia // 2, tail_avg_iters=n_ia // 2,
        mesh=mesh2d)
    print('[3] {} IA chains over the chain axis: final R-hat max = '
          '{:.3f}'.format(c, float(np.max(out[6]['r_hat_mean']))))

    # 3b) HMC ground-truth chains on the same chain axis (each layout is
    # individually deterministic; sharded vs unsharded chains differ by
    # design — see hmc_sample's docstring)
    from viabel_tpu.mcmc import hmc_sample
    n_hmc = max(int(2000 * scale), 100)
    hmc = hmc_sample(model.log_prob, np.zeros(model.dim),
                     key=jax.random.PRNGKey(3), n_chains=2 * c,
                     n_samples=n_hmc, n_warmup=n_hmc // 2, mesh=mesh2d)
    print('[3b] {} HMC chains over the chain axis: R-hat max = {:.3f}, '
          'accept = {:.2f}'.format(2 * c, float(np.max(hmc['r_hat'])),
                                   hmc['accept_rate']))

    # host post-passes already used fetch_global internally; show it for a
    # user-held sharded array too
    print('    log-weights live on {} devices; fetch_global -> host {}'
          .format(len(lw.sharding.device_set), fetch_global(lw).shape))


if __name__ == '__main__':
    main()
