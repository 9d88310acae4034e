"""Mesh-scaling measurement on virtual CPU devices and across processes.

What this script can measure without accelerators splits into three
tiers (benchmarks/SCALING.md interprets them); the sharded paths on four
real GPUs are exercised by `python chip_smoke.py --four-gpus`:

1. **Mechanism (virtual pool)** — `sharded_all_bounds` + `psislw_sharded`
   over 1/2/4/8 virtual CPU devices at production sizes.  For each device
   count D this reports the sharded wall-clock T_D(n) *and* the
   single-device wall-clock on one shard's worth of work T_1(n/D); their
   difference is (collective cost + host core contention).  NOTE the host
   has few physical cores and XLA's CPU backend already multithreads the
   D=1 baseline across all of them, so wall-clock "efficiency vs linear"
   on this pool measures core contention, NOT the sharding design.
2. **Cross-process (2-process Gloo)** — the same program structure that
   crosses hosts in a multi-host run, timed at production size via
   `benchmarks/scaling_worker.py` (both ranks must report identical
   replicated statistics).
3. **Collective-payload accounting (static)** — bytes moved by the
   collectives per fused bound+PSIS pass vs bytes of per-device local
   work.

Usage:
  python benchmarks/scaling.py [--n 2500000] [--devices 8] [--reps 3]
                               [--two-process] [--nprocs 4] [--json PATH]

`--nprocs` widens the cross-process modes beyond the default 2 ranks:
each rank owns 2 virtual devices, so ``--nprocs 4`` forms an 8-device
mesh spanning 4 OS-process controllers (tier 2c).
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _bound_pass_timer(model, fam, vp, mesh, n, key, reps):
    """Best-of-reps wall-clock of the fused sharded bound+PSIS pass.

    Follows the production conventions: closed-form moments come from ONE
    cached program + one transfer (`family_moment_bounds`, CLAUDE.md's
    single-fetch rule) and samples are not materialized (the moment bounds
    make them unnecessary) — the timed op is exactly `validated_vi`'s
    sharded bound stage."""
    import jax
    from viabel_tpu.bounds import family_moment_bounds
    from viabel_tpu.parallel import psislw_sharded, sharded_all_bounds

    def one_pass(k):
        res, lw = sharded_all_bounds(
            model.log_prob, fam, vp, n, k, mesh,
            moment_bound_fn=family_moment_bounds(fam, vp),
            return_log_weights=True)
        slw, _ = psislw_sharded(lw, mesh)
        jax.block_until_ready(slw)

    one_pass(key)  # warm-up / compile
    best = float('inf')
    for rep in range(reps):
        t0 = time.perf_counter()
        one_pass(jax.random.fold_in(key, rep))
        best = min(best, time.perf_counter() - t0)
    return best


def _spawn_workers(nprocs, n, reps, mode):
    """Launch `nprocs` scaling_worker.py ranks (2 virtual devices each)
    sharing one Gloo coordinator; returns their parsed JSON outputs."""
    import socket
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = str(s.getsockname()[1])
    s.close()
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'scaling_worker.py')
    env = {k: v for k, v in os.environ.items() if k != 'XLA_FLAGS'}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(i), str(nprocs), port, str(n),
         str(reps), mode],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for i in range(nprocs)]
    outs = []
    for pr in procs:
        out_b, err = pr.communicate(timeout=1800)
        assert pr.returncode == 0, err.decode()[-2000:]
        outs.append(json.loads(out_b.decode().strip().splitlines()[-1]))
    return outs


def _collective_accounting(n, d, n_dev, tail_len):
    """Static payload accounting for one fused bound+PSIS pass.

    Local work reads/writes O(n/D * d) floats from device memory; the
    collectives move O(1) scalars (stat psums) plus the PSIS tail gather
    of D * (tail_len + 1) floats.
    """
    f = 4  # f32 bytes
    local_bytes = (n // n_dev) * (d + 1) * f * 3   # draws, scores, weights
    stat_scalars = (2 * 2 + 1) + (d + d * d)       # psums + moment psums
    gather_bytes = n_dev * (tail_len + 1) * f
    coll_bytes = stat_scalars * f + gather_bytes
    return dict(local_bytes=local_bytes, collective_bytes=coll_bytes)


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--devices', type=int, default=8)
    p.add_argument('--n', type=int, default=2500000)
    p.add_argument('--reps', type=int, default=3)
    p.add_argument('--two-process', action='store_true')
    p.add_argument('--nprocs', type=int, default=2,
                   help='process count for the cross-process modes (each '
                        'rank owns 2 virtual devices; 4 procs -> an '
                        '8-device mesh spanning 4 controllers)')
    p.add_argument('--two-process-multistart', action='store_true',
                   help='record tier 2b: the 2-D fused multistart timed '
                        'across a real 2-process Gloo boundary vs '
                        'single-process on the same (2, 2) mesh shape')
    p.add_argument('--json', help='write results to this path')
    args = p.parse_args()

    os.environ['XLA_FLAGS'] = (os.environ.get('XLA_FLAGS', '')
                               + ' --xla_force_host_platform_device_count={}'
                               .format(args.devices))
    import jax
    jax.config.update('jax_platforms', 'cpu')

    import warnings

    import jax.numpy as jnp
    from viabel_tpu import mean_field_t_variational_family
    from viabel_tpu.bounds import MonteCarloErrorWarning
    from viabel_tpu.models import eight_schools_cp_model
    from viabel_tpu.parallel import make_mesh
    from viabel_tpu.psis import _tail_len
    warnings.simplefilter('ignore', MonteCarloErrorWarning)

    model = eight_schools_cp_model()
    fam = mean_field_t_variational_family(model.dim, 40)
    vp = jnp.zeros(fam.var_param_dim, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)
    n = args.n

    print('host: {} physical cores; {} virtual {} devices; n = {:.2g}'
          .format(os.cpu_count(), len(jax.devices()),
                  jax.devices()[0].platform, float(n)))

    results = dict(n=n, host_cores=os.cpu_count(), tiers={})
    sizes = [d for d in [1, 2, 4, 8, 16] if d <= len(jax.devices())]

    # tier 1: sharded pass at n over D devices vs one shard's work on 1
    tier1 = []
    for n_dev in sizes:
        mesh = make_mesh(axis_names=('sample',), shape=(n_dev,),
                         devices=jax.devices()[:n_dev])
        t_full = _bound_pass_timer(model, fam, vp, mesh, n, key, args.reps)
        mesh1 = make_mesh(axis_names=('sample',), shape=(1,),
                          devices=jax.devices()[:1])
        t_shard = _bound_pass_timer(model, fam, vp, mesh1, n // n_dev,
                                    jax.random.fold_in(key, 99), args.reps)
        row = dict(devices=n_dev, t_sharded_s=t_full,
                   t_one_shard_s=t_shard,
                   samples_per_s=n / t_full,
                   overhead_s=t_full - t_shard)
        tier1.append(row)
        print('D={:2d}: T_D(n) = {:6.3f}s ({:.3g} samples/s) | '
              'T_1(n/D) = {:6.3f}s | overhead (collectives + core '
              'contention) = {:6.3f}s'.format(
                  n_dev, t_full, n / t_full, t_shard, row['overhead_s']))
    results['tiers']['virtual_pool'] = tier1

    # tier 3: static collective accounting
    acct = _collective_accounting(n, model.dim, args.devices,
                                  _tail_len(n, 1.0))
    results['tiers']['collective_accounting'] = acct
    print('collective payload: {:.1f} kB moved vs {:.1f} MB local per '
          'pass'.format(acct['collective_bytes'] / 1e3,
                        acct['local_bytes'] / 1e6))

    # tier 2b: the flagship 2-D fused multistart (2 starts x n-sample
    # sharded bounds on a 2x2 mesh) timed across the real process boundary
    # AND single-process on the same mesh shape
    if args.two_process_multistart:
        from viabel_tpu import black_box_klvi, validated_vi_multistart
        # chain size = process count (each rank owns 2 devices and one
        # chain row of the (nprocs, 2) mesh); K = nprocs starts
        c = args.nprocs
        mesh2d = make_mesh(axis_names=('chain', 'sample'), shape=(c, 2),
                           devices=jax.devices()[:2 * c])
        obj = black_box_klvi(fam, model.log_prob, 100, presampled=True)

        def ms_pass(k):
            out = validated_vi_multistart(
                model.log_prob, fam, vp, 2000, n_starts=c,
                perturb_scale=0.1, objective_and_grad=obj,
                n_bound_samples=n, key=k, learning_rate=.01, mesh=mesh2d)
            return out
        out = ms_pass(jax.random.PRNGKey(0))
        t_sp = float('inf')
        for rep in range(args.reps):
            t0 = time.perf_counter()
            out = ms_pass(jax.random.fold_in(jax.random.PRNGKey(0),
                                             rep + 1))
            t_sp = min(t_sp, time.perf_counter() - t0)
        print('2-D multistart single-process ({}x2 of {} virtual): {:.3f}s'
              .format(c, args.devices, t_sp))

        outs = _spawn_workers(args.nprocs, n, args.reps, 'multistart2d')
        for o in outs[1:]:
            assert o['d2'] == outs[0]['d2'], 'ranks disagree'
            assert o['khat'] == outs[0]['khat'], 'ranks disagree'
        best = max(o['best_s'] for o in outs)
        tier_key = ('two_process_multistart2d' if args.nprocs == 2
                    else 'multiprocess{}_multistart2d'.format(args.nprocs))
        results['tiers'][tier_key] = dict(
            n_procs=args.nprocs,
            n_global_devices=outs[0]['n_global'], best_s=best,
            single_process_s=t_sp, d2=outs[0]['d2'], khat=outs[0]['khat'])
        print('2-D multistart {}-process ({}x2 over Gloo): {:.3f}s vs '
              '{:.3f}s single-process; all ranks agree on d2/khat'.format(
                  args.nprocs, c, best, t_sp))

    # tier 2: cross-process Gloo run at the same size
    if args.two_process:
        outs = _spawn_workers(args.nprocs, n, args.reps, 'bounds')
        for o in outs[1:]:
            assert o['d2'] == outs[0]['d2'], 'ranks disagree'
            assert o['khat'] == outs[0]['khat'], 'ranks disagree'
        best = max(o['best_s'] for o in outs)  # slower rank bounds the pass
        tier_key = ('two_process' if args.nprocs == 2
                    else 'multiprocess{}'.format(args.nprocs))
        results['tiers'][tier_key] = dict(
            n_procs=args.nprocs,
            n_global_devices=outs[0]['n_global'], best_s=best,
            samples_per_s=n / best, d2=outs[0]['d2'],
            khat=outs[0]['khat'])
        print('{}-process ({} global devices, Gloo): {:.3f}s '
              '({:.3g} samples/s); all ranks agree on d2/khat'.format(
                  args.nprocs, outs[0]['n_global'], best, n / best))

    if args.json:
        # merge into an existing file so one JSON carries all tiers
        if os.path.exists(args.json):
            with open(args.json) as f:
                prior = json.load(f)
            prior_tiers = prior.get('tiers', {})
            for k, v in prior_tiers.items():
                results['tiers'].setdefault(k, v)
        with open(args.json, 'w') as f:
            json.dump(results, f, indent=1)
        print('wrote', args.json)
    return results


if __name__ == '__main__':
    main()
