"""Subprocess worker for benchmarks/scaling.py's 2-process mode.

Each OS process owns half the virtual CPU devices; the shipped sharded
programs run over the global mesh with collectives crossing the process
boundary over Gloo — the same program structure that spans hosts in a
multi-host run.  Prints one JSON line with replicated results and steady-state
timings.

Modes (argv[6], default ``bounds``):

* ``bounds`` — the fused sharded bound+PSIS pass (`sharded_all_bounds`
  + `psislw_sharded`), the tier-1/tier-2 comparison op;
* ``multistart2d`` — the flagship 2-D fused multistart
  (`validated_vi_multistart(mesh=)` on a 2x2 (chain, sample) mesh):
  K=2 starts x <n>-sample bound passes, timed at production size across
  the real process boundary (tier 2b).

Usage: scaling_worker.py <proc_id> <n_procs> <port> <n_samples> <reps>
                         [bounds|multistart2d]
"""
import json
import os
import sys
import time


def main():
    proc_id, n_procs = int(sys.argv[1]), int(sys.argv[2])
    port, n, reps = sys.argv[3], int(sys.argv[4]), int(sys.argv[5])
    mode = sys.argv[6] if len(sys.argv) > 6 else 'bounds'
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=2'
    import jax
    jax.config.update('jax_platforms', 'cpu')
    sys.path.insert(0, os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))

    from viabel_tpu.parallel import (initialize_distributed, make_mesh,
                                     psislw_sharded, sharded_all_bounds)
    info = initialize_distributed('127.0.0.1:' + port, n_procs, proc_id)

    import warnings

    import jax.numpy as jnp
    from viabel_tpu import mean_field_t_variational_family
    from viabel_tpu.bounds import MonteCarloErrorWarning
    from viabel_tpu.models import eight_schools_cp_model
    warnings.simplefilter('ignore', MonteCarloErrorWarning)

    model = eight_schools_cp_model()
    fam = mean_field_t_variational_family(model.dim, 40)
    vp = jnp.zeros(fam.var_param_dim, dtype=jnp.float32)
    key = jax.random.PRNGKey(0)

    if mode == 'multistart2d':
        # tier 2b/2c: the complete fused multistart (optimize + sharded
        # bounds + PSIS per start) across the process boundary.  The mesh
        # is (n_global/2, 2): each rank owns 2 devices = one chain row,
        # with K = n_global/2 starts, so 4 ranks drive a (4, 2) mesh
        # spanning 4 controllers
        from viabel_tpu import black_box_klvi, validated_vi_multistart
        c = info['global_devices'] // 2
        mesh = make_mesh(axis_names=('chain', 'sample'), shape=(c, 2))
        obj = black_box_klvi(fam, model.log_prob, 100, presampled=True)

        def one_pass(k):
            out = validated_vi_multistart(
                model.log_prob, fam, vp, 2000, n_starts=c,
                perturb_scale=0.1, objective_and_grad=obj,
                n_bound_samples=n, key=k, learning_rate=.01, mesh=mesh)
            return out

        out = one_pass(key)  # warm-up / compile
        best = float('inf')
        for rep in range(reps):
            t0 = time.perf_counter()
            out = one_pass(jax.random.fold_in(key, rep + 1))
            best = min(best, time.perf_counter() - t0)
        print(json.dumps(dict(
            proc=proc_id, n_global=info['global_devices'],
            n_local=info['local_devices'], n=n, best_s=best,
            best=int(out['best']),
            d2=[float(b['d2']) for b in out['bounds']],
            khat=[float(v) for v in out['khat']])), flush=True)
        return

    mesh = make_mesh(axis_names=('sample',))  # all global devices

    # single-fetch closed-form moments, no sample materialization — the
    # same timed op as scaling.py's tier-1 `_bound_pass_timer`, so the
    # tier-1/tier-2 comparison is like for like (CLAUDE.md single-fetch
    # rule: never float() device scalars one by one)
    from viabel_tpu.bounds import family_moment_bounds

    def one_pass(k):
        res, lw = sharded_all_bounds(
            model.log_prob, fam, vp, n, k, mesh,
            moment_bound_fn=family_moment_bounds(fam, vp),
            return_log_weights=True)
        slw, khat = psislw_sharded(lw, mesh)
        jax.block_until_ready(slw)
        return res, float(khat)

    res, khat = one_pass(key)  # warm-up / compile
    best = float('inf')
    for rep in range(reps):
        t0 = time.perf_counter()
        res, khat = one_pass(jax.random.fold_in(key, rep))
        best = min(best, time.perf_counter() - t0)

    print(json.dumps(dict(
        proc=proc_id, n_global=info['global_devices'],
        n_local=info['local_devices'], n=n, best_s=best,
        samples_per_s=n / best, d2=float(res['d2']), khat=khat)),
        flush=True)


if __name__ == '__main__':
    main()
