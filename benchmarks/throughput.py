"""Optimizer-throughput benchmark: every BASELINE.md it/s row on one GPU.

Measures steady-state iterations/s (compile excluded by timing repeat
invocations of the cached compiled program) for each workload/objective
configuration the reference notebooks record, and writes
`benchmarks/THROUGHPUT.md` (the card's name beside the numbers).

Usage: python benchmarks/throughput.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def measure(obj, init, n_iters, lr, lr_end, reps=3):
    from viabel_tpu import adagrad_optimize
    t0 = time.perf_counter()
    out = adagrad_optimize(n_iters, obj, init, key=jax.random.PRNGKey(0),
                           learning_rate=lr, learning_rate_end=lr_end)
    jax.block_until_ready(out[0])
    t_first = time.perf_counter() - t0
    best = float('inf')
    for r in range(reps):
        t0 = time.perf_counter()
        out = adagrad_optimize(n_iters, obj, init,
                               key=jax.random.PRNGKey(r + 1),
                               learning_rate=lr, learning_rate_end=lr_end)
        jax.block_until_ready(out[0])
        best = min(best, time.perf_counter() - t0)
    return n_iters / best, t_first


def _card():
    """`nvidia-smi` name and power limit of the first card."""
    import subprocess
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].strip()


def main():
    if jax.devices()[0].platform != 'gpu':
        sys.exit('throughput: needs a GPU, found {!r}'.format(
            jax.devices()[0].platform))
    from viabel_tpu import (black_box_chivi, black_box_klvi,
                            mean_field_t_variational_family,
                            t_variational_family)
    from viabel_tpu.models import (eight_schools_cp_model,
                                   eight_schools_ncp_model, funnel_model,
                                   robust_regression_model)

    rr = robust_regression_model()
    fu = funnel_model()
    cp = eight_schools_cp_model()
    ncp = eight_schools_ncp_model()

    mf2 = mean_field_t_variational_family(2, 40)
    fr2 = t_variational_family(2, 100)
    mf10 = mean_field_t_variational_family(10, 40)

    def klvi(fam, m):
        return black_box_klvi(fam, m.log_prob, 100, presampled=True)

    def chivi(fam, m):
        return black_box_chivi(2, fam, m.log_prob, 500, presampled=True)

    z2, z4 = jnp.zeros(4, jnp.float32), jnp.zeros(20, jnp.float32)
    zfr = jnp.zeros(fr2.var_param_dim, jnp.float32)
    configs = [
        ('robust-regression KLVI mf-t(40) n_mc=100', klvi(mf2, rr), z2,
         5000, .01, None, 245.65),
        ('robust-regression CHIVI a=2 n_mc=500', chivi(mf2, rr), z2,
         5000, .01, None, 48.70),
        ('robust-regression KLVI full-rank-t(100)', klvi(fr2, rr), zfr,
         5000, .1, .001, 143.81),
        ('funnel KLVI mf-t(40)', klvi(mf2, fu), z2, 10000, .01, .001,
         541.35),
        ('funnel CHIVI', chivi(mf2, fu), z2, 10000, .01, .001, 218.38),
        ('eight-schools CP KLVI mf-t(40)', klvi(mf10, cp), z4, 10000,
         .01, .001, 278.19),
        ('eight-schools CP CHIVI', chivi(mf10, cp), z4, 10000, .01, .001,
         48.41),
        ('eight-schools NCP KLVI', klvi(mf10, ncp), z4, 5000, .01, .001,
         243.26),
        ('eight-schools NCP CHIVI', chivi(mf10, ncp), z4, 5000, .01, .001,
         44.82),
    ]

    rows = []
    for name, obj, init, n_iters, lr, lr_end, ref in configs:
        it_s, t_first = measure(obj, init, n_iters, lr, lr_end)
        speedup = it_s / ref
        print('{:45s} {:>9.0f} it/s  (ref {:>7.2f}; {:>6.1f}x; '
              'compile {:.0f}s)'.format(name, it_s, ref, speedup, t_first),
              flush=True)
        rows.append((name, it_s, ref, speedup))

    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'THROUGHPUT.md')
    with open(out_path, 'w') as f:
        f.write('# Optimizer throughput vs reference\n\n')
        f.write('Hardware: `{}` ({}).  Steady-state it/s of the '
                'compiled scan, best of 3; reference numbers are the '
                'notebook tqdm rates (BASELINE.md, author laptop CPU).  '
                'All KLVI/CHIVI configs use pre-sampled draws '
                '(bit-identical to key-threaded runs).\n\n'
                .format(jax.devices()[0].device_kind, _card()))
        f.write('| Workload / config | viabel_tpu (it/s) | reference (it/s)'
                ' | speedup |\n|---|---|---|---|\n')
        for name, it_s, ref, speedup in rows:
            f.write('| {} | {:.0f} | {:.2f} | {:.0f}x |\n'.format(
                name, it_s, ref, speedup))
    print('wrote', out_path)


if __name__ == '__main__':
    main()
