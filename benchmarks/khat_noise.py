"""Seed-noise quantification for the parity statistics.

Every khat / bound value in benchmarks/RESULTS.md is a Monte Carlo estimate
of a stochastic optimizer's solution quality — comparing a single run to
the reference's single notebook value needs an acceptance band.  This
script produces it: for each headline workload configuration it runs S
complete validated pipelines (identical init, S different PRNG keys) in
ONE fused multistart dispatch (`validated_vi_multistart` with explicit
replicated `init_params` — the start axis is the seed axis) and records
the khat / d2 distributions.

Writes benchmarks/KHAT_NOISE.json; `benchmarks/parity.py` picks it up to
add the noise column to RESULTS.md.  Runs on the default backend (the
GPU, in float32): 16 pipelines per config fit in one dispatch.

Usage: python benchmarks/khat_noise.py [--seeds 16] [--quick] [--cpu]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def _stats(vals):
    vals = np.asarray(vals, dtype=float)
    q25, q50, q75 = np.percentile(vals, [25, 50, 75])
    return dict(mean=float(vals.mean()), sd=float(vals.std(ddof=1)),
                q25=float(q25), median=float(q50), q75=float(q75),
                min=float(vals.min()), max=float(vals.max()),
                values=[float(v) for v in vals])


def run_config(name, model, fam, obj, init, n_iters, n_bound, seeds, ref,
               has_log_norm=None, **opt_kw):
    from viabel_tpu import validated_vi_multistart
    t0 = time.perf_counter()
    init = jnp.asarray(init)
    init_params = jnp.tile(init[None, :], (seeds, 1))
    out = validated_vi_multistart(
        model.log_prob, fam, init, n_iters, init_params=init_params,
        objective_and_grad=obj, n_bound_samples=n_bound,
        key=jax.random.PRNGKey(20260819), has_log_norm=has_log_norm,
        **opt_kw)
    res = dict(reference=ref, n_iters=n_iters, n_bound=n_bound,
               seeds=seeds, khat=_stats(out['khat']),
               d2=_stats([b['d2'] for b in out['bounds']]),
               W2=_stats([b['W2'] for b in out['bounds']]),
               mean_error=_stats([b['mean_error'] for b in out['bounds']]),
               wall_s=time.perf_counter() - t0)
    k = res['khat']
    z = (ref - k['mean']) / k['sd'] if k['sd'] > 0 else float('inf')
    print('{:>16}: khat = {:.3f} +- {:.3f}  [{:.3f}, {:.3f}]  '
          'ref {:.3f} (z = {:+.1f})  ({:.1f}s)'.format(
              name, k['mean'], k['sd'], k['min'], k['max'], ref, z,
              res['wall_s']), flush=True)
    res['khat_ref_z'] = z
    return res


def nm_noise(seeds=16, quick=False, cpu=False):
    """Seed-noise bands for the normal-mixture bounds-only workload
    (examples/normal_mixture.py: the RESULTS.md rows
    carried no band).  No optimizer is involved — each seed draws fresh
    q-samples and re-evaluates the three bound configurations, so the band
    is pure Monte Carlo noise of the bound estimators.

    The band is computed at the REFERENCE's sample size, n = 50,000
    (normal-mixture.ipynb cell 8: ``n_samples = 50000``) — the z-score
    judges the reference's single notebook draw against the fresh-seed
    distribution of the same-size estimator, so the estimator noise being
    scored matches the noise the reference value actually carries.  (The
    parity columns run the example's full mode at n = 1e6, which is ~4.5x
    tighter; a z computed against THAT band would mostly measure the
    reference's own small-n noise.)

    Merges ``nm_*`` configs into the existing KHAT_NOISE.json (the
    optimizer campaigns recorded earlier are left untouched; this
    workload is backend-independent statistics, each config is tagged
    with the backend that produced it).
    """
    if cpu:
        jax.config.update('jax_platforms', 'cpu')
    import warnings

    from scipy.special import factorial2

    from viabel_tpu import all_bounds
    from viabel_tpu.bounds import MonteCarloErrorWarning
    warnings.simplefilter('ignore', MonteCarloErrorWarning)

    q_var = 5.0
    n = 50000  # the reference protocol's size (see docstring)
    mb = lambda order: factorial2(order - 1) * q_var ** (order / 2)

    def one_seed(s):
        samples = jnp.sqrt(q_var) * jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(918), s), (n,))
        log_q = (-0.5 * samples ** 2 / q_var
                 - 0.5 * jnp.log(2 * jnp.pi * q_var))
        log_p = jnp.logaddexp(-0.5 * (samples + 2) ** 2,
                              -0.5 * (samples - 2) ** 2) \
            - 0.5 * jnp.log(2 * jnp.pi) - jnp.log(2.0)
        lw = log_p - log_q
        return (all_bounds(lw, samples),
                all_bounds(lw, samples, q_var=q_var, log_norm_bound=0),
                all_bounds(lw, moment_bound_fn=mb, q_var=q_var))

    t0 = time.perf_counter()
    runs = [one_seed(s) for s in range(seeds)]
    refs = dict(
        nm_samples_only=dict(W2=6.08, d2=0.768, mean_error=4.79),
        nm_qvar_lnb=dict(W2=4.41, d2=0.277, mean_error=2.52),
        # the corrected analytic-moment W2's reference is the notebook's
        # own empirical estimate (its published 2.72 replicates a
        # double-rooting bug; PARITY.md)
        nm_analytic=dict(W2=6.08),
    )
    results = {}
    for i, (name, ref) in enumerate(refs.items()):
        cfg = dict(n_bound=n, seeds=seeds,
                   backend=str(jax.devices()[0].platform))
        for stat, rv in ref.items():
            st = _stats([float(r[i][stat]) for r in runs])
            cfg[stat] = st
            cfg['reference_' + stat] = rv
            z = (rv - st['mean']) / st['sd'] if st['sd'] > 0 else float(
                'inf')
            print('{:>16} {:>10}: {:.3g} +- {:.2g}  ref {:.3g} '
                  '(z = {:+.1f})'.format(name, stat, st['mean'], st['sd'],
                                         rv, z), flush=True)
        results[name] = cfg
    print('normal-mixture noise campaign: {:.1f}s'.format(
        time.perf_counter() - t0))

    # a --quick smoke run must never clobber the recorded full campaign's
    # nm_* bands (the same protection main() applies; parity.py renders
    # RESULTS.md's acceptance bands from KHAT_NOISE.json)
    name = 'KHAT_NOISE_quick.json' if quick else 'KHAT_NOISE.json'
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            name)
    data = dict(meta=dict(seeds=seeds, quick=quick,
                          backend=str(jax.devices()[0].platform),
                          dtype=str(jnp.result_type(float))),
                configs={})
    if os.path.exists(out_path):
        with open(out_path) as f:
            data = json.load(f)
    data['configs'].update(results)
    with open(out_path, 'w') as f:
        json.dump(data, f, indent=1)
    print('merged into', out_path)
    return results


def main(seeds=16, quick=False, cpu=False):
    if cpu:
        jax.config.update('jax_platforms', 'cpu')
    import warnings

    from viabel_tpu import (black_box_chivi, black_box_klvi,
                            init_from_moments, adagrad_optimize,
                            mean_field_t_variational_family,
                            t_variational_family)
    from viabel_tpu.bounds import MonteCarloErrorWarning
    from viabel_tpu.models import (eight_schools_cp_model,
                                   eight_schools_ncp_model,
                                   funnel_model, robust_regression_model)
    warnings.simplefilter('ignore', MonteCarloErrorWarning)

    scale = 0.1 if quick else 1.0
    it = lambda n: max(int(n * scale), 200)
    n_bound = 100000 if quick else 1000000
    results = {}
    print('devices: {}; seeds per config: {}'.format(jax.devices(), seeds))

    # --- robust regression (protocol: examples/robust_regression.py) ---
    rr = robust_regression_model()
    fam = mean_field_t_variational_family(2, 40)
    klvi = black_box_klvi(fam, rr.log_prob, 100, presampled=True)
    init = jnp.asarray(np.concatenate([np.zeros(2), np.ones(2)]),
                       dtype=jnp.result_type(float))
    results['rr_klvi'] = run_config(
        'rr_klvi', rr, fam, klvi, init, it(5000), n_bound, seeds, 0.92,
        learning_rate=.01)
    # CHIVI warm-starts from the seed-0 KLVI fit (+3 on the log-scales),
    # exactly the example's protocol; seeds vary the CHIVI keys
    klvi_param, _, _, _ = adagrad_optimize(
        it(5000), klvi, init,
        key=jax.random.split(jax.random.PRNGKey(0), 6)[0],
        learning_rate=.01)
    chivi = black_box_chivi(2, fam, rr.log_prob, 500, presampled=True)
    warm = jnp.asarray(np.asarray(klvi_param)).at[2:].add(3.0)
    results['rr_chivi'] = run_config(
        'rr_chivi', rr, fam, chivi, warm, it(5000), n_bound, seeds, 0.341,
        learning_rate=.01)
    tfam = t_variational_family(2, 100)
    full_klvi = black_box_klvi(tfam, rr.log_prob, 100, presampled=True)
    results['rr_full_klvi'] = run_config(
        'rr_full_klvi', rr, tfam, full_klvi, tfam.init_param(), it(5000),
        n_bound, seeds, -0.93, learning_rate=.1, learning_rate_end=.001)

    # --- funnel (protocol: examples/funnel.py -> run_experiment:
    #     has_log_norm=False matches the reference harness) ---
    fu = funnel_model()
    fam_f = mean_field_t_variational_family(2, 40)
    fu_init = jnp.asarray(np.concatenate([[0.0, -1.0], np.ones(2)]),
                          dtype=jnp.result_type(float))
    results['funnel_klvi'] = run_config(
        'funnel_klvi', fu, fam_f,
        black_box_klvi(fam_f, fu.log_prob, 100, presampled=True),
        fu_init, it(10000), n_bound, seeds, 0.768,
        learning_rate=.01, learning_rate_end=.001)
    results['funnel_chivi'] = run_config(
        'funnel_chivi', fu, fam_f,
        black_box_chivi(2, fam_f, fu.log_prob, 500, presampled=True),
        fu_init, it(10000), n_bound, seeds, 0.894, has_log_norm=False,
        learning_rate=.01, learning_rate_end=.001)

    # --- eight schools (protocol: examples/eight_schools.py) ---
    for tag, model, n_it, refs in (
            ('es_cp', eight_schools_cp_model(), it(10000), (0.906, 0.875)),
            ('es_ncp', eight_schools_ncp_model(), it(5000),
             (0.649, 0.552))):
        fam10 = mean_field_t_variational_family(10, 40)
        es_init = init_from_moments(
            fam10, model.true_mean,
            model.true_cov).astype(jnp.result_type(float))
        results[tag + '_klvi'] = run_config(
            tag + '_klvi', model, fam10,
            black_box_klvi(fam10, model.log_prob, 100, presampled=True),
            es_init, n_it, n_bound, seeds, refs[0],
            learning_rate=.01, learning_rate_end=.001)
        results[tag + '_chivi'] = run_config(
            tag + '_chivi', model, fam10,
            black_box_chivi(2, fam10, model.log_prob, 500,
                            presampled=True),
            es_init, n_it, n_bound, seeds, refs[1], has_log_norm=False,
            learning_rate=.01, learning_rate_end=.001)

    # a --quick smoke run must never clobber the recorded full campaign
    # (parity.py renders RESULTS.md's acceptance bands from this file)
    name = 'KHAT_NOISE_quick.json' if quick else 'KHAT_NOISE.json'
    out_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            name)
    meta = dict(seeds=seeds, quick=quick,
                backend=str(jax.devices()[0].platform),
                dtype=str(jnp.result_type(float)))
    # merge: keep configs this campaign did not run (the bounds-only
    # nm_* entries from --nm-only), update everything it did
    data = dict(meta=meta, configs={})
    if os.path.exists(out_path):
        with open(out_path) as f:
            prior = json.load(f)
        data['configs'] = {k: v for k, v in prior.get('configs',
                                                      {}).items()
                           if k not in results}
    data['meta'] = meta
    data['configs'].update(results)
    with open(out_path, 'w') as f:
        json.dump(data, f, indent=1)
    print('wrote', out_path)
    return results


if __name__ == '__main__':
    p = argparse.ArgumentParser()
    p.add_argument('--seeds', type=int, default=16)
    p.add_argument('--quick', action='store_true')
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--nm-only', action='store_true',
                   help='run only the normal-mixture bounds-only noise '
                        'campaign and merge it into KHAT_NOISE.json')
    a = p.parse_args()
    if a.nm_only:
        nm_noise(a.seeds, a.quick, a.cpu)
    else:
        main(a.seeds, a.quick, a.cpu)
