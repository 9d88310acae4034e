"""Serving-layer latency benchmark: HTTP endpoint latencies on the device.

SURVEY.md section 5 lists serving as a layer the reference lacks;
`viabel_tpu.serve` provides it (PosteriorService + stdlib HTTP server with
compile-cached device programs).  This records what a client actually
observes: per-endpoint latency percentiles over repeated requests against a
fitted posterior, plus one background /fit wall time.  Every endpoint's
device program is compiled on first touch and replayed after.  Requests are
sent one after another (closed loop).

Usage: python benchmarks/serving.py [--cpu] [--reqs 50] [--json PATH]
"""
import argparse
import json
import os
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _pct(xs, q):
    xs = sorted(xs)
    i = min(int(q / 100.0 * len(xs)), len(xs) - 1)
    return xs[i]


def _time_requests(url, n, payload=None):
    """Latency of n sequential requests (seconds each)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        if payload is None:
            with urllib.request.urlopen(url, timeout=300) as r:
                r.read()
        else:
            req = urllib.request.Request(
                url, data=json.dumps(payload).encode(),
                headers={'Content-Type': 'application/json'})
            with urllib.request.urlopen(req, timeout=300) as r:
                r.read()
        times.append(time.perf_counter() - t0)
    return times


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--cpu', action='store_true')
    p.add_argument('--reqs', type=int, default=50)
    p.add_argument('--json', default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), 'serving.json'))
    args = p.parse_args()

    import jax
    if args.cpu:
        jax.config.update('jax_platforms', 'cpu')
    import numpy as np

    from viabel_tpu import adagrad_optimize, black_box_klvi, \
        mean_field_t_variational_family
    from viabel_tpu.models import funnel_model
    from viabel_tpu.serve import PosteriorService, start_server

    print('device: {}'.format(jax.devices()[0]))
    model = funnel_model()
    fam = mean_field_t_variational_family(2, 40)
    obj = black_box_klvi(fam, model.log_prob, 100, presampled=True)
    vp, _, _, _ = adagrad_optimize(2000, obj, fam.init_param(),
                                   key=jax.random.PRNGKey(0),
                                   learning_rate=.01)
    service = PosteriorService(model, fam, vp, seed=0)
    server, thread = start_server(service, port=0)
    port = server.server_address[1]
    base = 'http://127.0.0.1:{}'.format(port)
    print('serving on', base)

    endpoints = [
        ('health', base + '/health', None),
        ('moments', base + '/moments', None),
        ('sample_1k', base + '/sample?n=1000', None),
        ('log_prob_100', base + '/log_prob',
         {'x': np.random.RandomState(0).randn(100, 2).tolist()}),
        ('bounds_1e5', base + '/bounds?n=100000', None),
    ]
    results = dict(device=str(jax.devices()[0]), reqs=args.reqs,
                   endpoints={})
    for name, url, payload in endpoints:
        _time_requests(url, 3, payload)  # warm-up / compile
        times = _time_requests(url, args.reqs, payload)
        row = dict(p50_ms=_pct(times, 50) * 1e3,
                   p95_ms=_pct(times, 95) * 1e3,
                   min_ms=min(times) * 1e3)
        results['endpoints'][name] = row
        print('{:>14}: p50 {:7.1f} ms | p95 {:7.1f} ms | min {:7.1f} ms'
              .format(name, row['p50_ms'], row['p95_ms'], row['min_ms']),
              flush=True)

    # /fit is synchronous over HTTP (returns the validated re-fit result);
    # first call compiles the fused pipeline, the second is steady state
    fit_payload = {'n_iters': 2000, 'n_bound_samples': 100000}
    _time_requests(base + '/fit', 1, fit_payload)  # warm-up / compile
    results['fit_2k_iters_s'] = _time_requests(
        base + '/fit', 1, fit_payload)[0]
    print('/fit (2k iters + 1e5-sample bounds, fused, steady state): '
          '{:.2f}s'.format(results['fit_2k_iters_s']))

    server.shutdown()
    with open(args.json, 'w') as f:
        json.dump(results, f, indent=1)
    print('wrote', args.json)


if __name__ == '__main__':
    main()
