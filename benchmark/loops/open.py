"""Requests at fixed arrival times, each timed from when it was due, so
that waiting behind a slow request counts. The gaps are the quantiles of
the exponential distribution of the mix's rate and the queries follow a
Zipf popularity over the pool, both as fixed multisets that the seed
only orders (every seed offers the same load); the seed also maps
popularity ranks to queries.
"""

import time

import numpy as np

from ..harness import runs, scene as scene_mod
from ..harness.served import Served


def _quantile_gaps(rate, n):
    """n gaps whose multiset is the exponential distribution's quantiles at
    (k + 1/2) / n: a Poisson process's gaps without its sampling noise."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) / rate


def _zipf_counts(n_ranks, s, n):
    """How often each popularity rank is asked in n requests: n p_r by
    largest remainders, p_r proportional to r^-s."""
    p = np.arange(1, n_ranks + 1, dtype=np.float64) ** -s
    want = n * p / p.sum()
    counts = np.floor(want).astype(np.int64)
    rest = n - counts.sum()
    counts[np.argsort(-(want - counts), kind="stable")[:rest]] += 1
    return counts


def schedule(seed, rate, seconds, n_queries, zipf_s, n_sample):
    """The open loop's requests from the seed: (due times in s, query of
    each, rank_to_query, the sampled request indices). The gaps and the
    popularity ranks are fixed multisets (``_quantile_gaps``,
    ``_zipf_counts``) in an order from the seed."""
    rng = np.random.default_rng(scene_mod.subseed(seed, "traffic"))
    rank_to_query = rng.permutation(n_queries)
    n = int(rate * seconds)
    due = np.cumsum(rng.permutation(_quantile_gaps(rate, n)))
    ranks = rng.permutation(np.repeat(
        np.arange(n_queries), _zipf_counts(n_queries, zipf_s, n)))
    sample = set(rng.choice(n, size=min(n_sample, n), replace=False)
                 .tolist())
    return due, rank_to_query[ranks], rank_to_query, sample


def run(run):
    mix = run.mix
    srv = Served(run)
    server, n_q = srv.server, srv.scene.n
    due, queries, rank_to_query, sample = schedule(
        run.seed, mix["rate_per_s"], run.seconds, n_q, mix["zipf_s"],
        mix["sample"])
    n = len(due)

    def predict(e):
        return server.predict(srv.request(e), ids=srv.ids(e))

    # Set-up: the forward's graph (warm-up, capture, replay) on the
    # coldest query, then the input cache filled from the most popular
    # down, until it holds no more.
    for _ in range(3):
        server.predict(srv.request(rank_to_query[-1]))
    run.mark("capture")
    cache = server._input_cache
    for r in range(n_q):
        held = cache.stats()["examples"]
        predict(rank_to_query[r])
        if cache.stats()["examples"] == held:
            break
    run.mark("cache_fill")
    hits0 = cache.stats()

    lat = np.full(n, np.inf)
    service = np.full(n, np.nan)
    missed = np.zeros(n, bool)
    got, t0 = {}, run.open_window()
    late_limit = run.seconds + mix["late_limit_s"]
    for k in range(n):
        t_due = t0 + due[k]
        now = time.perf_counter()
        if now - t0 > late_limit:
            break
        run.maybe_trace(t0, max(now, t_due), run.units)
        with run.spans.span("wait"):
            # Spin: a sleeping client wakes late on a shared host.
            while time.perf_counter() < t_due:
                pass
        misses = cache.misses
        try:
            t_start = time.perf_counter()
            with run.spans.span("request"):
                out = predict(queries[k])
            t_done = time.perf_counter()
            lat[k] = t_done - t_due
            service[k] = t_done - t_start
            missed[k] = cache.misses != misses
            if k in sample:
                got[k] = out
        except RuntimeError as e:    # a request that fails counts as late
            print("request %d failed: %s" % (k, e), flush=True)
        run.units += 1
    run.sync()
    run.window_s = time.perf_counter() - t0
    run.close_window()
    stats = cache.stats()
    run.counters["input_cache"] = {k: stats[k] - hits0[k]
                                   for k in ("hits", "misses")}
    run.attempted = n
    run.failed = int(np.sum(~np.isfinite(lat)))
    # The 95th percentile by nearest rank, over every request due in the
    # window (a failed one is infinitely late).
    srt = np.sort(lat)
    run.e2e["serve_p95_ms"] = float(srt[int(np.ceil(0.95 * n)) - 1]) * 1e3
    run.info["latency_p50_ms"] = float(np.median(lat)) * 1e3
    for name, pick in (("hit", ~missed), ("miss", missed)):
        ms = service[pick & np.isfinite(service)] * 1e3
        if ms.size:
            run.info["service_ms_" + name] = [float(np.percentile(ms, q))
                                              for q in (50, 95, 99)]
    run.outputs["latency_s"] = lat
    keys = sorted(got)
    requests = [srv.request(queries[k]) for k in keys]
    del server
    srv.server = None
    runs.free()
    srv.check(run, requests, [got[k] for k in keys])
