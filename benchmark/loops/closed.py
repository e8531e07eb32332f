"""One client sending its next request when the last is back, over every
group of `bs` consecutive lights of one camera, in an order from the
seed.
"""

import time

import numpy as np

from ..harness import runs, scene as scene_mod
from ..harness.served import Served


def ring(seed, groups, n_sample):
    """The closed loop's order of request groups, and the sampled ring
    positions, from the seed."""
    rng = np.random.default_rng(scene_mod.subseed(seed, "traffic"))
    order = [groups[i] for i in rng.permutation(len(groups))]
    sample = set(rng.choice(len(order), size=min(n_sample, len(order)),
                            replace=False).tolist())
    return order, sample


def run(run):
    mix = run.mix
    srv = Served(run)
    server, bs = srv.server, srv.bs
    ring_order, sample = ring(
        run.seed, [c * srv.scene.n_lights + g * bs
                   for c in range(srv.scene.n_cams)
                   for g in range(srv.scene.n_lights // bs)], mix["sample"])
    for _ in range(3):              # warm-up, capture, replay
        server.predict(srv.request(ring_order[-1]))
    run.mark("capture")
    got, t0 = {}, run.open_window()
    while True:
        now = time.perf_counter()
        if now - t0 >= run.seconds:
            break
        run.maybe_trace(t0, now, run.units)
        i = run.units % len(ring_order)
        with run.spans.span("request"):
            out = server.predict(srv.request(ring_order[i]))
        if i in sample:
            got[i] = out              # the last answer to each sampled query
        run.units += 1
    run.sync()
    run.window_s = time.perf_counter() - t0
    run.close_window()
    run.attempted = run.units
    run.e2e["sweep_frames_per_s"] = run.units * bs / run.window_s
    keys = sorted(got)
    requests = [srv.request(ring_order[i]) for i in keys]
    del server
    srv.server = None
    runs.free()
    srv.check(run, requests, [got[i] for i in keys])
