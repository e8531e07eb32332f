"""The open loop times each request from when it was due, so that
waiting behind a stall counts, and takes the 95th percentile over every
request due in the window, a failed one counting as infinitely late."""

import time

import numpy as np

from benchmark.harness import runs
from benchmark.tests import tiny
from nlt_tpu_torch.serve import Server

CELL = "dragon_specular.serve_bs1"


def test_latency_counts_the_wait_behind_a_stall(monkeypatch):
    predict, open_window, calls = Server.predict, runs.Run.open_window, []
    stall = 0.3

    def opened(self):
        calls.clear()                 # count the window's requests
        return open_window(self)

    def slow(self, batch, ids=None):
        calls.append(time.perf_counter())
        if len(calls) == 10:          # the window's 10th request stalls
            time.sleep(stall)
        return predict(self, batch, ids)

    monkeypatch.setattr(runs.Run, "open_window", opened)
    monkeypatch.setattr(Server, "predict", slow)
    result, run = tiny.run(CELL, seconds=2.0)
    lat = run.outputs["latency_s"]
    assert np.all(np.isfinite(lat)) and result["failed"] == 0
    # Requests due while the stall held the server waited for it: at a
    # rate of 40/s, the ones due in the 0.3 s after it are late by up to
    # about that much.
    assert lat.max() >= 0.9 * stall
    assert np.sum(lat > stall / 3) >= 3
    p95 = np.sort(lat)[int(np.ceil(0.95 * len(lat))) - 1] * 1e3
    assert result["metrics"]["serve_p95_ms"]["value"] == p95


def test_failed_requests_count_as_late(monkeypatch):
    predict, calls = Server.predict, []

    def failing(self, batch, ids=None):
        calls.append(1)
        if len(calls) > 30 and len(calls) % 10 == 0:
            raise RuntimeError("planted failure")
        return predict(self, batch, ids)

    monkeypatch.setattr(Server, "predict", failing)
    result, run = tiny.run(CELL, seconds=2.0)
    assert result["failed"] >= 5
    assert result["attempted"] == len(run.outputs["latency_s"])
    assert result["metrics"]["serve_p95_ms"]["value"] == float("inf")
