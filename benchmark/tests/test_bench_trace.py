"""The readers of the program's own spans and counts
(``harness/program.py``): the program logs what a profiler saw on the
host clock of the harness's spans; a reader takes the entries inside
the run's window, and nothing where the program logs none. The traced
slice's own record (``bench.*`` annotations) is as before."""

import collections
import time
import types

import pytest
import torch

from benchmark.harness import program, registry, trace
from benchmark.tests import tiny
from nlt_tpu_torch.parallel import device_cache
from nlt_tpu_torch.utils import trace as program_trace
from nlt_tpu_torch.utils.trace import span


def _busy(seconds):
    t0 = time.perf_counter()
    x = torch.ones(64)
    while time.perf_counter() - t0 < seconds:
        x.add_(1)


def test_program_spans_of_a_traced_slice():
    """The spans a CPU profiler saw inside the window are the slice's;
    one from an earlier profiler, before the window, is not."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("serve.place"):
            _busy(0.001)
    t_start = time.perf_counter()
    spans = trace.Spans()
    prof = trace.Profiler(spans, "cpu")
    t0 = time.perf_counter()
    prof.start()
    for _ in range(3):
        with spans.span("request"):
            with span("serve.predict"):
                with span("serve.place"):
                    _busy(0.002)
                _busy(0.001)
        _busy(0.001)
    sl = prof.stop()
    sl.units = 3
    run = types.SimpleNamespace(slice=sl, t_start=t_start,
                                setup_s=t0 - t_start,
                                window_s=time.perf_counter() - t0)
    assert {n for n, _, _ in sl.host} == {"window", "request"}
    place = program.spans(run, "serve.place")
    assert len(place) == 3 and len(program.spans(run, "serve.predict")) == 3
    for (a, b), (c, d) in zip(place, program.spans(run, "serve.predict")):
        assert t0 <= c <= a < b <= d
        assert b - a >= 0.002
    # The request's time is its spans': each request span holds one
    # serve.predict, which holds at least the 3 ms of work.
    got = registry.metric_reader("place_ms_per_request.serve")(run)
    assert 2.0 <= got < sum(b - a for n, a, b in sl.host
                            if n == "request") / 3 * 1e3
    assert program.counted(run, "upload.bytes") is None


def test_program_count_of_uploads(monkeypatch):
    """upload.bytes over the window is the uploaded arrays' bytes."""
    monkeypatch.setattr(program_trace, "LOG", collections.deque())
    arrays = {"a": torch.zeros(2, 3).numpy(), "b": torch.ones(5).numpy()}
    t0 = time.perf_counter()
    device_cache.upload(arrays, "cpu")              # no profiler: no entry
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            device_cache.upload(arrays, "cpu")
    run = types.SimpleNamespace(
        slice=types.SimpleNamespace(units=2), t_start=t0, setup_s=0.0,
        window_s=time.perf_counter() - t0)
    assert program.counted(run, "upload.bytes") == 2 * (6 + 5) * 4
    assert len(program.spans(run, "upload.copy")) == 4


def _run(units=2):
    """A traced run whose window is (100, 108) s on the host clock."""
    return types.SimpleNamespace(
        slice=types.SimpleNamespace(units=units), t_start=90.0,
        setup_s=10.0, window_s=8.0)


LOG = [("serve.predict", 100.5, 104.5, 1), ("serve.place", 100.9, 102.1, 1),
       ("graph.call", 102.5, 104.2, 1), ("graph.replay", 102.6, 102.7, 1),
       ("serve.predict", 104.8, 107.4, 1), ("upload.pin", 104.9, 105.4, 1),
       ("upload.pin", 105.5, 105.6, 1), ("feat_cache.indices", 107.9, 109, 1),
       ("upload.bytes", 104.9, 104.9, 3 << 20),
       ("upload.bytes", 105.5, 105.5, 3 << 20),
       # Another run's entries, before this window.
       ("graph.call", 90.0, 99.0, 1), ("upload.bytes", 99.9, 99.9, 1 << 30)]

# Each reader's number on _run() over LOG, 2 units.
READERS = {
    "dispatch_ms_per_step.train": 1.7 / 2 * 1e3,
    "dispatch_ms_per_request.serve": 1.7 / 2 * 1e3,
    # 107.9 to the window's end at 108.
    "place_wait_ms_per_step.train": 0.1 / 2 * 1e3,
    "place_ms_per_request.serve": 1.2 / 2 * 1e3,
    "pin_ms_per_request.sweep": 0.6 / 2 * 1e3,
    "upload_mb_per_request.sweep": 3.0,
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_a_built_run(monkeypatch, name):
    read = registry.metric_reader(name)
    monkeypatch.setattr(program_trace, "LOG", collections.deque(LOG))
    assert read(_run()) == pytest.approx(READERS[name], rel=1e-9)
    assert read(_run(units=0)) is None
    assert read(types.SimpleNamespace(slice=None, t_start=0.0, setup_s=None,
                                      window_s=None)) is None
    # A program that logs none of it: nothing to read.
    monkeypatch.setattr(program_trace, "LOG", collections.deque())
    assert read(_run()) is None
    monkeypatch.delattr(program_trace, "LOG")
    assert read(_run()) is None


def test_tiny_traced_sweep_reads_its_uploads():
    """A traced CPU run of the sweep: the MiB a request is the log's
    bytes over the slice's requests, each of which uploads the same
    fields."""
    result, run = tiny.run("dragon_specular.sweep_bs4", traced=True)
    got = result["metrics"]["upload_mb_per_request.sweep"]["value"]
    n = program.counted(run, "upload.bytes")
    assert got == pytest.approx(n / run.slice.units / float(1 << 20))
    uploads = len(program.spans(run, "upload.copy"))
    assert uploads and uploads % run.slice.units == 0
    assert "pin_ms_per_request.sweep" not in result["metrics"]   # CPU
