"""nlt_tpu_torch.utils.trace: the program's spans on torch.profiler's
clock, and the counters beside them (``graph.CAPTURES``,
``device_cache.UPLOADS``), on the CPU.

A span with no profiler running is one check and a shared null context;
under a profiler the spans land in the Chrome trace as ``nlt::<name>``,
nested as the program calls them. The serving request runs its compiled
forward on ``test_torch_graph.py``'s emulated graph backend, so the
runner's own spans appear as on the card.
"""

import json
import os
import statistics
import threading
import time

import numpy as np
import pytest
import torch

from nlt_tpu_torch.parallel import device_cache, feat_cache, graph
from nlt_tpu_torch.serve import Server
from nlt_tpu_torch.utils import trace
from nlt_tpu_torch.utils.config import Config as TConfig
from tests.test_torch_graph import EmulatedGraphs
from tests.test_torch_model import make_batch, small_cfg


def _profiled(fn, tmp_path):
    """fn() under a CPU torch.profiler; the trace's nlt:: spans as
    [(name without the prefix, t0, t1)] in µs."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    os.unlink(path)
    return [(ev["name"][len("nlt::"):], float(ev["ts"]),
             float(ev["ts"]) + float(ev["dur"]))
            for ev in events.get("traceEvents", events)
            if ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
            and ev.get("name", "").startswith("nlt::")]


def _inside(spans, child, parent):
    """Every `parent` span holds a `child` span."""
    outer = [(a, b) for n, a, b in spans if n == parent]
    inner = [(a, b) for n, a, b in spans if n == child]
    assert outer, (parent, sorted({n for n, _, _ in spans}))
    for pa, pb in outer:
        assert any(pa <= a and b <= pb for a, b in inner), (child, parent)


def test_span_off_is_the_null_context_and_costs_under_a_microsecond():
    assert not torch.autograd._profiler_enabled()
    assert trace.span("graph.call") is trace.span("serve.place")
    with trace.span("x") as got:
        assert got is None
    # The median of 1,000 batches of 100 spans (10^5 in all).
    per_call = []
    for _ in range(1000):
        t0 = time.perf_counter()
        for _ in range(100):
            with trace.span("graph.call"):
                pass
        per_call.append((time.perf_counter() - t0) / 100)
    assert statistics.median(per_call) <= 1e-6, statistics.median(per_call)


def test_span_reads_the_profiler_of_its_own_thread(tmp_path):
    """Under a profiler on this thread a span is a record; on a thread the
    profiler does not observe, it is the null context."""
    seen = {}

    def other():
        seen["other"] = trace.span("x")

    def body():
        seen["here"] = trace.span("x")
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with trace.span("outer"):
            with trace.span("inner"):
                torch.ones(4).add_(1)

    spans = _profiled(body, tmp_path)
    assert seen["here"] is not trace.span("x")
    assert seen["other"] is trace.span("x")
    _inside(spans, "inner", "outer")


def test_log_keeps_what_a_profiler_saw(monkeypatch, tmp_path):
    """LOG holds the spans and counts made under a profiler, on the host
    clock, and nothing made without one."""
    monkeypatch.setattr(trace, "LOG", trace.collections.deque(maxlen=8))
    with trace.span("off"):
        trace.count("off.bytes", 5)
    t0 = time.perf_counter()

    def body():
        with trace.span("outer"):
            with trace.span("inner"):
                trace.count("inner.bytes", 7)

    spans = _profiled(body, tmp_path)
    t1 = time.perf_counter()
    assert [e[0] for e in trace.LOG] == ["inner.bytes", "inner", "outer"]
    (_, c, c1, n), (_, ia, ib, one), (_, oa, ob, _) = trace.LOG
    assert (n, one, c1) == (7, 1, c)
    assert t0 <= oa <= ia <= c <= ib <= ob <= t1
    assert {n for n, _, _ in spans} == {"outer", "inner"}


def test_clock_times_parts_as_spans(tmp_path):
    """Clock adds each part's host seconds, also for a body that raises
    (StopIteration included), and marks it <prefix>.<part>."""
    clock = trace.Clock("trainvali", ("loader", "step"))

    def body():
        with clock.part("step"):
            time.sleep(0.01)
        it = iter(())
        with pytest.raises(StopIteration):
            with clock.part("loader"):
                next(it)

    spans = _profiled(body, tmp_path)
    assert list(clock.seconds) == ["loader", "step"]
    assert clock.seconds["step"] >= 0.01 and clock.seconds["loader"] > 0
    assert {n for n, _, _ in spans} == {"trainvali.loader", "trainvali.step"}


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(graph, "_graphs_on", lambda device: EmulatedGraphs)
    monkeypatch.setattr(graph, "eager_reason", lambda *a, **kw: None)


def test_serving_request_spans_nest(monkeypatch, emulated, tmp_path):
    """serve.predict holds serve.place, the forward's graph.call (its key,
    copy, replay and clones) and serve.fetch, in that order."""
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1")
    srv = Server(str(tmp_path / "none"), config=TConfig(small_cfg()),
                 pack="uint8", fields=("pred_camspc",), device="cpu")
    req = make_batch(7, n=1)
    for _ in range(2):                # warm-up, capture
        srv.predict(req, ids=["a"])
    spans = _profiled(lambda: srv.predict(req, ids=["a"]), tmp_path)
    for child in ("serve.place", "graph.call", "serve.fetch"):
        _inside(spans, child, "serve.predict")
    for child in ("graph.key", "graph.copy_in", "graph.replay",
                  "graph.clone_out"):
        _inside(spans, child, "graph.call")
    _inside(spans, "device_cache.shard_batch", "serve.place")
    first = {}
    for n, a, _ in spans:
        first[n] = min(a, first.get(n, a))
    assert (first["serve.place"] < first["graph.call"]
            < first["serve.fetch"])
    assert not {"graph.warm_up", "graph.capture"} & {n for n, _, _ in spans}


def test_feat_cache_spans_nest(tmp_path):
    cache = feat_cache.GTFeatureCache(["a", "b", "c"])
    feats = {"x": torch.arange(6.0).reshape(2, 3)}
    spans = _profiled(lambda: (cache.insert(["a", "b"], feats),
                               cache.gather(["b", "a"])), tmp_path)
    _inside(spans, "feat_cache.indices", "feat_cache.gather")
    _inside(spans, "feat_cache.indices", "feat_cache.insert")


def test_captures_count_warm_ups_and_captures(emulated):
    """One warm-up and one capture per key, nothing on a replay."""
    run = graph.Captured(lambda x: x + 1, name="trace probe")
    was = graph.CAPTURES.get("trace probe", 0)
    for shape, counts in (((3,), (1, 2, 2, 2)), ((2, 2), (3, 4, 4, 4))):
        for want in counts:
            torch.testing.assert_close(run(torch.zeros(shape)),
                                       torch.ones(shape))
            assert graph.CAPTURES["trace probe"] - was == want
    assert (run.captures, run.replays) == (2, 6)


def test_uploads_count_the_arrays_bytes():
    arrays = {"a": np.zeros((2, 3, 4), np.float32),
              "b": np.ones((2, 5), np.uint8),
              "c": np.zeros((2, 4, 4), np.float16)[:, ::2]}
    was = dict(device_cache.UPLOADS)
    out = device_cache.upload(arrays, "cpu")
    assert device_cache.UPLOADS["uploads"] - was["uploads"] == 1
    assert device_cache.UPLOADS["bytes"] - was["bytes"] == sum(
        v.nbytes for v in arrays.values())
    for k, v in arrays.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
