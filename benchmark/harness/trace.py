"""The traced slice of a run (``--trace 1``): torch.profiler over the last
`trace_seconds` of the window, read back from its Chrome trace.

The harness marks its own spans with ``record_function('bench.<what>')``
while the profiler runs (``span``); with the profiler off a span is the
host clock alone. ``bench.window`` encloses the traced slice; device
time is every kernel, copy and memset on the card's timeline inside it.
"""

import contextlib
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Host spans of the whole window: [(name, t0, t1)] on the host's
    perf_counter clock; with a profiler running, also trace annotations."""

    def __init__(self):
        self.items = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name):
        rf = (torch.profiler.record_function("bench." + name)
              if self.profiling else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def total(self, name):
        return sum(t1 - t0 for n, t0, t1 in self.items if n == name)

    def count(self, name):
        return sum(1 for n, _, _ in self.items if n == name)


class Slice:
    """What the traced slice recorded, in seconds on the trace's clock:
    device events [(name, cat, t0, t1)], host annotations [(name, t0,
    t1)] without the 'bench.' prefix, the window (t0, t1), and the units
    (steps, requests) and counter deltas of the slice (set by the
    loop)."""

    def __init__(self, device, host, window):
        self.device = device
        self.host = host
        self.window = window
        self.units = 0
        self.counters = {}

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def intervals(self, t0=None, t1=None, cats=DEVICE_CATS, match=None):
        """Device intervals clipped to [t0, t1] (the window by default)."""
        t0 = self.window[0] if t0 is None else t0
        t1 = self.window[1] if t1 is None else t1
        out = []
        for name, cat, a, b in self.device:
            if cat in cats and b > t0 and a < t1 and (
                    match is None or any(m in name for m in match)):
                out.append((max(a, t0), min(b, t1), name))
        return out

    def busy_s(self, t0=None, t1=None):
        """Seconds in [t0, t1] with any device operation running."""
        busy, end = 0.0, None
        for a, b, _ in sorted(self.intervals(t0, t1)):
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy

    def summed(self, cats=DEVICE_CATS, match=None):
        return sum(b - a for a, b, _ in self.intervals(cats=cats,
                                                       match=match))

    def annotations(self, name):
        return [(a, b) for n, a, b in self.host if n == name
                and b > self.window[0] and a < self.window[1]]

    def breakdown(self, top=10):
        """{'device_ops': the device operations that took most time,
        'idle_gaps': idle device time by the host span it fell in}."""
        by_op = {}
        for a, b, name in self.intervals():
            by_op[name] = by_op.get(name, 0.0) + (b - a)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps, end = [], self.window[0]
        for a, b, _ in sorted(self.intervals()):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        inner = [(n, a, b) for n, a, b in self.host if n != "window"]
        by_host = {}
        for a, b in gaps:
            mid = (a + b) / 2
            # The innermost host span holding the gap's middle names it.
            holding = [(e - s, n) for n, s, e in inner if s <= mid <= e]
            label = min(holding)[1] if holding else "between spans"
            by_host[label] = by_host.get(label, 0.0) + (b - a)
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}


class Profiler:
    """torch.profiler over a slice; stop() returns its Slice."""

    def __init__(self, spans, device):
        self.spans = spans
        self.device = torch.device(device)
        self.prof = None
        self.window = None
        self.acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            self.acts.append(torch.profiler.ProfilerActivity.CUDA)

    def warm_up(self):
        """A profiler run in set-up, so that the one in the window
        starts without initialising the tracing libraries there."""
        with torch.profiler.profile(activities=self.acts):
            torch.zeros(1, device=self.device).add_(1)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    def start(self):
        self.prof = torch.profiler.profile(activities=self.acts)
        self.prof.__enter__()
        self.spans.profiling = True
        self.window = torch.profiler.record_function("bench.window")
        self.window.__enter__()

    @property
    def active(self):
        return self.prof is not None

    def stop(self):
        """Close the window (the caller has synchronised) and read the
        trace."""
        self.window.__exit__(None, None, None)
        self.spans.profiling = False
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        events = events.get("traceEvents", events)
        device, host, window = [], [], None
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            a = float(ev["ts"]) * 1e-6
            b = a + float(ev["dur"]) * 1e-6
            cat, name = ev.get("cat", ""), ev.get("name", "")
            if cat in DEVICE_CATS:
                device.append((name, cat, a, b))
            elif cat == "user_annotation" and name.startswith("bench."):
                host.append((name[len("bench."):], a, b))
                if name == "bench.window":
                    window = (a, b)
        self.prof = None
        return Slice(device, host, window)
