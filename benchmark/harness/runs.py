"""What every loop shares: the record of one run (``Run``: its window,
spans, counters and the profiler slice), the program's launch and replay
counters, and the configuration as the port's ``Config``.

Every loop measures `seconds` after its set-up, in which every shape it
uses has been warmed up and captured; with a profiler (``--trace 1``)
the last ``trace_seconds`` of the window are traced.
"""

import gc
import time

import numpy as np
import torch

from . import trace

CONFIG_META = ("name", "source", "reduced", "assumed", "env", "limits")


class Run:
    """What one run of a cell measured."""

    def __init__(self, cell, cfg, mix, seed, seconds, traced, device,
                 t_start):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.seed, self.seconds = seed, seconds
        self.device = torch.device(device)
        self.t_start = t_start
        self.spans = trace.Spans()
        self.profiler = trace.Profiler(self.spans, device) if traced else None
        self.slice = None
        self.e2e, self.numbers, self.counters, self.info = {}, {}, {}, {}
        self.attempted = self.failed = 0
        self.units = 0
        self.setup_s = self.window_s = None
        self.memory_peak_bytes = 0
        self.outputs = {}     # what the timed path produced, for the check

    # ---- the window ----

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, what):
        """A set-up phase's end, in seconds from the run's start."""
        self.info.setdefault("setup_marks", {})[what] = (
            time.perf_counter() - self.t_start)

    def open_window(self):
        if self.profiler is not None:
            self.profiler.warm_up()
        self.sync()
        self.counters_at_open = counters()
        t0 = time.perf_counter()
        self.setup_s = t0 - self.t_start
        return t0

    def _by_second(self):
        """Units (steps, requests) that ended in each second of the window,
        and their median host ms: how steady the window ran."""
        name = "step" if self.info.get("unit") == "step" else "request"
        spans = [(a, b) for n, a, b in self.spans.items if n == name]
        if not spans:
            return []
        t0, out = spans[0][0], {}
        for a, b in spans:
            out.setdefault(int(b - t0), []).append(b - a)
        return [[k, len(v), float(np.median(v)) * 1e3]
                for k, v in sorted(out.items())]

    def maybe_trace(self, t0, now, units):
        """Start the profiler once the window's last trace_seconds begin."""
        if (self.profiler is None or self.profiler.active
                or self.slice is not None
                or now - t0 < self.seconds - self.mix["trace_seconds"]):
            return
        self._trace_at = (units, counters())
        self.profiler.start()

    def close_window(self):
        """After the caller's last sync: the trace and the counters."""
        if self.profiler is not None and self.profiler.active:
            units0, counts0 = self._trace_at
            self.slice = self.profiler.stop()
            self.slice.units = self.units - units0
            self.slice.counters = _delta(counters(), counts0)
        self.counters = _delta(counters(), self.counters_at_open)
        self.info["units_by_second"] = self._by_second()
        if self.device.type == "cuda":
            self.memory_peak_bytes = torch.cuda.max_memory_allocated(
                self.device)


def counters():
    """The kernels' launch counters and the compiled programs' replays."""
    from nlt_tpu_torch.ops import conv_stage, fused_stage, scatter
    from nlt_tpu_torch.parallel import graph
    out = dict(fused_stage.LAUNCHES, **scatter.LAUNCHES,
               **conv_stage.LAUNCHES)
    out.update({"replays." + k: v for k, v in graph.REPLAYS.items()})
    return out


def _delta(now, was):
    return {k: v - was.get(k, 0) for k, v in now.items()}


def program_config(cfg):
    """The configuration's recipe keys as the port's Config."""
    from nlt_tpu_torch.utils.config import Config
    return Config({k: v for k, v in cfg.items() if k not in CONFIG_META})


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
