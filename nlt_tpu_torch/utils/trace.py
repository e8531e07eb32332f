"""Spans of the program's host work on torch.profiler's clock.

``span(name)`` marks a range ``nlt::<name>`` in the profiler's trace,
beside the card's kernels and copies, while a torch profiler runs on the
calling thread (the benchmark's traced slice, trainvali's ``--profile``,
an operator's own ``torch.profiler``). With no profiler running it
returns one shared null context, after a single check. There is no
switch: tracing is on exactly when a profiler is. The profiler keeps the
ranges in memory and writes them when it stops; a span's parent is the
span that encloses it on its thread.

What a profiler saw is also kept in ``LOG``, newest last, on the host's
``time.perf_counter`` clock: each span as ``(name, t0, t1, 1)`` and each
amount passed to ``count`` as ``(name, t, t, n)``. A reader that knows
when its profiler ran (the benchmark's traced slice) takes the entries
of that time; the log holds the newest ``LOG.maxlen``.

``Clock`` keeps host seconds by part (trainvali's ``epoch_times.jsonl``)
and marks each part as a span, so the file and a trace read one clock.
"""

import collections
import contextlib
import time

import torch

_NULL = contextlib.nullcontext()
# The profiler's state on the calling thread (record_function reaches
# the trace only from a thread the profiler observes).
_profiling = torch.autograd._profiler_enabled
# The spans and counts profilers saw, [(name, t0, t1, n)].
LOG = collections.deque(maxlen=1 << 17)


def span(name):
    """A context that marks ``nlt::<name>`` while a profiler runs."""
    if not _profiling():
        return _NULL
    return _traced(name)


@contextlib.contextmanager
def _traced(name):
    with torch.profiler.record_function("nlt::" + name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            LOG.append((name, t0, time.perf_counter(), 1))


def count(name, n):
    """Log that `n` of `name` passed now, while a profiler runs."""
    if _profiling():
        t = time.perf_counter()
        LOG.append((name, t, t, n))


class Clock:
    """Host seconds by part (``seconds``, in the order of `parts`), each
    timed part also the span ``<prefix>.<part>``."""

    def __init__(self, prefix, parts):
        self.seconds = dict.fromkeys(parts, 0.0)
        self._names = {p: prefix + "." + p for p in parts}

    @contextlib.contextmanager
    def part(self, part):
        """Add the body's host seconds to `part`, also when it raises."""
        t0 = time.perf_counter()
        try:
            with span(self._names[part]):
                yield
        finally:
            self.seconds[part] += time.perf_counter() - t0
