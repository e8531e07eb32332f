"""The program's own spans and counts in a run's traced slice.

While a torch profiler runs, ``nlt_tpu_torch`` marks its host work as
spans (``nlt_tpu_torch/utils/trace.py``): ``nlt::<name>`` ranges in the
profiler's trace, and entries ``(name, t0, t1, n)`` of the module's
``LOG`` on ``time.perf_counter``, the clock of the harness's own spans.
The traced slice is the one time in a run's window that a profiler
runs, so the log's entries inside the window are the slice's. A program
that keeps no such log gives nothing, and a reader then returns None.
"""


def _log():
    try:
        from nlt_tpu_torch.utils import trace
    except ImportError:
        return []
    log = getattr(trace, "LOG", None)
    return list(log.copy()) if log is not None else []


def _entries(run, name):
    """The log's entries `name` [(t0, t1, n)] that overlap the window of
    a traced run, clipped to it."""
    if run.slice is None or run.setup_s is None or run.window_s is None:
        return []
    t0 = run.t_start + run.setup_s
    t1 = t0 + run.window_s
    return [(max(a, t0), min(b, t1), n) for what, a, b, n in _log()
            if what == name and b >= t0 and a <= t1]


def spans(run, name):
    """The program's spans `name` in the traced slice, [(t0, t1)]."""
    return [(a, b) for a, b, _ in _entries(run, name)]


def counted(run, name):
    """The program's count `name` over the traced slice, or None where it
    counted none."""
    got = _entries(run, name)
    return sum(n for _, _, n in got) if got else None


def ms_per_unit(run, name):
    """Host ms in the program's spans `name` a unit (step, request) of
    the traced slice, or None where there are none."""
    got = spans(run, name)
    if not got or not run.slice.units:
        return None
    return sum(b - a for a, b in got) / run.slice.units * 1e3
