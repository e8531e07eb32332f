"""Host ms a request in the traced slice: each request's span (placement
to the fetched result) less the device time that ran inside it."""


def read(run):
    sl = run.slice
    if sl is None:
        return None
    spans = sl.annotations("request")
    if not spans or sl.busy_s() <= 0:
        return None
    host = [(b - a) - sl.busy_s(a, b) for a, b in spans]
    return sum(host) / len(host) * 1e3
