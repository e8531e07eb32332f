"""Placement's host ms a training step: the harness's span around
DeviceExampleCache.shard_batch and GTFeatureCache.gather / insert (with
the static extraction on a cache miss), over every step of the window."""


def read(run):
    n = run.spans.count("place")
    return run.spans.total("place") / n * 1e3 if n else None
