"""nlt_tpu_torch.parallel.feat_cache on the CPU: the rows the cache
hands back, and the route its index uploads take.

On a CUDA device the slot indices (and insert's batch rows) go up
through pinned memory with ``non_blocking=True``, so the host does not
wait for the card's queue. The CPU tests have no card: a stand-in CUDA
device, with ``Tensor.pin_memory`` and ``Tensor.to`` replaced by
recorders, shows the route; the rows are checked against the blocking
upload the cache made before (``torch.as_tensor`` of a numpy array).
"""

import time

import numpy as np
import pytest
import torch

from nlt_tpu_torch.parallel import feat_cache
from nlt_tpu_torch.utils import trace
from nlt_tpu_torch.utils.tree import tree_leaves

CUDA = torch.device("cuda")
# One example's rows of _feats are a little over 256 KiB: cap_mb=1 gives
# three slots.
ROW = 1 << 16


def _feats(ids, width=3):
    """Per-batch statics tree: leaves of several dtypes and ranks, each
    row a function of its example id."""
    key = torch.tensor([float(sum(map(ord, i))) for i in ids])
    return {"gt": key[:, None] + torch.arange(width, dtype=torch.float32),
            "products": {
                "mask": (key[:, None, None].long()
                         + torch.arange(4).reshape(1, 2, 2)).to(torch.int32),
                "wide": key[:, None].expand(len(ids), ROW).contiguous()}}


def _blocking_upload(values, device):
    """The cache's index upload before the pinned route."""
    return torch.as_tensor(np.array(values, np.int64), device=device)


# (example ids, cap_mb, the batches inserted, the batches gathered).
SCENARIOS = {
    "batch_order": (list("abcdef"), None, ["abcd", "ef"],
                    ["dcba", "fa", "bed"]),
    "repeated_id": (list("abcd"), None, ["abca", "d"], ["aab", "dddd"]),
    "capped_uncached": (list("abcd"), 1, ["abcd"], ["ba", "dab", "cac"]),
}


def _play(ids, cap_mb, inserts, gathers):
    """Insert then gather; (insert returns, slots, tables, gathered)."""
    cache = feat_cache.GTFeatureCache(ids, cap_mb=cap_mb)
    got = [cache.insert(list(b), _feats(list(b))) for b in inserts]
    tables = [t.clone() for t in tree_leaves(cache.taps)]
    out = [tree_leaves(cache.gather(list(b))) for b in gathers
           if cache.has_all(list(b))]
    return got, dict(cache.slot), tables, out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_rows_are_the_blocking_uploads(name, monkeypatch):
    """The same slots, tables and gathered rows as with the blocking
    upload, bit for bit; gathered rows are the inserted examples' rows,
    in batch order."""
    ids, cap_mb, inserts, gathers = SCENARIOS[name]
    new = _play(ids, cap_mb, inserts, gathers)
    with monkeypatch.context() as m:
        m.setattr(feat_cache, "_upload_indices", _blocking_upload)
        old = _play(ids, cap_mb, inserts, gathers)
    assert new[:2] == old[:2]
    for a, b in zip(new[2] + sum(new[3], []), old[2] + sum(old[3], [])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got, slot, _, out = new
    gathered = [b for b in gathers if all(i in slot for i in b)]
    assert len(out) == len(gathered)
    for b, leaves in zip(gathered, out):
        for a, want in zip(leaves, tree_leaves(_feats(list(b)))):
            assert torch.equal(a, want)
    if name == "capped_uncached":
        # Three examples' rows fit in 1 MiB: a, b and c, first come.
        assert got == [False] and slot == {"a": 0, "b": 1, "c": 2}
        assert len(out) == 2
    else:
        assert all(got)


class _Routes:
    """Recorders for Tensor.pin_memory and Tensor.to on a stand-in CUDA
    device: a copy bound for CUDA stays on the CPU and is logged as
    (from pinned memory, non_blocking); a tensor made directly on CUDA
    is logged as pageable."""

    def __init__(self, monkeypatch):
        self.pins, self.copies, self.pageable = 0, [], []
        pinned = set()
        to, tensor, as_tensor = torch.Tensor.to, torch.tensor, torch.as_tensor

        def pin_memory(t, *args, **kwargs):
            self.pins += 1
            out = t.clone()
            pinned.add(out.data_ptr())
            return out

        def to_(t, *args, **kwargs):
            dev = kwargs.get("device", args[0] if args else None)
            if isinstance(dev, (str, torch.device)) and \
                    torch.device(dev).type == "cuda":
                self.copies.append((t.data_ptr() in pinned,
                                    bool(kwargs.get("non_blocking"))))
                return t
            return to(t, *args, **kwargs)

        def made_on(fn):
            def call(*args, **kwargs):
                dev = kwargs.get("device")
                if dev is not None and torch.device(dev).type == "cuda":
                    self.pageable.append(fn.__name__)
                    kwargs["device"] = "cpu"
                return fn(*args, **kwargs)
            return call

        monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
        monkeypatch.setattr(torch.Tensor, "to", to_)
        monkeypatch.setattr(torch, "tensor", made_on(tensor))
        monkeypatch.setattr(torch, "as_tensor", made_on(as_tensor))


def test_indices_take_the_pinned_route_on_cuda(monkeypatch):
    cache = feat_cache.GTFeatureCache(list("abc"))
    cache.insert(list("abc"), _feats(list("abc")))
    routes = _Routes(monkeypatch)
    idx = cache._indices(["c", "a", "c"], CUDA)
    assert idx.dtype == torch.int64 and idx.tolist() == [2, 0, 2]
    assert routes.pins == 1 and routes.copies == [(True, True)]
    assert routes.pageable == []


def test_insert_uploads_its_rows_through_pinned_memory(monkeypatch):
    """insert's batch rows (src) and slots (dst) on a stand-in CUDA
    device: both pinned, both non-blocking, and the rows land as on the
    CPU."""
    cache = feat_cache.GTFeatureCache(list("abcd"))
    cache.insert(["a"], _feats(["a"]))     # tables allocated on the CPU
    routes = _Routes(monkeypatch)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: CUDA))
    assert cache.insert(["d", "b"], _feats(["d", "b"]))
    monkeypatch.undo()
    assert routes.pins == 2 and routes.copies == [(True, True)] * 2
    assert routes.pageable == []
    assert cache.slot == {"a": 0, "d": 1, "b": 2}
    for a, want in zip(tree_leaves(cache.gather(["b", "d", "a"])),
                       tree_leaves(_feats(["b", "d", "a"]))):
        assert torch.equal(a, want)


def test_cpu_indices_pin_nothing(monkeypatch):
    routes = _Routes(monkeypatch)
    cache = feat_cache.GTFeatureCache(list("ab"))
    cache.insert(list("ab"), _feats(list("ab")))
    idx = cache._indices(["b", "a"], torch.device("cpu"))
    cache.gather(["b"])
    assert idx.device.type == "cpu" and idx.tolist() == [1, 0]
    assert routes.pins == 0 and routes.copies == [] and routes.pageable == []


def _pinned_log(t0):
    return [e for e in trace.LOG
            if e[0] == "feat_cache.indices.pinned" and e[1] >= t0]


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_index_uploads_count(device, profiled, monkeypatch):
    """INDEX_UPLOADS counts every upload (insert: rows and slots; gather:
    slots) and the pinned ones; the log holds one
    feat_cache.indices.pinned entry of 1 per pinned upload, and only
    while a profiler runs."""
    cache = feat_cache.GTFeatureCache(list("abcd"))
    cache.insert(list("abcd"), _feats(list("abcd")))
    _Routes(monkeypatch)
    dev = torch.device(device)
    if device == "cuda":
        monkeypatch.setattr(torch.Tensor, "device",
                            property(lambda t: CUDA))
    was = dict(feat_cache.INDEX_UPLOADS)
    t0 = time.perf_counter()

    def work():
        cache.insert(["c", "a"], _feats(["c", "a"]))
        for b in ("ab", "dc", "a"):
            cache.gather(list(b))
        cache._indices(["b"], dev)

    if profiled:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            work()
    else:
        work()
    monkeypatch.undo()
    pinned = 6 if device == "cuda" else 0
    assert {k: v - was[k] for k, v in feat_cache.INDEX_UPLOADS.items()} == {
        "uploads": 6, "pinned": pinned}
    log = _pinned_log(t0)
    assert len(log) == (pinned if profiled else 0)
    assert all(e[3] == 1 and e[1] == e[2] for e in log)
