"""Device-resident example cache: keep batch fields in device memory
across epochs so steady-state epochs upload (almost) nothing (port of
the single-device half of nlt_tpu/parallel/device_cache.py).

Every array field of this dataset is a deterministic function of the
example id (supervised pairs, warps and neighbor observations are fixed
per (cam, light) config — datasets/nlt.py; the per-epoch seed only
shuffles ORDER), so re-uploading batches every epoch is redundant
traffic. Each example's field rows live on the device after its first
upload, and a batch is assembled there by one concatenation per field.

Uploads go through pinned host memory with ``non_blocking=True`` (the
copy engine overlaps the device's work); ``upload`` is also the plain
placement of an uncached batch.

Capacity-capped (``cache_device_mb``): once the cap is reached further
examples stream as before. The multi-host half of nlt_tpu's cache
(``make_global_batch``) waits for distribution (ROADMAP.md, queue 1,
item 5).
"""

import numpy as np
import torch

from ..utils import logging as logutil

logger = logutil.Logger(loggee="parallel/device_cache")


def upload(arrays, device):
    """{field: numpy array} -> {field: tensor on `device`}. CUDA: staged
    through pinned memory and copied without blocking the host; the
    caching host allocator keeps each pinned buffer until its copy is
    done. CPU: a copy (the loader's buffers are not aliased)."""
    device = torch.device(device)
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            out[k] = t.pin_memory().to(device, non_blocking=True)
        else:
            out[k] = t.clone()
    return out


class DeviceExampleCache:
    """Per-example-id device cache of batch field rows.

    ``shard_batch(arrays, ids)`` places a batch on the cache's device,
    from cached rows where it can. Fields must all carry the batch axis
    first (the dataset contract), and content must be a pure function of
    the id — ``invalidate()`` drops entries otherwise.
    """

    def __init__(self, cap_mb=2048, device="cuda"):
        self.cap_bytes = int(cap_mb) << 20
        self.device = torch.device(device)
        self._rows = {}      # id -> (sig, {field: (1, ...) tensor})
        self._bytes = 0
        self._full_logged = False
        self.hits = 0
        self.misses = 0

    def stats(self):
        return {"hits": self.hits, "misses": self.misses,
                "examples": len(self._rows),
                "mb": self._bytes / float(1 << 20)}

    def invalidate(self, ids=None):
        """Drop cached entries (all of them, or the given ids)."""
        if ids is None:
            self._rows.clear()
            self._bytes = 0
            self._full_logged = False
            return
        for eid in ids:
            ent = self._rows.pop(eid, None)
            if ent is not None:
                self._bytes -= self._entry_bytes(ent)
                self._full_logged = False

    @staticmethod
    def _entry_bytes(ent):
        return sum(v.numel() * v.element_size() for v in ent[1].values())

    @staticmethod
    def _signature(arrays):
        """Field layout a cached row must match to be reusable."""
        return tuple(sorted(
            (k, v.shape[1:], str(v.dtype)) for k, v in arrays.items()))

    def _evict_stale(self, eid, ent):
        if ent is not None:
            del self._rows[eid]
            self._bytes -= self._entry_bytes(ent)

    def shard_batch(self, arrays, ids):
        n = len(ids)
        assert all(v.shape[0] == n for v in arrays.values()), (
            "device cache needs batch-leading fields",
            {k: v.shape for k, v in arrays.items()})
        sig = self._signature(arrays)
        cached = {eid: self._rows.get(eid) for eid in ids}
        all_miss = all(c is None or c[0] != sig for c in cached.values())
        if all_miss and self._bytes >= self.cap_bytes:
            # Nothing to gain: one upload per field, no per-row copies.
            for eid, ent in cached.items():
                if ent is not None:
                    self._evict_stale(eid, ent)
            self.misses += n
            return upload(arrays, self.device)
        rows = []
        for i, eid in enumerate(ids):
            # Fresh lookup: a batch may repeat an id, and the first
            # occurrence's insert must be visible to the second.
            ent = self._rows.get(eid)
            if ent is not None and ent[0] == sig:
                self.hits += 1
                rows.append(ent[1])
                continue
            self.misses += 1
            row = upload({k: v[i:i + 1] for k, v in arrays.items()},
                         self.device)
            nbytes = sum(v.numel() * v.element_size() for v in row.values())
            freed = self._entry_bytes(ent) if ent is not None else 0
            if self._bytes - freed + nbytes <= self.cap_bytes:
                self._rows[eid] = (sig, row)
                self._bytes += nbytes - freed
            else:
                if ent is not None:
                    self._evict_stale(eid, ent)
                if not self._full_logged:
                    logger.info(
                        "Device example cache full (%.0f MB, %d examples); "
                        "further examples stream from host each batch",
                        self._bytes / float(1 << 20), len(self._rows))
                    self._full_logged = True
            rows.append(row)
        if n == 1:
            return dict(rows[0])
        return {k: torch.cat([r[k] for r in rows], dim=0) for k in arrays}
