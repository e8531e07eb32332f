"""Device-resident cache of static per-example step inputs (port of
nlt_tpu/parallel/feat_cache.py).

Two classes of the training step's work depend only on static
per-example data, never on params:

- the ground-truth branch of feature losses (LPIPS AlexNet taps of
  gt_camspc; the LPIPS net is frozen) — models/base.extract_gt_feats;
- the warp products: gt_camspc, base_camspc and the resample plan of
  the prediction (its integer window rows, slot weights and live
  gradient rows) — models/nlt.static_products.

The cache stores each example's extracted statics in device memory the
first time the example is seen and feeds them back into every later
step (parallel/train.make_train_step(cached_statics=True)); the loss and
its gradients are the uncached path's because none of the cached values
carry gradients.

Memory: one preallocated (n_slots, ...) table per leaf, so inserts are
in-place row copies. `cap_mb` bounds the tables: slots are assigned
first-come, and examples beyond capacity stay uncached — trainvali
extracts their statics fresh each time and feeds them directly.
Several ranks: each rank has its own cache of the examples of its
blocks, with its own cap (nlt_tpu's per-host instance; the global
statics arrays it then assembles have no torch counterpart).

Index uploads: on a CUDA device the slot indices (and insert's batch
rows) are staged through pinned memory and copied with
``non_blocking=True``, so the host never waits for the card's queue
here and enqueues the next step while the current one runs; the caching
host allocator keeps each pinned block until its copy is done. On the
CPU the indices are built in place. ``INDEX_UPLOADS`` counts the
uploads and those that went through pinned memory; each pinned one is
also the count ``feat_cache.indices.pinned`` in the trace's log.

Spans (``utils/trace.py``, while a profiler runs): ``feat_cache.gather``,
``feat_cache.insert``, and inside both ``feat_cache.indices``, the
slot indices' upload (on CUDA the pin and the enqueued copy).
"""

import numpy as np
import torch

from ..utils import logging as logutil
from ..utils import trace
from ..utils.trace import span
from ..utils.tree import tree_leaves, tree_map

logger = logutil.Logger(loggee="parallel/feat_cache")

# Index uploads and those staged through pinned memory, over the process.
INDEX_UPLOADS = {"uploads": 0, "pinned": 0}


def _upload_indices(values, device):
    """int64 tensor of `values` on `device`. CUDA: staged through pinned
    memory and copied without blocking the host. Elsewhere: built there."""
    t = torch.tensor(values, dtype=torch.int64, device="cpu")
    INDEX_UPLOADS["uploads"] += 1
    if torch.device(device).type != "cuda":
        return t.to(device)
    INDEX_UPLOADS["pinned"] += 1
    trace.count("feat_cache.indices.pinned", 1)
    return t.pin_memory().to(device, non_blocking=True)


class GTFeatureCache:
    def __init__(self, example_ids, cap_mb=None):
        self.index = {id_: i for i, id_ in enumerate(sorted(example_ids))}
        self.n = len(self.index)
        self.cap_bytes = None if cap_mb is None else int(cap_mb) << 20
        self.n_slots = None  # decided at first insert (needs shapes)
        self.slot = {}       # id -> table row
        self.taps = None     # tree of tensors with leading (n_slots,) dim
        self.have = None

    def nbytes(self):
        if self.taps is None:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(self.taps))

    def _indices(self, ids, device):
        with span("feat_cache.indices"):
            return _upload_indices([self.slot[i] for i in ids], device)

    def has_all(self, ids):
        return (self.taps is not None
                and all(i in self.slot and self.have[self.slot[i]]
                        for i in ids))

    def _alloc(self, ids, feats):
        leaves = tree_leaves(feats)
        per_ex = sum(f.numel() * f.element_size()
                     for f in leaves) // max(len(ids), 1)
        self.n_slots = self.n
        if self.cap_bytes is not None and per_ex > 0:
            self.n_slots = min(self.n, self.cap_bytes // per_ex)
        self.taps = tree_map(
            lambda f: torch.zeros((self.n_slots,) + tuple(f.shape[1:]),
                                  dtype=f.dtype, device=f.device), feats)
        self.have = np.zeros(self.n_slots, bool)
        if self.n_slots < self.n:
            logger.warn(
                "GT feature cache capped: %d of %d examples fit in "
                "%.0f MB (cache_static_mb; the rest re-extract each "
                "step)", self.n_slots, self.n, self.nbytes() / 1e6)
        else:
            logger.info("GT feature cache: %d examples, %.0f MB device "
                        "memory", self.n, self.nbytes() / 1e6)

    def insert(self, ids, feats):
        """feats: tree of per-batch tensors (leading dim len(ids)).
        Returns True iff every id now occupies a cache slot (rows beyond
        capacity are skipped). A compact resample plan
        (take_compact_frac) with more live queries than its capacity
        was truncated when it was made: refused here, the one host-side
        point every extracted plan passes through."""
        with span("feat_cache.insert"):
            return self._insert(ids, feats)

    def _insert(self, ids, feats):
        plan = (feats.get("products", {}).get("pred_plan", {})
                if isinstance(feats, dict) else {})
        if "clive" in plan:
            most = int(plan["clive"].max()) if plan["clive"].numel() else 0
            cap = plan["cpos"].shape[1]
            if most > cap:
                raise ValueError(
                    "take_compact_frac capacity %d rows/example is below "
                    "this scene's live-query coverage (max %d); raise "
                    "take_compact_frac (or set 0 to disable compaction)"
                    % (cap, most))
        if self.taps is None:
            self._alloc(ids, feats)
        for i in ids:
            if i not in self.index:
                raise KeyError(i)  # unknown example id
            if i not in self.slot and len(self.slot) < self.n_slots:
                self.slot[i] = len(self.slot)
        rows = [r for r, i in enumerate(ids) if i in self.slot]
        if not rows:
            return False
        slotted = [ids[r] for r in rows]
        device = tree_leaves(feats)[0].device
        src = _upload_indices(rows, device)
        dst = self._indices(slotted, device)
        for table, f in zip(tree_leaves(self.taps), tree_leaves(feats)):
            table.index_copy_(0, dst, f.index_select(0, src))
        for i in slotted:
            self.have[self.slot[i]] = True
        return len(rows) == len(ids)

    def gather(self, ids):
        with span("feat_cache.gather"):
            device = tree_leaves(self.taps)[0].device
            idx = self._indices(ids, device)
            return tree_map(lambda t: t.index_select(0, idx), self.taps)
