"""Checkpoints of the whole training state (port of
nlt_tpu/utils/checkpoint.py; Orbax becomes ``torch.save``).

One file per step, ``<ckptdir>/<step>.pt``: a ``torch.save`` of the state
tree {params (network and loss latents), opt_state, step[, ema_params]}
with every tensor on the CPU, written to a temporary file and moved into
place with ``os.replace``, so a reader never sees half a checkpoint.
``nlt_test.save_params`` writes the same format with the params alone.
Retention follows keep_recent_epochs (<= 0 keeps everything), plus the
best-``psnr_vali`` step when keep_best_metric is set.
"""

import json
import os
import re

import numpy as np
import torch

from . import logging as logutil
from .tree import tree_map

logger = logutil.Logger(loggee="utils/checkpoint")

_NAME = re.compile(r"(\d+)\.pt")


def _to_cpu(tree):
    return tree_map(lambda t: t.detach().to("cpu", copy=True)
                    if isinstance(t, torch.Tensor) else t, tree)


def _structure(tree, path=""):
    """{path: shape or None} of every leaf, for structure checks."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_structure(tree[k], "%s/%s" % (path, k)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_structure(v, "%s/%d" % (path, i)))
        return out
    return {path: tuple(tree.shape) if isinstance(tree, torch.Tensor)
            else None}


def fit_to(template, tree, where=""):
    """`tree` (as loaded) placed like `template`: every tensor on its
    template tensor's device and dtype. A tree of another structure or
    leaf shape raises ValueError naming the first differing paths."""
    want, got = _structure(template), _structure(tree)
    if want != got:
        diff = sorted(k for k in set(want) | set(got)
                      if want.get(k, "missing") != got.get(k, "missing"))
        raise ValueError("checkpoint %s does not match the state's "
                         "structure at %s" % (where, ", ".join(diff[:8])))

    def put(tpl, val):
        if isinstance(tpl, torch.Tensor):
            return val.to(device=tpl.device, dtype=tpl.dtype)
        return val

    return tree_map(put, template, tree)


class CheckpointManager:
    def __init__(self, ckptdir, max_to_keep=None, keep_best_metric=None):
        """keep_best_metric (e.g. 'psnr_vali'): retention keeps the most
        recent max_to_keep steps PLUS the step with the best logged
        validation metric. psnr_vali for step N is only computed by the
        validation pass after the step-N save, so retention is applied
        by prune(), which trainvali calls once the epoch's scalars are
        on disk."""
        if max_to_keep is not None and max_to_keep <= 0:
            max_to_keep = None  # keep all
        self._dir = str(ckptdir)
        self._max_to_keep = max_to_keep
        self._keep_best_metric = (
            keep_best_metric if max_to_keep is not None else None)

    @property
    def directory(self):
        return self._dir

    def path(self, step):
        return os.path.join(self._dir, "%d.pt" % int(step))

    def all_steps(self):
        if not os.path.isdir(self._dir):
            return []
        steps = []
        for f in os.listdir(self._dir):
            m = _NAME.fullmatch(f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step, state, force=False):
        """Write `state` at `step`; force=True overwrites an existing
        step (the preemption save lands on the last completed epoch,
        which may already have a periodic checkpoint)."""
        path = self.path(step)
        if os.path.exists(path) and not force:
            raise FileExistsError(
                "checkpoint step %d already exists: %s" % (step, path))
        os.makedirs(self._dir, exist_ok=True)
        tmp = "%s.%d.tmp" % (path, os.getpid())
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, path)
        if self._max_to_keep is not None and self._keep_best_metric is None:
            for s in self.all_steps()[:-self._max_to_keep]:
                self._delete(s)
        return path

    def _delete(self, step):
        try:
            os.remove(self.path(step))
        except OSError as e:
            logger.warn("Retention could not delete step %d: %s", step, e)

    def prune(self):
        """Apply keep-best retention (no-op without keep_best_metric).
        Call after the epoch's vali scalars are written, so a just-saved
        step's metric counts."""
        if self._keep_best_metric is None or self._max_to_keep is None:
            return
        steps = self.all_steps()
        if len(steps) <= self._max_to_keep:
            return
        keep = set(steps[-self._max_to_keep:])
        picked = best_step(self._dir, steps, metric=self._keep_best_metric)
        if picked is not None:
            keep.add(int(picked[0]))
        for s in steps:
            if s not in keep:
                self._delete(s)

    def wait(self):
        """Saves are synchronous; kept for nlt_tpu's interface."""

    def close(self):
        """Nothing to release; kept for nlt_tpu's interface."""

    def load(self, step=None):
        """The raw tree at `step` (latest if None), tensors on the CPU;
        None when there is no checkpoint."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state_like, step=None):
        """Restore into the structure of `state_like` (each tensor onto
        its template's device and dtype); returns (state, restored_step),
        or (state_like, 0) when there is nothing to restore. A tree of
        another structure or shape raises ValueError."""
        if step is None:
            step = self.latest_step()
        if step is None:
            logger.info("Started from scratch")
            return state_like, 0
        restored = fit_to(state_like, self.load(step), self.path(step))
        logger.info("Resumed from step %d", step)
        return restored, int(step)


def _vali_scalars_path(ckpt_dir, metric_split="vali"):
    """<outdir>/checkpoints -> <outdir>/summary_vali/scalars.jsonl.
    abspath first: a relative ckpt dir with no separator ('checkpoints'
    from inside the outdir) must resolve to its parent, not itself."""
    outdir = os.path.dirname(os.path.abspath(str(ckpt_dir).rstrip("/")))
    return os.path.join(outdir, "summary_%s" % metric_split, "scalars.jsonl")


def best_step(ckpt_dir, available, metric="psnr_vali"):
    """The available checkpoint step with the best logged validation
    metric (trainvali's JSONL scalars under <outdir>/summary_vali/).
    Returns (step, value), or None when no series exists. Selection is
    over checkpoints that still exist, with a warning when a better
    evicted epoch is on record."""
    path = _vali_scalars_path(ckpt_dir)
    if not os.path.isfile(path):
        return None
    series = {}
    with open(path) as h:
        for line in h:
            try:
                r = json.loads(line)
            except ValueError:
                continue
            if r.get("tag") == metric and "value" in r:
                series[int(r["step"])] = float(r["value"])  # last wins
    finite = {s: v for s, v in series.items() if np.isfinite(v)}
    if not finite:
        return None
    avail = {int(s) for s in (available or [])}
    reachable = {s: v for s, v in finite.items() if s in avail}
    if not reachable:
        return None
    step, value = max(reachable.items(), key=lambda kv: kv[1])
    global_step, global_value = max(finite.items(), key=lambda kv: kv[1])
    if global_step not in avail and global_value > value:
        logger.warn(
            "Best %s epoch %d (%.3f) was evicted by retention; using "
            "best REMAINING checkpoint %d (%.3f). Raise "
            "keep_recent_epochs to keep more.", metric, global_step,
            global_value, step, value)
    return step, value


def resolve_step(ckpt_dir, step, metric="psnr_vali"):
    """Step spec -> concrete step: None/'latest' stays None (latest),
    'best' selects by the logged vali metric (falling back to latest
    with a warning when nothing is selectable), numeric strings become
    ints."""
    if step is None:
        return None
    if isinstance(step, str) and step.lower() == "latest":
        return None
    if isinstance(step, str) and step.lower() == "best":
        picked = best_step(ckpt_dir, CheckpointManager(ckpt_dir).all_steps(),
                           metric=metric)
        if picked is None:
            if not os.path.isfile(_vali_scalars_path(ckpt_dir)):
                logger.warn("--step=best: no vali scalar log at %s; using "
                            "latest", _vali_scalars_path(ckpt_dir))
            else:
                logger.warn(
                    "--step=best: a vali scalar log exists but no logged "
                    "epoch matches a retained checkpoint under %s; using "
                    "latest", ckpt_dir)
            return None
        logger.info("--step=best resolved to step %d (%s %.3f)",
                    picked[0], metric, picked[1])
        return picked[0]
    try:
        return int(step)
    except (TypeError, ValueError):
        raise ValueError(
            "--step must be an integer, 'best', or 'latest'; got %r"
            % (step,))
