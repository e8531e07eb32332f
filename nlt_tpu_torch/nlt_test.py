"""Test-time helpers shared with serving (subset of nlt_tpu/nlt_test.py):
the config path convention, model restore, and the averaged
observation feature pyramid.

Port checkpoints are ``torch.save`` files of the params tree,
``<ckpt_dir>/params_<step>.pt`` (``save_params``); a tree converted from
nlt_tpu with ``convert.params_from_jax`` is saved the same way. The
video-writing inference entry point (``infer``, ``main``) needs the dataset
port and is not ported yet.
"""

import glob
import os
import re

import numpy as np
import torch

from . import models as models_mod
from .models.nlt import normalize_batch, tree_to
from .utils import logging as logutil

logger = logutil.Logger(loggee="nlt_test")


def get_config_ini(ckpt_dir):
    """<outdir>/checkpoints -> <outdir>.ini."""
    outdir = ckpt_dir.rstrip("/").rsplit("/", 1)[0]
    return outdir + ".ini"


def _ckpt_path(ckpt_dir, step):
    return os.path.join(ckpt_dir, "params_%d.pt" % step)


def save_params(params, ckpt_dir, step=0):
    """Write a port checkpoint of `params` (kept on the CPU)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, step)
    torch.save(tree_to(params, "cpu"), path)
    return path


def _steps(ckpt_dir):
    steps = []
    for path in glob.glob(os.path.join(ckpt_dir, "params_*.pt")):
        m = re.fullmatch(r"params_(\d+)\.pt", os.path.basename(path))
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def restore_model(config, ckpt_dir, step=None, device="cuda"):
    """(model, state) with state = {'params': ..., 'step': ...}: the
    checkpoint at `step` (latest if None) of `ckpt_dir`, or, if there
    is none, a fresh init from a torch.Generator seeded with 0."""
    model = models_mod.get_model_class(config.get("model"))(
        config, device=device)
    steps = _steps(ckpt_dir)
    if step is not None and int(step) not in steps:
        raise FileNotFoundError(
            "No checkpoint for step %s under %s" % (step, ckpt_dir))
    if steps:
        step = int(step) if step is not None else steps[-1]
        params = torch.load(_ckpt_path(ckpt_dir, step), map_location="cpu",
                            weights_only=True)
        params = tree_to(params, model.device)
    else:
        logger.warn("No checkpoint found under %s; using fresh init",
                    ckpt_dir)
        step = 0
        params = model.init_params(torch.Generator().manual_seed(0))
    return model, {"params": params, "step": step}


def extract_feat(model, state, dataset, n_obs_batches=1):
    """Average observation feature pyramid over training batches: each
    level's features summed over every sample, divided by the count.
    `dataset` is anything with iterate(seed=, drop_remainder=) yielding
    dicts of numpy arrays."""
    feat_sums, count = None, 0
    with torch.no_grad():
        for batch_i, batch in enumerate(
                dataset.iterate(seed=0, drop_remainder=False)):
            if 0 <= n_obs_batches <= batch_i:
                break
            batch = normalize_batch(
                {k: torch.as_tensor(np.asarray(v), device=model.device)
                 for k, v in batch.items() if not isinstance(v, list)})
            x = batch["rgb"] - batch["base"]
            feats = model.extract_obs_features(state["params"]["net"], x)
            sums = [f.sum(dim=0, keepdim=True) for f in feats]
            feat_sums = sums if feat_sums is None else [
                s + t for s, t in zip(feat_sums, sums)]
            count += x.shape[0]
    assert feat_sums is not None, "No observation batches"
    return [s / count for s in feat_sums]  # each 1 x H x W x C
