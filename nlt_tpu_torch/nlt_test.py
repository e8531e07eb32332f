"""Test-time helpers shared with serving (subset of nlt_tpu/nlt_test.py):
the config path convention, model restore, and the averaged
observation feature pyramid.

Checkpoints are trainvali's (``utils/checkpoint.py``: one
``<ckpt_dir>/<step>.pt`` per step holding the state tree);
``save_params`` writes the same format with the params alone (a tree
converted from nlt_tpu with ``convert.params_from_jax``, for one).
``restore_model`` prefers the EMA weights where the run kept them, as
nlt_tpu does. The video-writing inference entry point (``infer``,
``main``) waits for ROADMAP.md queue 1, item 5.
"""

import numpy as np
import torch

from . import models as models_mod
from .models.nlt import normalize_batch, tree_to
from .utils import checkpoint as ckpt_mod
from .utils import logging as logutil

logger = logutil.Logger(loggee="nlt_test")


def get_config_ini(ckpt_dir):
    """<outdir>/checkpoints -> <outdir>.ini."""
    outdir = ckpt_dir.rstrip("/").rsplit("/", 1)[0]
    return outdir + ".ini"


def save_params(params, ckpt_dir, step=0):
    """Write a checkpoint holding `params` alone (trainvali's format)."""
    return ckpt_mod.CheckpointManager(ckpt_dir).save(
        step, {"params": params, "step": torch.tensor(step)}, force=True)


def restore_model(config, ckpt_dir, step=None, device="cuda"):
    """(model, state) with state = {'params': ..., 'step': checkpoint
    step}: the checkpoint at `step` of `ckpt_dir` (None or 'latest': the latest;
    'best': the best logged psnr_vali; or an int), with the EMA weights
    where the run kept them; a fresh init from a torch.Generator seeded
    with 0 when there is no checkpoint at all."""
    model = models_mod.get_model_class(config.get("model"))(
        config, device=device)
    manager = ckpt_mod.CheckpointManager(ckpt_dir)
    step = ckpt_mod.resolve_step(ckpt_dir, step)
    if step is not None and step not in manager.all_steps():
        raise FileNotFoundError(
            "No checkpoint for step %s under %s" % (step, ckpt_dir))
    if step is None:
        step = manager.latest_step()
    tree = manager.load(step)
    if tree is None:
        logger.warn("No checkpoint found under %s; using fresh init",
                    ckpt_dir)
        params = model.init_params(torch.Generator().manual_seed(0))
        return model, {"params": params, "step": 0}
    params = tree.get("ema_params", tree["params"])
    return model, {"params": tree_to(params, model.device), "step": step}


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
