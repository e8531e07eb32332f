"""Test-time inference: relight and re-view every test view of a
trained scene (port of nlt_tpu/nlt_test.py, one device).

    python -m nlt_tpu_torch.nlt_test --ckpt=<outdir>/checkpoints
        [--step=N|best] [--batch_size_override=N] [--n_obs_batches=N]
        [--fps=N] [--device cuda|cpu]

1. the config .ini is the checkpoint's run snapshot (<outdir>.ini next
   to <outdir>/checkpoints);
2. a fixed observation feature pyramid is computed by running training
   batches' (rgb - base) through the obs path and averaging every
   level's features over all samples (``extract_feat``);
3. every test view is inferred with that pyramid tiled to the batch as
   obs_override (``infer``), its frames written under
   ``<outdir>/vis_test/ckpt-<step>_pred/batch<i>/``;
4. the predictions are compiled into one video, ordered by view id.

Checkpoints are trainvali's (``utils/checkpoint.py``: one
``<ckpt_dir>/<step>.pt`` per step holding the state tree);
``save_params`` writes the same format with the params alone (a tree
converted from nlt_tpu with ``convert.params_from_jax``, for one).
``restore_model`` prefers the EMA weights where the run kept them, as
nlt_tpu does.

One device: ``--n_data`` takes -1 or 1 (nlt_tpu on one chip), and a
larger value or the multi-host flags raise (ROADMAP.md, queue 1, item
5).
"""

import argparse
from os.path import join

import numpy as np
import torch

from . import datasets as datasets_mod
from . import models as models_mod
from . import resolve_device
from .models.nlt import normalize_batch, tree_to
from .parallel import device_cache as device_cache_mod
from .trainvali import VisStager, strip_host_fields
from .utils import checkpoint as ckpt_mod
from .utils import config as config_mod
from .utils import logging as logutil

logger = logutil.Logger(loggee="nlt_test")

# The to_vis entries a test frame is made of.
TEST_OUTPUTS = ("pred_camspc", "base_camspc", "nn_camspc")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", type=str, required=True,
                   help="path to <outdir>/checkpoints (directory)")
    p.add_argument("--step", type=str, default=None,
                   help="checkpoint step; an integer, or 'best' to "
                        "select the epoch with the best logged "
                        "psnr_vali; default latest")
    p.add_argument("--batch_size_override", type=int, default=None)
    p.add_argument("--n_obs_batches", type=int, default=1)
    p.add_argument("--fps", type=int, default=24)
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--n_data", type=int, default=-1,
                   help="devices along the inference data axis; one "
                        "device here, so -1 (all) and 1 both mean it")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def _check_single_device(args):
    if (args.n_data not in (-1, 1) or args.coordinator_address
            or (args.num_processes or 1) > 1 or args.process_id):
        raise NotImplementedError(
            "several devices (--n_data > 1, multi-host flags) are not "
            "ported yet (ROADMAP.md, queue 1, item 5)")


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


def tile_pyramid(feat_agg, bs):
    """The averaged pyramid tiled to a batch of `bs` (obs_override)."""
    return [f.expand((bs,) + tuple(f.shape[1:])).contiguous()
            for f in feat_agg]


def infer(model, state, dataset, feat_agg, outroot, report_every=10):
    """Infer every test view (the remainder batch too) with the tiled
    pyramid as obs_override and write its frames; returns the batch
    dirs in order.

    A one-deep vis pipeline: batch i's outputs are packed on the device
    and copied into pinned host buffers without blocking, behind a CUDA
    event (``trainvali.VisStager``); they are written once batch i+1 has
    been queued, after waiting on batch i's event alone, so the host
    writes PNGs while the device computes."""
    stager = VisStager(model.config.get_bool("linear_space"),
                       dump_raw=False)
    overrides = {}  # bs -> tiled pyramid (loop-invariant per bs)
    pending, batch_dirs = [], []

    def write_oldest():
        staged, outdir = pending.pop(0)
        # Waits on this batch's event alone, not on the device.
        model.vis_batch(stager.materialize(staged), outdir, "test")

    with torch.no_grad():
        for batch_i, batch in enumerate(
                dataset.iterate(seed=0, drop_remainder=False)):
            arrays, meta = strip_host_fields(batch)
            bs = arrays["base"].shape[0]
            if bs not in overrides:
                overrides[bs] = tile_pyramid(feat_agg, bs)
            placed = device_cache_mod.upload(arrays, model.device)
            to_vis = model.apply(state["params"], placed, "test",
                                 obs_override=overrides[bs],
                                 outputs=TEST_OUTPUTS)[3]
            outdir = join(outroot, "batch%09d" % batch_i)
            pending.append((stager.stage(to_vis, meta), outdir))
            if len(pending) > 1:
                write_oldest()
            batch_dirs.append(outdir)
            if (batch_i + 1) % report_every == 0:
                logger.info("Done inferring %d batches", batch_i + 1)
        while pending:
            write_oldest()
    return batch_dirs


def main(argv=None):
    """Returns the path of the compiled video."""
    args = parse_args(argv)
    _check_single_device(args)
    device = resolve_device(args.device)

    config_ini = get_config_ini(args.ckpt)
    config = config_mod.read_config(config_ini)
    if args.batch_size_override is not None:
        config.set("bs", args.batch_size_override)

    step = ckpt_mod.resolve_step(args.ckpt, args.step)
    model, state = restore_model(config, args.ckpt, step=step, device=device)

    Dataset = datasets_mod.get_dataset_class(config.get("dataset"))
    feat_agg = extract_feat(model, state, Dataset(config, "train"),
                            n_obs_batches=args.n_obs_batches)

    outroot = join(config_ini[:-len(".ini")], "vis_test",
                   "ckpt-%s_pred" % (step if step is not None else "latest"))
    # The video is compiled from infer()'s dir list, not a re-glob: dirs
    # left by an earlier run at another batch size would join it.
    batch_vis_dirs = infer(model, state, Dataset(config, "test"), feat_agg,
                           outroot)
    view_at = model.compile_batch_vis(batch_vis_dirs, outroot.rstrip("/"),
                                      "test", fps=args.fps)
    logger.info("Compilation available for viewing at\n\t%s", view_at)
    return view_at


if __name__ == "__main__":
    main()
