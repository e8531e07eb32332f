"""The port's training entry point with this slice's options, on the CPU:
nlt_tpu_torch.trainvali on the synthesized 32^2 scene of
test_torch_trainvali.py with norm = batch and loss =
barron,1e+0elpips,1e+0ssim. The checkpoint carries the merged BatchNorm
moving statistics; validation and serving run on them; the cached-statics
path (cache_static) caches no E-LPIPS feature and gives the uncached
run's losses."""

import os
from os.path import join

import numpy as np
import torch

from nlt_tpu_torch.datasets import get_dataset_class
from nlt_tpu_torch.models import get_model_class
from nlt_tpu_torch.models.base import Model as BaseModel
from nlt_tpu_torch.nlt_test import restore_model
from nlt_tpu_torch.parallel import train as ttrain
from nlt_tpu_torch.parallel.device_cache import upload
from nlt_tpu_torch.serve import Server
from nlt_tpu_torch.utils import checkpoint as tckpt
from nlt_tpu_torch.utils.config import Config as TConfig
from tests.test_torch_trainvali import (_cfg, _port_run, _scalars,
                                        scene_root)  # noqa: F401

OPTIONS = {"norm": "batch", "loss": "barron,1e+0elpips,1e+0ssim",
           "epochs": 1}


def _moving(tree):
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                if isinstance(v, torch.Tensor):
                    if k.startswith("moving_"):
                        out[path + (k,)] = v
                else:
                    walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))

    walk(tree, ())
    return out


def test_trainvali_batch_norm_elpips_ssim(tmp_path, scene_root):  # noqa: F811
    out = _port_run(tmp_path, scene_root, "bn", cache_static=False,
                    **OPTIONS)
    cfg = TConfig(_cfg(scene_root, str(tmp_path), **OPTIONS))
    ckpt_dir = join(out, "checkpoints")
    tree = tckpt.CheckpointManager(ckpt_dir).load()
    model, state = restore_model(cfg, ckpt_dir, device="cpu")
    # The merged moving statistics of every BN layer are in the checkpoint
    # and have left their init (mean 0, variance 1).
    moving = _moving(tree["params"])
    assert moving and sorted(moving) == sorted(_moving(model.init_params(
        torch.Generator().manual_seed(0))))
    for k, v in moving.items():
        init = 0.0 if k[-1].startswith("moving_mean__") else 1.0
        assert not torch.equal(v, torch.full_like(v, init)), k

    # Validation ran on them: the logged loss_vali is the eval step of
    # the checkpoint's params on the validation batches, and differs
    # from the same params with the statistics at their init.
    vali = get_dataset_class("nlt")(cfg, "vali")
    eval_step = ttrain.make_eval_step(model)
    n_vali = cfg.get_int("vali_batches")
    batches = [upload({k: v for k, v in b.items() if not isinstance(v, list)},
                      torch.device("cpu"))
               for _, b in zip(range(n_vali), vali.iterate(
                   seed=0, drop_remainder=False))]
    got = float(np.mean([float(eval_step(state, b)[0]) for b in batches]))
    logged = _scalars(out, "vali")["loss_vali"][1]
    np.testing.assert_allclose(got, logged, rtol=1e-6)

    def reset(t):
        if isinstance(t, dict):
            return {k: (torch.full_like(v, 0.0 if k.startswith("moving_mean")
                                        else 1.0)
                        if k.startswith("moving_") else reset(v))
                    for k, v in t.items()}
        if isinstance(t, list):
            return [reset(v) for v in t]
        return t

    fresh = float(np.mean([float(eval_step(
        {"params": reset(state["params"])}, b)[0]) for b in batches]))
    assert abs(fresh - logged) > 1e-4 * abs(logged)

    # A server answers from the checkpoint with the moving statistics:
    # its prediction is the model's test-mode forward of those params.
    server = Server(ckpt_dir, config=cfg, device="cpu")
    req = {k: v for k, v in next(iter(vali.iterate(
        seed=0, drop_remainder=False))).items() if not isinstance(v, list)}
    served = server.predict(req)
    with torch.no_grad():
        _, _, _, to_vis = model.apply(state["params"],
                                      upload(req, torch.device("cpu")),
                                      "test")
    np.testing.assert_allclose(served["pred"], to_vis["pred"].numpy(),
                               rtol=1e-6, atol=1e-6)


def test_trainvali_cached_statics_skip_elpips_features(tmp_path,
                                                       scene_root):  # noqa
    """cache_static with E-LPIPS and SSIM: the statics cache holds the
    warp products only (E-LPIPS's ground truth changes with each draw),
    and the run's losses are the uncached run's (the same draws: the
    generator is seeded from the step)."""
    cfg = TConfig(_cfg(scene_root, str(tmp_path), **OPTIONS))
    model = get_model_class("nlt")(cfg, device="cpu")
    assert model.feat_loss_indices() == []
    assert type(model).static_products is not BaseModel.static_products
    runs = {}
    for cached in (False, True):
        out = _port_run(tmp_path, scene_root, "c%d" % cached,
                        cache_static=cached, **OPTIONS)
        runs[cached] = _scalars(out, "train")["loss_train"]
        assert os.path.isdir(join(out, "checkpoints"))
    np.testing.assert_allclose(runs[True][1], runs[False][1], rtol=1e-5)
