"""The reference's two entries: training steps from given weights, and
served frames from given requests."""

import torch

from . import losses, model, optim
from .precision import ROUNDINGS, no_tf32


def train(cfg, weights, lpips_w, batches, precision="float32", half=False,
          frozen=False):
    """Run the recipe's training step once per wire-format batch from
    `weights` ({name: tensor}, left unchanged). Faults a comparison has
    to catch: half, each step sees only the first half of its batch;
    frozen, no step changes the weights.
    Returns (losses, grads, params): each step's loss (floats), each
    step's gradients as {step number from 1: {name: tensor}}, and the
    weights after the last step."""
    model.check_recipe(cfg)
    rnd = ROUNDINGS[precision]
    params = {k: v.detach().clone().float() for k, v in weights.items()}
    opt = optim.AMSGrad(params, cfg["lr"], cfg.get("mgm", -1.0))
    out_losses, out_grads = [], {}
    with no_tf32():
        for batch in batches:
            b = model.to_float(batch, next(iter(params.values())).device)
            if half:
                b = {k: v[:v.shape[0] // 2] for k, v in b.items()}
            live = {k: p.detach().requires_grad_(True)
                    for k, p in params.items()}
            pred = model.predict(cfg, live, b, rnd=rnd)
            value = losses.loss(cfg["loss"], lpips_w, model.target(cfg, b),
                                pred)
            grads = dict(zip(live, torch.autograd.grad(value,
                                                       list(live.values()))))
            out_losses.append(float(value.detach()))
            out_grads[len(out_losses)] = {k: g.detach()
                                          for k, g in grads.items()}
            if not frozen:
                opt.step(grads)
            del live, pred, value, grads
    return out_losses, out_grads, params


@torch.no_grad()
def frames(cfg, weights, obs_batch, requests, precision="float32"):
    """uint8 pred_camspc frames (N, H, W, 3) of each wire-format request,
    under the pyramid baked from `obs_batch`."""
    model.check_recipe(cfg)
    rnd = ROUNDINGS[precision]
    device = next(iter(weights.values())).device
    with no_tf32():
        pyramid = model.obs_pyramid(
            cfg, weights, model.to_float(obs_batch, device), rnd=rnd)
        return [model.pack_uint8(model.predict(
                    cfg, weights, model.to_float(r, device), pyramid=pyramid,
                    rnd=rnd)).cpu() for r in requests]
