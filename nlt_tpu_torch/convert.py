"""Parameters and training states from nlt_tpu to the port.

nlt_tpu's params are a nested dict/list of arrays,
``{'net': {'query': [...], 'obs': [...]}, 'loss': {...}}``, with HWIO
conv kernels. The port keeps the tree, the key names (BatchNorm moving
statistics included) and the layouts, so the conversion is a copy into
tensors. ``params['loss']`` (Barron's latents when trainable, the LPIPS
AlexNet weights) comes across with the network: the loss network is
part of the training objective.

A training state converts too (``state_from_jax``): optax's AMSGrad
state, alone or chained after ``clip_by_global_norm``, becomes the port's
``{'count', 'mu', 'nu', 'nu_max'}`` (parallel/train.AMSGrad), so a
nlt_tpu run continues in the port.
"""

import numpy as np
import torch


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_from_jax(tree, device="cpu"):
    """nlt_tpu params (numpy or jax arrays; pass the EMA weights where
    the run kept them) -> the port's params tree on `device`."""
    return {k: _convert(tree[k], torch.device(device))
            for k in ("net", "loss") if k in tree}


_AMSGRAD = ("count", "mu", "nu", "nu_max")


def _amsgrad_states(tree):
    """Every AMSGrad state (optax's ScaleByAmsgradState) inside an optax
    state, found through chain tuples."""
    if all(hasattr(tree, a) for a in _AMSGRAD):
        return [{a: getattr(tree, a) for a in _AMSGRAD}]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in _amsgrad_states(v)]
    return []


def opt_state_from_jax(opt_state, device="cpu"):
    """nlt_tpu's optimizer state (optax.amsgrad, or chained after
    clip_by_global_norm, whose state is empty) -> the port's AMSGrad
    state on `device`."""
    found = _amsgrad_states(opt_state)
    if len(found) != 1:
        raise ValueError("expected one AMSGrad state in the optax state, "
                         "found %d" % len(found))
    st = found[0]
    device = torch.device(device)
    out = {k: _convert(st[k], device) for k in ("mu", "nu", "nu_max")}
    out["count"] = torch.tensor(int(np.asarray(st["count"])),
                                dtype=torch.int32, device=device)
    return out


def state_from_jax(state, device="cpu"):
    """nlt_tpu's training state {params, opt_state, step[, ema_params]}
    -> the port's, on `device`."""
    out = {"params": params_from_jax(state["params"], device),
           "opt_state": opt_state_from_jax(state["opt_state"], device),
           "step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32, device=device)}
    if "ema_params" in state:
        out["ema_params"] = params_from_jax(state["ema_params"], device)
    return out
