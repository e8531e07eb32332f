"""Parameters from nlt_tpu to the port.

nlt_tpu's params are a nested dict/list of arrays,
``{'net': {'query': [...], 'obs': [...]}, 'loss': {...}}``, with HWIO
conv kernels. The port keeps the tree, the key names (BatchNorm moving
statistics included) and the layouts, so the conversion is a copy into
tensors. ``params['loss']`` (loss latents) is dropped: the port's
inference path has no losses.
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
    return {"net": _convert(tree["net"], torch.device(device))}
