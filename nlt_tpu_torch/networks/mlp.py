"""MLP with optional input-skip concatenation (port of
nlt_tpu/networks/mlp.py): dense layers on (..., C) tensors; after each
layer listed in `skip_at` the network's input is concatenated to the
output. The NLT model does not use it."""

import torch

from .elements import dense
from .seq import Network as BaseNetwork


class Network(BaseNetwork):
    def __init__(self, widths, act=None, skip_at=None):
        super().__init__()
        if act is None:
            act = [None] * len(widths)
        if len(act) != len(widths):
            raise ValueError(
                "If not None, `act` must have the same length as `widths`")
        for w, a in zip(widths, act):
            self.stages.append(dense(w, activation=a))
        self.skip_at = skip_at

    def apply(self, params, x):
        if self.skip_at is None:
            return super().apply(params, x)
        y = x
        for i, (stage, p) in enumerate(zip(self.stages, params)):
            y = stage.apply(p, y)
            if i in self.skip_at:
                y = torch.cat((y, x), dim=-1)
        return y

    def init_params(self, gen, in_ch):
        """A skip concatenation widens the next layer's input, so init
        follows apply's dataflow."""
        if self.skip_at is None:
            return super().init_params(gen, in_ch)
        params = []
        ch = in_ch
        for i, stage in enumerate(self.stages):
            p, ch_out = stage.init(gen, ch)
            params.append(p)
            ch = ch_out + (in_ch if i in self.skip_at else 0)
        return params, ch
