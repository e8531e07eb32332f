"""Symmetric UV U-Net factory (port of nlt_tpu/networks/convnet.py).

1x1 conv in; per channel count of utils.net.gen_feat_n a contracting
stage [conv(k, s) -> norm -> act -> conv(k, 1) -> norm -> act -> pool]
or an expanding one [upconv or iden -> deconv(k, s) -> norm -> act ->
deconv(k, 1) -> norm -> act]; 1x1 conv out; `is_contracting` /
`spatsize_changes` bookkeeping with the resolution round-trip assert.

NLT_TPU_FUSED_STAGE=1 routes every stage of the shipped shape
(kernel == stride == 2, no norm, no pool, relu/leakyrelu) through the
fused stage op (ops/fused_stage.py), whose CUDA kernels run the whole
stage in one launch; NLT_TPU_FUSED_MIN_CH routes only stages whose
input has at least that many channels. Both are read when a Network is
built, under the same conditions as nlt_tpu.
"""

import os

import numpy as np

from ..utils import net as netutil
from .elements import (LEAKYRELU_SLOPE, Layer, act, conv, deconv, iden, norm,
                       pool, sequential, upconv)
from .seq import Network as BaseNetwork

_ACT_SLOPE = {"relu": 0.0, "leakyrelu": LEAKYRELU_SLOPE}


def _fused_stage_layer(seq_layer, kind, conv_idx, slope, min_ch):
    """Wrap a sequential stage Layer with a fused-op apply that reads the
    SAME params (init and name are the sequential's own)."""
    from ..ops import fused_stage as fs

    i1, i2 = conv_idx
    op_name = kind + "_stage"

    def apply(params, x):
        if x.shape[3] < min_ch:
            return seq_layer.apply(params, x)
        return getattr(fs, op_name)(
            x, params[i1]["w"].to(x.dtype), params[i1]["b"].to(x.dtype),
            params[i2]["w"].to(x.dtype), params[i2]["b"].to(x.dtype),
            slope)

    return Layer(seq_layer.init, apply, seq_layer.name)


class Network(BaseNetwork):
    def __init__(self, depth0, depth, kernel, stride, norm_type=None,
                 act_type="relu", pool_type=None, bn_prefix=""):
        super().__init__()
        norm_type = self.str2none(norm_type)
        pool_type = self.str2none(pool_type)
        n_feat = netutil.gen_feat_n(depth0, depth)
        self.n_feat = n_feat

        bn_count = iter(range(1 << 30))

        def mknorm():
            return norm(norm_type,
                        bn_name="%sbn%d" % (bn_prefix, next(bn_count)))

        prev_n = 0
        self.is_contracting, self.spatsize_changes = [], []

        self.stages.append(conv(1, n_feat[0], stride=1))
        self.is_contracting.append(True)
        self.spatsize_changes.append(1)

        fusable = (os.environ.get("NLT_TPU_FUSED_STAGE", "0") == "1"
                   and norm_type is None and pool_type is None
                   and kernel == stride == 2 and act_type in _ACT_SLOPE)
        min_ch = int(os.environ.get("NLT_TPU_FUSED_MIN_CH", "0"))

        for n in n_feat[:-1]:
            if n >= prev_n:  # 64 -> 64 counts as contracting
                stage = sequential([
                    conv(kernel, n, stride=stride),
                    mknorm(),
                    act(act_type),
                    conv(kernel, n, stride=1),
                    mknorm(),
                    act(act_type),
                    pool(pool_type),
                ], name="contract%d" % n)
                if fusable:
                    stage = _fused_stage_layer(
                        stage, "contract", (0, 3), _ACT_SLOPE[act_type],
                        min_ch)
                self.stages.append(stage)
                self.is_contracting.append(True)
                change = 1.0 / stride
                if pool_type is not None:
                    change *= 0.5
                self.spatsize_changes.append(change)
            else:
                stage = sequential([
                    iden() if pool_type is None else upconv(n),
                    deconv(kernel, n, stride=stride),
                    mknorm(),
                    act(act_type),
                    deconv(kernel, n, stride=1),
                    mknorm(),
                    act(act_type),
                ], name="expand%d" % n)
                if fusable:
                    stage = _fused_stage_layer(
                        stage, "expand", (1, 4), _ACT_SLOPE[act_type],
                        min_ch)
                self.stages.append(stage)
                self.is_contracting.append(False)
                change = float(stride)
                if pool_type is not None:
                    change *= 2.0
                self.spatsize_changes.append(change)
            prev_n = n

        self.stages.append(conv(1, n_feat[-1], stride=1))
        self.is_contracting.append(False)
        self.spatsize_changes.append(1)

        spatsizes = np.cumprod(self.spatsize_changes)
        assert spatsizes[-1] == 1, (
            "Resolution doesn't return to the original value")
