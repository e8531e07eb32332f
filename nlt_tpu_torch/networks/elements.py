"""Layer elements: conv/deconv/upconv/norm/act/pool as (init, apply)
pairs of plain functions on NHWC tensors with HWIO kernels.

Port of nlt_tpu/networks/elements.py. Kept semantics:

- conv/deconv use TF 'SAME' padding, glorot-uniform kernels, zero bias;
- the k2s1 deconv is the transpose of the SAME k2s1 conv: correlation
  with the spatially flipped kernel and the before/after pad split
  swapped;
- leakyrelu slope 0.3;
- params are stored float32 and cast per layer to the activation dtype;
  products accumulate in float32 and round once to the activation dtype
  before the bias add.

kernel == stride convs are a space-to-depth reshape + one matmul (and
the transposed conv a matmul + depth-to-space), stride-1 convs with
kernel <= 3 a sum of shifted per-tap matmuls, as in nlt_tpu. Other
kernel/stride pairs are not on any shipped config and raise.

A Layer is a pair of functions:
    init(generator, in_ch) -> (params, out_ch)   # float32 on the CPU
    apply(params, x) -> y                        # x, y are NHWC
"""

import collections
import math

import torch
import torch.nn.functional as F

from ..utils.img import upsample2x

Layer = collections.namedtuple("Layer", ["init", "apply", "name"])

_S1_MAX_KERNEL = 3
LEAKYRELU_SLOPE = 0.3


def _glorot_uniform(gen, shape):
    """Keras Conv2D default kernel init; shape is HWIO."""
    fan_in = shape[0] * shape[1] * shape[2]
    fan_out = shape[0] * shape[1] * shape[3]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen, dtype=torch.float32)
            * (2.0 * limit) - limit)


def lrelu(x, slope=LEAKYRELU_SLOPE):
    """where(x >= 0, x, slope * x) with the slope rounded to x's dtype, as
    jax evaluates a weakly typed scalar (under bf16 it is 0.30078125)."""
    slope = float(torch.tensor(slope, dtype=x.dtype))
    return torch.where(x >= 0, x, x * slope)


def _matmul_f32(a, b):
    """a @ b accumulated (and returned) in float32."""
    return torch.matmul(a.float(), b.float())


def _shift_matmul_conv(x, w, flip=False, transpose_pad=False):
    """SAME stride-1 conv as a sum of per-tap shifted matmuls, float32.

    SAME pads (k-1)//2 before and the rest after each spatial dim (TF);
    with transpose_pad the split is swapped, which with flip=True is the
    transpose of that conv, i.e. Conv2DTranspose(stride=1).
    """
    n, h, wd, c = x.shape
    k = w.shape[0]
    beg = (k - 1) // 2
    end = k - 1 - beg
    if transpose_pad:
        beg, end = end, beg
    xp = F.pad(x, (0, 0, beg, end, beg, end))
    if flip:
        w = torch.flip(w, dims=(0, 1))
    y = None
    for di in range(k):
        for dj in range(k):
            part = _matmul_f32(xp[:, di:di + h, dj:dj + wd, :], w[di, dj])
            y = part if y is None else y + part
    return y


def conv(kernel_size, n_ch_out, stride=1):
    """2-D convolution, SAME padding."""
    k = kernel_size

    def init(gen, in_ch):
        w = _glorot_uniform(gen, (k, k, in_ch, n_ch_out))
        return {"w": w, "b": torch.zeros(n_ch_out)}, n_ch_out

    def apply(params, x):
        w = params["w"].to(x.dtype)
        b = params["b"].to(x.dtype)
        n, h, wd, c = x.shape
        if k == stride and h % k == 0 and wd % k == 0:
            # Space-to-depth + matmul: exact SAME conv when k == s.
            patches = x.reshape(n, h // k, k, wd // k, k, c).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h // k, wd // k, k * k * c)
            y = _matmul_f32(patches, w.reshape(k * k * c, n_ch_out))
        elif stride == 1 and 1 < k <= _S1_MAX_KERNEL:
            y = _shift_matmul_conv(x, w)
        else:
            raise NotImplementedError(
                "conv kernel %d stride %d on %s" % (k, stride, tuple(x.shape)))
        return y.to(x.dtype) + b

    return Layer(init, apply, "conv%dx%ds%d" % (k, k, stride))


def deconv(kernel_size, n_ch_out, stride=1):
    """Transposed 2-D convolution, SAME padding."""
    k = kernel_size

    def init(gen, in_ch):
        w = _glorot_uniform(gen, (k, k, in_ch, n_ch_out))
        return {"w": w, "b": torch.zeros(n_ch_out)}, n_ch_out

    def apply(params, x):
        w = params["w"].to(x.dtype)
        b = params["b"].to(x.dtype)
        n, h, wd, c = x.shape
        if k == stride:
            # Matmul + depth-to-space: each input pixel emits a k x k block.
            y = _matmul_f32(x, w.permute(2, 0, 1, 3).reshape(
                c, k * k * n_ch_out)).to(x.dtype)
            y = y.reshape(n, h, wd, k, k, n_ch_out).permute(
                0, 1, 3, 2, 4, 5).reshape(n, h * k, wd * k, n_ch_out)
        elif stride == 1 and 1 < k <= _S1_MAX_KERNEL:
            y = _shift_matmul_conv(
                x, w, flip=True, transpose_pad=True).to(x.dtype)
        else:
            raise NotImplementedError(
                "deconv kernel %d stride %d" % (k, stride))
        return y + b

    return Layer(init, apply, "deconv%dx%ds%d" % (k, k, stride))


def upconv(n_ch_out):
    """2x bilinear upsample + 2x2 SAME conv."""
    inner = conv(2, n_ch_out, stride=1)
    return Layer(inner.init,
                 lambda params, x: inner.apply(params, upsample2x(x)),
                 "upconv")


def _no_params(apply_fn, name):
    def init(gen, in_ch):
        return {}, in_ch

    return Layer(init, lambda params, x: apply_fn(x), name)


def iden():
    return _no_params(lambda x: x, "iden")


def act(type_):
    """relu / leakyrelu(0.3) / elu."""
    if type_ == "relu":
        return _no_params(torch.relu, "relu")
    if type_ == "leakyrelu":
        return _no_params(lrelu, "leakyrelu")
    if type_ == "elu":
        return _no_params(F.elu, "elu")
    raise NotImplementedError(type_)


def norm(type_, bn_name=None):
    """None, or 'batch' in inference mode: Keras BatchNormalization
    normalizing by the moving statistics (eps 1e-3), which live in the
    params dict under per-layer unique names as in nlt_tpu. Training-mode
    batch statistics and the other norms come with the training port."""
    if type_ is None or str(type_).lower() == "none":
        return iden()
    if type_ == "batch":
        if bn_name is None:
            raise ValueError("a batch norm layer needs a bn_name")
        mean_key = "moving_mean__" + bn_name
        var_key = "moving_var__" + bn_name

        def init(gen, in_ch):
            return {"gamma": torch.ones(in_ch),
                    "beta": torch.zeros(in_ch),
                    mean_key: torch.zeros(in_ch),
                    var_key: torch.ones(in_ch)}, in_ch

        def apply(params, x):
            mean = params[mean_key].to(x.dtype)
            var = params[var_key].to(x.dtype)
            xn = (x - mean) * torch.rsqrt(var + 1e-3)
            return xn * params["gamma"].to(x.dtype) \
                + params["beta"].to(x.dtype)

        return Layer(init, apply, "batchnorm")
    raise NotImplementedError(type_)


def _pool_same_2x2(x, fill, reduce_fn):
    """2x2 stride-2 SAME window over NHWC: odd sizes pad one row/column
    after with `fill`."""
    n, h, w, c = x.shape
    x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2), value=fill)
    x = x.reshape(n, (h + 1) // 2, 2, (w + 1) // 2, 2, c)
    return reduce_fn(x)


def pool(type_):
    """2x2 stride-2 SAME pooling."""
    if type_ is None or str(type_).lower() == "none":
        return iden()
    if type_ == "max":
        return _no_params(lambda x: _pool_same_2x2(
            x, float("-inf"), lambda t: t.amax(dim=(2, 4))), "maxpool")
    if type_ == "avg":
        def apply_fn(x):
            summed = _pool_same_2x2(x, 0.0, lambda t: t.sum(dim=(2, 4)))
            counts = _pool_same_2x2(torch.ones_like(x), 0.0,
                                    lambda t: t.sum(dim=(2, 4)))
            return summed / counts
        return _no_params(apply_fn, "avgpool")
    raise NotImplementedError(type_)


def sequential(layers, name="seq"):
    """Compose layers into one Layer (params is a list)."""

    def init(gen, in_ch):
        params = []
        ch = in_ch
        for layer in layers:
            p, ch = layer.init(gen, ch)
            params.append(p)
        return params, ch

    def apply(params, x):
        for layer, p in zip(layers, params):
            x = layer.apply(p, x)
        return x

    return Layer(init, apply, name)
