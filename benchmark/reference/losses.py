"""The recipe's training loss, ``loss = barron,1e+0lpips``, in plain
float32 PyTorch.

Barron: the NLL of the general robust distribution (arXiv 1701.03077)
with alpha 1 and scale 0.01 held fixed, over the CDF 9/7 wavelet
coefficients (5 levels, unbounded reflecting padding, scale base 1) of
each channel of the residual gt - pred in volume-preserving YUV. With
alpha = 1, rho(x) = sqrt((x / c)^2 + 1) - 1 and log Z(1) = log(2 e K1(1)),
K1 the modified Bessel function of the second kind (the integral of
exp(-rho) over the line, by x = sinh t). The loss of an example is the
mean over its coefficients, whose count is the image's.

LPIPS: AlexNet's five conv stages (ReLU taps; 3x3 stride-2 max pooling
after the first two) on inputs scaled from [0, 1] to [-1, 1] and then
by LPIPS's per-channel shift and scale; each tap unit-normalised over
channels, squared difference, a non-negative 1x1 linear head, spatial
mean, summed over taps. Weights come from the caller.

The loss is the mean over the batch of barron + lpips (both weighted 1).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

BARRON_SCALE = 0.01
LOG_Z_ALPHA1 = 1.185495232349193   # log(2 e K1(1))
YUV_SCALE = 1.580227820074         # makes the BT.601 matrix volume preserving
RGB_TO_YUV = ((0.299, 0.587, 0.114),
              (-0.14714119, -0.28886916, 0.43601035),
              (0.61497538, -0.51496512, -0.10001026))
# CDF 9/7 analysis filters (Cohen, Daubechies and Feauveau 1992): the
# non-redundant halves, centre tap first.
CDF97_LO = (0.852698679009, 0.377402855613, -0.110624404418,
            -0.023849465020, 0.037828455507)
CDF97_HI = (0.788485616406, -0.418092273222, -0.040689417609,
            0.064538882629)
WAVELET_LEVELS = 5

ALEX = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
        (256, 3, 1, 1))     # (out channels, kernel, stride, pad)
LPIPS_SHIFT = (-0.030, -0.088, -0.188)
LPIPS_SCALE = (0.458, 0.448, 0.450)


def parse_spec(spec):
    """'barron,1e+0lpips' -> [('barron', 1.0), ('lpips', 1.0)]."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        for i in range(len(part), -1, -1):
            try:
                weight = float(part[:i]) if i else 1.0
            except ValueError:
                continue
            out.append((part[i:], weight))
            break
    for name, _ in out:
        if name not in ("barron", "lpips"):
            raise NotImplementedError("reference loss %r" % name)
    return out


def _mirror(half):
    return np.concatenate([half[-1:0:-1], half])


def _reflect(n, below, above):
    i = np.arange(-below, n + above)
    period = max(1, 2 * (n - 1))
    i = np.mod(i, period)
    return np.minimum(2 * (n - 1) - i, i)


def _down(x, taps, dim, shift):
    """Reflect-pad, correlate with taps and keep every second sample
    (starting `shift` in) along `dim` of an (N, H, W) stack."""
    k = len(taps)
    idx = _reflect(x.shape[dim], (k - 1) // 2, k // 2)[shift:]
    xr = x.index_select(dim, torch.as_tensor(idx, device=x.device))
    f = torch.tensor(taps, dtype=x.dtype, device=x.device)
    return xr.unfold(dim, k, 2) @ f


def wavelet_bands(x):
    """Every coefficient band of the CDF 9/7 pyramid of an (N, H, W)
    stack: 3 high-pass bands a level, then the coarsest low-pass."""
    lo_f, hi_f = _mirror(np.array(CDF97_LO)), _mirror(np.array(CDF97_HI))
    bands = []
    for _ in range(WAVELET_LEVELS):
        hi = _down(x, hi_f, 1, 1)
        lo = _down(x, lo_f, 1, 0)
        bands += [_down(hi, hi_f, 2, 1), _down(lo, hi_f, 2, 1),
                  _down(hi, lo_f, 2, 0)]
        x = _down(lo, lo_f, 2, 0)
    return bands + [x]


def barron(gt, pred):
    """(N,) Barron image loss of NHWC images."""
    n, h, w, c = gt.shape
    m = torch.tensor(RGB_TO_YUV, dtype=gt.dtype, device=gt.device)
    r = YUV_SCALE * ((gt - pred) @ m.t())
    stack = r.permute(0, 3, 1, 2).reshape(n * c, h, w)
    total = 0.0
    for band in wavelet_bands(stack):
        rho = torch.sqrt((band / BARRON_SCALE) ** 2 + 1.0) - 1.0
        total = total + rho.reshape(n, -1).sum(dim=1)
    return total / (h * w * c) + math.log(BARRON_SCALE) + LOG_Z_ALPHA1


def lpips_features(lp, img):
    """Normalised AlexNet taps of NHWC [0, 1] images (NCHW each)."""
    shift = torch.tensor(LPIPS_SHIFT, device=img.device).view(1, 3, 1, 1)
    scale = torch.tensor(LPIPS_SCALE, device=img.device).view(1, 3, 1, 1)
    x = ((img * 2.0 - 1.0).permute(0, 3, 1, 2) - shift) / scale
    taps = []
    for i, (_, _, stride, pad) in enumerate(ALEX):
        x = torch.relu(F.conv2d(x, lp["conv%d.w" % i].permute(3, 2, 0, 1),
                                lp["conv%d.b" % i], stride=stride,
                                padding=pad))
        taps.append(x / (torch.sqrt((x * x).sum(dim=1, keepdim=True))
                         + 1e-10))
        if i < 2:
            x = F.max_pool2d(x, 3, 2)
    return taps


def lpips(lp, gt, pred):
    """(N,) LPIPS distance of NHWC [0, 1] images."""
    total = 0.0
    for i, (a, b) in enumerate(zip(lpips_features(lp, gt),
                                   lpips_features(lp, pred))):
        head = torch.relu(lp["lin%d.w" % i]).view(1, -1, 1, 1)
        total = total + (((a - b) ** 2) * head).sum(dim=1).mean(dim=(1, 2))
    return total


def loss(spec, lp, gt, pred):
    """The batch's scalar loss: the mean over examples of the weighted
    sum of the spec's losses."""
    per_example = 0.0
    for name, weight in parse_spec(spec):
        fn = barron(gt, pred) if name == "barron" else lpips(lp, gt, pred)
        per_example = per_example + weight * fn
    return per_example.mean()
