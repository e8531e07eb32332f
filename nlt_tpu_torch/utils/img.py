"""Device image ops on NHWC tensors: the subset of nlt_tpu/utils/img.py
that the serving path runs."""

import torch

from . import logging as logutil

logger = logutil.Logger(loggee="utils/img")


def alpha_blend(t1, alpha, t2=None):
    """t1 * alpha + t2 * (1 - alpha); t2 defaults to zeros."""
    if t2 is None:
        return t1 * alpha
    return t1 * alpha + t2 * (1 - alpha)


def set_left_top_corner(x, val=0.0):
    """Force pixel (0, 0) of every image in an NHWC batch to `val`
    (background texels warp to (0, 0), so this blacks out backgrounds)."""
    mask = torch.ones((1, x.shape[1], x.shape[2], 1), dtype=x.dtype,
                      device=x.device)
    mask[:, 0, 0, :] = 0.0
    y = x * mask
    if val != 0.0:
        y = y + (1.0 - mask) * val
    return y


def _linear_weight_mat(in_size, out_size):
    """(in_size, out_size) weights of jax.image.resize(method='linear'):
    half-pixel centers, a triangle kernel widened by the downscale
    factor (antialiasing), weights renormalized over in-range taps and
    zeroed where the sample lies outside the input. Computed in float64."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float64) + 0.5)
              * inv_scale - 0.5)
    dist = (sample[None, :]
            - torch.arange(in_size, dtype=torch.float64)[:, None]).abs()
    weights = torch.clamp(1.0 - dist / kernel_scale, min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize(x, new_h=None, new_w=None):
    """Bilinear resize of an NHWC batch, equal to nlt_tpu's resize
    (jax.image.resize, method 'linear'): it antialiases when it
    downsamples, which torch's interpolate does not by default."""
    h, w = x.shape[1], x.shape[2]
    if new_h is not None and new_w is not None:
        if int(h / w * new_w) != new_h:
            logger.warn(
                "Aspect ratio changed in resizing: original %s; new %s",
                (h, w), (new_h, new_w))
    elif new_h is None and new_w is not None:
        new_h = int(h / w * new_w)
    elif new_h is not None and new_w is None:
        new_w = int(w / h * new_h)
    else:
        raise ValueError("At least one of new height or width must be given")
    if (new_h, new_w) == (h, w):
        return x
    wh = _linear_weight_mat(h, new_h).to(device=x.device, dtype=x.dtype)
    ww = _linear_weight_mat(w, new_w).to(device=x.device, dtype=x.dtype)
    return torch.einsum("nhwc,hH,wW->nHWc", x, wh, ww)


def upsample2x(x):
    """2x bilinear upsampling of NHWC (Keras UpSampling2D bilinear)."""
    return resize(x, 2 * x.shape[1], 2 * x.shape[2])


def pack_vis(tree, linear_space=False):
    """Quantize a dict of [0, 1] images on the device before the fetch:
    uint8, or float16 for linear-space outputs."""
    def pack(v):
        if v.dtype == torch.uint8:
            return v
        v = torch.clamp(v, 0.0, 1.0)
        if linear_space:
            return v.to(torch.float16)
        return torch.round(v * 255.0).to(torch.uint8)

    return {k: pack(v) for k, v in tree.items()}


_SRGB_LINEAR_THRES = 0.0031308
_SRGB_LINEAR_COEFF = 12.92
_SRGB_EXP_COEFF = 1.055
_SRGB_EXPONENT = 2.4


def linear2srgb(x):
    """Linear -> sRGB transfer for [0, 1] inputs."""
    x = torch.clamp(x, 0.0, 1.0)
    linear = x * _SRGB_LINEAR_COEFF
    safe_x = torch.clamp(x, min=1e-12)
    nonlinear = _SRGB_EXP_COEFF * (
        safe_x ** (1.0 / _SRGB_EXPONENT)) - (_SRGB_EXP_COEFF - 1.0)
    return torch.where(x <= _SRGB_LINEAR_THRES, linear, nonlinear)
