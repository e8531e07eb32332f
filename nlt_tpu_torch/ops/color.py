"""Color-space transforms for the robust image loss (port of
nlt_tpu/ops/color.py): the volume-preserving scaled YUV and the
orthonormal image DCT, here as products with a DCT-II matrix."""

import math

import torch

from ..utils.img import rgb_to_yuv, yuv_to_rgb

# Scale that makes the BT.601 RGB->YUV matrix volume preserving (unit
# Jacobian determinant), so log-likelihoods keep meaning across it.
VOLUME_PRESERVING_YUV_SCALE = 1.580227820074


def rgb_to_syuv(rgb):
    """Volume-preserving scaled YUV."""
    return VOLUME_PRESERVING_YUV_SCALE * rgb_to_yuv(rgb)


def syuv_to_rgb(yuv):
    return yuv_to_rgb(yuv / VOLUME_PRESERVING_YUV_SCALE)


def _dct_matrix(n, dtype, device):
    """(n, n) orthonormal DCT-II: D[k, i] = s_k cos(pi (2i + 1) k / 2n),
    built in float64."""
    i = torch.arange(n, dtype=torch.float64)
    k = i[:, None]
    d = torch.cos(math.pi * (2 * i[None, :] + 1) * k / (2 * n))
    d *= math.sqrt(2.0 / n)
    d[0] /= math.sqrt(2.0)
    return d.to(dtype=dtype, device=device)


def image_dct(image):
    """Orthonormal type-II DCT over axes 1 and 2 of an (N, H, W) stack."""
    dh = _dct_matrix(image.shape[1], image.dtype, image.device)
    dw = _dct_matrix(image.shape[2], image.dtype, image.device)
    return torch.matmul(dh, torch.matmul(image, dw.t()))


def image_idct(dct_x):
    """Inverse of image_dct."""
    dh = _dct_matrix(dct_x.shape[1], dct_x.dtype, dct_x.device)
    dw = _dct_matrix(dct_x.shape[2], dct_x.dtype, dct_x.device)
    return torch.matmul(dh.t(), torch.matmul(dct_x, dw))
