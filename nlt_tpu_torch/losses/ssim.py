"""SSIM of NHWC batches (port of nlt_tpu/losses/ssim.py, tf.image.ssim's
defaults): an 11x11 Gaussian window of sigma 1.5, built in float64 numpy
and cast to the images' dtype, applied per channel with VALID padding;
k1 = 0.01, k2 = 0.03; the mean over channels and windows, one value per
image."""

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window(size, sigma):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g /= g.sum()
    return np.outer(g, g)


def ssim(img1, img2, max_val=1.0, filter_size=11, filter_sigma=1.5,
         k1=0.01, k2=0.03):
    """Per-image SSIM of (N, H, W, C) batches; returns shape (N,)."""
    if img1.shape != img2.shape or img1.dim() != 4:
        raise ValueError("two (N, H, W, C) batches of one shape expected, "
                         "got %s and %s" % (tuple(img1.shape),
                                            tuple(img2.shape)))
    c = img1.shape[3]
    win = torch.as_tensor(_gaussian_window(filter_size, filter_sigma),
                          dtype=img1.dtype, device=img1.device)
    kern = win.expand(c, 1, filter_size, filter_size)

    def filt(x):
        return F.conv2d(x.permute(0, 3, 1, 2), kern, groups=c)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu12
    lum = (2.0 * mu12 + c1) / (mu1_sq + mu2_sq + c1)
    cs = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    return (lum * cs).mean(dim=(1, 2, 3))
