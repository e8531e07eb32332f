"""Bilinear resampling through a per-pixel warp field, forward only
(port of nlt_tpu/ops/resample.py::resample).

Semantics of ``tfa.image.resampler``, as nlt_tpu matches them:
``warp[..., 0]`` is the x (width) and ``warp[..., 1]`` the y (height)
source coordinate in pixel units; the 4 neighboring texels are combined
bilinearly; a tap outside [0, W-1] x [0, H-1] contributes 0, so queries
in (-1, 0) or (size-1, size) get partial contributions and queries
further out sample zeros.

nlt_tpu computes this in XLA (a flat row take over a 2x2 window table),
not in Pallas, so the port's version is plain PyTorch: four clipped
corner gathers. Its backward (the Pallas scatter of
nlt_tpu/ops/scatter_pallas.py) belongs to the training port.
"""

import torch


def resample(img, warp):
    """img: (N, H, W, C); warp: (N, Ho, Wo, 2) source (x, y) per target
    pixel. Returns (N, Ho, Wo, C) in img's dtype."""
    n, h, w, c = img.shape
    ho, wo = warp.shape[1], warp.shape[2]
    x = warp[..., 0]
    y = warp[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = x - x0f
    ty = y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = img.reshape(n, h * w, c)

    def tap(xi, yi, weight):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(n, ho * wo, c))
        wgt = torch.where(inb, weight, torch.zeros_like(weight))
        return vals.reshape(n, ho, wo, c) * wgt[..., None]

    return (tap(x0, y0, (1 - tx) * (1 - ty))
            + tap(x0 + 1, y0, tx * (1 - ty))
            + tap(x0, y0 + 1, (1 - tx) * ty)
            + tap(x0 + 1, y0 + 1, tx * ty))
