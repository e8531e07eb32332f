"""Image quality metrics (port of nlt_tpu/metrics.py): luma PSNR in
numpy on the host (the vis metadata and ``psnr_vali`` use it), SSIM and
LPIPS through the losses' functions. SSIM and LPIPS take HWC images as
numpy arrays, computed on the CPU, or as tensors, computed on their
device."""

import numpy as np
import torch

from .losses import lpips as _lpips
from .losses.ssim import ssim as _ssim
from .utils.tree import tree_map

_LUMA = np.array([0.299, 0.587, 0.114], np.float64)


class PSNR:
    """Luma PSNR with optional mask and dtype-aware dynamic range."""

    def __init__(self, dtype=np.float32, dynamic_range=None):
        if dynamic_range is None:
            dtype = np.dtype(dtype)
            if np.issubdtype(dtype, np.integer):
                dynamic_range = float(np.iinfo(dtype).max)
            else:
                dynamic_range = 1.0
        self.dynamic_range = dynamic_range

    def __call__(self, im1, im2, mask=None):
        im1 = np.asarray(im1, np.float64)
        im2 = np.asarray(im2, np.float64)
        assert im1.shape == im2.shape
        if im1.ndim == 3 and im1.shape[2] == 3:
            im1 = im1 @ _LUMA
            im2 = im2 @ _LUMA
        se = (im1 - im2) ** 2
        if mask is not None:
            mask = np.asarray(mask).astype(bool)
            if mask.ndim == 3:
                mask = mask[:, :, 0]
            se = se[mask]
        mse = float(np.mean(se))
        if mse == 0:
            return float("inf")
        return 10.0 * np.log10(self.dynamic_range ** 2 / mse)


def _as_tensor(im):
    if isinstance(im, torch.Tensor):
        return im.float()
    return torch.from_numpy(np.asarray(im, np.float32))


class SSIM:
    """Structural similarity (higher is better) of two HW or HWC images."""

    def __init__(self, dynamic_range=1.0):
        self.dynamic_range = dynamic_range

    def __call__(self, im1, im2):
        im1, im2 = _as_tensor(im1), _as_tensor(im2)
        if im1.dim() == 2:
            im1, im2 = im1[:, :, None], im2[:, :, None]
        if im1.dim() == 3:
            im1, im2 = im1[None], im2[None]
        with torch.no_grad():
            return float(_ssim(im1, im2, max_val=self.dynamic_range)[0])


class LPIPS:
    """Perceptual distance (lower is better) of two [0, 1] HWC RGB images.
    `weights_npz`: converted canonical LPIPS weights; otherwise nlt_tpu's
    deterministic random-feature network of `seed`."""

    def __init__(self, weights_npz=None, seed=0):
        self._params = (_lpips.load_weights(weights_npz)
                        if weights_npz is not None
                        else _lpips.init_params(seed))
        self._on = {}  # device -> params there

    def __call__(self, im1, im2):
        im1 = _as_tensor(im1)[None] * 2.0 - 1.0
        im2 = _as_tensor(im2)[None] * 2.0 - 1.0
        dev = im1.device
        if dev not in self._on:
            self._on[dev] = tree_map(lambda t: t.to(dev), self._params)
        with torch.no_grad():
            return float(_lpips.lpips(self._on[dev], im1, im2)[0])
