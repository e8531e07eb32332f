"""Image quality metrics on the host (port of nlt_tpu/metrics.py: PSNR,
which the vis metadata and ``psnr_vali`` use). SSIM and LPIPS as
metrics wait for ROADMAP.md queue 1, item 5."""

import numpy as np

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
