"""Adaptive robust loss with its latent parameters as explicit tree
leaves (port of nlt_tpu/losses/adaptive.py).

- per-channel latent alpha squashed to (alpha_lo, alpha_hi) by an affine
  sigmoid, latent scale mapped to (scale_lo, inf) by an affine softplus;
- alpha_lo == alpha_hi / scale_lo == scale_init freeze the respective
  parameter to a constant (no latent);
- the image form transforms residuals RGB -> sYUV, then per channel to
  a CDF9/7 (or LeGall5/3) wavelet pyramid, a DCT or pixels, and applies
  the per-coefficient NLL.
"""

import math

import numpy as np
import torch

from ..ops import color, distribution, safe_math, wavelet


def _check_scale(scale_lo, scale_init):
    if not np.isscalar(scale_lo):
        raise ValueError("`scale_lo` must be a scalar")
    if not np.isscalar(scale_init):
        raise ValueError("`scale_init` must be a scalar")
    if not scale_lo > 0:
        raise ValueError("`scale_lo` must be > 0, got %g" % scale_lo)
    if not scale_init >= scale_lo:
        raise ValueError("`scale_init` must be >= `scale_lo`")


def _full(shape, value, like):
    return torch.full(shape, value, dtype=like.dtype, device=like.device)


class AdaptiveLossFunction:
    """Adaptive NLL over rank-2 inputs [batch, channel]; one (alpha, scale)
    pair per channel."""

    def __init__(self, num_channels, alpha_lo=0.001, alpha_hi=1.999,
                 alpha_init=None, scale_lo=1e-5, scale_init=1.0,
                 dtype=torch.float32):
        _check_scale(scale_lo, scale_init)
        if not np.isscalar(alpha_lo) or not np.isscalar(alpha_hi):
            raise ValueError("`alpha_lo`/`alpha_hi` must be scalars")
        if not alpha_lo >= 0:
            raise ValueError("`alpha_lo` must be >= 0, got %g" % alpha_lo)
        if not alpha_hi >= alpha_lo:
            raise ValueError("`alpha_hi` must be >= `alpha_lo`")
        if alpha_init is not None and alpha_lo != alpha_hi:
            if not alpha_lo < alpha_init < alpha_hi:
                raise ValueError(
                    "`alpha_init` must be in (`alpha_lo`, `alpha_hi`)")
        self.num_channels = num_channels
        self.alpha_lo = alpha_lo
        self.alpha_hi = alpha_hi
        self.alpha_init = (
            (alpha_lo + alpha_hi) / 2.0 if alpha_init is None else alpha_init)
        self.scale_lo = scale_lo
        self.scale_init = scale_init
        self.dtype = dtype
        self._distribution = distribution.Distribution()

    @property
    def alpha_is_trainable(self):
        return self.alpha_lo != self.alpha_hi

    @property
    def scale_is_trainable(self):
        return self.scale_lo != self.scale_init

    def init_params(self):
        """Latent tree (CPU tensors); an empty dict when both are frozen."""
        params = {}
        if self.alpha_is_trainable:
            frac = ((self.alpha_init - self.alpha_lo)
                    / (self.alpha_hi - self.alpha_lo))
            latent_init = -math.log(1.0 / frac - 1.0)  # logit, float64
            params["latent_alpha"] = torch.full(
                (1, self.num_channels), latent_init, dtype=self.dtype)
        if self.scale_is_trainable:
            params["latent_scale"] = torch.zeros(
                (1, self.num_channels), dtype=self.dtype)
        return params

    def alpha(self, params, like):
        if not self.alpha_is_trainable:
            return _full((1, self.num_channels), self.alpha_lo, like)
        return safe_math.affine_sigmoid(
            params["latent_alpha"], lo=self.alpha_lo, hi=self.alpha_hi)

    def scale(self, params, like):
        if not self.scale_is_trainable:
            return _full((1, self.num_channels), self.scale_init, like)
        return safe_math.affine_softplus(
            params["latent_scale"], lo=self.scale_lo, ref=self.scale_init)

    def __call__(self, params, x):
        if x.dim() != 2 or x.shape[1] != self.num_channels:
            raise ValueError("Expected [batch, %d], got %s"
                             % (self.num_channels, tuple(x.shape)))
        return self._distribution.nllfun(
            x, self.alpha(params, x), self.scale(params, x))


class StudentsTLossFunction:
    """NLL of a per-channel Student's t-distribution."""

    def __init__(self, num_channels, scale_lo=1e-5, scale_init=1.0,
                 dtype=torch.float32):
        _check_scale(scale_lo, scale_init)
        self.num_channels = num_channels
        self.scale_lo = scale_lo
        self.scale_init = scale_init
        self.dtype = dtype

    @property
    def scale_is_trainable(self):
        return self.scale_lo != self.scale_init

    def init_params(self):
        params = {"log_df": torch.zeros((1, self.num_channels),
                                        dtype=self.dtype)}
        if self.scale_is_trainable:
            params["latent_scale"] = torch.zeros(
                (1, self.num_channels), dtype=self.dtype)
        return params

    def df(self, params):
        return safe_math.exp_safe(params["log_df"])

    def scale(self, params, like):
        if not self.scale_is_trainable:
            return _full((1, self.num_channels), self.scale_init, like)
        return safe_math.affine_softplus(
            params["latent_scale"], lo=self.scale_lo, ref=self.scale_init)

    def __call__(self, params, x):
        if x.dim() != 2 or x.shape[1] != self.num_channels:
            raise ValueError("Expected [batch, %d], got %s"
                             % (self.num_channels, tuple(x.shape)))
        return safe_math.students_t_nll(x, self.df(params),
                                        self.scale(params, x))


class AdaptiveImageLossFunction:
    """Adaptive NLL over image residuals (N, H, W, C): RGB -> sYUV ->
    per-channel spatial representation (wavelets with per-level rescale,
    DCT or PIXEL) -> flatten to (N, H*W*C) -> per-coefficient NLL ->
    back to (N, H, W, C)."""

    def __init__(self, image_size, color_space="YUV",
                 representation="CDF9/7", wavelet_num_levels=5,
                 wavelet_scale_base=1.0, use_students_t=False,
                 dtype=torch.float32, **kwargs):
        if color_space not in ("RGB", "YUV"):
            raise ValueError("Unsupported color space %r" % color_space)
        if representation not in wavelet.generate_filters() + ["DCT",
                                                               "PIXEL"]:
            raise ValueError("Unsupported representation %r" % representation)
        if len(image_size) != 3:
            raise ValueError("image_size must be (H, W, C)")
        if image_size[2] != 3 and color_space != "RGB":
            raise ValueError("YUV needs 3 channels")
        self.image_size = tuple(image_size)
        self.color_space = color_space
        self.representation = representation
        self.wavelet_num_levels = wavelet_num_levels
        self.wavelet_scale_base = wavelet_scale_base
        self.use_students_t = use_students_t
        num_channels = int(np.prod(image_size))
        cls = StudentsTLossFunction if use_students_t \
            else AdaptiveLossFunction
        self.lossfun = cls(num_channels, dtype=dtype, **kwargs)

    def init_params(self):
        return self.lossfun.init_params()

    def alpha(self, params, like):
        if self.use_students_t:
            raise ValueError("a Student's t loss has no alpha")
        return self.lossfun.alpha(params, like).reshape(self.image_size)

    def df(self, params):
        if not self.use_students_t:
            raise ValueError("only a Student's t loss has df")
        return self.lossfun.df(params).reshape(self.image_size)

    def scale(self, params, like):
        return self.lossfun.scale(params, like).reshape(self.image_size)

    def transform_to_mat(self, x):
        """Color + spatial transform, flattened to (N, H*W*C)."""
        h, w, c = self.image_size
        if self.color_space == "YUV":
            x = color.rgb_to_syuv(x)
        # (N, H, W, C) -> (N*C, H, W): each channel transformed separately.
        x_stack = x.permute(0, 3, 1, 2).reshape(-1, h, w)
        if self.representation in wavelet.generate_filters():
            x_stack = wavelet.flatten(wavelet.rescale(
                wavelet.construct(x_stack, self.wavelet_num_levels,
                                  self.representation),
                self.wavelet_scale_base))
        elif self.representation == "DCT":
            x_stack = color.image_dct(x_stack)
        # (N*C, H, W) -> (N, H*W*C), channel-minor.
        return x_stack.reshape(-1, c, h, w).permute(0, 2, 3, 1).reshape(
            -1, h * w * c)

    def __call__(self, params, x):
        if tuple(x.shape[1:]) != self.image_size:
            raise ValueError("Expected (N,) + %s, got %s"
                             % (self.image_size, tuple(x.shape)))
        h, w, c = self.image_size
        return self.lossfun(params, self.transform_to_mat(x)).reshape(
            -1, h, w, c)
