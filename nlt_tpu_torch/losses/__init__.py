"""Loss layer (port of nlt_tpu/losses/__init__.py): L1, L2, UVL2, SSIM,
Barron, LPIPS and E-LPIPS, and the weighted loss-spec parser
(``'barron,1e+0lpips'``).

Every loss is an object with

    init_params() -> tree          (CPU tensors; {} for stateless losses)
    __call__(params, gt, pred, keep_batch=False, weights=None) -> loss

Stateful losses carry their state explicitly (Barron's latent alpha and
scale when trainable, LPIPS's network weights), so it lives in the
params tree under ``params['loss']``. E-LPIPS is stochastic
(``stochastic = True``): it takes a CPU ``torch.Generator`` to draw its
transforms from. The forwards are marked for the profiler
(``nlt::barron``, ``nlt::lpips``, ``nlt::ssim``, ``nlt::elpips``).
"""

import torch

from ..utils import logging as logutil
from ..utils.img import alpha_blend, resize, rgb_to_yuv
from ..utils.tree import tree_map
from . import adaptive as _adaptive
from . import elpips as _elpips
from . import lpips as _lpips
from . import ssim as _ssim

logger = logutil.Logger(loggee="losses")


def _reduce(loss, keep_batch):
    """Mean over all non-batch dims (keep_batch) or everything."""
    if keep_batch:
        return loss.mean(dim=tuple(range(1, loss.dim())))
    return loss.mean()


class L1:
    """Mean absolute error."""

    def init_params(self):
        return {}

    def __call__(self, params, gt, pred, keep_batch=False, weights=None):
        err = (gt - pred).abs()
        if weights is not None:
            err = err * weights
        return _reduce(err, keep_batch)


class L2:
    """Mean squared error."""

    def init_params(self):
        return {}

    def __call__(self, params, gt, pred, keep_batch=False, weights=None):
        err = (gt - pred) ** 2
        if weights is not None:
            err = err * weights
        return _reduce(err, keep_batch)


class UVL2:
    """Chroma-only (UV of YUV) L2 on clipped inputs."""

    def init_params(self):
        return {}

    def __call__(self, params, gt, pred, keep_batch=False, weights=None):
        gt_yuv = rgb_to_yuv(gt.clamp(0.0, 1.0))
        pred_yuv = rgb_to_yuv(pred.clamp(0.0, 1.0))
        err = (gt_yuv[..., 1:] - pred_yuv[..., 1:]) ** 2
        if weights is not None:
            err = err * weights
        return _reduce(err, keep_batch)


class SSIM:
    """(1 - SSIM) / 2, in [0, 1]."""

    def __init__(self, dynamic_range=1.0):
        self.dynamic_range = dynamic_range

    def init_params(self):
        return {}

    def __call__(self, params, gt, pred, keep_batch=False, weights=None):
        if weights is not None:
            gt = alpha_blend(gt, weights)
            pred = alpha_blend(pred, weights)
        with torch.profiler.record_function("nlt::ssim"):
            loss = (1.0 - _ssim.ssim(gt, pred,
                                     max_val=self.dynamic_range)) / 2.0
        return loss if keep_batch else loss.mean()


class Barron:
    """Adaptive robust image loss on the residual gt - pred. NLT settings:
    alpha fixed at 1, scale fixed at 0.01, sYUV, CDF9/7 wavelets, 5
    levels, scale base 1 (no latent parameters); trainable bounds make
    alpha/scale adapt."""

    def __init__(self, imw, imh, alpha=1.0, scale=0.01,
                 wavelet_scale_base=1.0, wavelet_num_levels=5,
                 color_space="YUV", representation="CDF9/7",
                 alpha_lo=None, alpha_hi=None, scale_lo=None):
        self.func = _adaptive.AdaptiveImageLossFunction(
            (imh, imw, 3),
            color_space=color_space,
            representation=representation,
            wavelet_num_levels=wavelet_num_levels,
            wavelet_scale_base=wavelet_scale_base,
            alpha_lo=alpha if alpha_lo is None else alpha_lo,
            alpha_hi=alpha if alpha_hi is None else alpha_hi,
            scale_lo=scale if scale_lo is None else scale_lo,
            scale_init=scale)

    def init_params(self):
        return self.func.init_params()

    def __call__(self, params, gt, pred, keep_batch=False, weights=None):
        if weights is not None:
            gt = alpha_blend(gt, weights)
            pred = alpha_blend(pred, weights)
        with torch.profiler.record_function("nlt::barron"):
            return _reduce(self.func(params, gt - pred), keep_batch)


class LPIPS:
    """Perceptual loss on [0, 1] NHWC RGB inputs. Its network is frozen:
    no gradient reaches its weights (they are detached at the call)."""

    # The gt branch is static per example, so its features may be cached.
    cacheable_gt = True

    def __init__(self, per_ch=False, weights_npz=None, seed=0,
                 max_res=None):
        self.per_ch = per_ch
        self.weights_npz = weights_npz
        self.seed = seed
        # Optional: downsample inputs above this resolution first.
        self.max_res = max_res
        if weights_npz is None:
            logger.warn(
                "LPIPS: no weights artifact configured; using a "
                "deterministic random-feature AlexNet. Values are a valid "
                "perceptual-style distance but NOT comparable to canonical "
                "LPIPS numbers.")

    def init_params(self):
        if self.weights_npz is not None:
            return _lpips.load_weights(self.weights_npz)
        return _lpips.init_params(self.seed)

    def _transform(self, img, weights=None):
        """Alpha blend, max_res downsample, [0, 1] -> [-1, 1]."""
        if weights is not None:
            img = alpha_blend(img, weights)
        if self.max_res is not None:
            h, w = img.shape[1], img.shape[2]
            if max(h, w) > self.max_res:
                scale = self.max_res / max(h, w)
                img = resize(img, max(1, round(h * scale)),
                             max(1, round(w * scale)))
        return img * 2.0 - 1.0

    def extract_feats(self, params, img, weights=None):
        """Normalized AlexNet taps of a [0, 1] NHWC image, to pass back as
        `gt_feats`."""
        if self.per_ch:
            raise ValueError("gt feature caching supports per_ch=False")
        return _lpips.features_normalized(tree_map(torch.Tensor.detach,
                                                   params),
                                          self._transform(img, weights))

    def __call__(self, params, gt, pred, keep_batch=False, weights=None,
                 gt_feats=None):
        with torch.profiler.record_function("nlt::lpips"):
            return self._distance(params, gt, pred, keep_batch, weights,
                                  gt_feats)

    def _distance(self, params, gt, pred, keep_batch, weights, gt_feats):
        if pred.shape[3] != 3:
            raise ValueError("Prediction must be (N, H, W, 3)")
        params = tree_map(torch.Tensor.detach, params)
        pred = self._transform(pred, weights)
        if gt_feats is not None:
            if self.per_ch:
                raise ValueError("gt_feats needs per_ch=False")
            loss = _lpips.lpips_from_feats(
                params, gt_feats, _lpips.features_normalized(params, pred))
            return loss if keep_batch else loss.mean()
        if gt.shape[3] != 3:
            raise ValueError("Ground truth must be (N, H, W, 3)")
        gt = self._transform(gt, weights)
        if self.per_ch:
            loss = 0.0
            for i in range(3):
                gt_ch = gt[..., i:i + 1].repeat(1, 1, 1, 3)
                pred_ch = pred[..., i:i + 1].repeat(1, 1, 1, 3)
                loss = loss + _lpips.lpips(params, pred_ch, gt_ch) / 3.0
        else:
            loss = _lpips.lpips(params, pred, gt)
        return loss if keep_batch else loss.mean()


class ELPIPS(LPIPS):
    """LPIPS averaged over `n_samples` random transforms, each applied
    identically to both images (losses/elpips.py). Stochastic: a call
    draws its transforms from `generator` (a CPU torch.Generator; the
    train step seeds one per step and microbatch), or from a generator
    seeded with `seed` when none is given (evaluation). `draws`, a list
    of n_samples elpips.Draw, replaces the drawing. The ground-truth
    branch changes with the transform, so its features are not cached
    (cacheable_gt = False)."""

    stochastic = True
    cacheable_gt = False

    def __init__(self, n_samples=1, weights_npz=None, seed=0, max_res=None):
        super().__init__(per_ch=False, weights_npz=weights_npz, seed=seed,
                         max_res=max_res)
        self.n_samples = n_samples

    def draw(self, generator, gt):
        """n_samples transforms for images shaped like `gt`."""
        square = gt.shape[1] == gt.shape[2]
        return [_elpips.draw_transform(generator, square)
                for _ in range(self.n_samples)]

    def __call__(self, params, gt, pred, keep_batch=False, weights=None,
                 generator=None, draws=None):
        if gt.shape[3] != 3 or pred.shape[3] != 3:
            raise ValueError("Both ground truth and prediction must be "
                             "(N, H, W, 3)")
        if draws is None:
            if generator is None:
                generator = torch.Generator().manual_seed(self.seed)
            draws = self.draw(generator, gt)
        if len(draws) != self.n_samples:
            raise ValueError("%d draws for %d samples"
                             % (len(draws), self.n_samples))
        if weights is not None:
            gt = alpha_blend(gt, weights)
            pred = alpha_blend(pred, weights)
        params = tree_map(torch.Tensor.detach, params)
        with torch.profiler.record_function("nlt::elpips"):
            total = 0.0
            for d in draws:
                total = total + _lpips.lpips(
                    params,
                    self._transform(_elpips.apply_transform(pred, d)),
                    self._transform(_elpips.apply_transform(gt, d)))
            loss = total / self.n_samples
        return loss if keep_batch else loss.mean()


def parse_loss_and_weight(weight_loss_str):
    """'1e+2lpips' / 'l1' / '10barron' -> (name, weight): the longest
    prefix that parses as a float is the weight."""
    for i in range(len(weight_loss_str), -1, -1):
        try:
            weight = float(weight_loss_str[:i])
        except ValueError:
            continue
        return weight_loss_str[i:], weight
    return weight_loss_str, 1.0


def build_losses(loss_str, config=None, imh=None, imw=None):
    """[(weight, loss)] from a comma-separated spec like
    'barron,1e+0lpips'."""
    wloss = []
    for part in loss_str.split(","):
        name, weight = parse_loss_and_weight(part.strip())
        if name == "lpips":
            weights_npz = max_res = None
            if config is not None and config.has("lpips_weights"):
                weights_npz = config.get_or_none("lpips_weights")
            if config is not None and config.has("lpips_max_res"):
                max_res = config.get_int("lpips_max_res")
            loss = LPIPS(per_ch=False, weights_npz=weights_npz,
                         max_res=max_res)
        elif name == "l1":
            loss = L1()
        elif name == "l2":
            loss = L2()
        elif name == "uvl2":
            loss = UVL2()
        elif name == "barron":
            if imh is None or imw is None:
                raise ValueError("Barron loss needs image dimensions")
            kw = {}
            if config is not None:
                for key, arg, get in (
                        ("barron_alpha", "alpha", config.get_float),
                        ("barron_scale", "scale", config.get_float),
                        ("barron_alpha_lo", "alpha_lo", config.get_float),
                        ("barron_alpha_hi", "alpha_hi", config.get_float),
                        ("barron_scale_lo", "scale_lo", config.get_float),
                        ("wavelet_scale_base", "wavelet_scale_base",
                         config.get_float),
                        ("wavelet_num_levels", "wavelet_num_levels",
                         config.get_int)):
                    if config.has(key):
                        kw[arg] = get(key)
            loss = Barron(imw, imh, **kw)
        elif name == "ssim":
            loss = SSIM(1.0)
        elif name == "elpips":
            kw = {}
            if config is not None:
                for key, arg, get in (
                        ("lpips_weights", "weights_npz", config.get_or_none),
                        ("lpips_max_res", "max_res", config.get_int),
                        ("elpips_samples", "n_samples", config.get_int)):
                    if config.has(key):
                        kw[arg] = get(key)
            loss = ELPIPS(**kw)
        else:
            raise NotImplementedError(name)
        wloss.append((weight, loss))
    return wloss
