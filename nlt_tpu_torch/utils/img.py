"""Image ops (port of nlt_tpu/utils/img.py): device ops on NHWC tensors,
and the host helpers on numpy arrays that the vis code composes with."""

import functools

import numpy as np
import torch

from . import logging as logutil

logger = logutil.Logger(loggee="utils/img")

_RGB2YUV = np.array([
    [0.299, 0.587, 0.114],
    [-0.14714119, -0.28886916, 0.43601035],
    [0.61497538, -0.51496512, -0.10001026]], dtype=np.float32).T

_YUV2RGB = np.linalg.inv(_RGB2YUV.astype(np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _yuv_matrix(inverse, dtype, device):
    """The (inverse) YUV matrix on `device`, copied there once: a copy
    from host memory in the step would wait for the device."""
    return torch.as_tensor(_YUV2RGB if inverse else _RGB2YUV, dtype=dtype,
                           device=device)


def rgb_to_yuv(x):
    """BT.601 RGB -> YUV over the last axis."""
    return x @ _yuv_matrix(False, x.dtype, x.device)


def yuv_to_rgb(x):
    return x @ _yuv_matrix(True, x.dtype, x.device)


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


def _triangle(x):
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x):
    """Keys' cubic convolution kernel (a = -0.5), x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius):
    def kernel(x):
        y = radius * torch.sin(np.pi * x) * torch.sin(np.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(
            x != 0, np.pi ** 2 * x ** 2, torch.ones_like(x)),
            torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


# jax.image.resize's methods, by the names it accepts.
_KERNELS = {"linear": _triangle, "bilinear": _triangle,
            "triangle": _triangle, "cubic": _keys_cubic,
            "bicubic": _keys_cubic, "lanczos3": _lanczos(3.0),
            "lanczos5": _lanczos(5.0)}
RESIZE_METHODS = ("nearest",) + tuple(_KERNELS)


def _weight_mat(in_size, out_size, method):
    """(in_size, out_size) weights of jax.image.resize(method=): half-pixel
    centers, the kernel widened by the downscale factor (antialiasing),
    weights renormalized over in-range taps and zeroed where the sample
    lies outside the input. Computed in float64."""
    inv_scale = 1.0 / (out_size / in_size)  # jax's rounding
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float64) + 0.5)
              * inv_scale - 0.5)
    dist = (sample[None, :]
            - torch.arange(in_size, dtype=torch.float64)[:, None]).abs()
    weights = _KERNELS[method](dist / kernel_scale)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(
        total.abs() > eps,
        weights / torch.where(total != 0, total, torch.ones_like(total)),
        torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


@functools.lru_cache(maxsize=None)
def _weight_mat_on(in_size, out_size, method, dtype, device):
    """_weight_mat in `dtype` on `device`, copied there once: a copy from
    host memory in the step would wait for the device (and cannot be
    captured in a CUDA graph)."""
    return _weight_mat(in_size, out_size, method).to(device=device,
                                                     dtype=dtype)


def _nearest_index(in_size, out_size, device):
    """jax.image.resize's nearest rule, in float32 as jax computes it."""
    pos = ((torch.arange(out_size, dtype=torch.float32, device=device) + 0.5)
           * in_size / out_size)
    return torch.floor(pos).long()


def _resize_nhwc(x, new_h, new_w, method):
    """jax.image.resize of an NHWC tensor; a dim whose size stays is not
    touched, as jax skips it."""
    h, w = x.shape[1], x.shape[2]
    if method == "nearest":
        if new_h != h:
            x = x.index_select(1, _nearest_index(h, new_h, x.device))
        if new_w != w:
            x = x.index_select(2, _nearest_index(w, new_w, x.device))
        return x
    if method not in _KERNELS:
        raise ValueError("Unknown resize method %r (one of %s)"
                         % (method, ", ".join(RESIZE_METHODS)))

    def mat(n, m):
        return _weight_mat_on(n, m, method, x.dtype, x.device)

    if new_h != h and new_w != w:
        return torch.einsum("nhwc,hH,wW->nHWc", x, mat(h, new_h),
                            mat(w, new_w))
    if new_h != h:
        return torch.einsum("nhwc,hH->nHwc", x, mat(h, new_h))
    if new_w != w:
        return torch.einsum("nhwc,wW->nhWc", x, mat(w, new_w))
    return x


def resize(x, new_h=None, new_w=None, method="linear"):
    """Resize of an NHWC tensor batch, or of an HxW[xC] image on the host
    (numpy in, float32 numpy out), equal to nlt_tpu's resize
    (jax.image.resize): method is one of RESIZE_METHODS; every method but
    nearest antialiases when it downsamples, which torch's interpolate
    does not by default. A missing side keeps the aspect ratio."""
    device_path = isinstance(x, torch.Tensor) and x.dim() == 4
    h, w = (x.shape[1], x.shape[2]) if device_path else x.shape[:2]
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
    if device_path:
        return _resize_nhwc(x, new_h, new_w, method)
    xn = torch.from_numpy(np.array(x, dtype=np.float32))
    squeeze = xn.dim() == 2
    if squeeze:
        xn = xn[:, :, None]
    out = _resize_nhwc(xn[None], new_h, new_w, method)[0].numpy()
    return out[:, :, 0] if squeeze else out


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


def vis_to_float01(x):
    """Undo pack_vis on the host: uint8 -> [0, 1] float32, float16 ->
    float32; float32 passes through."""
    x = np.asarray(x)
    if x.dtype == np.uint8:
        return x.astype(np.float32) / 255.0
    return np.asarray(x, np.float32)


_SRGB_LINEAR_THRES = 0.0031308
_SRGB_LINEAR_COEFF = 12.92
_SRGB_EXP_COEFF = 1.055
_SRGB_EXPONENT = 2.4


def linear2srgb(x):
    """Linear -> sRGB transfer for [0, 1] inputs: a tensor, or a numpy
    array on the host (the vis writer's)."""
    if not isinstance(x, torch.Tensor):
        x = np.clip(x, 0.0, 1.0)
        nonlinear = _SRGB_EXP_COEFF * (
            x ** (1.0 / _SRGB_EXPONENT)) - (_SRGB_EXP_COEFF - 1.0)
        return np.where(x <= _SRGB_LINEAR_THRES, x * _SRGB_LINEAR_COEFF,
                        nonlinear)
    x = torch.clamp(x, 0.0, 1.0)
    linear = x * _SRGB_LINEAR_COEFF
    safe_x = torch.clamp(x, min=1e-12)
    nonlinear = _SRGB_EXP_COEFF * (
        safe_x ** (1.0 / _SRGB_EXPONENT)) - (_SRGB_EXP_COEFF - 1.0)
    return torch.where(x <= _SRGB_LINEAR_THRES, linear, nonlinear)


def srgb2linear(x):
    """sRGB -> linear transfer for [0, 1] inputs (tensor or numpy)."""
    xp_where = torch.where if isinstance(x, torch.Tensor) else np.where
    x = (torch.clamp(x, 0.0, 1.0) if isinstance(x, torch.Tensor)
         else np.clip(x, 0.0, 1.0))
    linear = x / _SRGB_LINEAR_COEFF
    nonlinear = ((x + (_SRGB_EXP_COEFF - 1.0)) / _SRGB_EXP_COEFF
                 ) ** _SRGB_EXPONENT
    return xp_where(x <= _SRGB_LINEAR_THRES * _SRGB_LINEAR_COEFF,
                    linear, nonlinear)


def to_uint(x_0to1, dtype=np.uint8):
    """[0, 1] -> the integer dtype's full range, truncated (host)."""
    x = np.clip(np.asarray(x_0to1), 0, 1)
    return (x * np.iinfo(dtype).max).astype(dtype)


# ---- filtering ----

def gaussian_kernel(sigma, kernel_size=None):
    """A normalized 2-D Gaussian, kernel_size (default int(6 sigma)) taps
    a side; an even size has taps -k/2 + 1 ... k/2 (numpy, float32)."""
    if kernel_size is None:
        kernel_size = int(6 * sigma)
    x = np.arange(-kernel_size // 2 + 1.0, kernel_size // 2 + 1.0)
    xx, yy = np.meshgrid(x, x)
    k = np.exp(-(xx ** 2 + yy ** 2) / (2.0 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(x, sigma, kernel_size=None):
    """Depthwise Gaussian blur of an NHWC tensor, TF SAME padding (the
    extra pad of an even kernel after), as nlt_tpu's
    conv_general_dilated(feature_group_count=C)."""
    k = torch.as_tensor(gaussian_kernel(sigma, kernel_size), dtype=x.dtype,
                        device=x.device)
    c, size = x.shape[3], k.shape[0]
    before = (size - 1) // 2
    after = size - 1 - before
    xp = torch.nn.functional.pad(x.permute(0, 3, 1, 2),
                                 (before, after, before, after))
    y = torch.nn.functional.conv2d(xp, k.expand(c, 1, size, size), groups=c)
    return y.permute(0, 2, 3, 1)


# ---- host-side composition helpers (vis only) ----

def hconcat(img_list, out_w=None):
    """Images side by side, each resized to the first one's height."""
    total = []
    for img in img_list:
        img = np.asarray(img)
        if total and img.shape[0] != total[-1].shape[0]:
            img = resize(img, new_h=total[-1].shape[0])
        total.append(img)
    out = np.hstack(total)
    if out_w is not None:
        out = resize(out, new_w=out_w)
    return out


def rot90(img, counterclockwise=False):
    """90-degree rotation of the first two axes (tensor or numpy)."""
    k = 1 if counterclockwise else 3
    if isinstance(img, torch.Tensor):
        return torch.rot90(img, k, dims=(0, 1))
    return np.rot90(img, k=k)


def put_text(img, text, font_size_ratio=0.06, top_left_ratio=(0.05, 0.05),
             color=(1, 1, 1)):
    """Stamp text onto a uint8 or float image (PIL)."""
    from PIL import Image, ImageDraw, ImageFont
    arr = np.asarray(img)
    was_float = arr.dtype.kind == "f"
    if was_float:
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    im = Image.fromarray(arr)
    draw = ImageDraw.Draw(im)
    h, w = arr.shape[:2]
    try:
        font = ImageFont.truetype(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf",
            max(8, int(font_size_ratio * h)))
    except Exception:
        font = ImageFont.load_default()
    xy = (int(top_left_ratio[0] * w), int(top_left_ratio[1] * h))
    draw.text(xy, text, fill=tuple(int(255 * c) for c in color), font=font)
    out = np.asarray(im)
    if was_float:
        out = out.astype(np.float32) / 255.0
    return out


def embed_into(inset, img, inset_scale=0.2):
    """Paste a (PIL or array) inset into the top-right corner of `img`,
    with the inset's alpha as the mask. (nlt_tpu tests hasattr(inset,
    'size'), which a numpy array passes, so an array inset raises there;
    here it is converted.)"""
    from PIL import Image
    if not isinstance(inset, Image.Image):
        inset = Image.fromarray(np.asarray(inset))
    inset_h = int(inset_scale * img.shape[0])
    inset_w = int(inset_h / inset.size[1] * inset.size[0])
    inset = inset.resize((inset_w, inset_h))
    bg = Image.fromarray(np.asarray(img))
    mask = inset if inset.mode == "RGBA" else None
    bg.paste(inset, (bg.size[0] - inset.size[0], 0), mask)
    return np.array(bg)


def frame_image(img, rgb=(0, 0, 1), width=4):
    """A `width`-pixel border of colour `rgb` (fractions of the integer
    dtype's range) around a copy of `img`."""
    img = np.array(img)
    val = np.array(rgb, dtype=img.dtype) * np.iinfo(img.dtype).max
    img[:width], img[-width:] = val, val
    img[:, :width], img[:, -width:] = val, val
    return img
