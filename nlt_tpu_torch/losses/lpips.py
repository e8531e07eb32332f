"""LPIPS perceptual loss: AlexNet features and linear heads (port of
nlt_tpu/losses/lpips.py).

- AlexNet features: 5 conv stages (64, 192, 384, 256, 256 channels),
  ReLU taps after each, 3x3 stride-2 max pooling after stages 0 and 1;
- inputs in [-1, 1] shifted and scaled per channel by LPIPS's constants;
- each tap unit-normalized across channels, squared difference, a
  non-negative 1x1 linear head per stage, spatial mean, sum over stages.

Activations and taps are NHWC and conv kernels HWIO, as in nlt_tpu; the
convolutions run as ``F.conv2d`` on NCHW views.

Weights: ``load_weights(npz_path)`` reads a converted checkpoint. Without
one, ``init_params(seed)`` builds nlt_tpu's deterministic random-feature
network, the values
``nlt_tpu.losses.lpips.init_params(jax.random.PRNGKey(seed))`` gives.
That weight set *is* the training loss, so the port optimizes the same
objective. The draws reproduce jax.random in numpy: threefry2x32 with
JAX's default (partitionable) bit layout, the [-1, 1) uniform, and
``jax.random.normal``'s sqrt(2) erfinv as XLA evaluates it in float32
(Giles' polynomial, fused multiply-adds). Its log1p is taken in
float64 and rounded, where XLA's float32 log1p can round the other way,
so about 1% of the weights differ from nlt_tpu's by 1 ulp.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

# (out_channels, kernel, stride, pad) per conv stage.
_ALEX_CFG = [
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_POOL_AFTER = {0, 1}

# Channel normalization applied to [-1, 1] inputs (public LPIPS constants).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


# ---------------------------------------------------------------------------
# jax.random in numpy: threefry2x32 keys, split and normal (float32)
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs (x1, x2)
    under key (k1, k2); uint32 arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [x1 + ks[0], x2 + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x


def _counters(n):
    """jax's iota_2x32_shape of a flat size n: (high, low) words."""
    i = np.arange(n, dtype=np.uint64)
    return ((i >> np.uint64(32)).astype(np.uint32),
            (i & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def prng_key(seed):
    """jax.random.PRNGKey(seed) as a (2,) uint32 array."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def split(key, num=2):
    """jax.random.split(key, num) (partitionable threefry)."""
    with np.errstate(over="ignore"):
        b1, b2 = _threefry2x32(key[0], key[1], *_counters(num))
    return np.stack([b1, b2], axis=1)


# XLA's float32 erf_inv: Giles' single-precision polynomials in
# w = -log1p(-x^2), for w < 5 and w >= 5.
_ERFINV_LO = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                       -4.39150654e-06, 0.00021858087, -0.00125372503,
                       -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_HI = np.array([-0.000200214257, 0.000100950558, 0.00134934322,
                       -0.00367342844, 0.00573950773, -0.0076224613,
                       0.00943887047, 1.00167406, 2.83297682], np.float32)


def _erfinv_f32(x):
    """erfinv of float32 x as XLA evaluates it (each multiply-add fused:
    the float64 product of two float32 values is exact)."""
    w = -np.log1p(-(x * x).astype(np.float64)).astype(np.float32)
    small = w < np.float32(5)
    w = np.where(small, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3)).astype(np.float32)
    p = np.where(small, _ERFINV_LO[0], _ERFINV_HI[0])
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        c = np.where(small, lo, hi).astype(np.float64)
        p = (c + p.astype(np.float64) * w).astype(np.float32)
    return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x)


def normal(key, shape):
    """jax.random.normal(key, shape, float32)."""
    size = int(np.prod(shape))
    with np.errstate(over="ignore"):
        b1, b2 = _threefry2x32(key[0], key[1], *_counters(size))
    bits = b1 ^ b2
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1)
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = np.maximum(lo, floats * (np.float32(1) - lo) + lo)
    return (np.float32(np.sqrt(2)) * _erfinv_f32(u)).reshape(shape)


@functools.lru_cache(maxsize=None)
def _random_features(seed):
    """nlt_tpu's He-init AlexNet convs for PRNGKey(seed), as numpy."""
    key = prng_key(seed)
    convs = []
    in_ch = 3
    for out_ch, k, _, _ in _ALEX_CFG:
        key, k1 = split(key)
        w = normal(k1, (k, k, in_ch, out_ch)) * np.float32(
            np.sqrt(2.0 / (k * k * in_ch)))
        w.setflags(write=False)
        convs.append(w)
        in_ch = out_ch
    return tuple(convs)


def init_params(seed=0, dtype=torch.float32):
    """Deterministic He-init AlexNet + 1/C linear heads, equal to
    nlt_tpu's init_params(jax.random.PRNGKey(seed)) (CPU tensors)."""
    params = {"convs": [], "lins": []}
    for w, (out_ch, _, _, _) in zip(_random_features(seed), _ALEX_CFG):
        params["convs"].append({"w": torch.tensor(w, dtype=dtype),
                                "b": torch.zeros(out_ch, dtype=dtype)})
        params["lins"].append(
            {"w": torch.full((out_ch,), 1.0 / out_ch, dtype=dtype)})
    return params


def load_weights(npz_path, dtype=torch.float32):
    """Converted LPIPS weights: conv{i}_w (k,k,in,out), conv{i}_b,
    lin{i}_w (C,) arrays in an .npz."""
    params = {"convs": [], "lins": []}
    with np.load(npz_path) as f:
        for i in range(len(_ALEX_CFG)):
            params["convs"].append({
                "w": torch.tensor(f["conv%d_w" % i], dtype=dtype),
                "b": torch.tensor(f["conv%d_b" % i], dtype=dtype)})
            params["lins"].append(
                {"w": torch.tensor(f["lin%d_w" % i], dtype=dtype)})
    return params


# ---------------------------------------------------------------------------
# The distance
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _input_norm(dtype, device):
    """(shift, scale) on `device`, copied there once: a copy from host
    memory in the step would wait for the device."""
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (_SHIFT, _SCALE))


def _features(params, x):
    """x: NHWC in [-1, 1]. Returns the 5 ReLU taps, NHWC."""
    if min(x.shape[1], x.shape[2]) < 32:
        raise ValueError(
            "LPIPS needs inputs >= 32 px: below that the deeper AlexNet "
            "stages have empty feature maps and the spatial mean is NaN "
            "(input %s; check imh/imw or lpips_max_res)" % (tuple(x.shape),))
    shift, scale = _input_norm(x.dtype, x.device)
    x = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    for i, ((_, _, stride, pad), conv_p) in enumerate(
            zip(_ALEX_CFG, params["convs"])):
        x = F.conv2d(x, conv_p["w"].permute(3, 2, 0, 1), conv_p["b"],
                     stride=stride, padding=pad)
        x = torch.relu(x)
        feats.append(x.permute(0, 2, 3, 1))
        if i in _POOL_AFTER:
            x = F.max_pool2d(x, 3, 2)
    return feats


def _normalize_channels(x, eps=1e-10):
    norm = torch.sqrt(torch.sum(x * x, dim=3, keepdim=True))
    return x / (norm + eps)


def features_normalized(params, img):
    """Channel-normalized AlexNet taps of an NHWC image in [-1, 1]
    (tuple of 5). For a static image they can be computed once and
    cached (gt_feats): the distance and its gradient with respect to the
    other image are unchanged."""
    return tuple(_normalize_channels(f) for f in _features(params, img))


def lpips_from_feats(params, feats0, feats1):
    """LPIPS distance between two normalized tap tuples. Returns (N,)."""
    total = 0.0
    for a, b, lin in zip(feats0, feats1, params["lins"]):
        d = (a - b) ** 2
        total = total + torch.mean(torch.sum(d * torch.relu(lin["w"]), dim=3),
                                   dim=(1, 2))
    return total


def lpips(params, img0, img1):
    """LPIPS distance between NHWC images in [-1, 1]. Returns (N,)."""
    return lpips_from_feats(params, features_normalized(params, img0),
                            features_normalized(params, img1))
