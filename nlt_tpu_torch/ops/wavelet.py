"""CDF9/7 and LeGall5/3 wavelet pyramids for the Barron image loss (port
of nlt_tpu/ops/wavelet.py: ``construct`` and its inverse ``collapse``,
``rescale``, ``flatten`` and the uint8 ``visualize``).

Boundary handling is nlt_tpu's unbounded *reflecting* padding. As in
nlt_tpu, each reflect-pad + K-tap correlation + decimation by 2 along
one axis is a static dense band matrix (built in numpy, float64, once
per axis length, filter and shift) applied as a matmul, so the pyramid
is a chain of small products whose autograd transpose is the exact
transposed-reflecting operator. ``collapse``'s undecimate + crop or
pad + reflect-pad + K-tap correlation along one axis is such a matrix
too. Inputs are (N, H, W) stacks.
"""

import collections
import functools
import math

import numpy as np
import torch

Filters = collections.namedtuple(
    "Filters", ["analysis_lo", "analysis_hi", "synthesis_lo", "synthesis_hi"])

HalfFilters = collections.namedtuple("HalfFilters", ["lo", "hi"])

# Non-redundant halves of the filter banks; center tap first, symmetrized
# by mirroring (CDF 9/7 from Cohen et al. 1992; LeGall 5/3).
_HALF_FILTERS = {
    "CDF9/7": HalfFilters(
        lo=np.array([
            +0.852698679009,
            +0.377402855613,
            -0.110624404418,
            -0.023849465020,
            +0.037828455507,
        ]),
        hi=np.array([
            +0.788485616406,
            -0.418092273222,
            -0.040689417609,
            +0.064538882629,
        ])),
    "LeGall5/3": HalfFilters(
        lo=np.array([0.75, 0.25, -0.125]) * np.sqrt(2.0),
        hi=np.array([1.0, -0.5]) / np.sqrt(2.0)),
}


def generate_filters(wavelet_type=None):
    """Full analysis/synthesis filter bank for `wavelet_type`; with no
    argument, the list of supported type names."""
    if wavelet_type is None:
        return list(_HALF_FILTERS.keys())
    half = _HALF_FILTERS[wavelet_type]

    def mirror(f):
        return np.concatenate([f[-1:0:-1], f])

    def alternating_sign(n):
        return (-1.0) ** np.arange(n)

    analysis_lo = mirror(half.lo)
    analysis_hi = mirror(half.hi)
    # Synthesis filters follow from the biorthogonality conditions.
    synthesis_lo = analysis_hi * mirror(alternating_sign(len(half.hi)))
    synthesis_hi = analysis_lo * mirror(alternating_sign(len(half.lo)))
    return Filters(analysis_lo, analysis_hi, synthesis_lo, synthesis_hi)


def _reflect_indices(n, pad_below, pad_above):
    """Index map of unbounded reflecting padding for a length-n axis:
    reflect([A,B,C,D], 2) -> [C,B,A,B,C,D,C,B]."""
    i = np.arange(-pad_below, n + pad_above)
    period = max(1, 2 * (n - 1))
    i_mod = np.mod(i, period)
    return np.minimum(2 * (n - 1) - i_mod, i_mod).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _downsample_matrix(n, f_bytes, flen, shift):
    """Dense (m, n) float64 matrix of reflect-pad + correlate + decimate:
    y[i] = sum_k f[k] x[reflect_idx[2i + shift + k]]."""
    f = np.frombuffer(f_bytes, np.float64)
    idx = _reflect_indices(n, (flen - 1) // 2, flen // 2)
    if shift:
        idx = idx[shift:]
    m = (len(idx) - flen) // 2 + 1
    d = np.zeros((m, n))
    for i in range(m):
        for k in range(flen):
            d[i, idx[2 * i + k]] += f[k]
    d.setflags(write=False)
    return d


@functools.lru_cache(maxsize=None)
def _downsample_tensor(n, f_bytes, flen, shift, dtype, device):
    """_downsample_matrix as a tensor, copied to `device` once."""
    return torch.tensor(_downsample_matrix(n, f_bytes, flen, shift),
                        dtype=dtype, device=device)


def _downsample(x, f, direction, shift):
    """Reflect-pad, correlate with `f` and decimate by 2 along spatial
    axis `direction` (0 = rows, 1 = cols) with sub-pixel `shift`."""
    f = np.ascontiguousarray(np.asarray(f, np.float64))
    n = x.shape[direction + 1]
    d = _downsample_tensor(n, f.tobytes(), len(f), shift, x.dtype, x.device)
    if direction == 0:
        return torch.matmul(d, x)
    return torch.matmul(x, d.t())


@functools.lru_cache(maxsize=None)
def _upsample_matrix(n, want, f_bytes, flen, shift):
    """Dense (want, n) float64 matrix of nlt_tpu's _upsample along one
    axis: interleave zeros (x at the odd or even places after `shift`),
    crop or zero-pad to `want`, reflect-pad by flen // 2 before and
    (flen - 1) // 2 after, correlate with the reversed filter."""
    f = np.frombuffer(f_bytes, np.float64)[::-1]
    p = np.arange(want)
    src = np.where((p % 2 == shift) & (p // 2 < n), p // 2, -1)
    idx = _reflect_indices(want, flen // 2, (flen - 1) // 2)
    u = np.zeros((want, n))
    for i in range(want):
        for k in range(flen):
            j = src[idx[i + k]]
            if j >= 0:
                u[i, j] += f[k]
    u.setflags(write=False)
    return u


@functools.lru_cache(maxsize=None)
def _upsample_tensor(n, want, f_bytes, flen, shift, dtype, device):
    return torch.tensor(_upsample_matrix(n, want, f_bytes, flen, shift),
                        dtype=dtype, device=device)


def _upsample(x, up_sz, f, direction, shift):
    """The transpose of _downsample: to length up_sz[direction] along
    spatial axis `direction`; the other axis must already match."""
    if x.shape[2 - direction] != up_sz[1 - direction]:
        raise ValueError("shape %s does not fit %s along the other axis"
                         % (tuple(x.shape), tuple(up_sz)))
    f = np.ascontiguousarray(np.asarray(f, np.float64))
    u = _upsample_tensor(x.shape[direction + 1], up_sz[direction],
                         f.tobytes(), len(f), shift, x.dtype, x.device)
    if direction == 0:
        return torch.matmul(u, x)
    return torch.matmul(x, u.t())


def get_max_num_levels(sz):
    """Max supported pyramid depth for an (N, H, W) shape tuple."""
    min_sz = min(sz[1], sz[2])
    return int(np.ceil(np.log2(max(1, min_sz))))


def construct(im, num_levels, wavelet_type):
    """Wavelet decomposition of an (N, H, W) stack: a tuple of
    `num_levels` 3-tuples of highpass bands, then the coarsest lowpass
    residual."""
    if im.dim() != 3:
        raise ValueError("Expected (N, H, W), got %s" % (tuple(im.shape),))
    if num_levels == 0:
        return (im,)
    if num_levels > get_max_num_levels(im.shape):
        raise ValueError("num_levels=%d too deep for shape %s"
                         % (num_levels, tuple(im.shape)))
    filters = generate_filters(wavelet_type)
    pyr = []
    for _ in range(num_levels):
        hi = _downsample(im, filters.analysis_hi, 0, 1)
        lo = _downsample(im, filters.analysis_lo, 0, 0)
        pyr.append((
            _downsample(hi, filters.analysis_hi, 1, 1),
            _downsample(lo, filters.analysis_hi, 1, 1),
            _downsample(hi, filters.analysis_lo, 1, 0)))
        im = _downsample(lo, filters.analysis_lo, 1, 0)
    pyr.append(im)
    return tuple(pyr)


def collapse(pyr, wavelet_type):
    """The inverse of construct(): the (N, H, W) stack back from its
    pyramid."""
    filters = generate_filters(wavelet_type)
    im = pyr[-1]
    for d in range(len(pyr) - 2, -1, -1):
        hi_hi, hi_lo, lo_hi = pyr[d]
        up_sz = (hi_lo.shape[1] + lo_hi.shape[1],
                 lo_hi.shape[2] + hi_lo.shape[2])
        lo_sz = (im.shape[1], up_sz[1])
        hi_sz = (hi_hi.shape[1], up_sz[1])
        im = (
            _upsample(
                _upsample(im, lo_sz, filters.synthesis_lo, 1, 0)
                + _upsample(hi_lo, lo_sz, filters.synthesis_hi, 1, 1),
                up_sz, filters.synthesis_lo, 0, 0)
            + _upsample(
                _upsample(lo_hi, hi_sz, filters.synthesis_lo, 1, 0)
                + _upsample(hi_hi, hi_sz, filters.synthesis_hi, 1, 1),
                up_sz, filters.synthesis_hi, 0, 1))
    return im


def rescale(pyr, scale_base):
    """Scale level d by scale_base**d."""
    out = []
    for d in range(len(pyr) - 1):
        s = scale_base ** d
        out.append(tuple(pyr[d][b] * s for b in range(3)))
    out.append(pyr[-1] * (scale_base ** (len(pyr) - 1)))
    return out


def flatten(pyr):
    """Pack the pyramid into one image-layout tensor: residual at the
    top-left, bands nested around it."""
    flat = pyr[-1]
    for d in range(len(pyr) - 2, -1, -1):
        flat = torch.cat([
            torch.cat([flat, pyr[d][1]], dim=2),
            torch.cat([pyr[d][2], pyr[d][0]], dim=2)], dim=1)
    return flat


def _percentile_nearest(x, percentile):
    """nlt_tpu's jnp.percentile(x, percentile, method='nearest') over all
    of x: the sorted value at rank pos, rounded down at an exact half.
    pos is percentile / 100 * (n - 1) as XLA compiles it, the constants
    refolded to percentile * ((n - 1) * 0.01), in float64; that decides
    which way an exact half (such as the median of 8 values) falls."""
    s = x.flatten().sort().values
    pos = percentile * ((s.numel() - 1) * 0.01)
    lo = math.floor(pos)
    return s[lo if pos - lo <= 0.5 else math.ceil(pos)]


def visualize(pyr, percentile=99.0):
    """uint8 (H, W, N) picture of a pyramid's flatten(): each band scaled
    by its `percentile`-th magnitude into [0, 1], the residual by its
    range."""
    vis_pyr = []
    for d in range(len(pyr) - 1):
        vis_pyr.append(tuple(
            0.5 * (1.0 + (band / _percentile_nearest(band.abs(), percentile))
                   .clamp(-1.0, 1.0)) for band in pyr[d]))
    resid = pyr[-1]
    vis_pyr.append((resid - resid.min()) / (resid.max() - resid.min()))
    flat = flatten(vis_pyr)
    return torch.round(255.0 * flat.permute(1, 2, 0)).to(torch.uint8)
