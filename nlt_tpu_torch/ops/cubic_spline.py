"""1-D cubic Hermite spline interpolation with linear extrapolation
(port of nlt_tpu/ops/cubic_spline.py). Knot x-coordinates are
implicitly [0, 1, ..., len(values)-1]."""

import torch


def interpolate1d(x, values, tangents):
    """Evaluate the spline at `x` (any shape); `values`/`tangents` are 1-D
    knot tensors of equal length. Queries outside [0, n-1] extrapolate
    linearly with the boundary tangents."""
    if values.dim() != 1 or values.shape != tangents.shape:
        raise ValueError("values and tangents must be 1-D of equal length")
    n = values.shape[0]
    x_lo = torch.floor(torch.clamp(x, 0.0, n - 2)).to(torch.int64)
    x_hi = x_lo + 1

    t = x - x_lo.to(x.dtype)
    t_sq = t * t
    t_cu = t * t_sq
    h01 = -2.0 * t_cu + 3.0 * t_sq
    h00 = 1.0 - h01
    h11 = t_cu - t_sq
    h10 = h11 - t_sq + t

    value_before = tangents[0] * t + values[0]
    value_after = tangents[-1] * (t - 1.0) + values[-1]
    value_mid = (values[x_lo] * h00 + values[x_hi] * h01
                 + tangents[x_lo] * h10 + tangents[x_hi] * h11)
    return torch.where(t < 0.0, value_before,
                       torch.where(t > 1.0, value_after, value_mid))
