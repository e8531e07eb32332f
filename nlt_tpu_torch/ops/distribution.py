r"""The probability distribution induced by the general robust loss
(port of nlt_tpu/ops/distribution.py). The NLL is

    nllfun(x, alpha, scale) = lossfun(x, alpha, scale)
                              + log(scale) + log Z(alpha)

with log Z(alpha) a cubic Hermite spline over a curved reparameterization
of alpha. The knots are nlt_tpu's (data/partition_spline.npz, a copy of
nlt_tpu/data/partition_spline.npz). nlt_tpu's rejection sampler
(``draw_samples``, jax.random) is not ported: no training path uses it.
"""

import os

import numpy as np
import torch

from . import cubic_spline, general_loss, safe_math

_SPLINE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "partition_spline.npz")


def partition_spline_curve(alpha):
    """Curved alpha reparameterization: roughly linear on [0, 4] with extra
    resolution near alpha=2, logarithmic beyond. Continuously
    differentiable."""
    return torch.where(
        alpha < 4,
        (2.25 * alpha - 4.5) / (torch.abs(alpha - 2) + 0.25) + alpha + 2,
        5.0 / 18.0 * safe_math.log_safe(4 * alpha - 15) + 8)


def inv_partition_spline_curve(x):
    """Inverse of partition_spline_curve, guarded so both branches stay
    finite for any non-negative input."""
    x_lo = torch.clamp(x, max=8.0)
    branch_lo = 0.5 * x_lo + torch.where(
        x_lo <= 4,
        1.25 - torch.sqrt(torch.clamp(1.5625 - x_lo + 0.25 * x_lo ** 2,
                                      min=0.0)),
        -1.25 + torch.sqrt(torch.clamp(9.5625 - 3.0 * x_lo
                                       + 0.25 * x_lo ** 2, min=0.0)))
    branch_hi = 3.75 + 0.25 * safe_math.exp_safe(x * 3.6 - 28.8)
    return torch.where(x < 8, branch_lo, branch_hi)


def numerical_base_partition_function(alpha):
    """Z(alpha) by numerical integration (float64, on the host)."""
    from scipy import integrate

    alpha = float(alpha)
    if alpha == 0:
        return np.pi * np.sqrt(2)
    if alpha == 2:
        return np.sqrt(2 * np.pi)

    def rho(x):
        # Exact general loss in float64 (scale=1), in log space so huge
        # alphas cannot overflow the pow.
        b = abs(alpha - 2.0)
        d = alpha if alpha >= 0 else -max(1e-300, abs(alpha))
        log_term = 0.5 * alpha * np.log1p(x * x / b)
        return (b / d) * np.expm1(np.minimum(log_term, 700.0))

    val, _ = integrate.quad(lambda x: np.exp(-np.minimum(rho(x), 700.0)),
                            0, np.inf, limit=400)
    return 2.0 * val


class Distribution:
    """Evaluates the NLL of the general robust distribution."""

    def __init__(self, spline_path=_SPLINE_PATH):
        with np.load(spline_path, allow_pickle=False) as f:
            self._spline_x_scale = float(f["x_scale"])
            self._spline_values = np.array(f["values"])
            self._spline_tangents = np.array(f["tangents"])
        self._knots = {}  # (dtype, device) -> (values, tangents)

    def _knots_for(self, dtype, device):
        key = (dtype, device)
        if key not in self._knots:
            self._knots[key] = tuple(
                torch.as_tensor(a, dtype=dtype, device=device)
                for a in (self._spline_values, self._spline_tangents))
        return self._knots[key]

    def log_base_partition_function(self, alpha):
        """Spline approximation of log Z(alpha), alpha >= 0."""
        x = partition_spline_curve(alpha)
        values, tangents = self._knots_for(alpha.dtype, alpha.device)
        return cubic_spline.interpolate1d(x * self._spline_x_scale, values,
                                          tangents)

    def nllfun(self, x, alpha, scale):
        """-log p(x | 0, alpha, scale). Requires alpha >= 0 and scale > 0
        (not checked). The spline runs on alpha's own shape (typically
        (1, C)) and the sum broadcasts."""
        loss = general_loss.lossfun(x, alpha, scale, approximate=False)
        alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
        log_partition = (torch.log(scale)
                         + self.log_base_partition_function(alpha))
        return loss + log_partition.to(x.dtype).expand(x.shape)
