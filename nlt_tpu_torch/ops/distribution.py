r"""The probability distribution induced by the general robust loss
(port of nlt_tpu/ops/distribution.py). The NLL is

    nllfun(x, alpha, scale) = lossfun(x, alpha, scale)
                              + log(scale) + log Z(alpha)

with log Z(alpha) a cubic Hermite spline over a curved reparameterization
of alpha. The knots are nlt_tpu's (data/partition_spline.npz, a copy of
nlt_tpu/data/partition_spline.npz). ``draw_samples`` is nlt_tpu's
rejection sampler with a static number of rounds; its uniforms come from
a torch.Generator (``samples_from_uniforms`` takes them as given).
"""

import math
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

    def draw_samples(self, generator, alpha, scale, n_rounds=64):
        """Rejection-sample the distribution (Algorithm 1 of the paper),
        one sample per element of `alpha` / `scale`, over a static
        `n_rounds` rounds: the first accepted Cauchy proposal of each
        element (nlt_tpu: acceptance fails with probability < 1e-9 per
        element for alpha in [0, 4] at 64 rounds). The uniforms are drawn
        on the generator's device."""
        if alpha.shape != scale.shape:
            raise ValueError("alpha and scale must have one shape")
        shape = (n_rounds,) + tuple(alpha.shape)
        kw = {"generator": generator, "dtype": alpha.dtype,
              "device": generator.device}
        u_proposal = torch.rand(shape, **kw).clamp_min(
            torch.finfo(alpha.dtype).tiny)
        u_accept = torch.rand(shape, **kw)
        return self.samples_from_uniforms(
            alpha, scale, u_proposal.to(alpha.device),
            u_accept.to(alpha.device))

    def samples_from_uniforms(self, alpha, scale, u_proposal, u_accept):
        """draw_samples on given uniforms, (n_rounds,) + alpha.shape each:
        u_proposal in (0, 1) makes round r's Cauchy proposal, u_accept
        its acceptance test."""
        log_z = self.log_base_partition_function(alpha)
        samples = torch.zeros_like(alpha)
        accepted = torch.zeros(alpha.shape, dtype=torch.bool,
                               device=alpha.device)
        for u, v in zip(u_proposal, u_accept):
            # Cauchy proposals with the sqrt(2) standardization.
            cauchy = torch.tan(math.pi * (u - 0.5)) * math.sqrt(2.0)
            nll = self.nllfun(cauchy, alpha, 1.0)
            nll_bound = general_loss.lossfun(cauchy, 0.0, 1.0) + log_z
            accept = v <= torch.exp(nll_bound - nll)
            samples = torch.where(accept & ~accepted, cauchy, samples)
            accepted = accepted | accept
        return samples * scale
