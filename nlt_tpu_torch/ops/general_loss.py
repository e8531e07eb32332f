r"""The general robust loss rho(x, alpha, scale) of "A General and
Adaptive Robust Loss Function" (Barron, arXiv:1701.03077); port of
nlt_tpu/ops/general_loss.py, with its special cases
alpha in {-inf, 0, 2, +inf} and its guarded general branch.
Elementwise and dtype-preserving; alpha and scale broadcast against x.
"""

import numpy as np
import torch

from . import safe_math


def _like(v, x):
    return torch.as_tensor(v, dtype=x.dtype, device=x.device).expand(x.shape)


def lossfun(x, alpha, scale, approximate=False, epsilon=1e-6):
    alpha = _like(alpha, x)
    scale = _like(scale, x)

    if approximate:
        # Fast approximate form; inaccurate as x and alpha approach zero.
        if not epsilon > np.finfo(np.float32).eps:
            raise ValueError("epsilon must exceed float32 eps")
        b = torch.abs(alpha - 2.0) + epsilon
        d = torch.where(alpha >= 0.0, alpha + epsilon, alpha - epsilon)
        return (b / d) * (torch.pow((x / scale) ** 2 / b + 1.0, 0.5 * d)
                          - 1.0)

    squared_scaled_x = (x / scale) ** 2

    loss_two = 0.5 * squared_scaled_x
    loss_zero = safe_math.log1p_safe(0.5 * squared_scaled_x)
    loss_neginf = -torch.expm1(-0.5 * squared_scaled_x)
    loss_posinf = safe_math.expm1_safe(0.5 * squared_scaled_x)

    # General branch, guarded so that division and pow stay finite at the
    # special-case alphas too: the untaken branch of a where() must stay
    # finite or its gradient turns 0 * inf into NaN.
    eps = float(np.finfo(np.float32).eps)
    alpha_fin = torch.where(torch.isfinite(alpha), alpha,
                            torch.ones_like(alpha))
    beta_safe = torch.clamp(torch.abs(alpha_fin - 2.0), min=eps)
    alpha_safe = torch.where(alpha_fin >= 0.0, torch.ones_like(alpha),
                             -torch.ones_like(alpha)) * torch.clamp(
                                 torch.abs(alpha_fin), min=eps)
    loss_otherwise = (beta_safe / alpha_safe) * (
        torch.pow(squared_scaled_x / beta_safe + 1.0, 0.5 * alpha_fin) - 1.0)

    inf = float("inf")
    return torch.where(
        alpha == -inf, loss_neginf,
        torch.where(
            alpha == 0.0, loss_zero,
            torch.where(
                alpha == 2.0, loss_two,
                torch.where(alpha == inf, loss_posinf, loss_otherwise))))
