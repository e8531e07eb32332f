"""Numerically safe scalar math used by the robust loss (port of
nlt_tpu/ops/safe_math.py). Elementwise and dtype-preserving."""

import math

import torch


def log_safe(x):
    """log(x) with the input clamped to avoid inf -> nan in gradients."""
    return torch.log(torch.clamp(x, max=3e37))


def log1p_safe(x):
    return torch.log1p(torch.clamp(x, max=3e37))


def exp_safe(x):
    return torch.exp(torch.clamp(x, max=87.5))


def expm1_safe(x):
    return torch.expm1(torch.clamp(x, max=87.5))


def inv_softplus(y):
    """Inverse of softplus; linear passthrough above 87.5."""
    return torch.where(y > 87.5, y,
                       torch.log(torch.expm1(torch.clamp(y, max=87.5))))


def logit(y):
    return -torch.log(1.0 / y - 1.0)


def affine_sigmoid(real, lo=0.0, hi=1.0):
    """Maps reals to (lo, hi); 0 maps to (lo+hi)/2."""
    if not lo < hi:
        raise ValueError("`lo` (%g) must be < `hi` (%g)" % (lo, hi))
    return torch.sigmoid(real) * (hi - lo) + lo


def inv_affine_sigmoid(alpha, lo=0.0, hi=1.0):
    if not lo < hi:
        raise ValueError("`lo` (%g) must be < `hi` (%g)" % (lo, hi))
    return logit((alpha - lo) / (hi - lo))


def affine_softplus(real, lo=0.0, ref=1.0):
    """Maps reals to (lo, inf); 0 maps to ref."""
    if not lo < ref:
        raise ValueError("`lo` (%g) must be < `ref` (%g)" % (lo, ref))
    shift = inv_softplus(torch.ones((), dtype=real.dtype, device=real.device))
    return (ref - lo) * torch.nn.functional.softplus(real + shift) + lo


def inv_affine_softplus(scale, lo=0.0, ref=1.0):
    if not lo < ref:
        raise ValueError("`lo` (%g) must be < `ref` (%g)" % (lo, ref))
    shift = inv_softplus(torch.ones((), dtype=scale.dtype,
                                    device=scale.device))
    return inv_softplus((scale - lo) / (ref - lo)) - shift


def students_t_nll(x, df, scale):
    """NLL of a generalized Student's t-distribution."""
    return (0.5 * ((df + 1.0) * torch.log1p((x / scale) ** 2.0 / df)
                   + torch.log(df))
            + torch.log(torch.abs(scale))
            + torch.lgamma(0.5 * df) - torch.lgamma(0.5 * df + 0.5)
            + 0.5 * math.log(math.pi))
