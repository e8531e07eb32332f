"""Where the reference rounds: nowhere (float32); for the control, to
float8 at every point where the configuration's compute dtype
(bfloat16) rounds: each U-Net layer's input and weights in the forward,
and the gradient that flows back through them; and, for a look at what
the configuration's own precision gives, to bfloat16 at those points.

float8 rounding is per tensor scaled, as float8 training recipes scale
it: the tensor is divided by amax / fmax (the format's largest finite
value), rounded and scaled back, so nothing saturates or underflows
wholesale. The forward rounds to e4m3, the gradient to e5m2 (the usual
split of the two formats). Products are summed in float32.
"""

import contextlib

import torch

FMAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(t, fmt):
    amax = t.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FMAX[fmt], torch.ones_like(amax))
    return (t / scale).to(fmt).to(t.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _round(t, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2)


def fp8_round(t):
    """t rounded to float8 e4m3 (its gradient to e5m2), in float32."""
    return _Fp8.apply(t)


class _Bf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


def bf16_round(t):
    """t (and its gradient) rounded to bfloat16, in float32."""
    return _Bf16.apply(t)


ROUNDINGS = {"float32": None, "bfloat16": bf16_round, "fp8": fp8_round}


@contextlib.contextmanager
def no_tf32():
    """float32 products summed in float32 (torch's cuDNN default would
    take TF32 for convolutions)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
