"""The port's 2x2 stride-2 conv + bias + LeakyReLU (ops/conv_stage.py)
against nlt_tpu's Pallas kernel run in interpret mode, at the shapes of
tests/test_pallas_kernels.py: numpy inputs, weights from
elements.conv(2, o, stride=2)'s init converted to torch. On the CPU the
wrapper runs the plain version and launches nothing; the CUDA kernel is
held against the plain version on the card by chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from nlt_tpu.networks import elements
from nlt_tpu.ops.conv_stage_pallas import conv2x2s2_lrelu as jax_conv
from nlt_tpu_torch.ops import conv_stage as cs

SHAPES = [((2, 16, 32, 8), 16), ((1, 64, 64, 16), 8), ((3, 8, 8, 32), 32)]


def _inputs(shape, o, seed):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    params, _ = elements.conv(2, o, stride=2).init(jax.random.PRNGKey(seed),
                                                   shape[3])
    w = np.array(params["w"], np.float32)  # writable copies for torch
    b = np.array(params["b"], np.float32)
    return x, w, b


@pytest.mark.parametrize("slope", [0.3, 0.0])
@pytest.mark.parametrize("shape,o", SHAPES)
def test_plain_matches_interpreted_pallas(shape, o, slope):
    x, w, b = _inputs(shape, o, 0)
    want = np.asarray(jax_conv(x, w, b, negative_slope=slope,
                               interpret=True))
    cs.reset_launches()
    got = cs.conv2x2s2_lrelu(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), negative_slope=slope)
    assert cs.LAUNCHES["conv2x2s2_lrelu"] == 0  # CPU: the plain version
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, o)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_plain_matches_reference_stage_odd_channels():
    """C = 5 (which nlt_tpu's Mosaic kernel cannot tile) against
    nlt_tpu's own stage, leaky_relu(conv_k2s2(x) + b)."""
    x, w, b = _inputs((2, 6, 10, 5), 3, 1)
    layer = elements.conv(2, 3, stride=2)
    want = jax.nn.leaky_relu(layer.apply({"w": w, "b": b}, x), 0.3)
    got = cs.conv2x2s2_lrelu(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4, 2))
    w = torch.zeros((2, 2, 2, 3))
    b = torch.zeros(3)
    with pytest.raises(TypeError, match="float32"):
        cs.conv2x2s2_lrelu(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="even"):
        cs.conv2x2s2_lrelu(torch.zeros((1, 3, 4, 2)), w, b)
    with pytest.raises(ValueError, match="w \\(2, 2, 2, O\\)"):
        cs.conv2x2s2_lrelu(x, torch.zeros((2, 2, 3, 3)), b)
    with pytest.raises(ValueError, match="no kernel"):
        cs.conv2x2s2_lrelu(x.to("meta"), w.to("meta"), b.to("meta"))
