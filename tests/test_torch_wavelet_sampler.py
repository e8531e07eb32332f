"""nlt_tpu_torch's wavelet collapse and visualize and the robust
distribution's rejection sampler against nlt_tpu's on the same inputs:
collapse(construct(x)) and the collapse of nlt_tpu's own pyramid,
visualize's uint8 picture, and draw_samples with nlt_tpu's uniforms fed
in."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu.ops import distribution as jdist
from nlt_tpu.ops import wavelet as jwav
from nlt_tpu_torch.ops import distribution as tdist
from nlt_tpu_torch.ops import wavelet as twav

# float32 band-matrix products against nlt_tpu's 1-D convolutions: the
# same terms, summed in another order, through a few levels.
TOL = 1e-5
# The sampler: the NLL spline and a tan per round, float32.
SAMPLE_TOL = 1e-6


def _pyr_to_torch(pyr):
    return tuple(tuple(torch.from_numpy(np.array(b)) for b in lvl)
                 if isinstance(lvl, tuple) else torch.from_numpy(np.array(lvl))
                 for lvl in pyr)


@pytest.mark.parametrize("wavelet_type", ["CDF9/7", "LeGall5/3"])
@pytest.mark.parametrize("shape,levels", [((2, 32, 40), 5), ((1, 37, 53), 4),
                                          ((3, 16, 16), 3)])
def test_collapse_matches(rng, wavelet_type, shape, levels):
    """collapse inverts construct (float64: to 1e-9, as nlt_tpu's own
    test holds it), and collapses nlt_tpu's float32 pyramid as nlt_tpu
    does, odd sizes included."""
    x = rng.standard_normal(shape)
    rec = twav.collapse(twav.construct(torch.from_numpy(x), levels,
                                       wavelet_type), wavelet_type)
    np.testing.assert_allclose(rec.numpy(), x, atol=1e-9)
    x32 = jnp.asarray(x, jnp.float32)
    jpyr = jwav.construct(x32, levels, wavelet_type)
    want = jwav.collapse(jpyr, wavelet_type)
    got = twav.collapse(_pyr_to_torch(jpyr), wavelet_type)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_collapse_gradient_matches(rng):
    """collapse is linear; its gradient (the transposed operator) with
    respect to every band, against nlt_tpu's."""
    x = jnp.asarray(rng.standard_normal((2, 24, 20)), jnp.float32)
    jpyr = jwav.construct(x, 3, "CDF9/7")
    g = rng.uniform(-1, 1, (2, 24, 20)).astype(np.float32)
    jg = jax.grad(lambda p: jnp.sum(jwav.collapse(p, "CDF9/7") * g))(jpyr)
    tpyr = tuple(tuple(b.requires_grad_() for b in lvl)
                 if isinstance(lvl, tuple) else lvl.requires_grad_()
                 for lvl in _pyr_to_torch(jpyr))
    (twav.collapse(tpyr, "CDF9/7") * torch.from_numpy(g)).sum().backward()
    flat_t = [b.grad for lvl in tpyr[:-1] for b in lvl] + [tpyr[-1].grad]
    flat_j = [b for lvl in jg[:-1] for b in lvl] + [jg[-1]]
    for t, j in zip(flat_t, flat_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL,
                                   rtol=TOL)
    with pytest.raises(ValueError):
        twav._upsample(torch.zeros(1, 4, 5), (8, 6), np.ones(3), 0, 0)


@pytest.mark.parametrize("percentile", [99.0, 50.0, 87.5])
def test_visualize_matches(rng, percentile):
    """The uint8 picture of nlt_tpu's pyramid, equal. The band scale is a
    value of the band itself (nearest-rank percentile), so both packages
    divide the same float32 numbers; float64 inputs as in nlt_tpu's
    golden test."""
    for dtype in (np.float64, np.float32):
        x = jnp.asarray(rng.standard_normal((2, 40, 36)), dtype)
        jpyr = jwav.construct(x, 4, "CDF9/7")
        want = np.asarray(jwav.visualize(jpyr, percentile))
        got = twav.visualize(_pyr_to_torch(jpyr), percentile)
        assert got.dtype == torch.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_percentile_nearest_matches_jnp():
    """The rank nlt_tpu's compiled jnp.percentile(method='nearest') picks,
    for every size up to 40 at ten percentiles: ties fall down (rank 1.5
    of 4 values -> 1) or up (rank 3.5 of 8 -> 4) as XLA's refolded
    float64 constants put them."""
    for n in range(1, 41):
        x = torch.arange(float(n)).flip(0)
        for q in (0.0, 1.0, 10.0, 12.5, 25.0, 33.0, 50.0, 75.0, 87.5, 99.0):
            assert float(twav._percentile_nearest(x, q)) == float(
                jnp.percentile(jnp.asarray(x.numpy()), q,
                               method="nearest")), (n, q)


def _jax_uniforms(key, n_rounds, shape, dtype=jnp.float32):
    """The uniforms nlt_tpu's draw_samples draws from `key`."""
    u_prop, u_acc = [], []
    for k in jax.random.split(key, n_rounds):
        k1, k2 = jax.random.split(k)
        u_prop.append(np.asarray(jax.random.uniform(
            k1, shape, dtype=dtype, minval=jnp.finfo(dtype).tiny,
            maxval=1.0)))
        u_acc.append(np.asarray(jax.random.uniform(k2, shape, dtype=dtype)))
    return np.stack(u_prop), np.stack(u_acc)


def test_draw_samples_matches_with_nlt_tpu_uniforms(rng):
    alpha = rng.uniform(0, 3, 200).astype(np.float32)
    scale = rng.uniform(0.5, 2, 200).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jdist.Distribution().draw_samples(
        key, jnp.asarray(alpha), jnp.asarray(scale), n_rounds=16)
    u_prop, u_acc = _jax_uniforms(key, 16, (200,))
    got = tdist.Distribution().samples_from_uniforms(
        torch.from_numpy(alpha), torch.from_numpy(scale),
        torch.from_numpy(u_prop), torch.from_numpy(u_acc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=SAMPLE_TOL, atol=SAMPLE_TOL)


def test_draw_samples_moments():
    """The port's own draws (nlt_tpu's moment tests): alpha = 2 is a
    normal of std `scale`, alpha = 0 a Cauchy of IQR 2 sqrt(2) scale;
    one generator seed, one draw."""
    d = tdist.Distribution()
    n = 20000
    s = d.draw_samples(torch.Generator().manual_seed(0),
                       torch.full((n,), 2.0), torch.full((n,), 1.0))
    assert abs(float(s.std()) - 1.0) < 0.05 and abs(float(s.mean())) < 0.05
    c = d.draw_samples(torch.Generator().manual_seed(1), torch.zeros(n),
                       torch.ones(n)).numpy()
    q25, q75 = np.percentile(c, [25, 75])
    np.testing.assert_allclose(q75 - q25, 2 * np.sqrt(2.0), rtol=0.08)
    again = d.draw_samples(torch.Generator().manual_seed(0),
                           torch.full((n,), 2.0), torch.full((n,), 1.0))
    assert torch.equal(s, again)
    with pytest.raises(ValueError):
        d.draw_samples(torch.Generator(), torch.zeros(3), torch.ones(4))
