"""nlt_tpu_torch's SSIM and E-LPIPS (losses and metrics) against
nlt_tpu's on the same numpy inputs and the same LPIPS weights. E-LPIPS
draws its transforms from another random stream than nlt_tpu, so the
port is held against nlt_tpu with nlt_tpu's own draws: `jax_draws`
repeats random_transform's jax.random calls for a key and hands the
values to the port as elpips.Draw."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu import losses as jlosses
from nlt_tpu import metrics as jmetrics
from nlt_tpu.losses import elpips as jelpips
from nlt_tpu.losses import ssim as jssim
from nlt_tpu.utils.config import Config as JConfig
from nlt_tpu_torch import losses as tlosses
from nlt_tpu_torch import metrics as tmetrics
from nlt_tpu_torch.losses import elpips as telpips
from nlt_tpu_torch.losses import ssim as tssim
from nlt_tpu_torch.utils.config import Config as TConfig

# SSIM: float32 window sums of 121 products, then ratios.
TOL = 1e-5
# E-LPIPS: the AlexNet's float32 chain, relative.
ELPIPS_RTOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def draw_of(key, square):
    """The draw of nlt_tpu's random_transform(key, ...): its jax.random
    calls, repeated."""
    k_shift, k_flip, k_perm, k_scale = jax.random.split(key, 4)
    oy, ox = jax.random.randint(k_shift, (2,), 0, jelpips._MAX_SHIFT)
    fx, fy, ft = jax.random.bernoulli(k_flip, 0.5, (3,))
    perm = jax.random.randint(k_perm, (), 0, len(jelpips._PERMS))
    scale = jax.random.uniform(k_scale, (), dtype=jnp.float32, minval=0.8,
                               maxval=1.0)
    return telpips.Draw(int(oy), int(ox), bool(fx), bool(fy),
                        bool(ft) and square, int(perm), float(scale))


def jax_draws(key, n_samples, square):
    """nlt_tpu's draws of an ELPIPS call with `key`: sample i is
    random_transform(fold_in(key, i), ...)."""
    return [draw_of(jax.random.fold_in(key, i), square)
            for i in range(n_samples)]


def _imgs(rng, n=2, h=24, w=24, c=3):
    return (rng.uniform(0, 1, (n, h, w, c)).astype(np.float32),
            rng.uniform(0, 1, (n, h, w, c)).astype(np.float32))


def test_ssim_matches(rng):
    """Per image, float32, with another dynamic range and filter too;
    the gradient with respect to the second image."""
    a, b = _imgs(rng, n=3, h=20, w=27)
    for kw in ({}, {"max_val": 2.0, "filter_size": 7, "filter_sigma": 1.0}):
        want = jssim.ssim(jnp.asarray(a), jnp.asarray(b), **kw)
        got = tssim.ssim(torch.from_numpy(a), torch.from_numpy(b), **kw)
        assert got.shape == want.shape == (3,)
        _close(got, want)
    jg = jax.grad(lambda y: jnp.sum(jssim.ssim(jnp.asarray(a), y)))(
        jnp.asarray(b))
    tb = torch.from_numpy(b).requires_grad_()
    tssim.ssim(torch.from_numpy(a), tb).sum().backward()
    _close(tb.grad, jg)
    np.testing.assert_allclose(
        _np(tssim.ssim(torch.from_numpy(a), torch.from_numpy(a))), 1.0,
        rtol=1e-6)
    with pytest.raises(ValueError):
        tssim.ssim(torch.zeros(1, 16, 16, 3), torch.zeros(1, 16, 15, 3))


@pytest.mark.parametrize("keep_batch", [False, True])
def test_ssim_loss_matches(rng, keep_batch):
    """(1 - SSIM) / 2 with and without alpha weights, and its gradient."""
    (_, jl), = jlosses.build_losses("ssim")
    (_, tl), = tlosses.build_losses("ssim")
    gt, pred = _imgs(rng)
    alpha = rng.uniform(0, 1, (2, 24, 24, 1)).astype(np.float32)
    for w in (None, alpha):
        jw = None if w is None else jnp.asarray(w)
        tw = None if w is None else torch.from_numpy(w)
        want = jl({}, jnp.asarray(gt), jnp.asarray(pred),
                  keep_batch=keep_batch, weights=jw)
        jg = jax.grad(lambda p: jnp.sum(jl({}, jnp.asarray(gt), p,
                                           keep_batch=keep_batch,
                                           weights=jw)))(jnp.asarray(pred))
        tp = torch.from_numpy(pred).requires_grad_()
        got = tl({}, torch.from_numpy(gt), tp, keep_batch=keep_batch,
                 weights=tw)
        got.sum().backward()
        _close(got, want)
        _close(tp.grad, jg)


def test_ssim_and_lpips_metrics_match(rng):
    """The metrics on HWC numpy images (and HW for SSIM), and on tensors,
    which stay on their device."""
    a, b = rng.uniform(0, 1, (2, 40, 36, 3)).astype(np.float32)
    js, ts = jmetrics.SSIM(), tmetrics.SSIM()
    for x, y in ((a, b), (a[..., 0], b[..., 0]), (a, a)):
        np.testing.assert_allclose(ts(x, y), js(x, y), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(ts(torch.from_numpy(a), torch.from_numpy(b)),
                               js(a, b), rtol=TOL, atol=TOL)
    assert isinstance(ts(a, b), float)
    jl, tl = jmetrics.LPIPS(seed=0), tmetrics.LPIPS(seed=0)
    # nlt_tpu's random-feature weights, reproduced to 1 ulp (test_torch_
    # losses.py): 1e-4 relative over the AlexNet.
    np.testing.assert_allclose(tl(a, b), jl(a, b), rtol=1e-4)
    np.testing.assert_allclose(tl(torch.from_numpy(a), b), jl(a, b),
                               rtol=1e-4)
    assert tl(a, a) == 0.0


def _key_with(kind, square=True, n_keys=200):
    """The first key whose draw exercises `kind`."""
    tests = {
        "shift": lambda d: d.oy > 0 and d.ox > 0,
        "flip_x": lambda d: d.fx and not d.fy,
        "flip_y": lambda d: d.fy and not d.fx,
        "transpose": lambda d: d.ft,
        "perm": lambda d: d.perm == 4,
        "identity_perm": lambda d: d.perm == 0,
    }
    for seed in range(n_keys):
        key = jax.random.PRNGKey(seed)
        d = draw_of(key, square)
        if kind == "non_square":
            if draw_of(key, True).ft:  # drawn, and must not apply
                return key, d
        elif tests[kind](d):
            return key, d
    raise AssertionError("no key for %s" % kind)


@pytest.mark.parametrize("kind", ["shift", "flip_x", "flip_y", "transpose",
                                  "perm", "identity_perm", "non_square"])
def test_transform_matches_random_transform(rng, kind):
    """apply_transform with nlt_tpu's draw gives nlt_tpu's
    random_transform of both images exactly (crops, flips, transposes,
    channel gathers and one float32 product)."""
    square = kind != "non_square"
    img0, img1 = _imgs(rng, h=24, w=24 if square else 20)
    key, d = _key_with(kind, square)
    w0, w1 = jelpips.random_transform(key, jnp.asarray(img0),
                                      jnp.asarray(img1))
    g0 = telpips.apply_transform(torch.from_numpy(img0), d)
    g1 = telpips.apply_transform(torch.from_numpy(img1), d)
    np.testing.assert_array_equal(_np(g0), np.asarray(w0))
    np.testing.assert_array_equal(_np(g1), np.asarray(w1))
    with pytest.raises(ValueError):
        telpips.apply_transform(torch.zeros(1, 8, 16, 3), d)


def test_draw_transform_covers_the_family():
    """The port's draws: offsets in [0, 8), each flip and transpose both
    ways, every permutation, scales in [0.8, 1.0]; no transpose of a
    non-square image; one generator seed, one sequence."""
    g = torch.Generator().manual_seed(5)
    draws = [telpips.draw_transform(g, True) for _ in range(300)]
    assert {d.oy for d in draws} == set(range(8)) == {d.ox for d in draws}
    assert {d.perm for d in draws} == set(range(6))
    for f in ("fx", "fy", "ft"):
        assert {getattr(d, f) for d in draws} == {False, True}
    assert all(0.8 <= d.scale <= 1.0 for d in draws)
    g = torch.Generator().manual_seed(5)
    assert [telpips.draw_transform(g, True) for _ in range(300)] == draws
    assert not any(telpips.draw_transform(g, False).ft for _ in range(50))


def _elpips_pair(n_samples):
    cfg = {"loss": "elpips", "elpips_samples": str(n_samples),
           "lpips_weights": "none"}
    (_, jl), = jlosses.build_losses("elpips", config=JConfig(cfg))
    (_, tl), = tlosses.build_losses("elpips", config=TConfig(cfg))
    jp = jl.init_params()
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jl, jp, tl, tp


@pytest.mark.parametrize("n_samples", [1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_elpips_matches_with_nlt_tpu_draws(rng, n_samples, weighted):
    """Value per image and the gradient with respect to the prediction,
    nlt_tpu's draws for the key handed to the port; the port's own draws
    from a generator give a finite loss of the same shape, the same twice
    from one seed."""
    jl, jp, tl, tp = _elpips_pair(n_samples)
    assert tl.n_samples == n_samples and tl.stochastic
    assert not tl.cacheable_gt
    gt, pred = _imgs(rng, h=40, w=40)
    w = rng.uniform(0, 1, (2, 40, 40, 1)).astype(np.float32) \
        if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    key = jax.random.PRNGKey(11)
    draws = jax_draws(key, n_samples, True)
    want = jl(jp, jnp.asarray(gt), jnp.asarray(pred), keep_batch=True,
              weights=jw, key=key)
    jg = jax.grad(lambda p: jnp.sum(jl(jp, jnp.asarray(gt), p,
                                       keep_batch=True, weights=jw,
                                       key=key)))(jnp.asarray(pred))
    tpred = torch.from_numpy(pred).requires_grad_()
    got = tl(tp, torch.from_numpy(gt), tpred, keep_batch=True, weights=tw,
             draws=draws)
    got.sum().backward()
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=ELPIPS_RTOL)
    scale = float(np.abs(np.asarray(jg)).max())
    np.testing.assert_allclose(_np(tpred.grad) / scale,
                               np.asarray(jg) / scale, atol=1e-4)
    own = [tl(tp, torch.from_numpy(gt), torch.from_numpy(pred),
              generator=torch.Generator().manual_seed(3)) for _ in range(2)]
    assert torch.equal(own[0], own[1]) and bool(torch.isfinite(own[0]))
    # No generator: the loss's fixed seed (evaluation).
    assert torch.equal(tl(tp, torch.from_numpy(gt), torch.from_numpy(pred)),
                       tl(tp, torch.from_numpy(gt), torch.from_numpy(pred)))
    with pytest.raises(ValueError):
        tl(tp, torch.from_numpy(gt), torch.from_numpy(pred),
           draws=draws + draws)


def test_elpips_lpips_max_res_matches(rng):
    """lpips_max_res downsamples the transformed images before the
    AlexNet, as in nlt_tpu."""
    cfg = {"loss": "elpips", "lpips_max_res": "32"}
    (_, jl), = jlosses.build_losses("elpips", config=JConfig(cfg))
    (_, tl), = tlosses.build_losses("elpips", config=TConfig(cfg))
    assert tl.max_res == 32
    jp = jl.init_params()
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    gt, pred = _imgs(rng, n=1, h=64, w=64)
    key = jax.random.PRNGKey(4)
    want = jl(jp, jnp.asarray(gt), jnp.asarray(pred), key=key)
    got = tl(tp, torch.from_numpy(gt), torch.from_numpy(pred),
             draws=jax_draws(key, 1, True))
    np.testing.assert_allclose(float(got), float(want), rtol=ELPIPS_RTOL)
