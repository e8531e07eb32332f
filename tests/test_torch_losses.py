"""nlt_tpu_torch's loss ops and losses against nlt_tpu's, with gradients:
safe math, the cubic spline, the general robust loss and its NLL, sYUV
and the DCT, the CDF9/7 wavelet pyramid, the adaptive losses, LPIPS
(including the reproduction of nlt_tpu's random-feature weights) and the
loss classes; plus nlt_tpu's golden files. Inputs come from a numpy
seed and go to both packages."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu import losses as jlosses
from nlt_tpu.losses import adaptive as jadaptive
from nlt_tpu.losses import lpips as jlpips
from nlt_tpu.ops import (color as jcolor, cubic_spline as jspline,
                         distribution as jdist, general_loss as jgl,
                         safe_math as jsm, wavelet as jwav)
from nlt_tpu.utils.config import Config as JConfig
from nlt_tpu_torch import losses as tlosses
from nlt_tpu_torch.losses import adaptive as tadaptive
from nlt_tpu_torch.losses import lpips as tlpips
from nlt_tpu_torch.ops import (color as tcolor, cubic_spline as tspline,
                               distribution as tdist, general_loss as tgl,
                               safe_math as tsm, wavelet as twav)
from nlt_tpu_torch.utils.config import Config as TConfig

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
# float32 elementwise math, the same formulas: a few ulps.
TOL = 1e-5
# Deep float32 chains (wavelet pyramid, AlexNet, sums over a batch).
DEEP_TOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _value_and_grads(jfn, tfn, *arrays):
    """(value, grads) of sum(f(*arrays) * g) on both sides, g a fixed
    random cotangent."""
    y = jax.jit(jfn)(*[jnp.asarray(a) for a in arrays])
    g = np.random.RandomState(99).uniform(-1, 1, y.shape).astype(y.dtype)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a) * g),
                          argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(np.array(a)).requires_grad_() for a in arrays]
    ty = tfn(*ts)
    (ty * torch.from_numpy(g)).sum().backward()
    return (ty, y), [(t.grad, w) for t, w in zip(ts, jg)]


@pytest.mark.parametrize("name,lo,hi", [
    ("log_safe", 0.1, 5.0), ("log1p_safe", -0.5, 5.0),
    ("exp_safe", -3.0, 3.0), ("expm1_safe", -3.0, 3.0),
    ("inv_softplus", 0.1, 5.0), ("logit", 0.05, 0.95),
    ("affine_sigmoid", -4.0, 4.0), ("affine_softplus", -4.0, 4.0),
    ("inv_affine_sigmoid", 0.05, 0.95), ("inv_affine_softplus", 0.1, 4.0)])
def test_safe_math_matches(rng, name, lo, hi):
    x = rng.uniform(lo, hi, (4, 5)).astype(np.float32)
    (y, yw), grads = _value_and_grads(getattr(jsm, name),
                                      getattr(tsm, name), x)
    _close(y, yw)
    for g, w in grads:
        _close(g, w)


def test_students_t_nll_matches(rng):
    x, df, scale = (rng.uniform(-3, 3, (4, 6)).astype(np.float32),
                    rng.uniform(0.5, 4, (1, 6)).astype(np.float32),
                    rng.uniform(0.1, 2, (1, 6)).astype(np.float32))
    (y, yw), grads = _value_and_grads(jsm.students_t_nll,
                                      tsm.students_t_nll, x, df, scale)
    _close(y, yw)
    for g, w in grads:
        _close(g, w, DEEP_TOL)


def test_cubic_spline_matches(rng):
    """Queries inside, before and after the knots (extrapolation)."""
    values = rng.standard_normal(9).astype(np.float32)
    tangents = rng.standard_normal(9).astype(np.float32)
    x = rng.uniform(-2, 10, 50).astype(np.float32)
    (y, yw), grads = _value_and_grads(jspline.interpolate1d,
                                      tspline.interpolate1d, x, values,
                                      tangents)
    _close(y, yw)
    for g, w in grads:
        _close(g, w)


def test_general_loss_and_nll_match_golden():
    with np.load(os.path.join(GOLDEN, "robust_loss_golden.npz")) as f:
        args = [torch.from_numpy(f[k]) for k in ("gl_x", "gl_alpha",
                                                 "gl_scale")]
        _close(tgl.lossfun(*args), f["gl_loss"], 1e-12)
        _close(tdist.Distribution().nllfun(*args), f["nll"], 1e-10)


@pytest.mark.parametrize("approximate", [False, True])
def test_general_loss_grads_match(rng, approximate):
    """Every special alpha and the general branch, float32."""
    x = rng.uniform(-3, 3, 48).astype(np.float32)
    alpha = np.array([-np.inf, -2, 0, 1, 2, np.inf, 0.5, 3.0] * 6,
                     np.float32)
    scale = rng.uniform(0.5, 2, 48).astype(np.float32)
    if approximate:
        # |alpha - 2| has no derivative at 2 (nor the sign switch at 0):
        # the approximate form is held off those points.
        alpha = np.clip(alpha, -4, 4) + np.float32(0.01)
    (y, yw), grads = _value_and_grads(
        lambda *a: jgl.lossfun(*a, approximate=approximate),
        lambda *a: tgl.lossfun(*a, approximate=approximate),
        x, alpha, scale)
    _close(y, yw)
    for g, w in grads:
        _close(g, w, DEEP_TOL)


def test_distribution_matches(rng):
    alpha = rng.uniform(0, 10, 40).astype(np.float32)
    (y, yw), grads = _value_and_grads(
        jdist.partition_spline_curve, tdist.partition_spline_curve, alpha)
    _close(y, yw)
    x = rng.uniform(0, 12, 40).astype(np.float32)
    _close(tdist.inv_partition_spline_curve(torch.from_numpy(x)),
           jdist.inv_partition_spline_curve(jnp.asarray(x)))
    jd, td = jdist.Distribution(), tdist.Distribution()
    (y, yw), grads = _value_and_grads(
        jd.log_base_partition_function, td.log_base_partition_function,
        alpha)
    _close(y, yw)
    for g, w in grads:
        _close(g, w, DEEP_TOL)
    for a in (0.0, 0.7, 2.0, 3.5):
        assert tdist.numerical_base_partition_function(a) == \
            jdist.numerical_base_partition_function(a)


def test_color_matches(rng):
    rgb = rng.uniform(0, 1, (2, 5, 6, 3)).astype(np.float32)
    for jf, tf in ((jcolor.rgb_to_syuv, tcolor.rgb_to_syuv),
                   (jcolor.syuv_to_rgb, tcolor.syuv_to_rgb)):
        _close(tf(torch.from_numpy(rgb)), jf(jnp.asarray(rgb)))
    stack = rng.standard_normal((3, 8, 6)).astype(np.float32)
    (y, yw), grads = _value_and_grads(jcolor.image_dct, tcolor.image_dct,
                                      stack)
    _close(y, yw)
    _close(grads[0][0], grads[0][1])
    _close(tcolor.image_idct(y), stack)


def test_wavelet_matches_golden():
    """nlt_tpu's goldens, float64, both filter banks."""
    with np.load(os.path.join(GOLDEN, "robust_loss_golden.npz")) as f:
        im = torch.from_numpy(f["input"])
        for wt, key in [("CDF9/7", "cdf97"), ("LeGall5/3", "legall53")]:
            flat = twav.flatten(twav.rescale(twav.construct(im, 3, wt), 0.8))
            _close(flat, f[key + "_flat"], 1e-12)


def test_wavelet_grads_match(rng):
    """Five levels of a 32x40 stack (the Barron loss's depth), float32."""
    im = rng.standard_normal((3, 32, 40)).astype(np.float32)

    def jfn(x):
        return jwav.flatten(jwav.rescale(jwav.construct(x, 5, "CDF9/7"), 1.3))

    def tfn(x):
        return twav.flatten(twav.rescale(twav.construct(x, 5, "CDF9/7"), 1.3))

    (y, yw), grads = _value_and_grads(jfn, tfn, im)
    _close(y, yw, DEEP_TOL)
    _close(grads[0][0], grads[0][1], DEEP_TOL)
    assert twav.get_max_num_levels((3, 32, 40)) == \
        jwav.get_max_num_levels((3, 32, 40))


@pytest.mark.parametrize("rep,color_space", [
    ("CDF9/7", "YUV"), ("DCT", "YUV"), ("PIXEL", "RGB")])
def test_adaptive_image_loss_matches(rng, rep, color_space):
    """Trainable alpha and scale: value and gradients with respect to the
    residual and both latents."""
    kw = dict(color_space=color_space, representation=rep,
              wavelet_num_levels=3, alpha_lo=0.5, alpha_hi=1.5,
              scale_lo=0.01, scale_init=0.5)
    jf = jadaptive.AdaptiveImageLossFunction((16, 16, 3), **kw)
    tf = tadaptive.AdaptiveImageLossFunction((16, 16, 3), **kw)
    jp, tp = jf.init_params(), tf.init_params()
    assert set(jp) == set(tp) == {"latent_alpha", "latent_scale"}
    for k in jp:
        _close(tp[k], jp[k])
    lat_a = rng.uniform(-1, 1, (1, 768)).astype(np.float32)
    lat_s = rng.uniform(-1, 1, (1, 768)).astype(np.float32)
    x = (rng.standard_normal((2, 16, 16, 3)) * 0.1).astype(np.float32)
    (y, yw), grads = _value_and_grads(
        lambda x, a, s: jf({"latent_alpha": a, "latent_scale": s}, x),
        lambda x, a, s: tf({"latent_alpha": a, "latent_scale": s}, x),
        x, lat_a, lat_s)
    _close(y, yw, DEEP_TOL)
    for g, w in grads:
        _close(g, w, DEEP_TOL)


def test_adaptive_fixed_and_students_t_match(rng):
    jf = jadaptive.AdaptiveLossFunction(6, alpha_lo=1.0, alpha_hi=1.0,
                                        scale_lo=0.01, scale_init=0.01)
    tf = tadaptive.AdaptiveLossFunction(6, alpha_lo=1.0, alpha_hi=1.0,
                                        scale_lo=0.01, scale_init=0.01)
    assert tf.init_params() == {} and jf.init_params() == {}
    x = rng.standard_normal((5, 6)).astype(np.float32)
    _close(tf({}, torch.from_numpy(x)), jf({}, jnp.asarray(x)))
    js = jadaptive.StudentsTLossFunction(6, scale_lo=0.01, scale_init=0.5)
    ts = tadaptive.StudentsTLossFunction(6, scale_lo=0.01, scale_init=0.5)
    p = {"log_df": rng.uniform(-1, 1, (1, 6)).astype(np.float32),
         "latent_scale": rng.uniform(-1, 1, (1, 6)).astype(np.float32)}
    _close(ts({k: torch.from_numpy(v) for k, v in p.items()},
              torch.from_numpy(x)),
           js({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x)))


def test_lpips_init_reproduces_nlt_tpu_weights():
    """The random-feature AlexNet equals nlt_tpu's init_params(
    PRNGKey(seed)): the same threefry draws; about 1% of the weights
    differ by 1 float32 ulp (XLA's float32 log1p, see losses/lpips.py)."""
    for seed in (0, 3):
        want = jlpips.init_params(jax.random.PRNGKey(seed))
        got = tlpips.init_params(seed)
        for part in ("convs", "lins"):
            for g, w in zip(got[part], want[part]):
                for k in w:
                    w_np = np.asarray(w[k])
                    assert g[k].shape == w_np.shape
                    np.testing.assert_allclose(g[k].numpy(), w_np,
                                               rtol=1e-6, atol=0)
                    assert np.mean(g[k].numpy() != w_np) < 0.02


def test_lpips_matches_golden_and_jax(rng):
    params = tlpips.init_params(0)
    with np.load(os.path.join(GOLDEN, "lpips_randfeat_golden.npz")) as f:
        img0, img1 = f["img0"], f["img1"]
        _close(tlpips.lpips(params, torch.from_numpy(img0),
                            torch.from_numpy(img1)), f["dist"], 1e-6)
        _close(tlpips.lpips(params, torch.from_numpy(img0),
                            torch.from_numpy(img0)), np.zeros(2), 1e-8)
    # The same converted weights on both sides: the taps and the
    # distance's gradient with respect to the first image.
    jp = jlpips.init_params(jax.random.PRNGKey(0))
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = rng.uniform(-1, 1, (2, 40, 36, 3)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 40, 36, 3)).astype(np.float32)
    jf = jlpips.features_normalized(jp, jnp.asarray(x))
    tf = tlpips.features_normalized(tp, torch.from_numpy(x))
    for g, w in zip(tf, jf):
        assert g.shape == w.shape
        _close(g, w, DEEP_TOL)
    (v, vw), grads = _value_and_grads(
        lambda a: jlpips.lpips(jp, a, jnp.asarray(y)),
        lambda a: tlpips.lpips(tp, a, torch.from_numpy(y)), x)
    _close(v, vw, DEEP_TOL)
    _close(grads[0][0], grads[0][1], DEEP_TOL)
    with pytest.raises(ValueError):
        tlpips.lpips(tp, torch.zeros(1, 16, 40, 3), torch.zeros(1, 16, 40, 3))


def _loss_pair(spec, **cfg):
    base = {"loss": spec}
    base.update(cfg)
    jw = jlosses.build_losses(spec, config=JConfig(base), imh=32, imw=32)
    tw = tlosses.build_losses(spec, config=TConfig(base), imh=32, imw=32)
    return jw, tw


@pytest.mark.parametrize("spec,cfg", [
    ("l1", {}), ("2l2", {}), ("uvl2", {}), ("barron", {}),
    ("barron", {"barron_alpha_lo": "0.5", "barron_alpha_hi": "1.5",
                "barron_scale_lo": "0.005", "wavelet_scale_base": "0.5"}),
    ("1e+0lpips", {})])
@pytest.mark.parametrize("keep_batch", [False, True])
def test_losses_match(rng, spec, cfg, keep_batch):
    """Value and gradient with respect to the prediction, with and
    without alpha weights; LPIPS also through cached gt features."""
    jw, tw = _loss_pair(spec, **cfg)
    assert [w for w, _ in jw] == [w for w, _ in tw]
    (_, jl), (_, tl) = jw[0], tw[0]
    jp = jl.init_params()
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    gt = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    pred = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    alpha = rng.uniform(0, 1, (2, 32, 32, 1)).astype(np.float32)
    for weights in (None, alpha):
        jwt = None if weights is None else jnp.asarray(weights)
        twt = None if weights is None else torch.from_numpy(weights)
        (v, vw), grads = _value_and_grads(
            lambda p: jl(jp, jnp.asarray(gt), p, keep_batch=keep_batch,
                         weights=jwt),
            lambda p: tl(tp, torch.from_numpy(gt), p, keep_batch=keep_batch,
                         weights=twt), pred)
        _close(v, vw, DEEP_TOL)
        _close(grads[0][0], grads[0][1], DEEP_TOL)
    if hasattr(tl, "extract_feats"):
        feats = tl.extract_feats(tp, torch.from_numpy(gt))
        got = tl(tp, None, torch.from_numpy(pred), keep_batch=keep_batch,
                 gt_feats=feats)
        want = jl(jp, jnp.asarray(gt), jnp.asarray(pred),
                  keep_batch=keep_batch)
        _close(got, want, DEEP_TOL)


def test_lpips_max_res_matches(rng):
    """lpips_max_res downsamples both images (jax's antialiased resize)
    before the AlexNet."""
    cfg = {"loss": "lpips", "lpips_max_res": "32"}
    (_, jl), = jlosses.build_losses("lpips", config=JConfig(cfg))
    (_, tl), = tlosses.build_losses("lpips", config=TConfig(cfg))
    assert tl.max_res == 32
    jp = jl.init_params()
    tp = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), jp)
    gt = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    pred = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    (v, vw), grads = _value_and_grads(
        lambda p: jl(jp, jnp.asarray(gt), p),
        lambda p: tl(tp, torch.from_numpy(gt), p), pred)
    _close(v, vw, DEEP_TOL)
    _close(grads[0][0], grads[0][1], DEEP_TOL)


def test_loss_spec_parsing_and_unported_losses():
    for s in ("1e+2lpips", "l1", "10barron", "0.5l2", "barron"):
        assert tlosses.parse_loss_and_weight(s) == \
            jlosses.parse_loss_and_weight(s)
    jw, tw = _loss_pair("barron,1e+0lpips,0.5ssim,2elpips",
                        elpips_samples="3")
    assert [(w, type(l).__name__) for w, l in tw] == \
        [(w, type(l).__name__) for w, l in jw]
    assert tw[3][1].n_samples == jw[3][1].n_samples == 3
    with pytest.raises(NotImplementedError):
        tlosses.build_losses("nosuchloss")
