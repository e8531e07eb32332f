"""nlt_tpu_torch's layers, image ops, resampler and Model.apply against
nlt_tpu's on the same numpy inputs and the same (converted) params."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu.models import get_model_class as jax_model_class
from nlt_tpu.networks import convnet as jconvnet
from nlt_tpu.networks import elements as jel
from nlt_tpu.ops import resample as jresample
from nlt_tpu.utils import img as jimg
from nlt_tpu.utils.config import Config as JConfig
from nlt_tpu_torch.convert import params_from_jax
from nlt_tpu_torch.models import get_model_class as torch_model_class
from nlt_tpu_torch.networks import elements as tel
from nlt_tpu_torch.ops import resample as tresample
from nlt_tpu_torch.utils import img as timg
from nlt_tpu_torch.utils.config import Config as TConfig

# Plain float32 layers: the same products, summed in another order.
TOL = 1e-5
# The whole model: 6-9 stages of such sums, then a resample.
MODEL_TOL = 1e-4


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor)
                      else t, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("layer,k,s,shape,o", [
    ("conv", 2, 2, (2, 8, 6, 5), 7),
    ("conv", 2, 1, (2, 5, 7, 5), 4),
    ("conv", 1, 1, (1, 6, 6, 3), 8),
    ("deconv", 2, 2, (2, 4, 3, 6), 5),
    ("deconv", 2, 1, (2, 5, 7, 5), 4),
    ("deconv", 1, 1, (1, 6, 6, 3), 8),
])
def test_elements_match(rng, layer, k, s, shape, o):
    x = rng.standard_normal(shape).astype(np.float32)
    p = {"w": (rng.standard_normal((k, k, shape[3], o)) * 0.3).astype(
        np.float32), "b": (rng.standard_normal(o) * 0.1).astype(np.float32)}
    want = getattr(jel, layer)(k, o, stride=s).apply(
        {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x))
    got = getattr(tel, layer)(k, o, stride=s).apply(
        {n: torch.from_numpy(v) for n, v in p.items()}, torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want, TOL)


@pytest.mark.parametrize("make", [
    lambda m: m.act("relu"), lambda m: m.act("leakyrelu"),
    lambda m: m.act("elu"), lambda m: m.pool("max"), lambda m: m.pool("avg"),
    lambda m: m.norm(None), lambda m: m.iden()],
    ids=["relu", "leakyrelu", "elu", "maxpool", "avgpool", "nonorm", "iden"])
def test_param_free_layers_match(rng, make):
    """Odd spatial sizes: SAME pooling pads the last row and column."""
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = make(jel).apply({}, jnp.asarray(x))
    got = make(tel).apply({}, torch.from_numpy(x))
    assert got.shape == want.shape
    _close(got, want, TOL)


def test_upconv_matches(rng):
    x = rng.standard_normal((2, 4, 6, 3)).astype(np.float32)
    p = {"w": (rng.standard_normal((2, 2, 3, 5)) * 0.3).astype(np.float32),
         "b": (rng.standard_normal(5) * 0.1).astype(np.float32)}
    want = jel.upconv(5).apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x))
    got = tel.upconv(5).apply({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
    _close(got, want, TOL)


def test_batch_norm_inference_matches(rng):
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    p = {"gamma": rng.uniform(0.5, 2, 3), "beta": rng.standard_normal(3),
         "moving_mean__bn0": rng.standard_normal(3),
         "moving_var__bn0": rng.uniform(0.5, 2, 3)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    want = jel.norm("batch", bn_name="bn0").apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = tel.norm("batch", bn_name="bn0").apply(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x))
    _close(got, want, TOL)


@pytest.mark.parametrize("impl", ["xla", "percorner"])
def test_resample_matches(rng, impl):
    """Warps reach past every border: partial taps in (-1, 0) and
    (size-1, size), zeros further out."""
    img = rng.uniform(0, 1, (2, 9, 11, 3)).astype(np.float32)
    warp = np.stack([rng.uniform(-2, 12, (2, 7, 8)),
                     rng.uniform(-2, 10, (2, 7, 8))], -1).astype(np.float32)
    want = jresample.resample(jnp.asarray(img), jnp.asarray(warp), impl=impl)
    got = tresample.resample(torch.from_numpy(img), torch.from_numpy(warp))
    assert got.shape == want.shape
    _close(got, want, TOL)


@pytest.mark.parametrize("src,dst", [((8, 6), (16, 12)), ((16, 12), (6, 5))])
def test_resize_matches_jax_linear(rng, src, dst):
    """jax.image.resize(method='linear') antialiases when it shrinks;
    torch's interpolate does not by default, so the port builds jax's
    weights. Upscale and downscale both pinned."""
    x = rng.uniform(0, 1, (2,) + src + (3,)).astype(np.float32)
    want = jimg.resize(jnp.asarray(x), *dst)
    got = timg.resize(torch.from_numpy(x), *dst)
    _close(got, want, TOL)
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(x).permute(0, 3, 1, 2), size=dst, mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    if dst[0] > src[0]:  # upscaling: no antialiasing, the two agree
        _close(plain, want, TOL)
    else:
        assert np.abs(_np(plain) - _np(want)).max() > 1e-2


def test_image_helpers_match(rng):
    x = rng.uniform(-0.2, 1.2, (2, 5, 6, 3)).astype(np.float32)
    a = rng.uniform(0, 1, (2, 5, 6, 1)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    _close(timg.set_left_top_corner(tx, 0.5),
           jimg.set_left_top_corner(jx, 0.5), 0)
    _close(timg.alpha_blend(tx, torch.from_numpy(a), tx * 0.5),
           jimg.alpha_blend(jx, jnp.asarray(a), jx * 0.5), TOL)
    _close(timg.linear2srgb(tx), jimg.linear2srgb(jx), TOL)
    _close(timg.upsample2x(tx), jimg.upsample2x(jx), TOL)
    for lin in (False, True):
        got = timg.pack_vis({"v": tx}, linear_space=lin)["v"]
        want = jimg.pack_vis({"v": jx}, linear_space=lin)["v"]
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


UVH = 32


def small_cfg(**overrides):
    cfg = {"dataset": "nlt", "model": "nlt", "loss": "l1",
           "imh": UVH, "imw": UVH, "uvh": UVH, "uvw": UVH,
           "use_obs": True, "skip_connect_base": True,
           "linear_space": False, "depth0": 16, "depth": 32,
           "kernel": 2, "stride": 2, "norm": "None", "act": "leakyrelu",
           "pool": "None", "bs": 2, "lr": "1e-3"}
    cfg.update(overrides)
    return cfg


def make_batch(seed, n=2, uvh=UVH, imh=UVH, n_obs=None):
    rng = np.random.RandomState(seed)

    def img(c, h=uvh):
        shape = (n, h, h, c) if n_obs is None else (n, n_obs, h, h, c)
        return rng.uniform(0, 1, shape).astype(np.float32)

    xs, ys = np.meshgrid(np.arange(imh), np.arange(imh))
    warp = np.stack([xs / imh, ys / imh], -1) + rng.uniform(
        -0.05, 0.05, (n, imh, imh, 2))
    batch = {"base": img(3)[:, 0] if n_obs else img(3),
             "cvis": img(1)[:, 0] if n_obs else img(1),
             "lvis": img(1)[:, 0] if n_obs else img(1),
             "warp": warp.astype(np.float32),
             "rgb": img(3)[:, 0] if n_obs else img(3),
             "rgb_camspc": rng.uniform(0, 1, (n, imh, imh, 3)).astype(
                 np.float32),
             "nn_base": img(3), "nn_rgb": img(3), "nn_rgb_camspc": img(3, imh)}
    if n_obs:
        batch["nn_dist"] = rng.uniform(0.5, 2, (n, n_obs)).astype(np.float32)
    return batch


def numpy_params(jmodel, seed):
    """nlt_tpu's param tree, filled from a numpy seed: glorot-uniform
    kernels, small nonzero biases. (Shapes from jax.eval_shape, which
    compiles nothing.)"""
    rng = np.random.RandomState(seed)

    def fill(leaf):
        if len(leaf.shape) == 4:
            k0, k1, ci, co = leaf.shape
            lim = np.sqrt(6.0 / (k0 * k1 * (ci + co)))
            return rng.uniform(-lim, lim, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)

    shapes = jax.eval_shape(jmodel.init_params, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(fill, shapes)


def build_pair(cfg, fused, monkeypatch, seed=0):
    """(jax model, its params, port model, converted params), with the
    fused stages on or off in both packages."""
    monkeypatch.setattr(jconvnet, "_FUSED_STAGE", fused)
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1" if fused else "0")
    jmodel = jax_model_class("nlt")(JConfig(cfg))
    params = numpy_params(jmodel, seed)
    tmodel = torch_model_class("nlt")(TConfig(cfg), device="cpu")
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, params), tmodel,
            params_from_jax(params))


@pytest.mark.parametrize("fused,override", [
    (True, False), (True, True), (False, False)])
def test_model_apply_test_mode_matches(rng, monkeypatch, fused, override):
    cfg = small_cfg()
    jmodel, jparams, tmodel, tparams = build_pair(cfg, fused, monkeypatch)
    batch = make_batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jov = tov = None
    if override:
        x = jnp.asarray(make_batch(2)["rgb"] - make_batch(2)["base"])
        feats = jmodel.extract_obs_features(jparams["net"], x)
        jov = [jnp.mean(f, axis=0, keepdims=True).repeat(2, 0)
               for f in feats]
        tov = [torch.from_numpy(np.array(f)) for f in jov]
        tfeats = tmodel.extract_obs_features(
            tparams["net"], torch.from_numpy(np.array(x)))
        for g, w in zip(tfeats, feats):
            _close(g, w, MODEL_TOL)
    want = jmodel.apply(jparams, jbatch, "test", obs_override=jov)
    with torch.no_grad():
        got = tmodel.apply(tparams, tbatch, "test", obs_override=tov)
    assert got[1] is None and got[2] is None
    _close(got[0], want[0], MODEL_TOL)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        _close(got[3][k], want[3][k], MODEL_TOL)


def test_model_apply_train_mode_and_multi_obs_match(rng, monkeypatch):
    """Train-mode outputs (gt_camspc) and K=2 observations aggregated by
    inverse distance, unrolled and folded."""
    for fold in ("false", "true"):
        cfg = small_cfg(obs_weighting="inverse_distance", obs_fold=fold)
        jmodel, jparams, tmodel, tparams = build_pair(cfg, False,
                                                      monkeypatch)
        batch = make_batch(3, n_obs=2)
        want = jmodel.apply(jparams, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, "train")
        with torch.no_grad():
            got = tmodel.apply(tparams, {k: torch.from_numpy(v)
                                         for k, v in batch.items()}, "train")
        _close(got[0], want[0], MODEL_TOL)
        _close(got[1], want[1], MODEL_TOL)
        for k in want[3]:
            _close(got[3][k], want[3][k], MODEL_TOL)


def test_model_apply_bfloat16_matches(rng, monkeypatch):
    """bf16 compute through the fused stages, with the request's own
    observations and with a float32 obs pyramid. Both sides round at the
    same points, but a float32 sum taken in another order can flip a
    bf16 rounding (2^-8 relative) somewhere in 6 stages, and that spreads
    through the later ones: 2e-2 on outputs of magnitude ~1. The float32
    pyramid promotes the query path after stage 0 to float32 in both
    packages (jnp.concatenate's promotion, kept by the port)."""
    from nlt_tpu_torch.ops import fused_stage as tfs

    cfg = small_cfg(compute_dtype="bfloat16")
    jmodel, jparams, tmodel, tparams = build_pair(cfg, True, monkeypatch)
    batch = make_batch(4)
    x = make_batch(5)["rgb"] - make_batch(5)["base"]
    jov = [jnp.repeat(f, 2, axis=0) for f in jmodel.extract_obs_features(
        jparams["net"], jnp.asarray(x[:1]))]
    seen = []
    for name in ("contract_stage", "expand_stage"):
        op = getattr(tfs, name)
        monkeypatch.setattr(tfs, name, lambda x, *a, _op=op, **k: (
            seen.append(x.dtype), _op(x, *a, **k))[1])
    for ov in (None, jov):
        seen.clear()
        want = jmodel.apply(jparams, {k: jnp.asarray(v)
                                      for k, v in batch.items()}, "test",
                            obs_override=ov)
        with torch.no_grad():
            got = tmodel.apply(
                tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
                "test", obs_override=None if ov is None else [
                    torch.from_numpy(np.array(f)) for f in ov])
        _close(got[3]["pred"], want[3]["pred"], 2e-2)
        _close(got[0], want[0], 2e-2)
        # Without a pyramid every stage call is bf16; with one, only the
        # six query stages run, all in float32.
        assert seen == [torch.bfloat16] * 9 if ov is None else \
            seen == [torch.float32] * 6


def test_model_outputs_subset_skips_work(monkeypatch):
    """outputs= computes only what is asked: no camera-space resample
    for 'pred' alone, and the obs stages do not run under an override."""
    cfg = small_cfg()
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1")
    tmodel = torch_model_class("nlt")(TConfig(cfg), device="cpu")
    params = tmodel.init_params(torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in make_batch(5).items()}
    calls = []
    monkeypatch.setattr(tresample, "resample",
                        lambda *a: calls.append(a) or a[0])
    obs_stage0 = tmodel.net["obs"].stages[0]
    tmodel.net["obs"].stages[0] = obs_stage0._replace(
        apply=lambda p, x: (_ for _ in ()).throw(AssertionError("obs ran")))
    ov = [torch.zeros(2, UVH >> i, UVH >> i, c)
          for i, c in enumerate([16, 16, 32, 32])]
    with torch.no_grad():
        out = tmodel.apply(params, batch, "test", obs_override=ov,
                           outputs=("pred",))
    assert calls == [] and set(out[3]) == {"pred"} and out[0] is None
