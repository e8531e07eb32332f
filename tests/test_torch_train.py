"""nlt_tpu_torch.parallel.train against nlt_tpu's make_train_step on the
same numpy-seeded batch and the same converted params (the network from
a numpy seed, the loss state nlt_tpu's own): loss, gradients and updated
params after one step and the loss after three, with the fused stages
on and off and cached statics on and off, in float32 and bfloat16; the
optimizer (AMSGrad with global-norm clipping) against optax; and the
step's options (grad_accum, nan_guard, EMA), mirroring
tests/test_parallel.py. Small shapes: 32^2, depth0 16 / depth 32, bs 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nlt_tpu.models import get_model_class as jax_model_class
from nlt_tpu.networks import convnet as jconvnet
from nlt_tpu.parallel import train as jtrain
from nlt_tpu.utils.config import Config as JConfig
from nlt_tpu_torch.convert import params_from_jax
from nlt_tpu_torch.models import get_model_class as torch_model_class
from nlt_tpu_torch.parallel import train as ttrain
from nlt_tpu_torch.utils.config import Config as TConfig
from nlt_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_model import make_batch, numpy_params, small_cfg

LR = 1e-3
FLAGSHIP_LOSS = "barron,1e+0lpips"


def _np(t):
    return np.asarray(t.detach() if isinstance(t, torch.Tensor) else t,
                      np.float32)


def build(cfg, fused, monkeypatch):
    """(jax model, jax state, port model, port state): the same params on
    both sides, fresh AMSGrad states."""
    monkeypatch.setattr(jconvnet, "_FUSED_STAGE", fused)
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1" if fused else "0")
    jmodel = jax_model_class("nlt")(JConfig(cfg))
    jparams = {"net": jax.tree_util.tree_map(
        jnp.asarray, numpy_params(jmodel, 0)["net"]),
        "loss": jmodel.init_loss_params()}
    tparams = params_from_jax(jparams)
    jtx = jtrain.make_optimizer(LR, cfg.get("mgm", -1.0))
    ttx = ttrain.make_optimizer(LR, cfg.get("mgm", -1.0))
    jstate = {"params": jparams, "opt_state": jtx.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tmodel = torch_model_class("nlt")(TConfig(cfg), device="cpu")
    tstate = {"params": tparams, "opt_state": ttx.init(tparams),
              "step": torch.zeros((), dtype=torch.int32)}
    return jmodel, jtx, jstate, tmodel, ttx, tstate


def batches(n_steps, n=2, seed0=10):
    out = []
    for i in range(n_steps):
        b = make_batch(seed0 + i, n=n)
        out.append(({k: jnp.asarray(v) for k, v in b.items()},
                    {k: torch.from_numpy(v) for k, v in b.items()}))
    return out


def _grads_of(opt_state_mu):
    """The first step's gradient, from the first moment it left."""
    return [_np(m) / (1 - ttrain.B1) for m in opt_state_mu]


def check_params(tparams, jparams, grads, tol):
    """Updated params after one AMSGrad step from a fresh state. The
    step is lr * g / (|g| + eps): elementwise it is close to lr * sign(g)
    and amplifies the rounding of tiny gradients, so where |g| is below
    1e-3 of its leaf's largest gradient only a sign flip (2 lr) bounds
    the difference; elsewhere it is lr times the gradient's relative
    error, within `tol`."""
    for t, j, g in zip(tree_leaves(tparams), jax.tree.leaves(jparams),
                       grads):
        t, j = _np(t), _np(j)
        np.testing.assert_allclose(t, j, rtol=0, atol=2 * LR + 1e-6)
        big = np.abs(g) >= 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(t[big], j[big], rtol=0, atol=tol)


def check_grads(tmu, jmu, tol):
    """Gradients leaf by leaf, as a fraction of each leaf's largest."""
    tg, jg = _grads_of(tree_leaves(tmu)), _grads_of(jax.tree.leaves(jmu))
    assert len(tg) == len(jg)
    for t, j in zip(tg, jg):
        assert t.shape == j.shape
        scale = max(float(np.abs(j).max()), 1e-30)
        np.testing.assert_allclose(t / scale, j / scale, rtol=0, atol=tol)
    return jg


def run_both(jmodel, jtx, jstate, tmodel, ttx, tstate, cached, steps,
             **kw):
    """Run both steps over the same batches; returns the losses and the
    states after the first step and at the end."""
    seed0 = kw.pop("seed0", 10)
    jstep = jtrain.make_train_step(jmodel, jtx, cached_statics=cached, **kw)
    tstep = ttrain.make_train_step(tmodel, ttx, cached_statics=cached, **kw)
    jext = jtrain.make_static_extractor(jmodel)
    text = ttrain.make_static_extractor(tmodel)
    losses, first = [], None
    for jb, tb in batches(steps, n=kw.get("grad_accum", 1) * 2, seed0=seed0):
        if cached:
            jstate, jl, _ = jstep(jstate, jb, jext(jstate["params"], jb))
            tstate, tl, _ = tstep(tstate, tb, text(tstate["params"], tb))
        else:
            jstate, jl, _ = jstep(jstate, jb)
            tstate, tl, _ = tstep(tstate, tb)
        losses.append((float(tl), float(jl)))
        if first is None:  # copied: nlt_tpu's step donates its state
            first = (jax.tree_util.tree_map(np.array, jstate), tstate)
    return losses, first, (jstate, tstate)


@pytest.mark.parametrize("fused,cached,loss", [
    (True, True, FLAGSHIP_LOSS),     # the flagship recipe's path
    (False, True, FLAGSHIP_LOSS),
    (True, False, "barron"),
    (False, False, "l1"),
])
def test_train_step_matches_jax(monkeypatch, fused, cached, loss):
    """Loss, gradients and updated params after one step, and the loss
    of three steps, float32. Gradients: the same float32 products summed
    in another order through ~9 stages, the resample's scatter and the
    loss: 1e-4 of each leaf's largest."""
    cfg = small_cfg(loss=loss)
    pair = build(cfg, fused, monkeypatch)
    losses, (j1, t1), _ = run_both(*pair, cached=cached, steps=3)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
    grads = check_grads(t1["opt_state"]["mu"], j1["opt_state"][0].mu, 1e-4)
    check_params(t1["params"], j1["params"], grads, 1e-5)
    assert int(t1["step"]) == 1


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_train_step_bfloat16_matches_jax(monkeypatch):
    """The flagship path in bfloat16 compute (params and loss float32).
    bf16 keeps 8 mantissa bits, the U-Net rounds at other points in the
    two packages (on the CPU the port's plain stages round every tap,
    nlt_tpu's Pallas kernels once; see test_model_apply_bfloat16_matches)
    and a stage output that changes sign flips its LeakyReLU mask in the
    backward; bias gradients are sums that cancel. At this size each
    package's bf16 gradients are 1-15% (relative L2, per leaf) from the
    float32 ones, so the two are held to 25% per leaf and 10% over all
    leaves; the loss to 1e-2; params within a sign flip of the first
    AMSGrad step (2 lr)."""
    cfg = small_cfg(loss=FLAGSHIP_LOSS, compute_dtype="bfloat16")
    pair = build(cfg, True, monkeypatch)
    losses, (j1, t1), _ = run_both(*pair, cached=True, steps=3)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=1e-2)
    tg = _grads_of(tree_leaves(t1["opt_state"]["mu"]))
    jg = _grads_of(jax.tree.leaves(j1["opt_state"][0].mu))
    for t, j in zip(tg, jg):
        assert t.shape == j.shape and _rel_l2(t, j) <= 0.25
    assert _rel_l2(np.concatenate([t.ravel() for t in tg]),
                   np.concatenate([j.ravel() for j in jg])) <= 0.1
    for t, j in zip(tree_leaves(t1["params"]),
                    jax.tree.leaves(j1["params"])):
        np.testing.assert_allclose(_np(t), _np(j), rtol=0, atol=2 * LR)


def test_static_extractor_matches_jax(monkeypatch):
    cfg = small_cfg(loss=FLAGSHIP_LOSS)
    jmodel, _, jstate, tmodel, _, tstate = build(cfg, True, monkeypatch)
    (jb, tb), = batches(1)
    want = jtrain.make_static_extractor(jmodel)(jstate["params"], jb)
    got = ttrain.make_static_extractor(tmodel)(tstate["params"], tb)
    for k in ("gt_camspc", "base_camspc"):
        np.testing.assert_allclose(_np(got["products"][k]),
                                   _np(want["products"][k]), atol=1e-5)
    np.testing.assert_array_equal(_np(got["products"]["pred_plan"]["rows"]),
                                  _np(want["products"]["pred_plan"]["rows"]))
    assert set(got["feats"]) == set(want["feats"]) == {"1"}
    for g, w in zip(got["feats"]["1"], want["feats"]["1"]):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5)


def test_grad_accum_matches_full_batch_and_jax(monkeypatch):
    """grad_accum=2 (strided microbatches) gives the full batch's loss,
    updated params and vis in batch order, and nlt_tpu's grad_accum=2
    step with cached statics."""
    cfg = small_cfg(loss="l1")
    jmodel, jtx, jstate, tmodel, ttx, tstate = build(cfg, True, monkeypatch)
    (jb, tb), = batches(1, n=4)
    full = ttrain.make_train_step(tmodel, ttx)
    acc = ttrain.make_train_step(tmodel, ttx, grad_accum=2)
    s_full, l_full, vis_full = full(tstate, tb)
    s_acc, l_acc, vis_acc = acc(tstate, tb)
    np.testing.assert_allclose(float(l_full), float(l_acc), rtol=1e-6)
    for a, b in zip(tree_leaves(s_full["params"]),
                    tree_leaves(s_acc["params"])):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)
    np.testing.assert_allclose(_np(vis_full["pred"]), _np(vis_acc["pred"]),
                               atol=1e-6)

    jstep = jtrain.make_train_step(jmodel, jtx, cached_statics=True,
                                   grad_accum=2)
    tstep = ttrain.make_train_step(tmodel, ttx, cached_statics=True,
                                   grad_accum=2)
    j1, jl, _ = jstep(jstate, jb, jtrain.make_static_extractor(jmodel)(
        jstate["params"], jb))
    t1, tl, _ = tstep(tstate, tb, ttrain.make_static_extractor(tmodel)(
        tstate["params"], tb))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
    grads = check_grads(t1["opt_state"]["mu"], j1["opt_state"][0].mu, 1e-4)
    check_params(t1["params"], j1["params"], grads, 1e-5)


def test_nan_guard_skips_bad_update(monkeypatch):
    """A non-finite batch leaves params and optimizer state untouched
    under nan_guard (and poisons them without it); step still advances;
    a good batch then updates."""
    cfg = small_cfg(loss="l1")
    _, _, _, tmodel, ttx, tstate = build(cfg, True, monkeypatch)
    (_, good), = batches(1)
    bad = dict(good, base=torch.full_like(good["base"], float("nan")))
    guarded = ttrain.make_train_step(tmodel, ttx, nan_guard=True)
    s_g, loss_g, _ = guarded(tstate, bad)
    assert not np.isfinite(float(loss_g))
    assert int(s_g["step"]) == 1
    for a, b in zip(tree_leaves((tstate["params"], tstate["opt_state"])),
                    tree_leaves((s_g["params"], s_g["opt_state"]))):
        assert torch.equal(a, b)
    s_p, _, _ = ttrain.make_train_step(tmodel, ttx)(tstate, bad)
    assert any(not bool(torch.isfinite(x).all())
               for x in tree_leaves(s_p["params"]))
    s_g2, loss2, _ = guarded(s_g, good)
    assert np.isfinite(float(loss2))
    assert any(not torch.equal(a, b) for a, b in zip(
        tree_leaves(tstate["params"]), tree_leaves(s_g2["params"])))


def test_ema_params_track_updates_and_eval_uses_them(monkeypatch):
    """ema = d * ema + (1 - d) * params after a step, and eval_step
    evaluates the EMA weights."""
    cfg = small_cfg(loss="l1")
    _, _, _, tmodel, ttx, tstate = build(cfg, True, monkeypatch)
    (_, tb), = batches(1)
    d = 0.9
    p0 = tree_map(torch.clone, tstate["params"])
    state = dict(tstate, ema_params=tree_map(torch.clone, p0))
    state, _, _ = ttrain.make_train_step(tmodel, ttx, ema_decay=d)(state, tb)
    for e, a, b in zip(tree_leaves(state["ema_params"]), tree_leaves(p0),
                       tree_leaves(state["params"])):
        np.testing.assert_allclose(_np(e), d * _np(a) + (1 - d) * _np(b),
                                   rtol=1e-5, atol=1e-7)
    eval_step = ttrain.make_eval_step(tmodel)
    forced, _ = eval_step(dict(state, ema_params=p0), tb)
    plain, _ = eval_step({"params": p0}, tb)
    np.testing.assert_allclose(float(forced), float(plain), rtol=1e-6)
    assert ttrain.ema_params_of(state) is state["ema_params"]


@pytest.mark.parametrize("mgm", [-1.0, 1e9, 0.5])
def test_optimizer_matches_optax(mgm):
    """AMSGrad (max over the bias-corrected second moment) and global-norm
    clipping (only at or above mgm, no epsilon) against optax over four
    updates of a small tree with gradients that shrink, so nu_max
    matters. 0.5 clips every step; 1e9 never does."""
    rng = np.random.RandomState(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": [rng.standard_normal(5).astype(np.float32),
                    np.zeros(2, np.float32)]}
    jtx, ttx = jtrain.make_optimizer(LR, mgm), ttrain.make_optimizer(LR, mgm)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = jtx.init(jp), ttx.init(tp)
    for i in range(4):
        g = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) / (i + 1) ** 2).astype(
                np.float32), params)
        ju, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = ttx.update(tree_map(torch.from_numpy, g), ts)
        tp = ttrain.apply_updates(tp, tu)
        for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(_np(t), _np(j), rtol=1e-6, atol=1e-7)
    assert int(ts["count"]) == 4


def test_unported_training_options_raise(monkeypatch):
    """What stays unported raises: compact resample plans
    (take_compact_frac > 0) when the statics are made. (Several devices:
    test_torch_trainvali.py::test_several_devices_not_ported.)"""
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "0")
    model = torch_model_class("nlt")(
        TConfig(small_cfg(take_compact_frac="0.5")), device="cpu")
    (_, tb), = batches(1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.make_static_extractor(model)(None, tb)


@pytest.mark.parametrize("over", [
    {"norm": "batch"}, {"remat": "true"}, {"loss": "barron,1e+0ssim"},
    {"loss": "barron,1e+0elpips"}], ids=["batch", "remat", "ssim", "elpips"])
def test_training_options_build_and_step(monkeypatch, over):
    """The options that raised before this slice of the port train: two
    steps on the fused path, finite losses that fall, the step counter
    advanced. (Their parity with nlt_tpu: test_torch_train_options.py,
    test_torch_train_resume.py.)"""
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1")
    model = torch_model_class("nlt")(TConfig(small_cfg(**over)),
                                     device="cpu")
    tx = ttrain.make_optimizer(LR)
    state = ttrain.init_state(model, tx, torch.Generator().manual_seed(0))
    step = ttrain.make_train_step(model, tx)
    (_, tb), = batches(1)
    losses = []
    for _ in range(2):
        state, loss, _ = step(state, tb)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[1] < losses[0]
    assert int(state["step"]) == 2
