"""The port's norms and remat in the train step against nlt_tpu's
make_train_step on the same numpy batches and converted params (32^2,
depth0 16 / depth 32, bs 2): BatchNorm in training mode (norm = batch)
at grad_accum 1 and 2, the layer / instance / pixel norms, remat with
and without BatchNorm, nan_guard with BatchNorm. Loss within 1e-4,
gradients within 1e-4 of each leaf's largest value (read back from
AMSGrad's first moment), BN moving statistics within 1e-5 after 2
steps. E-LPIPS and resuming a nlt_tpu state: test_torch_train_resume.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu.parallel import train as jtrain
from nlt_tpu_torch.convert import state_from_jax
from nlt_tpu_torch.parallel import train as ttrain
from nlt_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_model import small_cfg
from tests.test_torch_train import (_grads_of, _np, batches, build,
                                    check_grads, check_params, run_both)

LOSS_TOL = 1e-4
GRAD_TOL = 1e-4
STATS_TOL = 1e-5


def _bn_leaves(params, kind):
    """{key path: leaf} of the params' BN leaves (`kind`: 'moving' for
    the statistics, 'gamma' for the scales)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                if isinstance(v, (dict, list, tuple)):
                    walk(v, path + (k,))
                elif (k.startswith("moving_") if kind == "moving"
                      else k == kind and any("moving_" in j for j in t)):
                    out[path + (k,)] = _np(v)
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))

    walk(params, ())
    return out


def build_bn(cfg, fused, monkeypatch):
    """build() with BN leaves of a trained network's kind: gamma near 1,
    positive moving variances (numpy_params fills every 1-D leaf with
    N(0, 0.01))."""
    pair = list(build(cfg, fused, monkeypatch))
    rng = np.random.RandomState(7)

    def fix(t):
        if isinstance(t, dict):
            out = {}
            for k, v in t.items():
                if k == "gamma":
                    v = np.asarray(v) + 1.0
                elif k.startswith("moving_var__"):
                    v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                out[k] = fix(v) if isinstance(v, (dict, list)) else v
            return out
        if isinstance(t, list):
            return [fix(v) for v in t]
        return t

    jparams = fix(jax.tree_util.tree_map(np.asarray,
                                         pair[2]["params"]))
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    pair[2] = {"params": jparams, "opt_state": pair[1].init(jparams),
               "step": jnp.zeros((), jnp.int32)}
    tparams = state_from_jax(dict(pair[2]))["params"]
    pair[5] = {"params": tparams, "opt_state": pair[4].init(tparams),
               "step": torch.zeros((), dtype=torch.int32)}
    return pair


def check_grads_bn(tmu, jmu, tol):
    """check_grads for a network with BatchNorm in training mode. The bias
    of a conv followed by BN has a zero gradient in exact arithmetic
    (the batch mean cancels it), so both sides hold only rounding noise
    there (1e-11 to 1e-8 here): such a leaf, below 1e-6 of the tree's
    largest gradient, is held to `tol` of that largest gradient instead
    of its own."""
    tg, jg = _grads_of(tree_leaves(tmu)), _grads_of(jax.tree.leaves(jmu))
    assert len(tg) == len(jg)
    top = max(float(np.abs(j).max()) for j in jg)
    zero = 0
    for t, j in zip(tg, jg):
        assert t.shape == j.shape
        scale = float(np.abs(j).max())
        if scale < 1e-6 * top:
            zero += 1
            scale = top
        np.testing.assert_allclose(t / scale, j / scale, rtol=0, atol=tol)
    return zero


def _check_stats(tparams, jparams, tol):
    got = _bn_leaves(tparams, "moving")
    want = _bn_leaves(jax.tree_util.tree_map(np.asarray, jparams), "moving")
    assert got and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol,
                                   err_msg=str(k))
    return got


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_batch_norm_step_matches_jax(monkeypatch, grad_accum):
    """norm = batch: batch statistics in the step, their EMA in the moving
    statistics (the mean of the microbatches' statistics at grad_accum
    2), the loss and gradients; after 2 steps the statistics have moved
    from their init and agree."""
    cfg = small_cfg(norm="batch", loss="l1")
    pair = build_bn(cfg, False, monkeypatch)
    init = _bn_leaves(pair[5]["params"], "moving")
    losses, (j1, t1), (j2, t2) = run_both(*pair, cached=False, steps=2,
                                          grad_accum=grad_accum)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    # The 18 conv biases in front of a BN layer, and the 36 moving
    # statistics, whose gradient is exactly zero (unused in training).
    assert check_grads_bn(t1["opt_state"]["mu"], j1["opt_state"][0].mu,
                          GRAD_TOL) == 18 + 36
    assert all(not v.any() for v in _bn_leaves(t1["opt_state"]["mu"],
                                               "moving").values())
    moved = _check_stats(t2["params"], j2["params"], STATS_TOL)
    assert all(not np.array_equal(moved[k], init[k]) for k in init)
    # Eval runs on the moving statistics: the port's params after the
    # steps, in both packages' eval steps. (The two runs' params are not
    # compared here: a conv bias in front of BN gets rounding noise for a
    # gradient, which AMSGrad turns into steps of +-lr.)
    (jb, tb), = batches(1)
    want, _ = jtrain.make_eval_step(pair[0])(
        {"params": jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()),
                                          t2["params"])}, jb)
    got, _ = ttrain.make_eval_step(pair[3])(t2, tb)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL)


@pytest.mark.parametrize("norm", ["layer", "instance", "pixel"])
def test_other_norms_step_matches_jax(monkeypatch, norm):
    """The batches start at seed 20: with the instance norm, seed 10's
    batch puts one LeakyReLU input 8e-7 from zero, where float32 rounding
    decides the mask in either package (the port flips it against the
    float64 value, nlt_tpu does not), and that flip moves the deep
    gradients by 3%. From seed 11 on the port's gradients are as close
    to nlt_tpu's float64 ones as nlt_tpu's float32 ones are (3e-6)."""
    cfg = small_cfg(norm=norm, loss="l1")
    pair = build_bn(cfg, False, monkeypatch)
    losses, (j1, t1), _ = run_both(*pair, cached=False, steps=2, seed0=20)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    if norm == "instance":
        # The instance norm cancels the conv bias in front of it too (its
        # per-sample mean): 18 leaves of rounding noise, whose AMSGrad
        # steps are +-lr, so the updated params are not compared.
        assert check_grads_bn(t1["opt_state"]["mu"], j1["opt_state"][0].mu,
                              GRAD_TOL) == 18
        return
    grads = check_grads(t1["opt_state"]["mu"], j1["opt_state"][0].mu,
                        GRAD_TOL)
    check_params(t1["params"], j1["params"], grads, 1e-5)


def test_batch_norm_nan_guard_keeps_the_statistics(monkeypatch):
    """A poisoned batch under nan_guard leaves the moving statistics (and
    every other leaf) as they were; without the guard they are
    poisoned."""
    cfg = small_cfg(norm="batch", loss="l1")
    *_, tmodel, ttx, tstate = build_bn(cfg, False, monkeypatch)
    (_, good), = batches(1)
    bad = dict(good, base=torch.full_like(good["base"], float("nan")))
    s, loss, _ = ttrain.make_train_step(tmodel, ttx, nan_guard=True)(
        tstate, bad)
    assert not np.isfinite(float(loss))
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(tstate["params"]), tree_leaves(s["params"])))
    s, _, _ = ttrain.make_train_step(tmodel, ttx)(tstate, bad)
    assert any(not np.isfinite(v).all()
               for v in _bn_leaves(s["params"], "moving").values())


@pytest.mark.parametrize("norm", ["None", "batch"])
def test_remat_step_matches_jax_and_the_plain_step(monkeypatch, norm):
    """remat = True with the fused stages: nlt_tpu's step within the
    tolerances, and the port's own step without remat exactly (the
    recompute reruns the same float32 ops on the same inputs, BatchNorm
    on the batch's statistics again). nlt_tpu's remat with norm = batch
    fails: jax.checkpoint traces the stage and BN writes the traced
    statistics into the collector (UnexpectedTracerError); so with BN the
    port's remat step is held against nlt_tpu's step without remat, which
    computes the same numbers."""
    cfg = small_cfg(remat="true", norm=norm, loss="barron")
    pair = build_bn(cfg, True, monkeypatch)
    assert pair[3].remat
    if norm == "batch":
        with pytest.raises(jax.errors.UnexpectedTracerError):
            run_both(*pair, cached=False, steps=1)
        pair[:3] = build_bn(small_cfg(norm=norm, loss="barron"), True,
                            monkeypatch)[:3]
    losses, (j1, t1), (_, t2) = run_both(*pair, cached=False, steps=2)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    if norm == "batch":
        check_grads_bn(t1["opt_state"]["mu"], j1["opt_state"][0].mu,
                       GRAD_TOL)
    else:
        check_grads(t1["opt_state"]["mu"], j1["opt_state"][0].mu, GRAD_TOL)
    plain = build_bn(small_cfg(norm=norm, loss="barron"), True,
                     monkeypatch)[3:]
    assert not plain[0].remat
    step = ttrain.make_train_step(plain[0], plain[1])
    s = plain[2]
    for _, tb in batches(2):
        s, _, _ = step(s, tb)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves((s["params"], s["opt_state"])),
        tree_leaves((t2["params"], t2["opt_state"]))))
