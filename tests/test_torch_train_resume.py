"""E-LPIPS in the port's train step and a nlt_tpu training state
continued in the port, against nlt_tpu's make_train_step on the same
numpy batches and converted params (32^2, depth0 16 / depth 32, bs 2).
E-LPIPS runs with nlt_tpu's draws injected (the port's random stream is
its own); the state is optax's AMSGrad, plain and chained after
clip_by_global_norm, converted by convert.state_from_jax. Loss within
1e-4, gradients within 1e-4 of each leaf's largest value."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nlt_tpu.parallel import train as jtrain
from nlt_tpu_torch import losses as tlosses
from nlt_tpu_torch.convert import opt_state_from_jax, state_from_jax
from nlt_tpu_torch.parallel import train as ttrain
from nlt_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_model import small_cfg
from tests.test_torch_ssim_elpips import jax_draws
from tests.test_torch_train import (LR, _np, batches, build, check_grads,
                                    run_both)

LOSS_TOL = 1e-4
GRAD_TOL = 1e-4


@pytest.fixture
def injected_draws(monkeypatch):
    """Replace the port's E-LPIPS draws by nlt_tpu's: the k-th draw of a
    run is nlt_tpu's for step k, key fold_in(PRNGKey(17), k)."""
    calls = []

    def draw(self, generator, gt):
        key = jax.random.fold_in(jax.random.PRNGKey(17), len(calls))
        calls.append(generator)
        return jax_draws(key, self.n_samples, gt.shape[1] == gt.shape[2])

    monkeypatch.setattr(tlosses.ELPIPS, "draw", draw)
    return calls


@pytest.mark.parametrize("cached", [False, True])
def test_elpips_step_matches_jax_with_its_draws(monkeypatch, injected_draws,
                                                cached):
    """barron + E-LPIPS over 2 steps with nlt_tpu's draws of each step:
    loss and gradients; the cached-statics step caches no E-LPIPS
    feature (the transform changes the ground truth)."""
    cfg = small_cfg(loss="barron,1e+0elpips")
    pair = build(cfg, True, monkeypatch)
    assert pair[3].has_stochastic_loss()
    assert pair[3].feat_loss_indices() == pair[0].feat_loss_indices() == []
    losses, (j1, t1), _ = run_both(*pair, cached=cached, steps=2)
    assert len(injected_draws) == 2
    assert all(isinstance(g, torch.Generator) for g in injected_draws)
    for tl, jl in losses:
        np.testing.assert_allclose(tl, jl, rtol=LOSS_TOL)
    check_grads(t1["opt_state"]["mu"], j1["opt_state"][0].mu, GRAD_TOL)


def test_elpips_step_draws_per_step_and_repeat(monkeypatch):
    """The port's own stream: the same seed gives the same losses twice,
    each step and microbatch draws anew, and the eval step draws from
    the loss's fixed seed."""
    cfg = small_cfg(loss="barron,1e+0elpips")
    *_, tmodel, ttx, tstate = build(cfg, True, monkeypatch)
    seen = []
    real = tlosses.ELPIPS.draw

    def draw(self, generator, gt):
        out = real(self, generator, gt)
        seen.append(out)
        return out

    monkeypatch.setattr(tlosses.ELPIPS, "draw", draw)
    runs = []
    for grad_accum in (1, 1, 2):
        step = ttrain.make_train_step(tmodel, ttx, grad_accum=grad_accum)
        s, losses = tstate, []
        for _, tb in batches(2, n=4):
            s, loss, _ = step(s, tb)
            losses.append(float(loss))
        runs.append(losses)
    assert runs[0] == runs[1]
    assert len(seen) == 2 + 2 + 4
    assert seen[0] != seen[1] and seen[:2] == seen[2:4]
    assert len({repr(d) for d in seen[4:]}) == 4
    assert len({ttrain.loss_generator(s, m).initial_seed()
                for s in range(3) for m in range(2)}) == 6
    ev = ttrain.make_eval_step(tmodel)
    (_, tb), = batches(1)
    assert float(ev(tstate, tb)[0]) == float(ev(tstate, tb)[0])


@pytest.mark.parametrize("mgm", [-1.0, 0.5])
def test_jax_state_continues_in_the_port(monkeypatch, mgm):
    """nlt_tpu's state after 2 steps (optax.amsgrad, or chained after
    clip_by_global_norm at 0.5, which clips), converted; the same
    gradients through both optimizers give params within 1e-6; one more
    train step in each gives nlt_tpu's loss and params (within 1e-6
    where the gradient is firm, a sign flip of a step elsewhere)."""
    cfg = small_cfg(loss="l1", mgm=mgm)
    jmodel, jtx, jstate, tmodel, ttx, _ = build(cfg, True, monkeypatch)
    jstep = jtrain.make_train_step(jmodel, jtx)
    bs = batches(3)
    for jb, _ in bs[:2]:
        jstate, _, _ = jstep(jstate, jb)
    jstate = jax.tree_util.tree_map(np.array, jstate)
    tstate = state_from_jax(jstate)
    assert int(tstate["step"]) == 2 and int(tstate["opt_state"]["count"]) == 2
    assert sorted(tstate) == ["opt_state", "params", "step"]
    with pytest.raises(ValueError):
        opt_state_from_jax((jstate["opt_state"], jstate["opt_state"]))

    rng = np.random.RandomState(1)
    g = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32),
        jstate["params"])
    jp = jax.tree_util.tree_map(jnp.asarray, jstate["params"])
    ju, _ = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                       jax.tree_util.tree_map(jnp.asarray,
                                              jstate["opt_state"]), jp)
    tu, _ = ttx.update(state_from_jax(dict(jstate, params=g))["params"],
                       tstate["opt_state"])
    for t, j in zip(tree_leaves(ttrain.apply_updates(tstate["params"], tu)),
                    jax.tree.leaves(optax.apply_updates(jp, ju))):
        np.testing.assert_allclose(_np(t), np.asarray(j), rtol=0, atol=1e-6)

    jb, tb = bs[2]
    j3, jl, _ = jstep(jax.tree_util.tree_map(jnp.asarray, jstate), jb)
    t3, tl, _ = ttrain.make_train_step(tmodel, ttx)(tstate, tb)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    assert int(t3["step"]) == 3
    mu = jax.tree.leaves(jax.tree_util.tree_map(
        np.asarray, j3["opt_state"][0].mu if mgm <= 0
        else j3["opt_state"][1][0].mu))
    for t, j, m in zip(tree_leaves(t3["params"]), jax.tree.leaves(
            j3["params"]), mu):
        t, j = _np(t), np.asarray(j)
        np.testing.assert_allclose(t, j, rtol=0, atol=2 * LR + 1e-6)
        firm = np.abs(m) >= 1e-3 * max(float(np.abs(m).max()), 1e-30)
        np.testing.assert_allclose(t[firm], j[firm], rtol=0, atol=1e-6)
