"""nlt_tpu_torch.ops.resample with gradients against nlt_tpu's: the
window-table resample (values, d_img, d_warp against jax.vjp), the
planned resample (values and d_img), make_plan's arrays, and the
dead-update rule at texel (0, 0). The backward runs the K1 op, which on
a CPU tensor is its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu.ops import resample as jres
from nlt_tpu.utils.img import set_left_top_corner as jcorner
from nlt_tpu_torch.ops import resample as tres
from nlt_tpu_torch.ops import scatter as tsc
from nlt_tpu_torch.utils.img import set_left_top_corner as tcorner

# float32: the same products, and the gradient's sums over duplicate
# rows taken in another order.
TOL = 1e-5


def _inputs(seed, n=2, h=9, w=11, c=3, ho=7, wo=8, reach=2.0):
    """Warps reach `reach` pixels past every border: partial taps in
    (-1, 0) and (size-1, size), zeros further out."""
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 1, (n, h, w, c)).astype(np.float32)
    warp = np.stack([rng.uniform(-reach, w - 1 + reach, (n, ho, wo)),
                     rng.uniform(-reach, h - 1 + reach, (n, ho, wo))],
                    -1).astype(np.float32)
    g = rng.uniform(-1, 1, (n, ho, wo, c)).astype(np.float32)
    return img, warp, g


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seed,reach", [(0, 2.0), (1, 0.5), (2, 6.0)])
def test_resample_values_and_grads_match_jax_vjp(seed, reach):
    img, warp, g = _inputs(seed, reach=reach)
    want, vjp = jax.vjp(jres.resample, jnp.asarray(img), jnp.asarray(warp))
    want_dimg, want_dwarp = vjp(jnp.asarray(g))
    ti = torch.from_numpy(img).requires_grad_()
    tw = torch.from_numpy(warp).requires_grad_()
    tsc.reset_launches()
    got = tres.resample(ti, tw)
    got.backward(torch.from_numpy(g))
    _close(got, want)
    _close(ti.grad, want_dimg)
    _close(tw.grad, want_dwarp)
    assert tsc.LAUNCHES["scatter_add_rows"] == 0  # CPU: plain version


def test_window_table_matches_reference_formulation():
    """The production formulation equals the four-corner reference
    (_resample_one), values and both gradients."""
    img, warp, g = _inputs(3)
    outs = []
    for fn in (tres.resample, tres._resample_one):
        ti = torch.from_numpy(img).requires_grad_()
        tw = torch.from_numpy(warp).requires_grad_()
        y = fn(ti, tw)
        y.backward(torch.from_numpy(g))
        outs.append((y.detach(), ti.grad, tw.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def _corner_warp(seed, n=2, h=16, w=16):
    """The NLT convention: background queries pinned to (0, 0), some
    fully out of bounds, the rest near the identity."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.arange(w), np.arange(h))
    warp = (np.tile(np.stack([xs, ys], -1)[None], (n, 1, 1, 1))
            + rng.uniform(0, 1, (n, h, w, 2))).astype(np.float32)
    warp[:, :5] = 0.0
    warp[:, 5, :4] = -3.0
    img = rng.uniform(0, 1, (n, h, w, 3)).astype(np.float32)
    g = rng.uniform(-1, 1, (n, h, w, 3)).astype(np.float32)
    return img, warp, g


@pytest.mark.parametrize("zero_grad_texel", [None, (0, 0)])
def test_make_plan_matches_jax(zero_grad_texel):
    img, warp, _ = _corner_warp(4)
    h, w = img.shape[1:3]
    want = jres.make_plan(jnp.asarray(warp), h, w,
                          zero_grad_texel=zero_grad_texel)
    got = tres.make_plan(torch.from_numpy(warp), h, w,
                         zero_grad_texel=zero_grad_texel)
    assert got["rows"].dtype == torch.int32
    np.testing.assert_array_equal(got["rows"].numpy(),
                                  np.asarray(want["rows"]))
    np.testing.assert_array_equal(got["wslot"].numpy(),
                                  np.asarray(want["wslot"]))
    live = got["grad_rows"] >= 0
    torch.testing.assert_close(got["grad_rows"][live], got["rows"][live])
    # Dead: every nonzero-weight slot discarded. Fully out-of-bounds
    # queries always are; with the (0, 0) rule so are the pinned rows.
    assert not live[:, 5, :4].any()
    assert bool(live[:, :5].any()) == (zero_grad_texel is None)


@pytest.mark.parametrize("zero_grad_texel", [None, (0, 0)])
def test_planned_values_and_grads_match_jax(zero_grad_texel):
    """Through set_left_top_corner (the model's use), d_img equals
    nlt_tpu's everywhere; nlt_tpu's CPU backward keeps every update,
    the port's drops the dead ones."""
    img, warp, g = _corner_warp(5)
    h, w = img.shape[1:3]
    jplan = jres.make_plan(jnp.asarray(warp), h, w,
                           zero_grad_texel=zero_grad_texel)
    want, vjp = jax.vjp(lambda im: jres.resample_planned(jcorner(im, 0.0),
                                                         jplan),
                        jnp.asarray(img))
    (want_dimg,) = vjp(jnp.asarray(g))
    plan = tres.make_plan(torch.from_numpy(warp), h, w,
                          zero_grad_texel=zero_grad_texel)
    ti = torch.from_numpy(img).requires_grad_()
    got = tres.resample_planned(tcorner(ti, 0.0), plan)
    got.backward(torch.from_numpy(g))
    _close(got, want)
    _close(ti.grad, want_dimg)


def test_dead_update_rule_changes_only_texel_00():
    """Without the corner blackout the planned backward differs from
    the unplanned one only at texel (0, 0), which the model's
    set_left_top_corner zeroes anyway."""
    img, warp, g = _corner_warp(6)
    h, w = img.shape[1:3]
    grads = []
    for plan in (None, tres.make_plan(torch.from_numpy(warp), h, w,
                                      zero_grad_texel=(0, 0))):
        ti = torch.from_numpy(img).requires_grad_()
        y = (tres.resample(ti, torch.from_numpy(warp)) if plan is None
             else tres.resample_planned(ti, plan))
        y.backward(torch.from_numpy(g))
        grads.append(ti.grad)
    diff = (grads[0] - grads[1]).abs().amax(dim=(0, 3))
    assert float(diff[0, 0]) > 0.1
    diff[0, 0] = 0
    assert float(diff.max()) <= TOL
