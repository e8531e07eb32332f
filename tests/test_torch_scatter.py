"""nlt_tpu_torch.ops.scatter (K1's plain version, which the op runs on a
CPU tensor) against nlt_tpu's Pallas scatter in interpret mode, plain
and planned, at the shapes of tests/test_scatter_pallas.py; plus dead
rows, duplicates and the argument checks. Inputs come from a numpy seed
and go to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu.ops import scatter_pallas as jsp
from nlt_tpu_torch.ops import scatter as tsc

# float32 sums of the same updates in another order.
TOL = 1e-6


def _case(seed, n_rows, n_groups, per_group, w, dead_frac=0.0):
    rng = np.random.RandomState(seed)
    gr = n_rows // n_groups
    idx = np.concatenate(
        [g * gr + rng.randint(0, gr, per_group) for g in range(n_groups)])
    idx[rng.uniform(size=idx.shape) < dead_frac] = -1
    upd = rng.rand(len(idx), w).astype(np.float32)
    return idx.astype(np.int32), upd


def _np_ref(idx, upd, n_rows):
    out = np.zeros((n_rows, upd.shape[1]), np.float32)
    keep = idx >= 0
    np.add.at(out, idx[keep], upd[keep])
    return out


@pytest.mark.parametrize("n_rows,n_groups,per_group,w", [
    (64, 2, 50, 5),        # ragged, multi-group
    (2048, 4, 750, 12),    # flagship-like width
    (96, 1, 50, 3),        # single group
    (16, 1, 3, 1),         # tiny
])
@pytest.mark.parametrize("dead_frac", [0.0, 0.5])
def test_matches_pallas_scatter(n_rows, n_groups, per_group, w, dead_frac):
    idx, upd = _case(n_rows + w, n_rows, n_groups, per_group, w, dead_frac)
    want = jsp.scatter_add_rows(jnp.asarray(idx), jnp.asarray(upd), n_rows,
                                n_groups)
    tsc.reset_launches()
    got = tsc.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(upd),
                               n_rows)
    assert got.shape == (n_rows, w) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), _np_ref(idx, upd, n_rows),
                               rtol=TOL, atol=TOL)
    # A CPU tensor runs the plain version: no kernel launch.
    assert tsc.LAUNCHES == {"scatter_add_rows": 0}


@pytest.mark.parametrize("n_rows,n_groups,per_group,w", [
    (64, 2, 50, 5), (2048, 4, 750, 12), (96, 1, 50, 3)])
def test_matches_planned_pallas_scatter(n_rows, n_groups, per_group, w):
    """nlt_tpu's planned route (routing precomputed by make_plan, dead
    updates marked -1) is the same function of (idx, upd)."""
    idx, upd = _case(n_rows * 7 + w, n_rows, n_groups, per_group, w, 0.3)
    routed, lo, hi = jax.jit(jsp.make_plan, static_argnums=(1, 2))(
        jnp.asarray(idx), n_rows, n_groups)
    want = jsp.scatter_add_rows_planned(routed, lo, hi, jnp.asarray(upd),
                                        n_rows, n_groups)
    got = tsc.scatter_add_rows(torch.from_numpy(idx), torch.from_numpy(upd),
                               n_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_duplicates_dead_and_disjoint_rows():
    idx = torch.tensor([3, 3, 3, 3, -1, 7], dtype=torch.int32)
    upd = torch.ones((6, 2))
    out = tsc.scatter_add_rows(idx, upd, 8)
    assert out[3].tolist() == [4.0, 4.0] and out[7].tolist() == [1.0, 1.0]
    assert float(out.abs().sum()) == 10.0
    # Rows hit once are exact; all-dead gives zeros; int64 indices work.
    rng = np.random.RandomState(1)
    perm = torch.from_numpy(rng.permutation(50)[:40])
    vals = torch.from_numpy(rng.standard_normal((40, 3)).astype(np.float32))
    out = tsc.scatter_add_rows(perm, vals, 50)
    assert torch.equal(out[perm], vals)
    dead = tsc.scatter_add_rows(torch.full((40,), -1), vals, 50)
    assert torch.equal(dead, torch.zeros(50, 3))


def test_argument_checks():
    with pytest.raises(ValueError):
        tsc.scatter_add_rows(torch.zeros(4, dtype=torch.int32),
                             torch.zeros(5, 2), 8)
    with pytest.raises(ValueError):
        tsc.scatter_add_rows(torch.zeros((4, 1), dtype=torch.int32),
                             torch.zeros(4, 2), 8)
    with pytest.raises(TypeError):
        tsc.scatter_add_rows(torch.zeros(4), torch.zeros(4, 2), 8)


@pytest.mark.parametrize("w", [1, 3, 5, 12, 16, 20])
def test_launch_plan_paths_and_grid(w):
    """csrc/scatter.cu's launch plan, mirrored by launch_plan: the float4
    path only where W is a multiple of 4 up to 16 (W / 4 fixed at compile
    time) and both pointers are 16-byte aligned, else the scalar path; a
    grid of 256-thread blocks, capped at 132 x 16, that reaches every
    row in its grid-stride loop and has no idle block."""
    for r in (1, 255, 256, 257, 1 << 20, 3 << 22):
        for upd_off, out_off in ((0, 0), (4, 0), (0, 4), (8, 8), (16, 32)):
            p = tsc.launch_plan(r, w, (1 << 30) + upd_off,
                                (1 << 31) + out_off)
            vec = (w % 4 == 0 and w <= 16 and upd_off % 16 == 0
                   and out_off % 16 == 0)
            assert p["wv"] == (w // 4 if vec else 0)
            assert 1 <= p["blocks"] <= 132 * 16
            assert (p["blocks"] - 1) * 256 < r
            assert p["blocks"] * 256 >= r or p["blocks"] == 132 * 16
