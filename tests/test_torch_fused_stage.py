"""nlt_tpu_torch.ops.fused_stage against nlt_tpu.ops.fused_stage: the
port's ops on CPU tensors (their plain PyTorch versions) against the
Pallas kernels in interpret mode, plain and lane-packed, and against
the JAX references; plus the CUDA launch plan, which is plain Python.
Inputs come from a numpy seed and go to both packages."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu.ops import fused_stage as jfs
from nlt_tpu_torch.ops import fused_stage as tfs
from tests.torch_ref import jax_call, jax_value_and_grads

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _args(rng, shape, o):
    c = shape[3]
    return [rng.standard_normal(shape).astype(np.float32),
            (rng.standard_normal((2, 2, c, o)) * 0.3).astype(np.float32),
            (rng.standard_normal(o) * 0.1).astype(np.float32),
            (rng.standard_normal((2, 2, o, o)) * 0.3).astype(np.float32),
            (rng.standard_normal(o) * 0.1).astype(np.float32)]


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.detach().float() if isinstance(got, torch.Tensor)
                   else got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol)


# f32 tolerance of tests/test_fused_stage.py: the two sides sum the same
# products in different orders.
TOL = 1e-5


@pytest.mark.parametrize("kind,shape,o,packing", [
    ("contract", (2, 16, 24, 6), 10, 1),
    ("contract", (1, 8, 8, 3), 4, 1),
    ("contract", (2, 16, 32, 4), 6, 2),
    ("expand", (2, 8, 12, 10), 6, 1),
    ("expand", (1, 4, 4, 3), 4, 1),
    ("expand", (2, 8, 16, 6), 5, 2),
])
@pytest.mark.parametrize("slope", [0.3, 0.0])
def test_stage_matches_pallas_kernel(rng, kind, shape, o, packing, slope):
    """y2 and y1 of the port's op equal the Pallas kernel's (interpret
    mode), including its column-packed layout (packing=2)."""
    args = _args(rng, shape, o)
    jfwd = (jfs._contract_fwd_pallas if kind == "contract"
            else jfs._expand_fwd_pallas)
    want_y2, want_y1 = jax_call(jfwd, *[jnp.asarray(a) for a in args],
                                slope=slope, interpret=True, packing=packing)
    op = tfs.contract_stage if kind == "contract" else tfs.expand_stage
    y2, y1 = op(*[torch.from_numpy(a) for a in args], slope=slope,
                return_y1=True)
    assert y2.shape == want_y2.shape and y1.shape == want_y1.shape
    _close(y2, want_y2, TOL)
    _close(y1, want_y1, TOL)
    y2_only = op(*[torch.from_numpy(a) for a in args], slope=slope)
    assert torch.equal(y2_only, y2)


@pytest.mark.parametrize("kind", ["contract", "expand"])
@pytest.mark.parametrize("dtype,tol", [
    ("float32", TOL),
    # bfloat16: both sides round at the same points (each tap product,
    # the running sum, y1); only the order of float32 partial sums
    # differs, which can flip a rounding: 1 bf16 ulp at |y| < 4.
    ("bfloat16", 2.0 ** -6),
])
def test_plain_version_matches_jax_reference(rng, kind, dtype, tol):
    args = _args(rng, (2, 8, 12, 6), 5)
    jref = (jfs.contract_stage_ref if kind == "contract"
            else jfs.expand_stage_ref)
    tref = (tfs.contract_stage_ref if kind == "contract"
            else tfs.expand_stage_ref)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    want = jax_call(jref, *[jnp.asarray(a).astype(jd) for a in args])
    got = tref(*[torch.from_numpy(a).to(td) for a in args])
    for g, w in zip(got, want):
        assert g.dtype == td
        _close(g, w, tol)


def test_stage_check_rejects_bad_inputs():
    x = torch.zeros(1, 6, 6, 4)
    w1, b1 = torch.zeros(2, 2, 4, 3), torch.zeros(3)
    w2, b2 = torch.zeros(2, 2, 3, 3), torch.zeros(3)
    with pytest.raises(ValueError):
        tfs.contract_stage(torch.zeros(1, 5, 6, 4), w1, b1, w2, b2)
    with pytest.raises(ValueError):
        tfs.contract_stage(x, torch.zeros(2, 2, 5, 3), b1, w2, b2)
    with pytest.raises(ValueError):
        tfs.expand_stage(x, w1, b1, torch.zeros(2, 2, 3, 4), b2)
    # A CPU tensor runs the plain version and launches nothing.
    tfs.reset_launches()
    tfs.contract_stage(x, w1, b1, w2, b2)
    assert tfs.LAUNCHES == {"contract_stage": 0, "expand_stage": 0}


# Every stage shape of the flagship U-Net (depth0 16, depth 256, 512^2),
# query and obs paths: (contract?, C, O, input H = W).
FLAGSHIP_STAGES = (
    [(True, c, o, h) for c, o, h in [
        (32, 16, 512), (32, 32, 256), (64, 64, 128), (128, 128, 64),
        (256, 256, 32), (512, 256, 16), (16, 16, 512), (16, 32, 256),
        (32, 64, 128), (64, 128, 64), (128, 256, 32), (256, 256, 16)]]
    + [(False, c, o, h) for c, o, h in [
        (1024, 128, 8), (640, 64, 16), (320, 32, 32), (160, 16, 64),
        (80, 8, 128), (40, 4, 256)]])


@pytest.mark.parametrize("itemsize", [2, 4])
def test_launch_plan_fits_every_flagship_stage(itemsize):
    """The plan of every flagship stage, bs 1 and 4, fits a block's
    shared memory and covers the stage's grid."""
    for contract, c, o, h in FLAGSHIP_STAGES:
        for n in (1, 4):
            th, tw, bn1, bn2 = tfs._plan(contract, n, h, h, c, o, itemsize)
            assert tfs._smem_bytes(contract, th, tw, o, bn1, bn2,
                                   itemsize) <= tfs._SMEM_MAX
            g = h // 2 if contract else h
            assert 1 <= th < 2 * g and 1 <= tw < 2 * g
            assert bn1 in tfs._BNS and bn2 in tfs._BNS


# The tiled kernel's plans (th, tw, bn1, bn2) of every flagship stage, by
# (bs, itemsize): (1, 2), (1, 4), (4, 2), (4, 4). Pinned so that the
# split expand route leaves the contract route and the tiled expand
# route's tilings as they were.
TILED_PLANS = {
    (True, 32, 16, 512): [(4, 32, 16, 16)] * 2 + [(16, 32, 16, 16),
                                                  (8, 32, 16, 16)],
    (True, 32, 32, 256): [(2, 32, 32, 32)] * 2 + [(4, 32, 16, 32)] * 2,
    (True, 64, 64, 128): [(2, 16, 64, 64)] * 4,
    (True, 128, 128, 64): [(2, 8, 128, 128)] * 4,
    (True, 256, 256, 32): [(2, 4, 256, 256)] * 4,
    (True, 512, 256, 16): [(2, 4, 256, 256)] * 4,
    (True, 16, 16, 512): [(4, 32, 16, 16)] * 2 + [(16, 32, 16, 16),
                                                  (8, 32, 16, 16)],
    (True, 16, 32, 256): [(2, 32, 32, 32)] * 2 + [(4, 32, 16, 32)] * 2,
    (True, 32, 64, 128): [(2, 16, 64, 64)] * 4,
    (True, 64, 128, 64): [(2, 8, 128, 128)] * 4,
    (True, 128, 256, 32): [(2, 4, 256, 256)] * 4,
    (True, 256, 256, 16): [(2, 4, 256, 256)] * 4,
    (False, 1024, 128, 8): [(2, 4, 256, 128)] * 4,
    (False, 640, 64, 16): [(2, 4, 256, 64)] * 4,
    (False, 320, 32, 32): [(2, 8, 128, 32)] * 4,
    (False, 160, 16, 64): [(2, 16, 64, 16)] * 4,
    (False, 80, 8, 128): [(2, 32, 32, 16)] * 2 + [(4, 32, 16, 16)] * 2,
    (False, 40, 4, 256): [(4, 32, 16, 16)] * 2 + [(16, 32, 16, 16),
                                                 (8, 32, 16, 16)],
}


@pytest.mark.parametrize("stage", FLAGSHIP_STAGES)
def test_tiled_plan_is_pinned(stage):
    contract, c, o, h = stage
    got = [tfs._plan(contract, n, h, h, c, o, item)
           for n in (1, 4) for item in (2, 4)]
    assert got == TILED_PLANS[stage]


# Expand stages the split route leaves on the tiled kernel, by (bs,
# itemsize): only bf16 O = 4, whose O / S slice is never a whole 16-byte
# copy.
SPLIT_KEPT_TILED = {(40, 4, 256, 1, 2), (40, 4, 256, 4, 2)}


@pytest.mark.parametrize("stage", [s for s in FLAGSHIP_STAGES if not s[0]])
@pytest.mark.parametrize("itemsize", [2, 4])
def test_split_plan_of_every_flagship_expand_stage(stage, itemsize):
    """_split_plan at bs 1 and 4: a plan that fits a block's shared
    memory and threads, S in 1, 2, 4, 8 dividing O with whole 16-byte
    rows, and clusters of S blocks that cover the stage's grid; None
    where the tiled kernel keeps the stage."""
    _, c, o, h = stage
    for n in (1, 4):
        plan = tfs._split_plan(n, h, h, c, o, itemsize)
        if (c, o, h, n, itemsize) in SPLIT_KEPT_TILED:
            assert plan is None
            continue
        assert plan is not None
        th, tw, s, ch = plan
        assert s in (1, 2, 4, 8) and o % s == 0
        assert (o // s) * itemsize % 16 == 0 and c * itemsize % 16 == 0
        assert ch in tfs._SPLIT_CHUNKS
        smem, r1, r2 = tfs._split_geometry(th, tw, o, s, ch, itemsize)
        assert smem <= tfs._SMEM_MAX and r1 in (1, 2, 4) and r2 in (1, 2, 4)
        # ceil(H / th) x ceil(W / tw) tiles per image, each a cluster of
        # S blocks, cover every input pixel once.
        assert -(-h // th) * th >= h > (-(-h // th) - 1) * th
        assert -(-h // tw) * tw >= h > (-(-h // tw) - 1) * tw
        assert plan in tfs._split_candidates(n, h, h, c, o, itemsize)
        # The deep stages (8^2 to 32^2), whose tiled grids leave SMs
        # idle, run as real clusters.
        if h <= 32:
            assert s > 1


def test_split_tuned_plans_are_candidates():
    """Every measured plan is one the kernel takes for its stage."""
    for (n, h, w, c, o, item), plan in tfs._SPLIT_TUNED.items():
        assert plan in tfs._split_candidates(n, h, w, c, o, item)


@pytest.mark.parametrize("n,h,w,c,o,itemsize", [
    (1, 5, 3, 33, 16, 4),      # C = 33: x rows are no whole 16-byte copies
    (1, 5, 3, 33, 16, 2),
    (1, 8, 8, 64, 4, 2),       # bf16 O = 4: no O / S slice of 16 bytes
    (1, 8, 8, 64, 6, 4),       # O = 6: no S gives whole float4 groups
    (64, 256, 256, 40, 4, 4),  # shapes no plan was measured at: bs 64,
    (2, 8, 8, 1024, 128, 4),   # bs 2 (the 128^2 recipes' batch),
    (2, 32, 32, 320, 32, 2),
    (4, 8, 8, 2048, 512, 2),   # a wider deep stage
])
def test_split_plan_keeps_stage_tiled(n, h, w, c, o, itemsize):
    assert tfs._split_plan(n, h, w, c, o, itemsize) is None


def test_split_route_only_where_measured():
    """The split expand route takes exactly the keys of its table, all of
    them shapes the sweep times (flagship and recipe stages); every
    other shape stays tiled. Each recipe expand stage the sweep measured
    faster split is routed, so only bf16 O = 4 keeps the tiled kernel."""
    measured = _measured_expand_keys()
    assert set(tfs._SPLIT_TUNED) <= measured
    for key in measured:
        assert tfs._split_plan(*key) == tfs._SPLIT_TUNED.get(key)
    recipe = {(n, h, h, c, o, item)
              for n, _, stages in _chip_smoke().RECIPE_STAGES.values()
              for kind, c, o, h in stages if kind == "expand_stage"
              for item in (2, 4)}
    assert {k for k in recipe if tfs._split_plan(*k) is None} == {
        (2, 64, 64, 40, 4, 2), (4, 256, 256, 40, 4, 2),
        (4, 512, 512, 40, 4, 2)}


def test_split_geometry_by_hand():
    """One launch's shared memory and thread items, computed by hand from
    csrc/expand_split.cu's layout: 3 ring stages of (9 pixels x (64 + 4)
    channels + 4 parities x 64 rows x 16 channels) floats, the 5 x 5 y1
    tile at 128 + 4 channels, 9 pixel offsets; 25 y1 pixels x 4 channel
    groups = 100 phase-1 items and 16 x 4 = 64 phase-2 items, R = 1."""
    stage = (9 * 68 + 4 * 64 * 16) * 4
    want = 3 * stage + 25 * 132 * 4 + 48
    assert tfs._split_geometry(2, 2, 128, 8, 64, 4) == (want, 1, 1)
    # 8 x 8 tiles, O / S = 8: 289 y1 pixels x 2 groups need R1 = 4 (73
    # groups x 2 = 146 items), 256 y2 pixels x 2 need R2 = 2.
    assert tfs._split_geometry(8, 8, 64, 8, 64, 4)[1:] == (4, 2)
    # A product no R <= 4 fits in 256 threads.
    assert tfs._split_geometry(8, 8, 128, 1, 32, 4)[1] == 0


def test_expand_route_on_tensors():
    """An expand call takes _split_plan's route; a pointer off a 16-byte
    boundary keeps the tiled kernel."""
    x = torch.zeros(1, 8, 8, 1024)
    w1, w2 = torch.zeros(2, 2, 1024, 128), torch.zeros(2, 2, 128, 128)
    want = tfs._split_plan(1, 8, 8, 1024, 128, 4)
    assert want is not None
    assert tfs._expand_route(x, w1, w2, 1024, 128) == want
    off = torch.zeros(1 + 8 * 8 * 1024)[1:].view(1, 8, 8, 1024)
    assert tfs._expand_route(off, w1, w2, 1024, 128) is None


def _grads(op, args, g, **kw):
    """(y2, d_args) of the port's op under autograd."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    y = op(*ts, **kw)
    y.backward(torch.from_numpy(g).to(y.dtype))
    return y, [t.grad for t in ts]


@pytest.mark.parametrize("kind,shape,o", [
    ("contract", (2, 8, 12, 6), 5),
    ("contract", (1, 16, 32, 4), 6),   # nlt_tpu packs its lanes (P=2)
    ("expand", (2, 4, 6, 10), 6),
    ("expand", (2, 8, 16, 6), 5),
])
@pytest.mark.parametrize("slope", [0.3, 0.0])
def test_stage_grads_match_jax(rng, kind, shape, o, slope):
    """Gradients of every input through ContractStage / ExpandStage
    against jax.vjp of nlt_tpu's custom_vjp (its Pallas forward in
    interpret mode, its XLA backward), float32."""
    args = _args(rng, shape, o)
    jop = jfs.contract_stage if kind == "contract" else jfs.expand_stage
    jargs = [jnp.asarray(a) for a in args]
    out = jax.eval_shape(lambda *a: jop(*a, slope, True), *jargs)
    g = rng.standard_normal(out.shape).astype(np.float32)
    y, want = jax_value_and_grads(lambda *a: jop(*a, slope, True), jargs,
                                  jnp.asarray(g))
    op = tfs.contract_stage if kind == "contract" else tfs.expand_stage
    got_y, got = _grads(op, args, g, slope=slope)
    _close(got_y, y, TOL)
    for a, b in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(b)).max()))
        _close(a / scale, np.asarray(b) / scale, TOL)


@pytest.mark.parametrize("kind", ["contract", "expand"])
def test_stage_backward_bfloat16_matches_jax(rng, kind):
    """bfloat16: the port's backward against nlt_tpu's on the same
    residuals (x, params, and the y1, y2 of nlt_tpu's Pallas forward).
    Both compute in float32 and round each gradient to bf16 once, so
    they agree to 1 bf16 ulp (2^-8 relative) of each gradient's largest
    entry; 2^-7 leaves a margin. (The forwards themselves round at other
    points, see test_plain_version_matches_jax_reference, and a y that
    changes sign flips its LeakyReLU mask, so end-to-end bf16 gradients
    are compared through the whole step in test_torch_train.py.)"""
    args = [jnp.asarray(a).astype(jnp.bfloat16)
            for a in _args(rng, (2, 8, 12, 6), 5)]
    jfwd, jbwd, tbwd = (
        (jfs._contract_fwd_pallas, jfs._contract_bwd_xla,
         tfs.contract_stage_bwd) if kind == "contract" else
        (jfs._expand_fwd_pallas, jfs._expand_bwd_xla, tfs.expand_stage_bwd))
    y2, y1 = jax_call(jfwd, *args, slope=0.3, interpret=True)
    g = jnp.asarray(rng.standard_normal(y2.shape)).astype(jnp.bfloat16)
    want = jax.jit(lambda res, g: jbwd(res + (0.3,), g))(
        tuple(args) + (y1, y2), g)

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16)

    got = tbwd(*[t(a) for a in args], t(y1), t(y2), t(g), 0.3)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        b = np.asarray(b.astype(jnp.float32))
        scale = max(1.0, float(np.abs(b).max()))
        _close(a.float() / scale, b / scale, 2.0 ** -7)


@pytest.mark.parametrize("kind", ["contract", "expand"])
def test_stage_backward_matches_autograd_of_plain_version(rng, kind):
    """The hand-derived backward equals torch autograd through the plain
    version (a check independent of nlt_tpu); float32, sums in another
    order."""
    args = _args(rng, (2, 6, 8, 4), 3)
    op = tfs.contract_stage if kind == "contract" else tfs.expand_stage
    ref = tfs.contract_stage_ref if kind == "contract" \
        else tfs.expand_stage_ref
    y = ref(*[torch.from_numpy(a) for a in args])[0]
    g = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    _, got = _grads(op, args, g)
    _, want = _grads(lambda *a: ref(*a)[0], args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=TOL, atol=TOL)


def test_stage_under_grad_refuses_return_y1():
    x = torch.zeros(1, 4, 4, 2, requires_grad=True)
    with pytest.raises(ValueError):
        tfs.contract_stage(x, torch.zeros(2, 2, 2, 3), torch.zeros(3),
                           torch.zeros(2, 2, 3, 3), torch.zeros(3),
                           return_y1=True)


# ---------------------------------------------------------------------------
# The split contract route (csrc/contract_split.cu): its planner, which is
# plain Python, and its index arithmetic, emulated on the CPU.
# ---------------------------------------------------------------------------


def _chip_smoke():
    """chip_smoke.py as a module (its stage lists; nothing runs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _measured_keys(contract):
    """Every contract (expand) shape chip_smoke.py --sweep times: the
    flagship stages at bs 1 and 4 and the recipe stages at their batch
    size, in both dtypes."""
    kind = "contract_stage" if contract else "expand_stage"
    keys = {(n, h, h, c, o, item) for is_c, c, o, h in FLAGSHIP_STAGES
            if is_c == contract for n in (1, 4) for item in (2, 4)}
    for n, _, stages in _chip_smoke().RECIPE_STAGES.values():
        keys |= {(n, h, h, c, o, item) for k, c, o, h in stages
                 if k == kind for item in (2, 4)}
    return keys


def _measured_contract_keys():
    return _measured_keys(True)


def _measured_expand_keys():
    return _measured_keys(False)


def test_contract_split_geometry_by_hand():
    """Two launches' shared memory and thread items (float32) or warp
    units (bfloat16), computed by hand from csrc/contract_split.cu's
    layout: 3 ring stages of (the y1 tile's (TH+1)(TW+1) pixels x (CH +
    one 16-byte pad) + CH weight rows x O/S, + one 16-byte pad in
    bfloat16) elements, the y1 tile at O + pad channels, one int per
    pixel."""
    # 2 x 4 tile, O = 256, S = 8, CH = 64, float32: 15 pixels; 15 x 8
    # channel groups = 120 phase-1 items, 8 x 8 = 64 phase-2 items.
    stage = (15 * 68 + 64 * 32) * 4
    want = 3 * stage + 15 * 260 * 4 + 64
    assert tfs._contract_split_geometry(2, 4, 256, 8, 64, 4) == (want, 1, 1)
    # 8 x 8 tile, O = 64, S = 2, CH = 32, bfloat16 (the tensor cores):
    # weight rows of 32 + 8 elements; 81 pixels are 6 m16 tiles x 2 n16
    # groups = 12 units over 8 warps: U1 = 2; 64 pixels 4 x 2 = 8: U2 = 1.
    # The bias slices follow as 2 x 32 float32.
    stage = (81 * 40 + 32 * 40) * 2
    want = (3 * stage + tfs._ceil_to(81 * 72 * 2, 16)
            + tfs._ceil_to(81 * 4, 16) + 2 * 32 * 4)
    assert tfs._contract_split_geometry(8, 8, 64, 2, 32, 2) == (want, 2, 1)
    # A product no R <= 4 fits in 256 threads: 25 pixels x 64 groups.
    assert tfs._contract_split_geometry(4, 4, 256, 1, 32, 4)[1] == 0


def test_contract_tc_geometry_by_hand():
    """The tensor-core path's largest tile by hand: 16 x 16 y2 pixels, O
    = 32, S = 1, CH = 64, bfloat16. The halo tile's 17 x 17 = 289 pixels
    are 19 m16 tiles x 2 n16 groups = 38 units over 8 warps (U1 = 8); the
    256 own pixels 16 x 2 = 32 (U2 = 4). A ring stage holds 289 x (64 + 8)
    x elements and 64 weight rows of 32 + 8; the bias slices 2 x 32
    float32 follow."""
    stage = (289 * 72 + 64 * 40) * 2
    want = 3 * stage + 289 * 40 * 2 + tfs._ceil_to(289 * 4, 16) + 256
    assert tfs._contract_split_geometry(16, 16, 32, 1, 64, 2) == (want, 8, 4)
    # Units beyond 8 a warp: 19 x 4 n16 groups = 76 > 64.
    assert tfs._contract_split_geometry(16, 16, 64, 1, 64, 2)[1] == 0
    # 16 x 16 tiles are candidates in bfloat16 alone.
    cands = {2: tfs._contract_split_candidates(4, 64, 64, 32, 32, 2),
             4: tfs._contract_split_candidates(4, 64, 64, 32, 32, 4)}
    assert (16, 16, 1, 64) in cands[2] and (8, 8, 1, 128) in cands[2]
    assert not any(16 in p[:2] or p[3] == 128 for p in cands[4])


def test_tc_launches_count_bf16_split_contracts(fake_launch, monkeypatch):
    """TC_LAUNCHES counts the forward launches whose products ran on the
    tensor cores: split contract launches in bfloat16, and no float32,
    tiled or expand launch; registered with graph (a replay adds what
    its capture counted) and reset by reset_launches."""
    from nlt_tpu_torch.parallel import graph

    assert any(c is tfs.TC_LAUNCHES for c in graph.COUNTERS)
    key = (1, 32, 32, 256, 256)
    monkeypatch.setitem(tfs._CONTRACT_SPLIT_TUNED, key + (2,), (2, 2, 2, 64))
    monkeypatch.setitem(tfs._CONTRACT_SPLIT_TUNED, key + (4,), (2, 2, 2, 64))
    bf16 = [t.bfloat16() for t in _stage_args(1, 32, 256, 256)]
    tfs._launch("contract_stage", *bf16, 0.3, False)
    tfs._launch("contract_stage", *bf16, 0.3, True, split=(4, 4, 2, 32))
    tfs._launch("contract_stage", *_stage_args(1, 32, 256, 256), 0.3, False)
    tfs._launch("contract_stage", *bf16, 0.3, False, plan=(1, 1, 64, 64))
    tfs._launch("expand_stage",
                *[t.bfloat16() for t in _stage_args(1, 8, 1024, 128)], 0.3,
                False, split=(1, 1, 1, 32))
    assert tfs.TC_LAUNCHES == {"contract_stage": 2}
    assert tfs.ROUTES["contract_stage"] == {"split": 3, "tiled": 1}
    tfs.reset_launches()
    assert tfs.TC_LAUNCHES == {"contract_stage": 0}


@pytest.mark.parametrize("c,o,s,itemsize,fits", [
    (32, 16, 1, 4, True), (32, 16, 4, 4, True), (32, 16, 8, 4, False),
    (32, 32, 2, 2, True), (32, 16, 4, 2, False),   # O/S = 4: 8 bytes
    (32, 16, 2, 2, False),        # bf16 O/S = 8: no n16 group
    (32, 16, 1, 2, True), (64, 256, 16, 2, True), (64, 128, 16, 2, False),
    (33, 16, 1, 4, False),                         # C rows of 132 bytes
    (32, 6, 1, 4, False), (32, 12, 2, 4, False),   # O/S no float4 groups
    (512, 256, 16, 4, True), (512, 256, 32, 4, False),
    (64, 2048, 1, 4, False), (64, 2048, 1, 2, True),  # a row of 512 copies
])
def test_contract_split_fits(c, o, s, itemsize, fits):
    assert tfs._contract_split_fits(c, o, s, itemsize) is fits


def test_contract_split_candidates_fit_the_kernel():
    """Every candidate of every measured shape fits a block's shared
    memory and threads (warps in bfloat16), with a cluster size and chunk
    the kernel takes and tiles no larger than the y2 grid allows."""
    for n, h, w, c, o, item in _measured_contract_keys():
        cands = tfs._contract_split_candidates(n, h, w, c, o, item)
        assert cands, (h, c, o, item)
        for th, tw, s, ch in cands:
            smem, r1, r2 = tfs._contract_split_geometry(th, tw, o, s, ch,
                                                        item)
            assert smem <= tfs._SMEM_MAX and r1 and r2 and r2 <= r1
            assert s in (1, 2, 4, 8, 16) and ch in (
                tfs._TC_CHUNKS if item == 2 else tfs._SPLIT_CHUNKS)
            assert th < h and tw < w


def test_contract_split_tuned_plans_are_candidates():
    """Every measured plan is one the kernel takes for its stage."""
    for (n, h, w, c, o, item), plan in tfs._CONTRACT_SPLIT_TUNED.items():
        assert plan in tfs._contract_split_candidates(n, h, w, c, o, item)


def test_contract_split_route_only_where_measured():
    """The split contract route takes exactly the keys of its table, all
    of them shapes the sweep times; every other shape stays tiled."""
    measured = _measured_contract_keys()
    assert set(tfs._CONTRACT_SPLIT_TUNED) <= measured
    for key in measured:
        assert tfs._contract_split_plan(*key) == \
            tfs._CONTRACT_SPLIT_TUNED.get(key)


@pytest.mark.parametrize("n,h,w,c,o,itemsize", [
    (1, 6, 10, 33, 16, 4),     # C = 33: x rows are no whole 16-byte copies
    (1, 6, 10, 33, 16, 2),
    (1, 16, 16, 32, 6, 4),     # O = 6: no S gives whole float4 groups
    (1, 16, 16, 32, 4, 2),     # bf16 O = 4: no O / S slice of 16 bytes
    (64, 32, 32, 256, 256, 4),  # shapes no sweep times: bs 64,
    (3, 32, 32, 256, 256, 2),   # bs 3,
    (4, 16, 16, 512, 2048, 2),  # a wider deep stage
])
def test_contract_split_plan_keeps_stage_tiled(n, h, w, c, o, itemsize):
    assert tfs._contract_split_plan(n, h, w, c, o, itemsize) is None


def test_recipe_contract_stages_tiled_unless_measured():
    """The bs-2 (128^2, depth 32) and depth-1024 recipe stages take the
    split route only at a plan the sweep measured faster than the tiled
    kernel, i.e. a key of the table; the rest keep the tiled kernel,
    whose plan fits."""
    for n, _, stages in _chip_smoke().RECIPE_STAGES.values():
        for kind, c, o, h in stages:
            for item in (2, 4):
                key = (n, h, h, c, o, item)
                plan = (tfs._contract_split_plan if kind == "contract_stage"
                        else tfs._split_plan)(*key)
                table = (tfs._CONTRACT_SPLIT_TUNED
                         if kind == "contract_stage" else tfs._SPLIT_TUNED)
                assert plan == table.get(key)
                th, tw, bn1, bn2 = tfs._plan(kind == "contract_stage", *key)
                assert tfs._smem_bytes(kind == "contract_stage", th, tw, o,
                                       bn1, bn2, item) <= tfs._SMEM_MAX


def test_contract_route_on_tensors(monkeypatch):
    """A contract call takes _contract_split_plan's route; a pointer off
    a 16-byte boundary keeps the tiled kernel; an unmeasured shape too."""
    x = torch.zeros(1, 32, 32, 256)
    w1, w2 = torch.zeros(2, 2, 256, 256), torch.zeros(2, 2, 256, 256)
    key = (1, 32, 32, 256, 256, 4)
    monkeypatch.setitem(tfs._CONTRACT_SPLIT_TUNED, key, (2, 4, 8, 64))
    assert tfs._contract_route(x, w1, w2, 256, 256) == (2, 4, 8, 64)
    off = torch.zeros(1 + 32 * 32 * 256)[1:].view(1, 32, 32, 256)
    assert tfs._contract_route(off, w1, w2, 256, 256) is None
    w1off = torch.zeros(1 + 4 * 256 * 256)[1:].view(2, 2, 256, 256)
    assert tfs._contract_route(x, w1off, w2, 256, 256) is None
    monkeypatch.delitem(tfs._CONTRACT_SPLIT_TUNED, key)
    assert tfs._contract_route(x, w1, w2, 256, 256) is None
    # The expand route is untouched by the contract table.
    xe = torch.zeros(1, 8, 8, 1024)
    assert tfs._expand_route(xe, torch.zeros(2, 2, 1024, 128),
                             torch.zeros(2, 2, 128, 128), 1024, 128) == \
        tfs._split_plan(1, 8, 8, 1024, 128, 4)


def test_contract_split_tuned_clusters_cover_grid_once():
    """Each tuned plan's grid, ceil(H2 / th) x S ceil(W2 / tw) blocks in
    clusters of S, covers every y2 pixel once and every output channel
    once per pixel."""
    for (n, h, w, c, o, item), (th, tw, s, ch) in \
            tfs._CONTRACT_SPLIT_TUNED.items():
        h2, w2 = h // 2, w // 2
        hits = np.zeros((h2, w2, o), np.int64)
        for by in range(-(-h2 // th)):
            for bx in range(s * -(-w2 // tw)):
                rank, r0, q0 = bx % s, by * th, (bx // s) * tw
                c0 = rank * (o // s)
                hits[r0:r0 + th, q0:q0 + tw, c0:c0 + o // s] += 1
        assert (hits == 1).all(), (h, c, o, item)


def _emulate_contract_split(x, w1, b1, w2, b2, plan, slope):
    """csrc/contract_split.cu's index arithmetic in float64 torch, one
    cluster tile at a time: phase 1 from the flat x offsets its loader
    copies (the patch's x offset pix plus k, and W C - 2C more for the
    di = 1 row) against w1's rows k, for the computed pixels only, each
    rank's slice into the padded y1 tile; phase 2 through the tap offsets
    of that tile. Returns (y2, y1); unwritten entries are NaN."""
    n, h, w, c = x.shape
    o = w1.shape[3]
    th, tw, s, _ = plan
    os_, gh, gw = o // s, h // 2, w // 2
    twp, ys = tw + 1, o + 4
    xf = x.double().reshape(-1)
    w1f, w2f = w1.double().reshape(4 * c, o), w2.double().reshape(4 * o, o)
    b1f, b2f = b1.double(), b2.double()
    k = torch.arange(4 * c)
    koff = k + (k >= 2 * c).long() * (w * c - 2 * c)
    y1 = torch.full((n, gh, gw, o), float("nan"), dtype=torch.float64)
    y2 = torch.full((n, gh, gw, o), float("nan"), dtype=torch.float64)

    def lrelu_(z):
        return torch.where(z >= 0, z, slope * z)

    for img in range(n):
        for r0 in range(0, gh, th):
            for q0 in range(0, gw, tw):
                nh1, nw1 = min(th + 1, gh - r0), min(twp, gw - q0)
                nh2, nw2 = min(th, gh - r0), min(tw, gw - q0)
                m = torch.arange(nh1 * nw1)
                r, cc = m // nw1, m % nw1
                pix = img * h * w * c + (2 * (r0 + r) * w + 2 * (q0 + cc)) * c
                xs = xf[pix[:, None] + koff[None, :]]
                tile = torch.zeros((th + 1) * twp * ys, dtype=torch.float64)
                for rank in range(s):
                    c0 = rank * os_
                    z = xs @ w1f[:, c0:c0 + os_] + b1f[c0:c0 + os_]
                    idx = ((r * twp + cc)[:, None] * ys + c0
                           + torch.arange(os_)[None, :])
                    tile[idx] = lrelu_(z)
                own = (r < th) & (cc < tw)
                y1[img, r0 + r[own], q0 + cc[own]] = tile[
                    (r[own] * twp + cc[own])[:, None] * ys
                    + torch.arange(o)[None, :]]
                m2 = torch.arange(nh2 * nw2)
                r2, c2 = m2 // nw2, m2 % nw2
                ybase = (r2 * twp + c2) * ys
                z2 = b2f.expand(len(m2), o)
                for tap in range(4):
                    toff = ((tap >> 1) * twp + (tap & 1)) * ys
                    ya = tile[ybase[:, None] + toff + torch.arange(o)[None, :]]
                    z2 = z2 + ya @ w2f[tap * o:(tap + 1) * o]
                y2[img, r0 + r2, q0 + c2] = lrelu_(z2)
    return y2, y1


@pytest.mark.parametrize("shape,o,plan", [
    ((2, 6, 10, 8), 8, (1, 1, 1, 32)),     # 1x1 tiles, 3 x 5 grid
    ((1, 10, 14, 12), 16, (2, 2, 2, 32)),  # ragged 5 x 7, S = 2
    ((1, 12, 12, 4), 8, (4, 4, 2, 64)),    # ragged 6 x 6, halo leaves
    ((1, 14, 18, 8), 16, (5, 7, 4, 32)),   # tiles no power of two
    ((2, 4, 8, 8), 16, (2, 4, 4, 64)),     # one tile per image
])
@pytest.mark.parametrize("slope", [0.3, 0.0])
def test_contract_split_indexing_matches_plain_version(rng, shape, o, plan,
                                                       slope):
    args = [torch.from_numpy(a) for a in _args(rng, shape, o)]
    y2, y1 = _emulate_contract_split(*args, plan, slope)
    want_y2, want_y1 = tfs.contract_stage_ref(*args, slope)
    assert not torch.isnan(y2).any() and not torch.isnan(y1).any()
    _close(y2, want_y2, TOL)
    _close(y1, want_y1, TOL)


# csrc/contract_split.cu's bfloat16 path, fragment by fragment: ldmatrix
# (lane l addresses row l % 8 of 8 x 8 matrix l / 8; lane t receives row
# t / 4, columns 2 (t % 4) and the next of each matrix, or their transpose)
# and mma.sync m16n8k16 (PTX's fragment layouts of A, B and the float32
# accumulators), in float64.


def _ldsm4(buf, addr, trans):
    """(32, 4, 2): each lane's four registers of two elements."""
    mats = buf[addr[:, None] + torch.arange(8)].reshape(4, 8, 8)
    if trans:
        mats = mats.transpose(1, 2)
    t = torch.arange(32)
    return mats[:, (t // 4)[:, None], (2 * (t % 4))[:, None]
                + torch.arange(2)].permute(1, 0, 2)


def _mma(acc, a, b0, b1):
    """acc (32, 4) += A (16 x 16) B (16 x 8) from the lanes' fragments."""
    t = torch.arange(32)
    gq, tq = t // 4, t % 4
    am = torch.zeros(16, 16, dtype=torch.float64)
    bm = torch.zeros(16, 8, dtype=torch.float64)
    for e in range(2):
        am[gq, 2 * tq + e] = a[:, 0, e]
        am[gq + 8, 2 * tq + e] = a[:, 1, e]
        am[gq, 8 + 2 * tq + e] = a[:, 2, e]
        am[gq + 8, 8 + 2 * tq + e] = a[:, 3, e]
        bm[2 * tq + e, gq] = b0[:, e]
        bm[8 + 2 * tq + e, gq] = b1[:, e]
    d = am @ bm
    return acc + torch.stack([d[gq, 2 * tq], d[gq, 2 * tq + 1],
                              d[gq + 8, 2 * tq], d[gq + 8, 2 * tq + 1]], 1)


def _emulate_contract_tc(x, w1, b1, w2, b2, plan, slope):
    """The tensor-core path's index arithmetic (Geo with item 2, the
    loader's ring layout, each warp's units, the lanes' ldmatrix rows and
    the accumulators' (pixel, channel)), one cluster tile and rank at a
    time. Unwritten shared memory reads as NaN; returns (y2, y1), NaN
    where nothing was written."""
    n, h, w, c = x.shape
    o = w1.shape[3]
    th, tw, s, ch = plan
    os_, ve, twp = o // s, 8, tw + 1
    m1, ldx, ys, lw = (th + 1) * twp, ch + ve, o + ve, o // s + ve
    stage = m1 * ldx + ch * lw
    ch2 = min(4 * o, (stage // lw) & ~15)
    ng, gh, gw = os_ // 16, h // 2, w // 2
    k1, k2 = 4 * c, 4 * o
    xf, w1f, w2f = (t.double().reshape(-1) for t in (x, w1, w2))
    b1f, b2f = b1.double(), b2.double()
    nan = float("nan")
    y1 = torch.full((n, gh, gw, o), nan, dtype=torch.float64)
    y2 = torch.full((n, gh, gw, o), nan, dtype=torch.float64)
    lane = torch.arange(32)
    lr, lc, gq, tq = lane % 16, (lane // 16) * 8, lane // 4, lane % 4

    def lrelu_(z):
        return torch.where(z >= 0, z, slope * z)

    for img, r0, q0 in [(i, r, q) for i in range(n) for r in range(0, gh, th)
                        for q in range(0, gw, tw)]:
        nh1, nw1 = min(th + 1, gh - r0), min(twp, gw - q0)
        nh2, nw2 = min(th, gh - r0), min(tw, gw - q0)
        nv1, nv2 = nh1 * nw1, nh2 * nw2
        mm = torch.arange(nv1)
        pix = img * h * w * c + (2 * (r0 + mm // nw1) * w
                                 + 2 * (q0 + mm % nw1)) * c
        nu1, nu2 = -(-nv1 // 16) * ng, -(-nv2 // 16) * ng
        tiles = []
        for rank in range(s):
            c0 = rank * os_
            y1s = torch.full((m1 * ys,), nan, dtype=torch.float64)
            for p in range(m1):
                if p // twp >= nh1 or p % twp >= nw1:
                    y1s[p * ys:(p + 1) * ys] = 0.0
            acc = {}
            for k0 in range(0, k1, ch):
                st = torch.full((stage,), nan, dtype=torch.float64)
                k = k0 + torch.arange(ch)
                ok = k < k1
                kk = k.clamp(max=k1 - 1)
                src = kk + (kk >= 2 * c).long() * (w * c - 2 * c)
                vals = torch.where(ok, xf[pix[:, None] + src[None, :]],
                                   torch.zeros(()))
                st[(mm[:, None] * ldx + torch.arange(ch)).reshape(-1)] = \
                    vals.reshape(-1)
                wrow = torch.where(ok[:, None], w1f.reshape(k1, o)[
                    kk, c0:c0 + os_], torch.zeros(()))
                st[(m1 * ldx + torch.arange(ch)[:, None] * lw
                    + torch.arange(os_)).reshape(-1)] = wrow.reshape(-1)
                kc = min(ch, k1 - k0)
                for warp in range(8):
                    for u in range(warp, nu1, 8):
                        m = torch.clamp((u // ng) * 16 + lr, max=nv1 - 1)
                        a1 = m * ldx + lc
                        b1o = m1 * ldx + lr * lw + (u % ng) * 16 + lc
                        for kk in range(0, kc, 16):
                            a = _ldsm4(st, a1 + kk, False)
                            b = _ldsm4(st, b1o + kk * lw, True)
                            for f in range(2):
                                acc[u, f] = _mma(acc.get(
                                    (u, f), torch.zeros(32, 4,
                                                        dtype=torch.float64)),
                                    a, b[:, 2 * f], b[:, 2 * f + 1])
            for (u, f), v in acc.items():
                for hh in range(2):
                    m = (u // ng) * 16 + gq + 8 * hh
                    ok = m < nv1
                    pos = (m // nw1) * twp + m % nw1
                    chn = c0 + (u % ng) * 16 + f * 8 + 2 * tq
                    for e in range(2):
                        y1s[(pos * ys + chn + e)[ok]] = lrelu_(
                            v[:, 2 * hh + e] + b1f[chn + e])[ok]
            tiles.append(y1s)
        # The exchange, then phase 2 per rank.
        for rank in range(s):
            y1s = tiles[rank].clone()
            for peer in range(s):
                if peer != rank:
                    for p in range(nv1):
                        pos = (p // nw1) * twp + p % nw1
                        sl = slice(pos * ys + peer * os_,
                                   pos * ys + (peer + 1) * os_)
                        y1s[sl] = tiles[peer][sl]
            c0 = rank * os_
            pp = torch.arange(nv2)
            own = (pp // nw2) * twp + pp % nw2
            y1[img, r0 + pp // nw2, q0 + pp % nw2, c0:c0 + os_] = y1s[
                own[:, None] * ys + c0 + torch.arange(os_)]
            acc = {}
            for k0 in range(0, k2, ch2):
                rows = min(ch2, k2 - k0)
                st = torch.full((stage,), nan, dtype=torch.float64)
                st[(torch.arange(rows)[:, None] * lw
                    + torch.arange(os_)).reshape(-1)] = w2f.reshape(k2, o)[
                    k0:k0 + rows, c0:c0 + os_].reshape(-1)
                for warp in range(8):
                    for u in range(warp, nu2, 8):
                        p0 = (u // ng) * 16 + lr
                        p = torch.where(p0 < nv2, p0, 0)
                        a2 = ((p // nw2) * twp + p % nw2) * ys + lc
                        for kk in range(0, rows, 16):
                            tap = (k0 + kk) // o
                            ya = ((tap >> 1) * twp + (tap & 1)) * ys + k0 \
                                + kk - tap * o
                            a = _ldsm4(y1s, ya + a2, False)
                            b = _ldsm4(st, (kk + lr) * lw + (u % ng) * 16
                                       + lc, True)
                            for f in range(2):
                                acc[u, f] = _mma(acc.get(
                                    (u, f), torch.zeros(32, 4,
                                                        dtype=torch.float64)),
                                    a, b[:, 2 * f], b[:, 2 * f + 1])
            for (u, f), v in acc.items():
                for hh in range(2):
                    p = (u // ng) * 16 + gq + 8 * hh
                    ok = p < nv2
                    chn = c0 + (u % ng) * 16 + f * 8 + 2 * tq
                    for e in range(2):
                        y2[img, (r0 + p // nw2)[ok], (q0 + p % nw2)[ok],
                           (chn + e)[ok]] = lrelu_(
                            v[:, 2 * hh + e] + b2f[chn + e])[ok]
    return y2, y1


@pytest.mark.parametrize("shape,o,plan", [
    ((1, 6, 10, 8), 16, (2, 2, 1, 32)),     # S = 1, ragged 3 x 5, M 9 -> 16
    ((1, 10, 14, 24), 32, (2, 4, 2, 32)),   # S = 2, ragged, 4C = 3 chunks
    ((2, 8, 8, 40), 64, (4, 4, 4, 64)),     # S = 4, K tail: 4C = 2.5 chunks
    ((1, 12, 20, 16), 32, (3, 5, 1, 32)),   # tiles no power of two
    ((1, 18, 18, 16), 16, (8, 8, 1, 64)),   # ragged 9 x 9, 81 -> 96 rows
    ((1, 8, 8, 16), 128, (2, 2, 2, 32)),    # n16 groups, 4 O in 16 chunks
    ((1, 34, 34, 8), 16, (16, 16, 1, 32)),  # 16 x 16 tiles, 289 -> 304
])
def test_contract_tc_indexing_matches_plain_version(rng, shape, o, plan):
    args = [torch.from_numpy(a) for a in _args(rng, shape, o)]
    y2, y1 = _emulate_contract_tc(*args, plan, 0.3)
    want_y2, want_y1 = tfs.contract_stage_ref(*args, 0.3)
    assert not torch.isnan(y2).any() and not torch.isnan(y1).any()
    _close(y2, want_y2, TOL)
    _close(y1, want_y1, TOL)


@pytest.mark.parametrize("recipe", ["dragon_sss.ini", "sphere_synthetic.ini",
                                    "dragon_sss.ini@uv1024"])
def test_recipe_stages_are_the_models_calls(recipe, monkeypatch):
    """chip_smoke.RECIPE_STAGES lists the stage calls the port's model
    makes under the recipe's keys ("@uv<n>": at uvh = uvw = n): the stage
    ops replaced by a recorder that returns zeros of the output shape,
    one forward at the recipe's batch size. The depth-1024 recipes run at
    256^2 (their stages' channel widths are what differ from the
    flagship; the spatial sizes are scaled back)."""
    from nlt_tpu_torch.models.nlt import Model
    from nlt_tpu_torch.utils import config as tconfig

    n_want, dtype, stages = _chip_smoke().RECIPE_STAGES[recipe]
    ini, _, uv = recipe.partition("@uv")
    cfg = tconfig.read_config(os.path.join(ROOT, "nlt_tpu", "config", ini))
    full = int(uv) if uv else cfg.get_int("uvh")
    res = 256 if cfg.get_int("depth") > 256 else full
    scale = full // res
    for key in ("uvh", "uvw", "imh", "imw"):
        cfg.set(key, str(res))
    monkeypatch.setenv("NLT_TPU_FUSED_STAGE", "1")
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    seen = []

    def recorder(kind):
        def op(x, w1, b1, w2, b2, slope=0.3, return_y1=False):
            nb, h, w, c = x.shape
            o = w1.shape[3]
            seen.append((kind, c, o, h * scale, nb, x.dtype))
            if kind == "contract_stage":
                return x.new_zeros((nb, h // 2, w // 2, o))
            return x.new_zeros((nb, 2 * h, 2 * w, o))
        return op

    for kind in ("contract_stage", "expand_stage"):
        monkeypatch.setattr(tfs, kind, recorder(kind))
    n = cfg.get_int("bs")
    rng = np.random.RandomState(0)

    def img(ch):
        return torch.from_numpy(
            rng.uniform(0, 1, (n, res, res, ch)).astype(np.float32))

    batch = {"base": img(3), "cvis": img(1), "lvis": img(1), "warp": img(2),
             "nn_base": img(3), "nn_rgb": img(3), "nn_rgb_camspc": img(3)}
    with torch.no_grad():
        model.apply(params, batch, "test", outputs=("pred",))
    assert n == n_want
    assert {(b, d) for *_, b, d in seen} == {(n, getattr(torch, dtype))}
    assert list(dict.fromkeys(s[:4] for s in seen)) == stages


def test_build_hash_covers_headers(monkeypatch, tmp_path):
    """A library's name hashes its source and every header of csrc/, so
    an edited header (csrc/split_common.cuh, shared by both split
    kernels) builds anew instead of reusing a stale library."""
    from nlt_tpu_torch.ops import _build

    real = sorted(os.listdir(_build.CSRC))
    assert "split_common.cuh" in real
    for name in ("contract_split.cu", "expand_split.cu"):
        with open(os.path.join(_build.CSRC, name)) as f:
            assert '#include "split_common.cuh"' in f.read()
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    src, lib = _build._target("a")
    assert src == str(tmp_path / "a.cu") and _build._target("a")[1] == lib
    (tmp_path / "h.cuh").write_text("// two\n")
    lib2 = _build._target("a")[1]
    assert lib2 != lib
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n// edited\n')
    assert _build._target("a")[1] not in (lib, lib2)


@pytest.mark.parametrize("kind,shape,o", [
    ("contract", (2, 8, 6, 4), 6), ("expand", (2, 4, 3, 6), 5)])
def test_custom_op_opcheck(rng, kind, shape, o):
    """The registered inference op passes torch.library.opcheck (schema,
    autograd registration, the fake against the CPU kernel, AOT
    dispatch), and an inference call of the public op goes through it:
    its CPU kernel is the plain version's y2, bit for bit."""
    args = [torch.from_numpy(a) for a in _args(rng, shape, o)]
    op = tfs.OPS[kind + "_stage"]
    assert str(op._qualname) == "nlt_tpu_torch::%s_stage" % kind
    torch.library.opcheck(op, tuple(args) + (0.3,))
    want = getattr(tfs, kind + "_stage_ref")(*args, 0.3)[0]
    torch.testing.assert_close(op(*args, 0.3), want, rtol=0, atol=0)
    seen = []
    orig = tfs.OPS[kind + "_stage"]
    tfs.OPS[kind + "_stage"] = lambda *a: seen.append(a) or orig(*a)
    try:
        with torch.no_grad():
            got = getattr(tfs, kind + "_stage")(*args, 0.3)
    finally:
        tfs.OPS[kind + "_stage"] = orig
    assert len(seen) == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_custom_op_fake_launches_nothing(rng):
    """Tracing with fake tensors (what torch.export does) runs the fake
    kernel: y2's shape, dtype and device, no launch counted; the fake
    checks shapes as the op does."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    tfs.reset_launches()
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(torch.from_numpy(a))
                for a in _args(rng, (1, 8, 8, 4), 6)]
        y = tfs.OPS["contract_stage"](*args, 0.3)
        assert tuple(y.shape) == (1, 4, 4, 6) and y.dtype == torch.float32
        with pytest.raises(ValueError, match="w1 must be"):
            tfs.OPS["expand_stage"](args[0], args[3], args[2], args[3],
                                    args[4], 0.3)
    assert tfs.LAUNCHES == {"contract_stage": 0, "expand_stage": 0}


@pytest.fixture
def fake_launch(monkeypatch):
    """_launch on CPU tensors: the libraries' launches return success and
    write nothing, the CUDA device and stream are stubbed."""
    import contextlib
    import types

    ok = lambda *a: 0  # noqa: E731
    lib = types.SimpleNamespace(launch=ok, error_string=ok,
                                nlt_contract_stage=ok, nlt_expand_stage=ok,
                                nlt_error_string=ok)
    monkeypatch.setattr(tfs, "_split_lib", lambda kind: lib)
    monkeypatch.setattr(tfs, "_lib", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    tfs.reset_launches()
    yield
    tfs.reset_launches()


def _stage_args(n, h, c, o):
    return (torch.zeros(n, h, h, c), torch.zeros(2, 2, c, o), torch.zeros(o),
            torch.zeros(2, 2, o, o), torch.zeros(o))


def test_routes_count_launches_by_route(fake_launch):
    """ROUTES counts each launch once, on the route it took, beside
    LAUNCHES: a measured shape on the split kernel, an unmeasured one and
    a forced tiled plan on the tiled kernel, a forced split plan on the
    split kernel. Its counters are registered with graph, as LAUNCHES
    is, so a replay adds what its capture counted."""
    from nlt_tpu_torch.parallel import graph

    assert all(any(c is r for c in graph.COUNTERS)
               for r in tfs.ROUTES.values())
    measured = _stage_args(1, 32, 256, 256)
    tfs._launch("contract_stage", *measured, 0.3, False)
    tfs._launch("contract_stage", *_stage_args(1, 6, 40, 33), 0.3, False)
    tfs._launch("contract_stage", *measured, 0.3, False, plan=(1, 1, 64, 64))
    tfs._launch("expand_stage", *_stage_args(1, 8, 1024, 128), 0.3, True)
    tfs._launch("expand_stage", *_stage_args(1, 4, 40, 4), 0.3, False,
                split=(1, 1, 1, 32))
    assert tfs.ROUTES == {"contract_stage": {"split": 1, "tiled": 2},
                          "expand_stage": {"split": 2, "tiled": 0}}
    assert tfs.LAUNCHES == {"contract_stage": 3, "expand_stage": 2}
    tfs.reset_launches()
    assert tfs.ROUTES == {"contract_stage": {"split": 0, "tiled": 0},
                          "expand_stage": {"split": 0, "tiled": 0}}


def test_routes_of_a_replay(fake_launch, monkeypatch):
    """A captured program's replay adds the routes its capture counted."""
    from nlt_tpu_torch.parallel import graph
    from tests.torch_ref import EmulatedGraphs

    monkeypatch.setattr(graph, "_graphs_on", lambda device: EmulatedGraphs)
    monkeypatch.setattr(graph, "eager_reason", lambda *a, **kw: None)
    args = _stage_args(1, 8, 1024, 128)
    run = graph.Captured(lambda x: (tfs._launch(
        "expand_stage", x, *args[1:], 0.3, False), tfs._launch(
        "contract_stage", *_stage_args(1, 6, 40, 33), 0.3, False))[0],
        name="routes")
    for i in range(1, 4):
        run(args[0])
        assert tfs.ROUTES == {"contract_stage": {"split": 0, "tiled": i},
                              "expand_stage": {"split": i, "tiled": 0}}
    assert (run.captures, run.replays) == (1, 2)


def test_unmeasured_shape_warns_once(capsys, monkeypatch):
    """A shape the split kernel could take but no sweep measured runs
    tiled and says so once, naming the shape; a shape the split kernel
    cannot take (bf16 O = 4) and a measured one say nothing."""
    monkeypatch.setattr(tfs, "_warn_unmeasured",
                        functools.lru_cache(maxsize=None)(
                            tfs._warn_unmeasured.__wrapped__))
    x, w1, _, w2, _ = _stage_args(3, 32, 256, 256)
    capsys.readouterr()
    for _ in range(3):
        assert tfs._contract_route(x, w1, w2, 256, 256) is None
    out = capsys.readouterr().out
    assert out.count("no measured split plan; runs tiled") == 1
    assert "(3, 32, 32, 256, 256, 4)" in out
    xe, w1e, _, w2e, _ = (t.bfloat16() for t in _stage_args(4, 256, 40, 4))
    assert tfs._expand_route(xe, w1e, w2e, 40, 4) is None
    xm, w1m, _, w2m, _ = _stage_args(1, 8, 1024, 128)
    assert tfs._expand_route(xm, w1m, w2m, 1024, 128) is not None
    assert "no measured split plan" not in capsys.readouterr().out


def test_uv1024_stages_have_split_plans():
    """Every fused stage of benchmark/configs/dragon_sss_uv1024.json's
    training step (cost/stages.fused_launches), in both dtypes, has a
    measured split plan, but the bf16 O = 4 stage (no 16-byte O / S row;
    the sweep found no shape faster tiled); each plan is one the kernel
    takes: 16-byte copies of C and the O / S slice, shared memory and
    thread items within a block (the checks every key passes)."""
    import json

    from benchmark.cost import stages

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "dragon_sss_uv1024.json")) as f:
        cfg = json.load(f)
    launches = stages.fused_launches(cfg, cfg["bs"], "train")
    assert len(launches) == 24
    tiled = set()
    for op, shape, _, o in launches:
        for item in (2, 4):
            key = (*shape, o, item)
            contract = op == "contract_stage"
            plan = (tfs._contract_split_plan if contract
                    else tfs._split_plan)(*key)
            if plan is None:
                tiled.add(key)
                continue
            th, tw, s, ch = plan
            fits = tfs._contract_split_fits if contract else tfs._split_fits
            geometry = (tfs._contract_split_geometry if contract
                        else tfs._split_geometry)
            assert fits(shape[3], o, s, item)
            smem, r1, r2 = geometry(th, tw, o, s, ch, item)
            assert smem <= tfs._SMEM_MAX and r1 and r2
    assert tiled == {(4, 512, 512, 40, 4, 2)}
