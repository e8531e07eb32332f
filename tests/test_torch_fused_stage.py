"""nlt_tpu_torch.ops.fused_stage against nlt_tpu.ops.fused_stage: the
port's ops on CPU tensors (their plain PyTorch versions) against the
Pallas kernels in interpret mode, plain and lane-packed, and against
the JAX references; plus the CUDA launch plan, which is plain Python.
Inputs come from a numpy seed and go to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlt_tpu.ops import fused_stage as jfs
from nlt_tpu_torch.ops import fused_stage as tfs


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
    want_y2, want_y1 = jfwd(*[jnp.asarray(a) for a in args], slope=slope,
                            interpret=True, packing=packing)
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
    want = jref(*[jnp.asarray(a).astype(jd) for a in args])
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
    y, vjp = jax.vjp(lambda *a: jop(*a, slope, True),
                     *[jnp.asarray(a) for a in args])
    g = rng.standard_normal(y.shape).astype(np.float32)
    want = vjp(jnp.asarray(g))
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
    y2, y1 = jfwd(*args, slope=0.3, interpret=True)
    g = jnp.asarray(rng.standard_normal(y2.shape)).astype(jnp.bfloat16)
    want = jbwd(tuple(args) + (y1, y2, 0.3), g)

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
