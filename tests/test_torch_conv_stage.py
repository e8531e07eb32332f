"""The port's 2x2 stride-2 conv + bias + LeakyReLU (ops/conv_stage.py)
against nlt_tpu's Pallas kernel run in interpret mode, at the shapes of
tests/test_pallas_kernels.py: numpy inputs, weights from
elements.conv(2, o, stride=2)'s init converted to torch. On the CPU the
wrapper runs the plain version and launches nothing; the CUDA kernel is
held against the plain version on the card by chip_smoke.py. Its launch
plan (``launch_plan``, plain Python) and its index arithmetic, emulated
here thread by thread in numpy, are tested on the CPU.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from nlt_tpu.networks import elements
from nlt_tpu.ops.conv_stage_pallas import conv2x2s2_lrelu as jax_conv
from nlt_tpu_torch.ops import conv_stage as cs

SHAPES = [((2, 16, 32, 8), 16), ((1, 64, 64, 16), 8), ((3, 8, 8, 32), 32)]


def _inputs(shape, o, seed):
    x = np.random.RandomState(seed).standard_normal(shape).astype(np.float32)
    params, _ = elements.conv(2, o, stride=2).init(jax.random.PRNGKey(seed),
                                                   shape[3])
    w = np.array(params["w"], np.float32)  # writable copies for torch
    b = np.array(params["b"], np.float32)
    return x, w, b


@pytest.mark.parametrize("slope", [0.3, 0.0])
@pytest.mark.parametrize("shape,o", SHAPES)
def test_plain_matches_interpreted_pallas(shape, o, slope):
    x, w, b = _inputs(shape, o, 0)
    want = np.asarray(jax_conv(x, w, b, negative_slope=slope,
                               interpret=True))
    cs.reset_launches()
    got = cs.conv2x2s2_lrelu(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b), negative_slope=slope)
    assert cs.LAUNCHES["conv2x2s2_lrelu"] == 0  # CPU: the plain version
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, o)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_plain_matches_reference_stage_odd_channels():
    """C = 5 (which nlt_tpu's Mosaic kernel cannot tile) against
    nlt_tpu's own stage, leaky_relu(conv_k2s2(x) + b)."""
    x, w, b = _inputs((2, 6, 10, 5), 3, 1)
    layer = elements.conv(2, 3, stride=2)
    want = jax.nn.leaky_relu(layer.apply({"w": w, "b": b}, x), 0.3)
    got = cs.conv2x2s2_lrelu(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4, 2))
    w = torch.zeros((2, 2, 2, 3))
    b = torch.zeros(3)
    with pytest.raises(TypeError, match="float32"):
        cs.conv2x2s2_lrelu(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="even"):
        cs.conv2x2s2_lrelu(torch.zeros((1, 3, 4, 2)), w, b)
    with pytest.raises(ValueError, match="w \\(2, 2, 2, O\\)"):
        cs.conv2x2s2_lrelu(x, torch.zeros((2, 2, 3, 3)), b)
    with pytest.raises(ValueError, match="no kernel"):
        cs.conv2x2s2_lrelu(x.to("meta"), w.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# The kernel's launch plan (csrc/conv_stage.cu's make_plan, mirrored by
# launch_plan) and its index arithmetic.
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMEM_MAX = 232448  # a block's shared memory on the H100
SWEEP = [1, 3, 5, 8, 16, 32, 64, 65, 128, 256]


def _chip_smoke():
    """chip_smoke.py as a module (its shape lists; nothing runs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_plan(n_pix, c, o, x_addr):
    p = cs.launch_plan(n_pix, c, o, x_addr)
    to = 4 * p["og"]
    assert p["smem"] <= SMEM_MAX
    assert p["og"] in (1, 2, 4, 8, 16) and p["tp"] == 256 // p["og"] * p["pm"]
    # Tiles of tp pixels and blocks of 4 og channels cover every output
    # pixel and channel once; K chunks cover the 4C patch rows.
    assert p["pix_tiles"] * p["tp"] >= n_pix > (p["pix_tiles"] - 1) * p["tp"]
    assert p["o_tiles"] * to >= o > (p["o_tiles"] - 1) * to
    assert p["nkc"] * p["chunk"] >= 4 * c > (p["nkc"] - 1) * p["chunk"]
    # O <= 64 is one block along O: x is read once.
    assert (p["o_tiles"] == 1) == (o <= 64)
    # The copies of a stage split evenly over 256 threads, none straddles
    # the two runs of 2C floats or the end of K, and each is aligned.
    assert p["tp"] * (p["chunk"] // p["vw"]) % 256 == 0
    assert (2 * c) % p["vw"] == 0 and x_addr % (4 * p["vw"]) == 0
    assert p["chunk"] in (32, 64) and (p["chunk"] == 32 or 4 * c > 32)
    stage = p["tp"] * (p["chunk"] + 4) * 4 + p["tp"] * 8
    w_res = p["nkc"] * p["chunk"] * to * 4
    if p["resident"]:
        assert p["smem"] == w_res + p["stages"] * stage
    else:  # the K-slice rule: w whole would not fit beside the ring
        assert w_res + p["stages"] * stage > SMEM_MAX
        assert p["smem"] == p["stages"] * (stage + p["chunk"] * to * 4)
    return p


@pytest.mark.parametrize("c", SWEEP)
def test_launch_plan_fits_and_covers(c):
    """Every C, O of the sweep, at a few pixel counts and x alignments:
    shared memory within a block's, every pixel, channel and K row
    covered once."""
    for o in SWEEP:
        for n_pix in (1, 255, 256, 4 * 64 * 64 + 1):
            for x_addr in (1 << 20, (1 << 20) + 8, (1 << 20) + 4):
                _check_plan(n_pix, c, o, x_addr)


def test_launch_plan_at_chip_smoke_shapes():
    """Every shape chip_smoke.py runs K4 at: 16-byte copies where C is
    even, 8-byte ones at odd C; at least one shape walks w in K slices."""
    mod = _chip_smoke()
    shapes = mod.CONV_TIMED + mod.CONV_EDGE + mod.CONV_CARD_EDGE
    plans = []
    for n, h, w, c, o in shapes:
        plans.append(_check_plan(n * (h // 2) * (w // 2), c, o, 1 << 20))
        assert plans[-1]["vw"] == (4 if c % 2 == 0 else 2)
    assert any(not p["resident"] for p in plans)


def test_launch_plan_by_hand():
    """nlt_tpu's three shapes, from csrc/conv_stage.cu's layout: w's
    (4C, TO) slice, then 3 stages of tp rows of chunk + 4 floats and tp
    8-byte pixel offsets."""
    p = cs.launch_plan(4 * 64 * 64, 64, 64, 0)      # 128^2, 64 -> 64
    assert (p["og"], p["pm"], p["tp"], p["chunk"], p["nkc"],
            p["resident"]) == (16, 8, 128, 64, 4, 1)
    assert p["smem"] == 256 * 64 * 4 + 3 * (128 * 68 * 4 + 128 * 8)
    assert p["pix_tiles"] == 128
    p = cs.launch_plan(4 * 256 * 256, 32, 16, 0)    # 512^2, 32 -> 16
    assert (p["og"], p["pm"], p["tp"], p["chunk"], p["nkc"]) == \
        (4, 4, 256, 64, 2)
    assert p["smem"] == 128 * 16 * 4 + 3 * (256 * 68 * 4 + 256 * 8)
    # 256^2, 32 -> 32: 64-row chunks would leave one block per SM where
    # 32-row ones leave two (74,752 bytes of shared memory each).
    p = cs.launch_plan(4 * 128 * 128, 32, 32, 0)
    assert (p["og"], p["pm"], p["tp"], p["chunk"]) == (8, 4, 128, 32)
    assert p["smem"] == 128 * 32 * 4 + 3 * (128 * 36 * 4 + 128 * 8)
    # C = 256, O = 64: w (1024 x 64 floats, 256 KB) is walked in K slices,
    # 32 rows a stage (64 would leave one block per SM, not two).
    p = cs.launch_plan(100, 256, 64, 0)
    assert not p["resident"] and p["chunk"] == 32
    assert p["smem"] == 3 * (128 * 36 * 4 + 128 * 8 + 32 * 64 * 4)
    # Small K stays at 32-row chunks.
    assert cs.launch_plan(100, 5, 3, 0)["chunk"] == 32


def _emulate(x, w, b, slope, grid_x):
    """csrc/conv_stage.cu's kernel, thread by thread in numpy over a grid
    of grid_x x o_tiles blocks: the tile walk, each stage's pixel offsets
    and copies (NaN where no copy wrote), w's K slice, the register tile
    (K order, float32) and the epilogue. Returns y and how often each
    output was written."""
    n, h, wd, c = x.shape
    o = w.shape[3]
    xf, wk = x.reshape(-1), w.reshape(4 * c, o)
    wo, n_pix = wd // 2, n * (h // 2) * (wd // 2)
    p = cs.launch_plan(n_pix, c, o, 0)
    og, pm, tp, vw, nkc = p["og"], p["pm"], p["tp"], p["vw"], p["nkc"]
    to, pt, cpv, ch = 4 * og, 256 // og, p["chunk"] // vw, p["chunk"]
    tid = np.arange(256)
    tx, ty = tid % og, tid // og
    rows = ty[:, None] + np.arange(pm)[None, :] * pt        # (256, pm)
    y = np.zeros(n_pix * o, np.float32)
    writes = np.zeros(n_pix * o, np.int64)
    for by in range(p["o_tiles"]):
        o0 = by * to
        cols = o0 + 4 * tx[:, None] + np.arange(4)[None, :]   # (256, 4)
        bias = np.where(cols < o, b[np.minimum(cols, o - 1)], 0)
        for bx in range(min(grid_x, p["pix_tiles"])):
            for tile in range(bx, p["pix_tiles"], grid_x):
                acc = np.zeros((256, pm, 4), np.float32)
                pix = tile * tp + np.arange(tp)
                r = pix // wo
                base = np.where(pix < n_pix,
                                (2 * r * wd + 2 * (pix - r * wo)) * c, -1)
                for chunk in range(nkc):
                    k0 = chunk * ch
                    xs = np.full((tp, ch), np.nan, np.float32)
                    v = tid % cpv
                    k = k0 + v * vw
                    koff = np.where(k < 2 * c, k, wd * c + k - 2 * c)
                    for m in range(tp * cpv // 256):
                        pp = tid // cpv + m * (256 // cpv)
                        ok = (k < 4 * c) & (base[pp] >= 0)
                        for e in range(vw):
                            src = np.where(ok, base[pp] + koff + e, 0)
                            xs[pp, v * vw + e] = np.where(ok, xf[src], 0)
                    kk = k0 + np.arange(ch)
                    ws = np.zeros((ch, to), np.float32)
                    ok = (kk[:, None] < 4 * c) & (o0 + np.arange(to) < o)
                    ws[ok] = wk[np.broadcast_to(kk[:, None], ok.shape)[ok],
                                np.broadcast_to(o0 + np.arange(to),
                                                ok.shape)[ok]]
                    for q in range(ch):
                        acc += (xs[rows, q][:, :, None]
                                * ws[q, 4 * tx[:, None] + np.arange(4)]
                                [:, None, :])
                z = acc + bias[:, None, :]
                z = np.where(z >= 0, z, slope * z)
                gp = tile * tp + rows                              # (256, pm)
                ok = (gp[:, :, None] < n_pix) & (cols[:, None, :] < o)
                flat = (gp[:, :, None] * o + cols[:, None, :])[ok]
                y[flat] = z[ok]
                np.add.at(writes, flat, 1)
    return y.reshape(n, h // 2, wd // 2, o), writes


@pytest.mark.parametrize("shape,o,grid_x", [
    ((2, 32, 40, 5), 3, 2),     # odd C (8-byte copies), 3 tiles, 2 blocks
    ((1, 12, 20, 8), 65, 1),    # O = 65: two blocks along O
    ((2, 8, 8, 32), 16, 1),     # nlt_tpu's 512^2 widths, one tile
    ((1, 24, 24, 64), 64, 2),   # nlt_tpu's 128^2 widths, two tiles
    ((1, 4, 6, 256), 40, 1),    # C = 256, O = 40: w walked in K slices
])
def test_kernel_indexing_matches_plain_version(shape, o, grid_x):
    """The kernel's index arithmetic, emulated on the CPU, computes the
    plain version's function, and writes each output once."""
    n, h, w, c = shape
    rng = np.random.RandomState(c + o)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((2, 2, c, o)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    got, writes = _emulate(x, wt, b, 0.3, grid_x)
    assert (writes == 1).all()
    want = cs.conv2x2s2_lrelu_ref(torch.from_numpy(x), torch.from_numpy(wt),
                                  torch.from_numpy(b), 0.3).numpy()
    # float32 sums of 4C <= 1024 products in another order: 1e-5 of the
    # output's scale (an index error moves outputs by O(1)).
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
