"""The stage backward's CUDA kernels (nlt_tpu_torch/csrc/stage_bwd.cu),
as far as the CPU can hold them: the three-term bfloat16 split of dz1,
the launch plan over every stage shape the card runs, and the kernel
names the benchmark's metrics must not match. chip_smoke.py --bwd checks
the kernels themselves against the plain backward on the card."""

import functools
import importlib.util
import os
import re

import pytest
import torch

from nlt_tpu_torch.ops import fused_stage as fs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "nlt_tpu_torch", "csrc", "stage_bwd.cu")


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    """chip_smoke.py as a module (its stage lists; nothing runs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _values(kind, n=4096):
    g = torch.Generator().manual_seed(len(kind))
    base = torch.randn(n, generator=g)
    if kind == "random":
        return base
    if kind == "wide":        # signed, exponents across 2^-60 .. 2^60
        return base * torch.exp2(torch.randint(-60, 61, (n,), generator=g)
                                  .float())
    if kind == "tiny":        # signed, 2^-100 .. 2^-90
        return (torch.sign(base) * (1 + torch.rand(n, generator=g))
                * torch.exp2(torch.randint(-100, -90, (n,), generator=g)
                             .float()))
    return base * 1e30        # huge


@pytest.mark.parametrize("kind", ["random", "wide", "tiny", "huge"])
def test_bf16_terms_rebuild_and_multiply_exactly(kind):
    """hi + mid + lo is v exactly; each term is a bfloat16 value whose
    product with a bfloat16 value is exact in float32; the three products
    sum (exactly, in float64) to v times that value, the float32 product
    the plain backward forms before it rounds."""
    v = _values(kind)
    hi, mid, lo = fs.bf16_terms(v)
    terms = [t.double() for t in (hi, mid, lo)]
    assert torch.equal(terms[0] + terms[1] + terms[2], v.double())
    g = torch.Generator().manual_seed(7)
    w = (torch.sign(torch.randn(v.shape, generator=g))
         * (0.5 + torch.rand(v.shape, generator=g))).to(torch.bfloat16)
    wd = w.double()
    for t, td in zip((hi, mid, lo), terms):
        assert torch.equal((t.float() * w.float()).double(), td * wd)
    assert torch.equal(terms[0] * wd + terms[1] * wd + terms[2] * wd,
                       v.double() * wd)


@pytest.mark.parametrize("label", ["specular", "sss", "sss_uv1024", "bs2",
                                   "tile2", "edge"])
def test_bwd_plan_fits_every_shape(label):
    """Every stage backward of the cells (bs 4), of two data ranks (bs 2),
    of two tile ranks and of the edge shapes has a plan whose launches
    fit shared memory and the grid, in both dtypes."""
    shapes = _chip_smoke().bwd_sets()[label]
    assert shapes
    if label in ("specular", "sss", "sss_uv1024"):
        assert len(shapes) == {"specular": 18}.get(label, 24)
    for kind, n, h, w, c, o in shapes:
        contract = kind == "contract_stage"
        p = fs.bwd_plan(contract, n, h, w, c, o)
        assert p.th * p.tw == 64 and p.xth * p.xtw == 64
        assert {p.bn_dz1, p.bn_dx} <= {16, 32, 64} and p.bn_w in (16, 32)
        for chunks, elems in ((p.chunks2, 4 * o * o), (p.chunks1, 4 * c * o)):
            assert chunks == 1 or chunks * elems <= fs._BWD_PART_MAX
        grids = fs.bwd_grids(contract, n, h, w, c, o, p)
        assert (grids[1][0] > 0) == (p.ks > 1)
        assert (grids[3][0] > 0) == (p.ksx > 1)
        for grid in [g for g in grids if g[0]]:
            assert 1 <= grid[0] < 2 ** 31
            assert all(1 <= d < 2 ** 16 for d in grid[1:])
        # Each K slice has two K chunks or more; each pixel chunk reduces
        # at least one tile.
        for slices in (p.ks, p.ksx):
            assert slices == 1 or 2 * slices <= -(-o // 32)
        hy, wy = (h // 2, w // 2) if contract else (2 * h, 2 * w)
        tiles2 = -(-n * hy // p.th) * -(-wy // p.tw)
        tiles1 = tiles2 if contract else (-(-n * h // p.xth)
                                          * -(-w // p.xtw))
        assert p.chunks2 <= tiles2 and p.chunks1 <= tiles1
        for item in (2, 4):
            for k in range(3):
                smem = fs.bwd_smem_bytes(k, contract, item, p)
                assert 0 < smem <= fs._SMEM_MAX and smem % 16 == 0


def test_bwd_plan_spreads_thin_and_deep_stages():
    """The thin 512^2 stage reduces its weight gradients over many pixel
    chunks in one K slice; the deep 4^2 stage of dragon_sss has one chunk,
    which writes the gradients directly, and spreads dz1 over K slices;
    the expand stage's dw2 (over 4x the pixels of dw1) gets more chunks."""
    thin = fs.bwd_plan(True, 4, 512, 512, 32, 16)
    deep = fs.bwd_plan(True, 4, 4, 4, 2048, 1024)
    assert thin.chunks1 > 100 and thin.ks == 1
    assert deep.chunks2 == deep.chunks1 == 1 and deep.ks > 1
    grids = fs.bwd_grids(True, 4, 4, 4, 2048, 1024, deep)
    assert grids[4][0] >= 132 and grids[0][1] * grids[0][2] >= 132
    assert deep.ksx > 1 and grids[2][1] * grids[2][2] >= 132
    exp = fs.bwd_plan(False, 4, 256, 256, 40, 4)
    assert exp.chunks2 >= 3 * exp.chunks1


def _forward_kernel_names():
    """The kernel names the benchmark's stage and scatter metrics and
    chip_smoke.py's profile match by substring."""
    names = {"scatter"}
    for f in ("stage_roofline.train.py", "stage_split_share.train.py",
              "scatter_roofline.train.py"):
        with open(os.path.join(ROOT, "benchmark", "metrics", f)) as fh:
            names |= set(re.findall(r'"(\w+_kernel)"', fh.read()))
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        src = fh.read()
    named = src[src.index("named = {"):]
    names |= set(re.findall(r'"(\w+_kernel)":', named[:named.index("}")]))
    return names


def test_bwd_kernel_names_match_no_forward_metric():
    """No __global__ of csrc/stage_bwd.cu contains a name the forward's
    and K1's metrics match, so they keep reading the forward alone."""
    with open(SOURCE) as fh:
        src = fh.read()
    kernels = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\("
                             r"[^)]*\)\s+)?(\w+)\s*\(", src))
    assert kernels == {"stage_dz1_kernel", "stage_dz1_sum_kernel",
                       "stage_dx_kernel", "stage_dx_sum_kernel",
                       "stage_wgrad_kernel", "stage_wgrad_sum_kernel"}
    forward = _forward_kernel_names()
    assert {"contract_kernel", "contract_split_kernel", "expand_kernel",
            "expand_split_kernel", "scatter_add_rows_kernel"} <= forward
    assert not [(k, f) for k in kernels for f in forward if f in k]


def test_cpu_backward_is_the_plain_version():
    """On the CPU the autograd Functions' backward is the plain version
    and counts no kernel backward."""
    torch.manual_seed(0)
    fs.reset_launches()
    for kind, shape in (("contract_stage", (1, 4, 6, 3)),
                        ("expand_stage", (1, 2, 3, 5))):
        x = torch.randn(shape, requires_grad=True)
        w1 = torch.randn(2, 2, shape[3], 4, requires_grad=True)
        w2 = torch.randn(2, 2, 4, 4, requires_grad=True)
        b1, b2 = (torch.randn(4, requires_grad=True) for _ in range(2))
        y = getattr(fs, kind)(x, w1, b1, w2, b2)
        g = torch.randn(y.shape)
        y.backward(g)
        with torch.no_grad():
            y2, y1 = fs._REFS[kind](x, w1, b1, w2, b2, 0.3)
        want = fs._BWDS[kind](x.detach(), w1.detach(), b1.detach(),
                              w2.detach(), b2.detach(), y1, y2, g, 0.3)
        for t, ref in zip((x, w1, b1, w2, b2), want):
            torch.testing.assert_close(t.grad, ref, rtol=1e-6, atol=1e-6)
    assert fs.BWD_LAUNCHES == {"contract_stage": 0, "expand_stage": 0}
