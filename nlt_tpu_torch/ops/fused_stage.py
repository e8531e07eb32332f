"""Fused U-Net stages: (conv k2s2 -> lrelu -> conv k2s1 -> lrelu) and the
mirrored expanding (deconv k2s2 -> lrelu -> deconv k2s1 -> lrelu), each
as one CUDA kernel launch (port of nlt_tpu/ops/fused_stage.py).

Kernels (built for sm_90a at first use). Each op has two routes:

- a split route, a thread-block cluster of S blocks per tile, each
  block one slice of the output channels, y1 shared through
  distributed shared memory, inputs and weights streamed by cp.async.
  It is made for the deep stages whose one-block-per-tile grid leaves
  the card idle;
- a tiled route, one block per tile (csrc/fused_stage.cu, planned by
  ``_plan``), for every other shape.

``contract_stage`` replaces the Pallas kernel ``_contract_kernel``
(nlt_tpu/ops/fused_stage.py, launched by ``_contract_fwd_pallas``):
``contract_split_kernel`` of csrc/contract_split.cu on the split route,
``contract_kernel`` of csrc/fused_stage.cu on the tiled one.
``_contract_split_plan`` routes exactly the shapes of
``_CONTRACT_SPLIT_TUNED``, at the plans where ``python3 chip_smoke.py
--sweep`` measured the split kernel faster than the tiled one on the
H100.

``expand_stage`` replaces ``_expand_kernel`` and its lane-packed twin
``_expand_kernel_packed`` (both launched by ``_expand_fwd_pallas``).
The packing, the row blocks and the halo BlockSpecs are TPU layout
devices; ``expand_split_kernel`` of csrc/expand_split.cu and
``expand_kernel`` of csrc/fused_stage.cu cover every channel count.
The split kernel was faster on the H100 at every expand stage it can
take that the sweep times (the flagship stages at bs 1 and 4 and the
stages of dragon_sss.ini and sphere_synthetic.ini); ``_split_plan``
routes exactly those stages, at the plans measured there
(``_SPLIT_TUNED``: S > 1 on the deep 2^2 to 32^2 stages, S = 1 from
64^2 on and at the bs-2 recipe's). The tiled kernel keeps the bf16
stages with O = 4, whose O / S slice is no whole 16-byte copy, and
every shape no sweep timed.

A call whose pointers are off a 16-byte boundary stays tiled. A split
launch the card refuses raises; there is no fallback.

What bounds them on the H100: per output pixel a stage reads 4C inputs
and does 4CO + 4OO multiply-adds, about O + O^2/C FLOP per byte in
bf16. The thin high-resolution stages of the flagship U-Net sit below
the card's ~295 FLOP/byte ridge (bound by bytes), the 256-channel ones
above it (bound by operations); the deep stages do so little work that
latency bounds them. The design keeps the intermediate y1 in
shared memory (the one thing the fusion is for: y1 never goes to
device memory unless asked) and streams the input channels in chunks,
so no stage's width is limited by shared memory. Products run on the
CUDA cores in float32.

On a CPU tensor each op runs its plain PyTorch version
(``contract_stage_ref`` / ``expand_stage_ref``, straight ports of the
JAX references); on a CUDA tensor it launches its kernel or raises.
``LAUNCHES`` counts kernel launches per op (one per call, either route).
An inference call (no gradient, y2 alone) goes through the op
registered with ``torch.library`` (``OPS``:
``nlt_tpu_torch::contract_stage`` / ``::expand_stage``): its CUDA
kernel is the launch above, its CPU kernel the plain version, and its
fake gives y2's shape to a tracer, so ``torch.export`` records the op
as one opaque node that the exported program launches as the eager
server does (the ctypes launch itself cannot be traced).

Gradients: when an input requires grad, the op runs as the
``ContractStage`` / ``ExpandStage`` autograd Function, whose forward is
the same kernel (or plain version) emitting y1 as well, and whose
backward is a straight port of nlt_tpu's ``_contract_bwd_xla`` /
``_expand_bwd_xla`` (matmuls in float32, each gradient cast to its
primal's dtype), shared by both devices. nlt_tpu's backward is XLA, not
Pallas, so there is no backward kernel to port.

Numerics follow the Pallas kernels: float32 accumulation, the bias
added in float32, y1 and y2 rounded to the activation dtype once each
after the activation. The plain versions follow nlt_tpu's references,
which under bfloat16 round every tap's product before the sum; the two
agree exactly in float32 up to summation order. The two routes of
each op sum in one order, so they agree bit for bit.
"""

import ctypes
import functools
import types

import torch

from ..networks.elements import _matmul_f32, lrelu

LAUNCHES = {"contract_stage": 0, "expand_stage": 0}

_SMS = 132                # streaming multiprocessors of an H100 SXM
_SMEM_MAX = 232448        # dynamic shared memory a block may use
_SMEM_PER_SM = 233472     # shared memory of one SM
_BLOCKS_PER_SM = 4        # resident 256-thread blocks the plan counts on
_KC = 16                  # kernel's K chunk
_TILE = 4096              # kernel's BM * BN
_PAD_A = 4                # kernel's As row padding
_BNS = (16, 32, 64, 128, 256)
_TILES = (1, 2, 4, 8, 16, 32)
# The split expand kernel (csrc/expand_split.cu).
_SPLIT_THREADS = 256
_SPLIT_STAGES = 3          # cp.async ring depth
_SPLIT_RS = (1, 2, 4)      # pixels per thread item
_SPLIT_S = (1, 2, 4, 8)    # blocks per cluster (the portable limit)
_SPLIT_CHUNKS = (32, 64)   # input channels per chunk
_SPLIT_TILES = (1, 2, 4, 8)
# The split contract kernel (csrc/contract_split.cu) shares the ring,
# thread items, tiles and chunks; it may also run 16-block clusters (the
# non-portable size), where the card accepts the launch.
_CONTRACT_SPLIT_S = (1, 2, 4, 8, 16)


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Plain versions (nlt_tpu/ops/fused_stage.py contract_stage_ref /
# expand_stage_ref)
# ---------------------------------------------------------------------------


def _shift_pp(a, ei, ej):
    """a[i+ei, j+ej] over NHWC spatial dims, zero past the bottom/right."""
    h, w = a.shape[1], a.shape[2]
    ap = torch.nn.functional.pad(a, (0, 0, 0, ej, 0, ei))
    return ap[:, ei:ei + h, ej:ej + w]


def _shift_mm(a, ei, ej):
    """a[i-ei, j-ej] over NHWC spatial dims, zero before the top/left."""
    h, w = a.shape[1], a.shape[2]
    ap = torch.nn.functional.pad(a, (0, 0, ej, 0, ei, 0))
    return ap[:, :h, :w]


def contract_stage_ref(x, w1, b1, w2, b2, slope=0.3):
    """Plain PyTorch contracting stage; returns (y2, y1)."""
    n, h, w, c = x.shape
    o = w1.shape[3]
    x5 = x.reshape(n, h // 2, 2, w // 2, 2 * c)
    w1r = w1.reshape(2, 2 * c, o)
    z1 = (_matmul_f32(x5[:, :, 0], w1r[0]) + _matmul_f32(x5[:, :, 1], w1r[1])
          + b1.float()).to(x.dtype)
    y1 = lrelu(z1, slope)
    z2 = b2.to(x.dtype)
    for ei in range(2):
        for ej in range(2):
            z2 = z2 + _matmul_f32(_shift_pp(y1, ei, ej), w2[ei, ej]).to(
                x.dtype)
    return lrelu(z2, slope), y1


def expand_stage_ref(x, w1, b1, w2, b2, slope=0.3):
    """Plain PyTorch expanding stage; returns (y2, y1)."""
    n, h, w, c = x.shape
    o = w1.shape[3]
    # deconv k2s2 == matmul + depth-to-space
    z1 = _matmul_f32(x, w1.permute(2, 0, 1, 3).reshape(c, 4 * o)).to(x.dtype)
    z1 = z1.reshape(n, h, w, 2, 2, o).permute(0, 1, 3, 2, 4, 5).reshape(
        n, 2 * h, 2 * w, o) + b1.to(x.dtype)
    y1 = lrelu(z1, slope)
    z2 = b2.to(x.dtype)
    for ei in range(2):
        for ej in range(2):
            z2 = z2 + _matmul_f32(_shift_mm(y1, ei, ej), w2[ei, ej]).to(
                x.dtype)
    return lrelu(z2, slope), y1


# ---------------------------------------------------------------------------
# Launch plan: tile and output-channel pass width per stage shape
# ---------------------------------------------------------------------------


def _ceil_to(v, m):
    return -(-v // m) * m


def _smem_bytes(contract, th, tw, o, bn1, bn2, itemsize):
    """Dynamic shared memory of a launch; mirrors csrc smem_bytes."""
    m1 = (th + 1) * (tw + 1)
    m2 = th * tw if contract else 4 * th * tw
    my = m1 if contract else (2 * th + 1) * (2 * tw + 1)
    floats = (_KC * (_TILE // min(bn1, bn2) + _PAD_A)
              + _KC * max(bn1, bn2))
    return _ceil_to(4 * (floats + m1 + m2), 16) + my * o * itemsize


@functools.lru_cache(maxsize=None)
def _plan(contract, n, h, w, c, o, itemsize):
    """(th, tw, bn1, bn2) minimizing a simple cost model: waves of blocks
    over the card's block slots times one block's padded multiply-adds
    (halo recomputation and ragged tiles included)."""
    gh, gw = (h // 2, w // 2) if contract else (h, w)
    n1 = o if contract else 4 * o
    k1 = 2 * _ceil_to(2 * c, _KC) if contract else _ceil_to(c, _KC)
    k2 = 4 * _ceil_to(o, _KC)
    best = None
    for th in [t for t in _TILES if t < 2 * gh]:
        for tw in [t for t in _TILES if t < 2 * gw]:
            m1 = (th + 1) * (tw + 1)
            m2 = th * tw if contract else 4 * th * tw
            blocks = n * -(-gh // th) * -(-gw // tw)
            for bn1 in _BNS:
                for bn2 in _BNS:
                    smem = _smem_bytes(contract, th, tw, o, bn1, bn2,
                                       itemsize)
                    if smem > _SMEM_MAX:
                        continue
                    bm1, bm2 = _TILE // bn1, _TILE // bn2
                    work = (_ceil_to(m1, bm1) * _ceil_to(n1, bn1) * k1
                            + _ceil_to(m2, bm2) * _ceil_to(o, bn2) * k2)
                    per_sm = min(_BLOCKS_PER_SM, _SMEM_PER_SM // (smem + 1024))
                    waves = -(-blocks // (_SMS * per_sm))
                    key = (waves * work, -th * tw, bn1, bn2)
                    if best is None or key < best[0]:
                        best = (key, (th, tw, bn1, bn2))
    if best is None:
        raise ValueError("no launch plan fits shared memory for stage "
                         "C=%d O=%d" % (c, o))
    return best[1]


def _split_geometry(th, tw, o, s, ch, itemsize):
    """(shared-memory bytes, R1, R2) of a split launch; mirrors csrc
    expand_split.cu's Geo and pick_r (R = 0: the product does not fit
    the block's threads)."""
    os_, ve = o // s, 16 // itemsize
    m1 = (th + 1) * (tw + 1)
    ny1 = (2 * th + 1) * (2 * tw + 1)
    stage = (m1 * (ch + ve) + 4 * ch * os_) * itemsize
    smem = (_SPLIT_STAGES * stage + _ceil_to(ny1 * (o + ve) * itemsize, 16)
            + _ceil_to(m1 * 4, 16))
    groups = [(th + q // 2) * (tw + q % 2) for q in range(4)]
    r1 = next((r for r in _SPLIT_RS if sum(-(-m // r) for m in groups)
               * (os_ // 4) <= _SPLIT_THREADS), 0)
    r2 = next((r for r in _SPLIT_RS if -(-4 * th * tw // r) * (os_ // 4)
               <= _SPLIT_THREADS), 0)
    return smem, r1, r2


def _split_fits(c, o, s, itemsize):
    """The split kernel's 16-byte copies can take C and the O/S slice."""
    ve = 16 // itemsize
    return (s in _SPLIT_S and o % s == 0 and (o // s) % ve == 0
            and (o // s) % 4 == 0 and c % ve == 0)


def _candidates(gh, gw, c, o, itemsize, sizes, fits, geometry):
    """Every split launch (th, tw, s, ch) over a gh x gw tile grid whose
    16-byte copies fit (`fits`) and whose shared memory and thread items
    fit a block (`geometry`)."""
    out = []
    for th in [t for t in _SPLIT_TILES if t < 2 * gh]:
        for tw in [t for t in _SPLIT_TILES if t < 2 * gw]:
            for s in sizes:
                if not fits(c, o, s, itemsize):
                    continue
                for ch in _SPLIT_CHUNKS:
                    smem, r1, r2 = geometry(th, tw, o, s, ch, itemsize)
                    if smem <= _SMEM_MAX and r1 and r2:
                        out.append((th, tw, s, ch))
    return out


def _split_candidates(n, h, w, c, o, itemsize):
    """Every split launch (th, tw, s, ch) the kernel takes for a stage."""
    return _candidates(h, w, c, o, itemsize, _SPLIT_S, _split_fits,
                       _split_geometry)


# The split route's plans, keyed (n, h, w, c, o, itemsize): every
# expand stage `python3 chip_smoke.py --sweep` times (the flagship
# stages at bs 1 and 4, dragon_sss.ini's at bs 4, sphere_synthetic.ini's
# at bs 2), where on an H100 SXM (700 W) it timed every candidate beside
# the tiled kernel and the split kernel won at every stage it can take
# (2.3-18x at the flagship 8^2 to 32^2, 2.2-2.7x at 64^2 to 256^2;
# 14-70x at dragon_sss.ini's 2^2 to 8^2; 2.9-3.5x at the bs-2 recipe's).
# The flagship deep stages (8^2 to 32^2) keep the fastest plan with
# S > 1 (at 32^2 bf16 bs 1 it is 7% behind an S = 1 plan); from 64^2 on,
# with tiles enough for the card, S = 1 won. bf16 O = 4 stays tiled (no
# 16-byte O/S row); a shape no sweep timed stays tiled.
_SPLIT_TUNED = {
    (1, 8, 8, 1024, 128, 2): (2, 4, 8, 64),
    (1, 8, 8, 1024, 128, 4): (2, 4, 8, 64),
    (1, 16, 16, 640, 64, 2): (4, 1, 2, 64),
    (1, 16, 16, 640, 64, 4): (4, 1, 2, 64),
    (1, 32, 32, 320, 32, 2): (4, 4, 2, 64),
    (1, 32, 32, 320, 32, 4): (4, 4, 2, 64),
    (1, 64, 64, 160, 16, 2): (8, 4, 1, 64),
    (1, 64, 64, 160, 16, 4): (8, 4, 1, 64),
    (1, 128, 128, 80, 8, 2): (8, 8, 1, 32),
    (1, 128, 128, 80, 8, 4): (8, 8, 1, 32),
    (1, 256, 256, 40, 4, 4): (8, 8, 1, 64),
    (4, 8, 8, 1024, 128, 2): (4, 1, 2, 64),
    (4, 8, 8, 1024, 128, 4): (1, 4, 2, 64),
    (4, 16, 16, 640, 64, 2): (8, 2, 2, 64),
    (4, 16, 16, 640, 64, 4): (4, 4, 2, 64),
    (4, 32, 32, 320, 32, 2): (8, 4, 2, 32),
    (4, 32, 32, 320, 32, 4): (4, 8, 2, 32),
    (4, 64, 64, 160, 16, 2): (8, 4, 1, 32),
    (4, 64, 64, 160, 16, 4): (8, 4, 1, 64),
    (4, 128, 128, 80, 8, 2): (8, 8, 1, 64),
    (4, 128, 128, 80, 8, 4): (8, 8, 1, 64),
    (4, 256, 256, 40, 4, 4): (8, 8, 1, 64),
    # dragon_sss.ini (depth 1024), bs 4.
    (4, 2, 2, 4096, 512, 2): (2, 1, 8, 64),
    (4, 2, 2, 4096, 512, 4): (2, 2, 8, 32),
    (4, 4, 4, 2560, 256, 2): (2, 4, 8, 64),
    (4, 4, 4, 2560, 256, 4): (2, 4, 8, 64),
    (4, 8, 8, 1280, 128, 2): (1, 4, 2, 64),
    (4, 8, 8, 1280, 128, 4): (4, 1, 2, 64),
    # sphere_synthetic.ini (128^2, depth 32), bs 2.
    (2, 16, 16, 128, 16, 2): (1, 4, 1, 64),
    (2, 16, 16, 128, 16, 4): (2, 2, 1, 64),
    (2, 32, 32, 80, 8, 2): (4, 4, 1, 64),
    (2, 32, 32, 80, 8, 4): (8, 4, 1, 64),
    (2, 64, 64, 40, 4, 4): (8, 8, 1, 64),
}


def _split_plan(n, h, w, c, o, itemsize):
    """(th, tw, s, chunk) of the split expand route, or None to stay on
    the tiled kernel: the measured plan of _SPLIT_TUNED, so only a stage
    whose two routes were timed on the card takes the split kernel."""
    return _SPLIT_TUNED.get((n, h, w, c, o, itemsize))


def _contract_split_geometry(th, tw, o, s, ch, itemsize):
    """(shared-memory bytes, R1, R2) of a split contract launch; mirrors
    csrc/contract_split.cu's Geo and pick_r (R = 0: the product does not
    fit the block's threads)."""
    os_, ve = o // s, 16 // itemsize
    m1 = (th + 1) * (tw + 1)
    stage = (m1 * (ch + ve) + ch * os_) * itemsize
    smem = (_SPLIT_STAGES * stage + _ceil_to(m1 * (o + ve) * itemsize, 16)
            + _ceil_to(m1 * 4, 16))
    r1 = next((r for r in _SPLIT_RS
               if -(-m1 // r) * (os_ // 4) <= _SPLIT_THREADS), 0)
    r2 = next((r for r in _SPLIT_RS
               if -(-th * tw // r) * (os_ // 4) <= _SPLIT_THREADS), 0)
    return smem, r1, r2


def _contract_split_fits(c, o, s, itemsize):
    """The split contract kernel's 16-byte copies can take C and the O/S
    slice, and a weight row is at most one copy per thread."""
    ve = 16 // itemsize
    return (s in _CONTRACT_SPLIT_S and o % s == 0 and (o // s) % ve == 0
            and (o // s) % 4 == 0 and (o // s) // ve <= _SPLIT_THREADS
            and c % ve == 0)


def _contract_split_candidates(n, h, w, c, o, itemsize):
    """Every split contract launch (th, tw, s, ch) the kernel takes for a
    stage with input (n, h, w, c): tiles of the (h/2) x (w/2) y2 grid."""
    return _candidates(h // 2, w // 2, c, o, itemsize, _CONTRACT_SPLIT_S,
                       _contract_split_fits, _contract_split_geometry)


# The split contract route's plans, keyed (n, h, w, c, o, itemsize) of
# the input: the shapes where `python3 chip_smoke.py --sweep` on an H100
# SXM (700 W) timed every candidate beside the tiled kernel and the
# fastest split plan beat it, each at that plan. It beat it at all 72
# keys swept (36 shapes: the flagship contract stages at bs 1 and 4, and
# the stages of dragon_sss.ini at bs 4 and sphere_synthetic.ini at bs 2;
# in both dtypes): 1.1-2.1x at 512^2 bs 4, 2.7-6.6x on the flagship
# 16^2 and 32^2 stages, 18-34x on dragon_sss's 1024-channel 8^2 and 4^2
# stages, which run clusters of 16 (as do most 16^2 stages). A shape of
# another recipe or batch size joins once a sweep has timed it.
_CONTRACT_SPLIT_TUNED = {
    # flagship stages, bs 1
    (1, 512, 512, 16, 16, 2): (8, 8, 1, 64),
    (1, 512, 512, 16, 16, 4): (8, 8, 1, 64),
    (1, 512, 512, 32, 16, 2): (8, 8, 1, 64),
    (1, 512, 512, 32, 16, 4): (8, 8, 1, 64),
    (1, 256, 256, 16, 32, 2): (8, 8, 1, 64),
    (1, 256, 256, 16, 32, 4): (8, 8, 1, 32),
    (1, 256, 256, 32, 32, 2): (8, 8, 1, 64),
    (1, 256, 256, 32, 32, 4): (8, 8, 1, 32),
    (1, 128, 128, 32, 64, 2): (4, 8, 1, 64),
    (1, 128, 128, 32, 64, 4): (8, 4, 1, 64),
    (1, 128, 128, 64, 64, 2): (8, 4, 1, 64),
    (1, 128, 128, 64, 64, 4): (4, 8, 1, 64),
    (1, 64, 64, 64, 128, 2): (8, 2, 2, 64),
    (1, 64, 64, 64, 128, 4): (4, 4, 2, 64),
    (1, 64, 64, 128, 128, 2): (8, 2, 2, 64),
    (1, 64, 64, 128, 128, 4): (4, 4, 2, 64),
    (1, 32, 32, 128, 256, 2): (2, 2, 2, 64),
    (1, 32, 32, 128, 256, 4): (1, 4, 2, 64),
    (1, 32, 32, 256, 256, 2): (2, 2, 2, 64),
    (1, 32, 32, 256, 256, 4): (4, 1, 2, 64),
    (1, 16, 16, 256, 256, 2): (2, 8, 16, 64),
    (1, 16, 16, 256, 256, 4): (8, 2, 16, 64),
    (1, 16, 16, 512, 256, 2): (2, 8, 16, 64),
    (1, 16, 16, 512, 256, 4): (8, 2, 16, 64),
    # flagship stages and dragon_sss.ini's, bs 4
    (4, 512, 512, 16, 16, 2): (8, 8, 1, 64),
    (4, 512, 512, 16, 16, 4): (8, 8, 1, 64),
    (4, 512, 512, 32, 16, 2): (8, 8, 1, 64),
    (4, 512, 512, 32, 16, 4): (8, 8, 1, 64),
    (4, 256, 256, 16, 32, 2): (8, 8, 1, 64),
    (4, 256, 256, 16, 32, 4): (8, 8, 1, 64),
    (4, 256, 256, 32, 32, 2): (8, 8, 1, 64),
    (4, 256, 256, 32, 32, 4): (8, 8, 1, 64),
    (4, 128, 128, 32, 64, 2): (4, 8, 1, 64),
    (4, 128, 128, 32, 64, 4): (8, 8, 2, 64),
    (4, 128, 128, 64, 64, 2): (8, 4, 1, 64),
    (4, 128, 128, 64, 64, 4): (8, 8, 2, 64),
    (4, 64, 64, 64, 128, 2): (8, 4, 2, 64),
    (4, 64, 64, 64, 128, 4): (4, 8, 2, 64),
    (4, 64, 64, 128, 128, 2): (4, 8, 2, 64),
    (4, 64, 64, 128, 128, 4): (8, 4, 2, 64),
    (4, 32, 32, 128, 256, 2): (4, 4, 2, 64),
    (4, 32, 32, 128, 256, 4): (4, 4, 2, 64),
    (4, 32, 32, 256, 256, 2): (4, 4, 2, 64),
    (4, 32, 32, 256, 256, 4): (4, 4, 2, 64),
    (4, 16, 16, 256, 256, 2): (8, 8, 16, 64),
    (4, 16, 16, 256, 256, 4): (2, 8, 8, 64),
    (4, 16, 16, 256, 512, 2): (8, 8, 16, 64),
    (4, 16, 16, 256, 512, 4): (4, 8, 8, 64),
    (4, 16, 16, 512, 256, 2): (8, 8, 16, 64),
    (4, 16, 16, 512, 256, 4): (8, 8, 16, 64),
    (4, 16, 16, 512, 512, 2): (8, 8, 16, 64),
    (4, 16, 16, 512, 512, 4): (8, 8, 16, 32),
    (4, 8, 8, 512, 1024, 2): (4, 4, 16, 64),
    (4, 8, 8, 512, 1024, 4): (4, 4, 16, 64),
    (4, 8, 8, 1024, 1024, 2): (4, 4, 16, 64),
    (4, 8, 8, 1024, 1024, 4): (4, 4, 16, 64),
    (4, 4, 4, 1024, 1024, 2): (2, 2, 16, 64),
    (4, 4, 4, 1024, 1024, 4): (2, 2, 16, 64),
    (4, 4, 4, 2048, 1024, 2): (2, 2, 16, 64),
    (4, 4, 4, 2048, 1024, 4): (2, 2, 16, 64),
    # sphere_synthetic.ini's stages, bs 2
    (2, 128, 128, 16, 16, 2): (8, 8, 1, 64),
    (2, 128, 128, 16, 16, 4): (8, 8, 1, 64),
    (2, 128, 128, 32, 16, 2): (8, 8, 1, 64),
    (2, 128, 128, 32, 16, 4): (8, 8, 1, 64),
    (2, 64, 64, 16, 32, 2): (4, 4, 1, 64),
    (2, 64, 64, 16, 32, 4): (4, 4, 1, 32),
    (2, 64, 64, 32, 32, 2): (2, 8, 1, 32),
    (2, 64, 64, 32, 32, 4): (8, 4, 2, 64),
    (2, 32, 32, 32, 32, 2): (4, 2, 1, 64),
    (2, 32, 32, 32, 32, 4): (2, 4, 1, 64),
    (2, 32, 32, 64, 32, 2): (4, 2, 1, 64),
    (2, 32, 32, 64, 32, 4): (4, 1, 1, 64),
}


def _contract_split_plan(n, h, w, c, o, itemsize):
    """(th, tw, s, chunk) of the split contract route, or None to stay on
    the tiled kernel: the measured plan of _CONTRACT_SPLIT_TUNED."""
    return _CONTRACT_SPLIT_TUNED.get((n, h, w, c, o, itemsize))


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


_LIB = None
# The split kernels' libraries (csrc/<source>.cu), by op.
_SPLIT_SOURCES = {"contract_stage": "contract_split",
                  "expand_stage": "expand_split"}
_SPLIT_LIBS = {}


def _split_lib(kind):
    """The split kernel of `kind` ("contract_stage" / "expand_stage"),
    built and typed at first use: its C functions
    nlt_<source>{,_clocks,_smem_bytes,_items,_error_string} as launch,
    clocks, smem_bytes, items and error_string."""
    lib = _SPLIT_LIBS.get(kind)
    if lib is None:
        from . import _build

        name = _SPLIT_SOURCES[kind]
        so = _build.load(name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fns = {sfx: getattr(so, "nlt_" + name + sfx) for sfx in (
            "", "_clocks", "_smem_bytes", "_items", "_error_string")}
        fns[""].argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float, i, p]
        fns["_clocks"].argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float, i,
                                                       p, p]
        fns["_smem_bytes"].argtypes = [i] * 6
        fns["_smem_bytes"].restype = ctypes.c_longlong
        fns["_items"].argtypes = [i] * 7
        fns["_error_string"].argtypes = [i]
        fns["_error_string"].restype = ctypes.c_char_p
        lib = types.SimpleNamespace(
            launch=fns[""], clocks=fns["_clocks"],
            smem_bytes=fns["_smem_bytes"], items=fns["_items"],
            error_string=fns["_error_string"])
        _SPLIT_LIBS[kind] = lib
    return lib


def _lib():
    """The kernels' library, built and typed at first use."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("fused_stage")
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn in (lib.nlt_contract_stage, lib.nlt_expand_stage):
            fn.argtypes = [p] * 7 + [i] * 9 + [ctypes.c_float, i, p]
            fn.restype = i
        lib.nlt_stage_smem_bytes.argtypes = [i] * 7
        lib.nlt_stage_smem_bytes.restype = ctypes.c_longlong
        lib.nlt_error_string.argtypes = [i]
        lib.nlt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(kind, x, w1, b1, w2, b2):
    if x.dim() != 4:
        raise ValueError("%s: x must be NHWC, got %s" % (kind, tuple(x.shape)))
    n, h, w, c = x.shape
    if w1.dim() != 4 or tuple(w1.shape[:3]) != (2, 2, c):
        raise ValueError("%s: w1 must be (2, 2, %d, O), got %s"
                         % (kind, c, tuple(w1.shape)))
    o = w1.shape[3]
    if tuple(w2.shape) != (2, 2, o, o) or tuple(b1.shape) != (o,) \
            or tuple(b2.shape) != (o,):
        raise ValueError("%s: w2 (2, 2, O, O), b1 and b2 (O,) expected for "
                         "O=%d, got %s %s %s" % (kind, o, tuple(w2.shape),
                                                 tuple(b1.shape),
                                                 tuple(b2.shape)))
    if kind == "contract_stage" and (h % 2 or w % 2):
        raise ValueError("contract_stage: H and W must be even, got %s"
                         % ((h, w),))
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError("%s: all tensors must be on %s" % (kind, x.device))
    if x.device.type == "cpu":
        return
    if x.device.type != "cuda":
        raise ValueError("%s: no kernel for device %s" % (kind, x.device))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("%s: the kernel takes float32 or bfloat16, got %s"
                        % (kind, x.dtype))
    for t in (x, w1, b1, w2, b2):
        if t.dtype != x.dtype:
            raise TypeError("%s: all tensors must be %s" % (kind, x.dtype))
        if not t.is_contiguous():
            raise ValueError("%s: tensors must be contiguous" % kind)
    if max(n * h * w * c, 4 * n * h * w * o) >= 2 ** 31:
        raise ValueError("%s: tensor too large for 32-bit offsets" % kind)


def _expand_route(x, w1, w2, c, o):
    """The split plan an expand call takes (_split_plan, if the pointers
    allow 16-byte copies), or None for the tiled kernel."""
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        return None
    return _split_plan(*x.shape[:3], c, o, x.element_size())


def _contract_route(x, w1, w2, c, o):
    """The split plan a contract call takes (_contract_split_plan, if the
    pointers allow 16-byte copies), or None for the tiled kernel."""
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        return None
    return _contract_split_plan(*x.shape[:3], c, o, x.element_size())


def _launch(kind, x, w1, b1, w2, b2, slope, return_y1, plan=None,
            split=None):
    """Launch the kernel on checked CUDA tensors. `plan` (th, tw, bn1,
    bn2) forces the tiled kernel and its tiling, `split` (th, tw, s, ch)
    the op's split kernel and its plan; neither: the op's route."""
    contract = kind == "contract_stage"
    n, h, w, c = x.shape
    o = w1.shape[3]
    oh, ow = (h // 2, w // 2) if contract else (2 * h, 2 * w)
    y2 = torch.empty((n, oh, ow, o), dtype=x.dtype, device=x.device)
    y1 = torch.empty_like(y2) if return_y1 else None
    if plan is None and split is None:
        route = _contract_route if contract else _expand_route
        split = route(x, w1, w2, c, o)
    is_bf16 = int(x.dtype == torch.bfloat16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = (x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                b2.data_ptr(), y2.data_ptr(),
                y1.data_ptr() if y1 is not None else None)
        if split is not None:
            lib = _split_lib(kind)
            err = lib.launch(*ptrs, n, h, w, c, o, *split, float(slope),
                             is_bf16, stream)
            what = "%s plan th=%d tw=%d s=%d ch=%d" % (
                (_SPLIT_SOURCES[kind],) + tuple(split))
            msg = lib.error_string
        else:
            th, tw, bn1, bn2 = plan or _plan(contract, n, h, w, c, o,
                                             x.element_size())
            lib = _lib()
            fn = lib.nlt_contract_stage if contract else lib.nlt_expand_stage
            err = fn(*ptrs, n, h, w, c, o, th, tw, bn1, bn2, float(slope),
                     is_bf16, stream)
            what = "plan th=%d tw=%d bn1=%d bn2=%d" % (th, tw, bn1, bn2)
            msg = lib.nlt_error_string
    if err != 0:
        raise RuntimeError("%s kernel launch failed: %s (%s, x %s, O=%d)" % (
            kind, msg(err).decode(), what, tuple(x.shape), o))
    LAUNCHES[kind] += 1
    return (y2, y1) if return_y1 else y2


# ---------------------------------------------------------------------------
# Backward (nlt_tpu/ops/fused_stage.py _contract_bwd_xla / _expand_bwd_xla):
# plain PyTorch on both devices, from the y1 and y2 the forward emitted.
# Float32 throughout; each gradient returns in its primal's dtype.
# ---------------------------------------------------------------------------


def _lrelu_mask(y, slope):
    """y > 0 ? 1 : slope, in y's dtype (leaky_relu's gradient except on
    the measure-zero set z == 0)."""
    one = torch.ones((), dtype=y.dtype, device=y.device)
    return torch.where(y > 0, one, torch.full_like(one, slope))


def _flat_t_matmul(a, b):
    """einsum('...i,...j->ij') in float32: sum over every leading dim."""
    return torch.matmul(a.reshape(-1, a.shape[-1]).float().t(),
                        b.reshape(-1, b.shape[-1]).float())


def _stage_bwd_common(shift_fwd, shift_bwd, y1, y2, w2, b2, g, slope):
    """The k2s1 half of either stage: (dz1, dw2, db2). shift_fwd is the
    forward's tap shift of y1, shift_bwd its adjoint on dz2."""
    dz2 = (g * _lrelu_mask(y2, slope)).float()
    db2 = dz2.sum(dim=(0, 1, 2)).to(b2.dtype)
    dw2 = torch.stack([
        torch.stack([_flat_t_matmul(shift_fwd(y1, ei, ej), dz2)
                     for ej in range(2)])
        for ei in range(2)]).to(w2.dtype)
    dy1 = 0.0
    for ei in range(2):
        for ej in range(2):
            dy1 = dy1 + torch.matmul(shift_bwd(dz2, ei, ej),
                                     w2[ei, ej].float().t())
    dz1 = (dy1 * _lrelu_mask(y1, slope)).float()
    return dz1, dw2, db2


def contract_stage_bwd(x, w1, b1, w2, b2, y1, y2, g, slope):
    """Gradients (dx, dw1, db1, dw2, db2) of contract_stage's y2."""
    n, h, w, c = x.shape
    o = w1.shape[3]
    dz1, dw2, db2 = _stage_bwd_common(_shift_pp, _shift_mm, y1, y2, w2, b2,
                                      g, slope)
    db1 = dz1.sum(dim=(0, 1, 2)).to(b1.dtype)
    x5 = x.reshape(n, h // 2, 2, w // 2, 2 * c)
    w1r = w1.reshape(2, 2 * c, o).float()
    dw1 = torch.stack([_flat_t_matmul(x5[:, :, r], dz1) for r in range(2)])
    dw1 = dw1.reshape(w1.shape).to(w1.dtype)
    dx5 = torch.stack([torch.matmul(dz1, w1r[r].t()) for r in range(2)],
                      dim=2)
    return dx5.reshape(x.shape).to(x.dtype), dw1, db1, dw2, db2


def expand_stage_bwd(x, w1, b1, w2, b2, y1, y2, g, slope):
    """Gradients (dx, dw1, db1, dw2, db2) of expand_stage's y2."""
    n, h, w, c = x.shape
    o = w1.shape[3]
    dz1, dw2, db2 = _stage_bwd_common(_shift_mm, _shift_pp, y1, y2, w2, b2,
                                      g, slope)
    db1 = dz1.sum(dim=(0, 1, 2)).to(b1.dtype)
    # z1[n, 2i+p, 2j+q, o] = sum_c x[n, i, j, c] w1[p, q, c, o]
    dz1p = dz1.reshape(n, h, 2, w, 2, o).permute(0, 1, 3, 2, 4, 5).reshape(
        n, h, w, 4 * o)
    w1f = w1.permute(2, 0, 1, 3).reshape(c, 4 * o).float()
    dw1 = _flat_t_matmul(x, dz1p).reshape(c, 2, 2, o).permute(1, 2, 0, 3)
    dx = torch.matmul(dz1p, w1f.t())
    return (dx.to(x.dtype), dw1.to(w1.dtype), db1, dw2, db2)


_REFS = {"contract_stage": contract_stage_ref,
         "expand_stage": expand_stage_ref}


def _forward(kind, x, w1, b1, w2, b2, slope):
    """(y2, y1): the kernel on CUDA, the plain version on the CPU."""
    if x.device.type == "cpu":
        return _REFS[kind](x, w1, b1, w2, b2, slope)
    return _launch(kind, x, w1, b1, w2, b2, slope, True)


class ContractStage(torch.autograd.Function):
    """contract_stage's y2, differentiable in x and the four params; the
    backward reuses the y1 the forward emitted."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, slope):
        y2, y1 = _forward("contract_stage", x, w1, b1, w2, b2, slope)
        ctx.save_for_backward(x, w1, b1, w2, b2, y1, y2)
        ctx.slope = slope
        return y2

    @staticmethod
    def backward(ctx, g):
        return contract_stage_bwd(*ctx.saved_tensors, g, ctx.slope) + (None,)


class ExpandStage(torch.autograd.Function):
    """expand_stage's y2, differentiable in x and the four params."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, slope):
        y2, y1 = _forward("expand_stage", x, w1, b1, w2, b2, slope)
        ctx.save_for_backward(x, w1, b1, w2, b2, y1, y2)
        ctx.slope = slope
        return y2

    @staticmethod
    def backward(ctx, g):
        return expand_stage_bwd(*ctx.saved_tensors, g, ctx.slope) + (None,)


# ---------------------------------------------------------------------------
# Inference: each op registered with torch.library as an opaque custom op
# (nlt_tpu_torch::contract_stage / ::expand_stage), so the eager server
# and a torch.export'ed program run one code path. The CUDA
# implementation launches the kernel or raises; the CPU one is the plain
# version; the fake gives y2's shape, dtype and device to a tracer and
# launches nothing (LAUNCHES counts real launches only).
# ---------------------------------------------------------------------------


def _out_shape(kind, x, w1):
    n, h, w, _ = x.shape
    if kind == "contract_stage":
        return (n, h // 2, w // 2, w1.shape[3])
    return (n, 2 * h, 2 * w, w1.shape[3])


def _register(kind):
    """The custom op of `kind`, with its CUDA, CPU and fake kernels."""

    @torch.library.custom_op("nlt_tpu_torch::" + kind, mutates_args=(),
                             device_types="cuda")
    def op(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
           w2: torch.Tensor, b2: torch.Tensor, slope: float) -> torch.Tensor:
        _check(kind, x, w1, b1, w2, b2)
        return _launch(kind, x, w1, b1, w2, b2, slope, False)

    @op.register_kernel("cpu")
    def _(x, w1, b1, w2, b2, slope):
        _check(kind, x, w1, b1, w2, b2)
        return _REFS[kind](x, w1, b1, w2, b2, slope)[0]

    @op.register_fake
    def _(x, w1, b1, w2, b2, slope):
        _check(kind, x, w1, b1, w2, b2)
        return x.new_empty(_out_shape(kind, x, w1))

    return op


OPS = {kind: _register(kind) for kind in _REFS}


def _stage(fn, kind, x, w1, b1, w2, b2, slope, return_y1):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        _check(kind, x, w1, b1, w2, b2)
        if return_y1:
            raise ValueError("%s: return_y1 is for inference; y1 carries no "
                             "gradient" % kind)
        return fn.apply(x, w1, b1, w2, b2, slope)
    if not return_y1:
        return OPS[kind](x, w1, b1, w2, b2, float(slope))
    # y1 too: eager only (the custom ops return y2 alone).
    _check(kind, x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return _REFS[kind](x, w1, b1, w2, b2, slope)
    return _launch(kind, x, w1, b1, w2, b2, slope, True)


def contract_stage(x, w1, b1, w2, b2, slope=0.3, return_y1=False):
    """Fused contracting U-Net stage.

    x: (N, H, W, C), H and W even; w1: (2, 2, C, O) HWIO stride-2 conv
    kernel, b1: (O,); w2: (2, 2, O, O) HWIO stride-1 SAME conv kernel,
    b2: (O,); all of x's dtype. slope: LeakyReLU slope (0.0 = ReLU).

    Returns y2 = lrelu(conv_k2s1(y1) + b2), (N, H/2, W/2, O), where
    y1 = lrelu(conv_k2s2(x) + b1); (y2, y1) if return_y1 (inference
    only). Differentiable (ContractStage) when an input requires grad.
    """
    return _stage(ContractStage, "contract_stage", x, w1, b1, w2, b2, slope,
                  return_y1)


def expand_stage(x, w1, b1, w2, b2, slope=0.3, return_y1=False):
    """Fused expanding U-Net stage.

    x: (N, H, W, C); w1: (2, 2, C, O) HWIO stride-2 transposed-conv
    kernel, b1: (O,); w2: (2, 2, O, O) HWIO stride-1 transposed-conv
    kernel, b2: (O,); all of x's dtype.

    Returns y2 = lrelu(deconv_k2s1(y1) + b2), (N, 2H, 2W, O), where
    y1 = lrelu(deconv_k2s2(x) + b1); (y2, y1) if return_y1 (inference
    only). Differentiable (ExpandStage) when an input requires grad.
    """
    return _stage(ExpandStage, "expand_stage", x, w1, b1, w2, b2, slope,
                  return_y1)
