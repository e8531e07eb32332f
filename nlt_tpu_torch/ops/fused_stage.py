"""Fused U-Net stages: (conv k2s2 -> lrelu -> conv k2s1 -> lrelu) and the
mirrored expanding (deconv k2s2 -> lrelu -> deconv k2s1 -> lrelu), each
as one CUDA kernel launch (port of nlt_tpu/ops/fused_stage.py).

Kernels (csrc/fused_stage.cu, built for sm_90a at first use):

- ``contract_stage`` replaces the Pallas kernel ``_contract_kernel``
  (nlt_tpu/ops/fused_stage.py, launched by ``_contract_fwd_pallas``);
- ``expand_stage`` replaces ``_expand_kernel`` and its lane-packed twin
  ``_expand_kernel_packed`` (both launched by ``_expand_fwd_pallas``).
  The packing, the row blocks and the halo BlockSpecs are TPU layout
  devices; one kernel covers every channel count here.

What bounds them on the H100: per output pixel a stage reads 4C inputs
and does 4CO + 4OO multiply-adds, about O + O^2/C FLOP per byte in
bf16. The thin high-resolution stages of the flagship U-Net sit below
the card's ~295 FLOP/byte ridge (bound by bytes), the 256-channel ones
above it (bound by operations). The design keeps the intermediate y1 in
shared memory (the one thing the fusion is for: y1 never goes to
device memory unless asked) and streams the input channels in chunks,
so no stage's width is limited by shared memory. Products run on the
CUDA cores in float32; tensor cores, TMA and pipelining are later work.

On a CPU tensor each op runs its plain PyTorch version
(``contract_stage_ref`` / ``expand_stage_ref``, straight ports of the
JAX references); on a CUDA tensor it launches its kernel or raises.
``LAUNCHES`` counts kernel launches per op.

Numerics follow the Pallas kernels: float32 accumulation, the bias
added in float32, y1 and y2 rounded to the activation dtype once each
after the activation. The plain versions follow nlt_tpu's references,
which under bfloat16 round every tap's product before the sum; the two
agree exactly in float32 up to summation order.
"""

import ctypes
import functools

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


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


_LIB = None


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
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        raise NotImplementedError(
            "%s: the CUDA kernel has no backward yet; run under "
            "torch.no_grad()" % kind)
    if max(n * h * w * c, 4 * n * h * w * o) >= 2 ** 31:
        raise ValueError("%s: tensor too large for 32-bit offsets" % kind)


def _launch(kind, x, w1, b1, w2, b2, slope, return_y1, plan=None):
    """Launch the kernel on checked CUDA tensors; `plan` (th, tw, bn1,
    bn2) overrides the planned tiling."""
    contract = kind == "contract_stage"
    n, h, w, c = x.shape
    o = w1.shape[3]
    oh, ow = (h // 2, w // 2) if contract else (2 * h, 2 * w)
    y2 = torch.empty((n, oh, ow, o), dtype=x.dtype, device=x.device)
    y1 = torch.empty_like(y2) if return_y1 else None
    th, tw, bn1, bn2 = plan or _plan(contract, n, h, w, c, o,
                                     x.element_size())
    lib = _lib()
    fn = lib.nlt_contract_stage if contract else lib.nlt_expand_stage
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                 b2.data_ptr(), y2.data_ptr(),
                 y1.data_ptr() if y1 is not None else None,
                 n, h, w, c, o, th, tw, bn1, bn2, float(slope),
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError("%s kernel launch failed: %s (plan th=%d tw=%d "
                           "bn1=%d bn2=%d, x %s, O=%d)" % (
                               kind, lib.nlt_error_string(err).decode(),
                               th, tw, bn1, bn2, tuple(x.shape), o))
    LAUNCHES[kind] += 1
    return (y2, y1) if return_y1 else y2


def contract_stage(x, w1, b1, w2, b2, slope=0.3, return_y1=False):
    """Fused contracting U-Net stage.

    x: (N, H, W, C), H and W even; w1: (2, 2, C, O) HWIO stride-2 conv
    kernel, b1: (O,); w2: (2, 2, O, O) HWIO stride-1 SAME conv kernel,
    b2: (O,); all of x's dtype. slope: LeakyReLU slope (0.0 = ReLU).

    Returns y2 = lrelu(conv_k2s1(y1) + b2), (N, H/2, W/2, O), where
    y1 = lrelu(conv_k2s2(x) + b1); (y2, y1) if return_y1.
    """
    _check("contract_stage", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        y2, y1 = contract_stage_ref(x, w1, b1, w2, b2, slope)
        return (y2, y1) if return_y1 else y2
    return _launch("contract_stage", x, w1, b1, w2, b2, slope, return_y1)


def expand_stage(x, w1, b1, w2, b2, slope=0.3, return_y1=False):
    """Fused expanding U-Net stage.

    x: (N, H, W, C); w1: (2, 2, C, O) HWIO stride-2 transposed-conv
    kernel, b1: (O,); w2: (2, 2, O, O) HWIO stride-1 transposed-conv
    kernel, b2: (O,); all of x's dtype.

    Returns y2 = lrelu(deconv_k2s1(y1) + b2), (N, 2H, 2W, O), where
    y1 = lrelu(deconv_k2s2(x) + b1); (y2, y1) if return_y1.
    """
    _check("expand_stage", x, w1, b1, w2, b2)
    if x.device.type == "cpu":
        y2, y1 = expand_stage_ref(x, w1, b1, w2, b2, slope)
        return (y2, y1) if return_y1 else y2
    return _launch("expand_stage", x, w1, b1, w2, b2, slope, return_y1)
