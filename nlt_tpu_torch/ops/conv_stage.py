"""Fused 2x2 stride-2 convolution + bias + LeakyReLU (port of
nlt_tpu/ops/conv_stage_pallas.py).

``conv2x2s2_lrelu(x, w, b, negative_slope=0.3)``: x (N, H, W, C) float32
with H and W even, w (2, 2, C, O) HWIO, b (O,); returns (N, H/2, W/2, O)
equal to ``leaky_relu(conv_k2s2(x, w) + b, negative_slope)``.

As in nlt_tpu, no path of the model runs this op: nlt_tpu's U-Net lowers
its convolutions through XLA and keeps this kernel as a stand-alone op
with its tests, and the port does the same (the model's stages run the
fused contract/expand kernels of ``ops/fused_stage.py``).

Kernel (csrc/conv_stage.cu, built for sm_90a at first use): it replaces
the Pallas kernel ``_kernel`` of nlt_tpu/ops/conv_stage_pallas.py. On a
CPU tensor the op runs its plain version (``conv2x2s2_lrelu_ref``, the
space-to-depth matmul); on a CUDA tensor it launches the kernel or
raises. float32 only, as nlt_tpu documents it. ``LAUNCHES`` counts kernel
launches. The kernel's launch plan (tile, ring, shared memory, the
K-slice rule) is ``launch_plan``, a mirror of the C side that the CPU
tests and ``chip_smoke.py`` hold against it.
"""

import ctypes

import torch

LAUNCHES = {"conv2x2s2_lrelu": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def conv2x2s2_lrelu_ref(x, w, b, negative_slope=0.3):
    """Plain PyTorch version: space-to-depth (the (di, dj, c) order of
    the HWIO kernel's rows), one matmul, bias, LeakyReLU."""
    n, h, wd, c = x.shape
    o = w.shape[3]
    patches = x.reshape(n, h // 2, 2, wd // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    y = patches.reshape(n, h // 2, wd // 2, 4 * c) @ w.reshape(4 * c, o) + b
    return torch.where(y >= 0, y, negative_slope * y)


# Mirrors csrc/conv_stage.cu: threads a block, ring depth, a block's and
# an SM's shared memory on the H100.
_THREADS, _STAGES, _SMEM_MAX, _SMEM_SM = 256, 3, 232448, 233472
PLAN_KEYS = ("og", "pm", "tp", "vw", "nkc", "resident", "o_tiles",
             "pix_tiles", "smem", "stages", "chunk")


def _chunk_plan(tp, to, c, kc):
    """(nkc, resident, smem) of K chunks of kc rows: w's (4C, TO) slice
    stays resident beside the ring where it fits (else each stage
    carries its K slice); a stage holds tp rows of kc + 4 floats and tp
    8-byte pixel offsets."""
    nkc = max(1, -(-4 * c // kc))
    stage = tp * (kc + 4) * 4 + tp * 8
    w_res = nkc * kc * to * 4
    resident = w_res + _STAGES * stage <= _SMEM_MAX
    smem = (w_res + _STAGES * stage if resident
            else _STAGES * (stage + kc * to * 4))
    return nkc, int(resident), smem


def _blocks_per_sm(smem):
    """Blocks an SM holds by shared memory (1 KB reserved each), at most
    2 (registers)."""
    return min(2, _SMEM_SM // (smem + 1024))


def launch_plan(n_pix, c, o, x_addr):
    """The kernel's launch plan for n_pix output pixels, C, O and x's
    address (csrc/conv_stage.cu's make_plan), as a dict of PLAN_KEYS:
    og 4-channel groups per block (the least power of two covering O,
    at most 16, so O <= 64 is one block along O), pm pixels per thread,
    tp = 256 / og x pm pixels per tile, vw floats per x copy (4 where 2C
    is a multiple of 4 and x is 16-byte aligned, else 2 where x is
    8-byte aligned, else 1), the chunk of K rows a ring stage holds (64
    where 4C > 32 and an SM holds as many blocks as with 32, else 32),
    nkc K chunks, whether w stays resident (the K-slice rule of
    _chunk_plan), the grid's O tiles, the pixel tiles, the dynamic
    shared memory."""
    groups = -(-o // 4)
    og = 1
    while og < groups and og < 16:
        og *= 2
    pm = 8 if og == 16 else 4 if og >= 4 else og
    tp = _THREADS // og * pm
    vw = 4 if (2 * c) % 4 == 0 and x_addr % 16 == 0 else \
        2 if x_addr % 8 == 0 else 1
    chunk, (nkc, resident, smem) = 32, _chunk_plan(tp, 4 * og, c, 32)
    if 4 * c > 32:
        wide = _chunk_plan(tp, 4 * og, c, 64)
        if _blocks_per_sm(wide[2]) >= _blocks_per_sm(smem):
            chunk, (nkc, resident, smem) = 64, wide
    return dict(og=og, pm=pm, tp=tp, vw=vw, nkc=nkc, resident=resident,
                o_tiles=-(-o // (4 * og)), pix_tiles=-(-n_pix // tp),
                smem=smem, stages=_STAGES, chunk=chunk)


_LIB = None


def _lib():
    """The kernel's library, built and typed at first use."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("conv_stage")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nlt_conv2x2s2_lrelu.argtypes = [p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, p]
        lib.nlt_conv2x2s2_lrelu.restype = i
        lib.nlt_conv2x2s2_lrelu_clocks.argtypes = [p, p, p, p, i, i, i, i,
                                                   i, ctypes.c_float, p, p]
        lib.nlt_conv2x2s2_lrelu_clocks.restype = i
        lib.nlt_conv_plan.argtypes = [ctypes.c_longlong, i, i,
                                      ctypes.c_ulonglong, p]
        lib.nlt_conv_plan.restype = None
        lib.nlt_conv_stage_error_string.argtypes = [i]
        lib.nlt_conv_stage_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(x, w, b, negative_slope):
    """Launch the kernel on checked, contiguous float32 CUDA tensors."""
    n, h, wd, c = x.shape
    o = w.shape[3]
    y = torch.empty((n, h // 2, wd // 2, o), dtype=torch.float32,
                    device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.nlt_conv2x2s2_lrelu(x.data_ptr(), w.data_ptr(),
                                      b.data_ptr(), y.data_ptr(), n, h, wd,
                                      c, o, float(negative_slope), stream)
    if err != 0:
        raise RuntimeError(
            "conv2x2s2_lrelu kernel launch failed: %s (x=%s, O=%d)" % (
                lib.nlt_conv_stage_error_string(err).decode(),
                tuple(x.shape), o))
    LAUNCHES["conv2x2s2_lrelu"] += 1
    return y


def conv2x2s2_lrelu(x, w, b, negative_slope=0.3):
    """Fused 2x2 stride-2 conv + bias + LeakyReLU (see the module
    docstring)."""
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError("conv2x2s2_lrelu: x (N, H, W, C), w (2, 2, C, O) "
                         "and b (O,) expected, got %s, %s, %s" % (
                             tuple(x.shape), tuple(w.shape), tuple(b.shape)))
    n, h, wd, c = x.shape
    if h % 2 or wd % 2:
        raise ValueError("conv2x2s2_lrelu: H and W must be even, got %s"
                         % (tuple(x.shape),))
    if tuple(w.shape[:3]) != (2, 2, c) or b.shape[0] != w.shape[3]:
        raise ValueError("conv2x2s2_lrelu: w (2, 2, %d, O) and b (O,) "
                         "expected, got %s and %s" % (
                             c, tuple(w.shape), tuple(b.shape)))
    if not (x.device == w.device == b.device):
        raise ValueError("conv2x2s2_lrelu: x, w and b must be on one device")
    if any(t.dtype != torch.float32 for t in (x, w, b)):
        raise TypeError("conv2x2s2_lrelu: float32 only (as nlt_tpu's "
                        "kernel), got %s" % sorted({str(t.dtype)
                                                    for t in (x, w, b)}))
    if x.device.type == "cpu":
        return conv2x2s2_lrelu_ref(x, w, b, negative_slope)
    if x.device.type != "cuda":
        raise ValueError("conv2x2s2_lrelu: no kernel for device %s"
                         % x.device)
    if n * (h // 2) * (wd // 2) >= 2 ** 31:
        raise ValueError("conv2x2s2_lrelu: too many output pixels for the "
                         "kernel's 32-bit pixel index: %s" % (tuple(x.shape),))
    return _launch(x.contiguous(), w.contiguous(), b.contiguous(),
                   negative_slope)
