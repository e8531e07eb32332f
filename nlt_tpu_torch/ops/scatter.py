"""Row scatter-add, the resampler's backward (port of
nlt_tpu/ops/scatter_pallas.py).

``scatter_add_rows(idx, upd, n_rows)`` is ``zeros((n_rows, W))`` with
``upd[r]`` added at row ``idx[r]``; an update whose row lies outside
``[0, n_rows)`` is skipped (make_plan marks dead updates with -1).

Kernel (csrc/scatter.cu, built for sm_90a at first use): it replaces the
Pallas kernel ``_kernel`` of nlt_tpu/ops/scatter_pallas.py (launched by
``_scatter_planned_local``, reached by ``scatter_add_rows`` and
``scatter_add_rows_planned``). nlt_tpu's routing plan (pieces, chunks,
dump rows, ``[lo, hi)`` scan bounds, the custom partitioning) exists to
fit the table in VMEM and the indices in SMEM; the CUDA kernel needs
none of it: it zeroes the table, then one thread per update row loads
the row's index once and adds a live row with float4 vector atomics
(a scalar path inside the same kernel where W is no multiple of 4 or
above 16, or a pointer is off a 16-byte boundary; ``launch_plan``
mirrors the choice and the grid). It is bound by bytes (read the
updates and indices once, write the table once). Sums over duplicate
rows come out in no fixed order, as nlt_tpu's "up to accumulation
order" allows.

On a CPU tensor the op runs its plain version (``scatter_add_rows_ref``,
``index_add_`` with skipped updates sent to a dump row); on a CUDA tensor
it launches the kernel or raises. ``LAUNCHES`` counts kernel launches.
"""

import ctypes

import torch

LAUNCHES = {"scatter_add_rows": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def scatter_add_rows_ref(idx, upd, n_rows):
    """Plain PyTorch version: one index_add_ into a table with a dump row
    past its end, where every skipped update lands."""
    keep = (idx >= 0) & (idx < n_rows)
    rows = torch.where(keep, idx.long(), n_rows)
    out = torch.zeros((n_rows + 1, upd.shape[1]), dtype=upd.dtype,
                      device=upd.device)
    return out.index_add_(0, rows, upd)[:n_rows]


# Mirrors csrc/scatter.cu: threads a block, the grid's cap (SMs x
# resident blocks), the widest row of the float4 path (in float4s).
_THREADS, _MAX_BLOCKS, _MAX_WV = 256, 132 * 16, 4
PLAN_KEYS = ("wv", "blocks")


def launch_plan(r, w, upd_addr, out_addr):
    """The kernel's launch plan for r update rows of w floats at the two
    addresses (csrc/scatter.cu's make_plan), as a dict of PLAN_KEYS: the
    float4s per row on the float4 path (w a multiple of 4 up to 16, both
    pointers 16-byte aligned), else 0, the scalar path; and the grid of
    256-thread blocks, one thread per row in a grid-stride loop."""
    vec = (w % 4 == 0 and w // 4 <= _MAX_WV and upd_addr % 16 == 0
           and out_addr % 16 == 0)
    return dict(wv=w // 4 if vec else 0,
                blocks=min(-(-r // _THREADS), _MAX_BLOCKS))


_LIB = None


def _lib():
    """The kernel's library, built and typed at first use."""
    global _LIB
    if _LIB is None:
        from . import _build

        lib = _build.load("scatter")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.nlt_scatter_add_rows.argtypes = [p, p, p, ctypes.c_longlong, i, i,
                                             p]
        lib.nlt_scatter_add_rows.restype = i
        lib.nlt_scatter_add_rows_parts.argtypes = [p, p, p, ctypes.c_longlong,
                                                   i, i, i, p]
        lib.nlt_scatter_add_rows_parts.restype = i
        lib.nlt_scatter_plan.argtypes = [ctypes.c_longlong, i,
                                         ctypes.c_ulonglong,
                                         ctypes.c_ulonglong, p]
        lib.nlt_scatter_plan.restype = None
        lib.nlt_scatter_error_string.argtypes = [i]
        lib.nlt_scatter_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(idx, upd, n_rows, out=None):
    """Launch the kernel on checked CUDA tensors, into `out` (a
    contiguous (n_rows, W) float32 tensor) if given, else a new one."""
    r, w = upd.shape
    if out is None:
        out = torch.empty((n_rows, w), dtype=torch.float32,
                          device=upd.device)
    lib = _lib()
    with torch.cuda.device(upd.device):
        stream = torch.cuda.current_stream(upd.device).cuda_stream
        err = lib.nlt_scatter_add_rows(idx.data_ptr(), upd.data_ptr(),
                                       out.data_ptr(), r, w, n_rows, stream)
    if err != 0:
        raise RuntimeError("scatter_add_rows kernel launch failed: %s (R=%d, "
                           "W=%d, n_rows=%d)" % (
                               lib.nlt_scatter_error_string(err).decode(),
                               r, w, n_rows))
    LAUNCHES["scatter_add_rows"] += 1
    return out


def scatter_add_rows(idx, upd, n_rows):
    """zeros((n_rows, W)) with upd[r] added at row idx[r] (rows outside
    [0, n_rows) skipped).

    idx: (R,) integer rows; upd: (R, W) updates, float32 on CUDA.
    Returns (n_rows, W) in upd's dtype.
    """
    if idx.dim() != 1 or upd.dim() != 2 or upd.shape[0] != idx.shape[0]:
        raise ValueError("scatter_add_rows: idx (R,) and upd (R, W) "
                         "expected, got %s and %s"
                         % (tuple(idx.shape), tuple(upd.shape)))
    if idx.device != upd.device:
        raise ValueError("scatter_add_rows: idx and upd must be on one "
                         "device")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError("scatter_add_rows: integer idx expected, got %s"
                        % idx.dtype)
    if upd.device.type == "cpu":
        return scatter_add_rows_ref(idx, upd, n_rows)
    if upd.device.type != "cuda":
        raise ValueError("scatter_add_rows: no kernel for device %s"
                         % upd.device)
    if upd.dtype != torch.float32:
        raise TypeError("scatter_add_rows: the kernel takes float32 "
                        "updates, got %s" % upd.dtype)
    if not 0 <= n_rows < 2 ** 31:
        raise ValueError("scatter_add_rows: n_rows %d out of range" % n_rows)
    return _launch(idx.to(torch.int32).contiguous(), upd.contiguous(),
                   n_rows)
