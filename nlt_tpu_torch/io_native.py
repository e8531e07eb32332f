"""ctypes bindings for the native host-IO library (port of
nlt_tpu/io_native.py over the same source, native/nltio.cc).

The port builds its own copy of the library at first use, with
``g++ -O3 -fPIC -shared -std=c++17 native/nltio.cc -lpng -lz``, into the
gitignored ``nlt_tpu_torch/_build/`` (named by a hash of the source and
the flags). It never loads the committed ``native/libnltio.so`` (built
with ``-march=native`` on another machine, so it may not run on this
host's CPU) and never runs ``make`` in ``native/``. It first asks the
preprocessor for libpng's header: where there is none (no libpng
installed, as on hosts that carry only the CUDA stack), PIL is the
decode path and g++ is not run. Where the build or the load fails,
decoding also falls back to PIL. The PIL path's resize is numerically
identical to the native one, and the fallback is logged once. ctypes calls
release the GIL, so the dataset's thread-pool workers decode in
parallel. Host IO only: nothing here touches the device.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from .utils import logging as logutil

logger = logutil.Logger(loggee="io_native")

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "nltio.cc")
_BUILD_DIR = os.path.join(_PKG, "_build")
_CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
_LIBS = ["-lpng", "-lz"]

_lib = None
_lib_lock = threading.Lock()
_tried = False


def _so_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(_CXX_FLAGS + _LIBS).encode()).hexdigest()
    return os.path.join(_BUILD_DIR, "libnltio-%s.so" % digest[:16])


def _have_libpng_header():
    """True when g++ finds <png.h> (preprocessing only, no compile)."""
    try:
        proc = subprocess.run(["g++", "-E", "-x", "c++", "-", "-o",
                               os.devnull], input="#include <png.h>\n",
                              capture_output=True, text=True)
    except OSError:
        return False
    return proc.returncode == 0


def _build(so_path):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so_path, os.getpid())
    proc = subprocess.run(
        ["g++"] + _CXX_FLAGS + ["-o", tmp, _SRC] + _LIBS,
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ exit %d: %s" % (
            proc.returncode, proc.stderr.strip().splitlines()[-1:]))
    os.replace(tmp, so_path)


def get_lib():
    """Returns the loaded library or None if unavailable.

    NOTE: `_tried` is only set AFTER the build/load attempt completes
    (inside the lock). Setting it before the attempt would let threads
    arriving mid-build take the unlocked fast path and observe None —
    silently routing them to the slow fallback (this was a real bug:
    the dataset's field-IO threads all fire at once on the first item).
    """
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lib_lock:
        if _lib is not None or _tried:
            return _lib
        try:
            so_path = _so_path()
            if not os.path.exists(so_path):
                if not _have_libpng_header():
                    logger.info("libpng's header not found; PNGs decode "
                                "with PIL")
                    return None
                _build(so_path)
            lib = ctypes.CDLL(so_path)
            lib.nltio_png_info.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.nltio_png_info.restype = ctypes.c_int
            lib.nltio_load_png_f32.argtypes = [
                ctypes.c_char_p,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.nltio_load_png_f32.restype = ctypes.c_int
            _lib = lib
            logger.info("Native IO library loaded: %s", so_path)
        except Exception as e:
            logger.warn(
                "Native IO unavailable (%s: %s); falling back to PIL",
                type(e).__name__, e)
            _lib = None
        finally:
            _tried = True
    return _lib


def _resize_bilinear_np(src, dh, dw):
    """Numpy mirror of nltio_resize_bilinear_f32 (half-pixel-centered
    point-sampled 2x2 bilinear, clamped edges): the fallback must be
    NUMERICALLY IDENTICAL to the native path, or models trained on
    machines with/without the .so would see different data. (PIL's
    BILINEAR antialiases on downsampling — different pixels.)"""
    sh, sw = src.shape[:2]
    fy = (np.arange(dh, dtype=np.float32) + 0.5) * (sh / dh) - 0.5
    fx = (np.arange(dw, dtype=np.float32) + 0.5) * (sw / dw) - 0.5
    y0 = np.floor(fy).astype(np.int64)
    x0 = np.floor(fx).astype(np.int64)
    ty = (fy - y0).astype(np.float32)[:, None, None]
    tx = (fx - x0).astype(np.float32)[None, :, None]
    y0c = np.clip(y0, 0, sh - 1)
    y1c = np.clip(y0 + 1, 0, sh - 1)
    x0c = np.clip(x0, 0, sw - 1)
    x1c = np.clip(x0 + 1, 0, sw - 1)
    if src.ndim == 2:
        src = src[:, :, None]
    top = src[y0c][:, x0c] * (1 - tx) + src[y0c][:, x1c] * tx
    bot = src[y1c][:, x0c] * (1 - tx) + src[y1c][:, x1c] * tx
    return (top * (1 - ty) + bot * ty).astype(np.float32)


def _pil_load_resized(path, new_h=None, new_w=None):
    """Pure-host fallback: PIL decode + the SAME point-sampled bilinear
    the native kernel uses (_resize_bilinear_np). MUST stay numpy-only —
    it runs inside loader threads, which never touch the device."""
    from PIL import Image
    img = Image.open(path)
    arr = np.asarray(img)
    if arr.dtype == np.uint8:
        # The native decoder's float32 product with 1/255 (a division
        # differs from it by 1 ulp).
        arr = arr.astype(np.float32) * np.float32(1.0 / 255.0)
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if new_h is not None:
        if new_w is None:
            new_w = int(arr.shape[1] / arr.shape[0] * new_h)
        squeeze = arr.ndim == 2
        arr = _resize_bilinear_np(arr, new_h, new_w)
        if squeeze:
            arr = arr[:, :, 0]
    return arr


def _png_bit_depth(path):
    """Bit depth from the IHDR chunk (byte 24 of a well-formed PNG)."""
    try:
        with open(path, "rb") as h:
            header = h.read(25)
        if len(header) == 25 and header[:8] == b"\x89PNG\r\n\x1a\n":
            return header[24]
    except OSError:
        pass
    return 8


def load_png_f32(path, new_h=None, new_w=None):
    """Decode a PNG to float32 [0,1] HWC (HxW for grayscale), optionally
    bilinearly resized to (new_h, new_w). Falls back to the PIL path.

    16-bit PNGs (xiuminglib's write_img can produce them) go through the
    PIL path: libpng's simplified API would silently gamma-linearize
    them, while PIL preserves raw values (normalized by 65535)."""
    lib = get_lib()
    if lib is not None and _png_bit_depth(path) == 16:
        lib = None
    if lib is None:
        return _pil_load_resized(path, new_h=new_h, new_w=new_w)

    bpath = os.fsencode(path)
    w = ctypes.c_int()
    h = ctypes.c_int()
    ch = ctypes.c_int()
    rc = lib.nltio_png_info(bpath, ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(ch))
    if rc != 0:
        raise IOError("nltio_png_info failed (%d) for %s" % (rc, path))
    w, h, ch = w.value, h.value, ch.value
    if new_h is None:
        dh, dw = h, w
    else:
        dh = new_h
        dw = new_w if new_w is not None else int(w / h * new_h)
    out = np.empty((dh, dw, ch), np.float32)
    rc = lib.nltio_load_png_f32(bpath, out, dh, dw, w, h, ch)
    if rc != 0:
        raise IOError("nltio_load_png_f32 failed (%d) for %s" % (rc, path))
    if ch == 1:
        return out[:, :, 0]
    return out
