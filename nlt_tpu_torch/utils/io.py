"""Host-side IO: json/pickle/npy/png/video, output-dir management (a copy
of nlt_tpu/utils/io.py: numpy and PIL only, no torch).
"""

import json
import os
import pickle
import shutil

import numpy as np

from . import logging as logutil

logger = logutil.Logger(loggee="utils/io")


# ---- config / outdir ----

def prepare_outdir(outdir, overwrite=False, quiet=False):
    """Create (optionally wiping) the experiment output directory
    (reference: nlt/util/io.py:47-60)."""
    if os.path.isdir(outdir):
        if not quiet:
            logger.info("Output directory already exists:\n\t%s", outdir)
        if overwrite:
            shutil.rmtree(outdir)
            if not quiet:
                logger.warn("Output directory wiped:\n\t%s", outdir)
        else:
            if not quiet:
                logger.info("Overwrite is off, so doing nothing")
            return
    os.makedirs(outdir)


def sortglob(directory, pattern="*"):
    """Sorted glob (reference: xiuminglib os.py sortglob)."""
    import glob as _glob
    return sorted(_glob.glob(os.path.join(directory, pattern)))


# ---- json / pickle / npy ----

def read_json(path):
    with open(path, "r") as h:
        return json.load(h)


def write_json(data, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _default(o):
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        raise TypeError(type(o))

    with open(path, "w") as h:
        json.dump(data, h, indent=4, default=_default)


def read_pickle(path):
    with open(path, "rb") as h:
        return pickle.load(h)


def write_pickle(data, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as h:
        pickle.dump(data, h)


def read_npy(path):
    return np.load(path)


def write_npy(arr, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.save(path, arr)


# ---- images (PIL-backed) ----

def load_img(path, as_array=True):
    from PIL import Image
    img = Image.open(path)
    if as_array:
        return np.array(img)
    return img


def write_img(arr_0to1, path):
    """Write a float [0,1] (or uint8) array as PNG; returns the uint8 array
    (reference pattern: xiuminglib io/img.py write_arr)."""
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arr = np.asarray(arr_0to1)
    if arr.dtype in (np.float32, np.float64, np.float16):
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    Image.fromarray(arr).save(path)
    return arr


# ---- video ----

def write_video(frames, path, fps=12):
    """Write frames (list of HxWx3 uint8/float arrays) to a video file.

    Prefers imageio-ffmpeg if available; falls back to an animated PNG/GIF
    next to the requested path so the capability degrades gracefully in
    hermetic environments (reference: nlt/util/io.py:90-105 uses xiuminglib's
    ffmpeg wrapper).
    """
    from PIL import Image
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrs = []
    for f in frames:
        f = np.asarray(f)
        if f.dtype != np.uint8:
            f = (np.clip(f, 0, 1) * 255).round().astype(np.uint8)
        arrs.append(f)
    if not arrs:
        logger.warn("No frames to write for %s", path)
        return path
    try:
        import imageio  # noqa: F401  (optional dependency)
        imageio.mimwrite(path, arrs, fps=fps)
        return path
    except Exception:
        pass
    # Fallback: animated image via PIL (APNG for .png/.apng, else GIF)
    base, ext = os.path.splitext(path)
    if ext.lower() not in (".png", ".apng", ".gif"):
        path = base + ".gif"
    ims = [Image.fromarray(a) for a in arrs]
    ims[0].save(
        path, save_all=True, append_images=ims[1:],
        duration=int(1000 / fps), loop=0)
    return path
