"""Animated-PNG / video visualization helpers (a copy of
nlt_tpu/vis/video.py). PIL-only, no ffmpeg dependency.
"""

import os

import numpy as np
from PIL import Image, ImageDraw, ImageFont


def _to_uint8(img):
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return arr


def _load_font(font_size):
    try:
        return ImageFont.truetype(
            "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf", font_size)
    except Exception:
        return ImageFont.load_default()


def make_apng(imgs, labels=None, label_top_left_xy=(10, 10), font_size=20,
              font_color=(1, 1, 1), outpath="out.apng", duration_ms=1000):
    """Write an animated PNG cycling through `imgs`, each optionally
    stamped with a text label."""
    frames = []
    font = _load_font(max(8, font_size))
    color = tuple(int(255 * c) for c in font_color)
    for i, img in enumerate(imgs):
        arr = _to_uint8(img)
        im = Image.fromarray(arr)
        if labels is not None:
            draw = ImageDraw.Draw(im)
            draw.text(label_top_left_xy, labels[i], fill=color, font=font)
        frames.append(im)
    os.makedirs(os.path.dirname(outpath) or ".", exist_ok=True)
    frames[0].save(
        outpath, save_all=True, append_images=frames[1:],
        duration=duration_ms, loop=0, default_image=False)
    return outpath
