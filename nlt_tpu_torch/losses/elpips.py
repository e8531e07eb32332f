"""E-LPIPS: LPIPS under random input transformations applied identically
to both images, averaged over samples (Kettunen et al. 2019; port of
nlt_tpu/losses/elpips.py).

The transform family is nlt_tpu's:
- an integer translation in [0, 8)^2: reflect-pad by 8 at the bottom and
  right, crop at the offset;
- horizontal and vertical flips;
- a spatial transpose (square images only);
- one of the 6 permutations of the RGB channels;
- a global intensity scale in [0.8, 1.0].

nlt_tpu draws a transform from a JAX key; the port splits the draw
(``draw_transform``, on a CPU ``torch.Generator``, so choosing a
transform never waits on the card) from its application
(``apply_transform``). The streams differ, so the port draws other
transforms than nlt_tpu from the same seed; handing nlt_tpu's draws to
``apply_transform`` gives nlt_tpu's values.
"""

import collections

import torch

PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
MAX_SHIFT = 8

# oy, ox: the crop offset; fx, fy: flips along W and H; ft: transpose;
# perm: an index into PERMS; scale: the intensity factor.
Draw = collections.namedtuple("Draw",
                              ["oy", "ox", "fx", "fy", "ft", "perm", "scale"])


def draw_transform(generator, square):
    """One ensemble sample from a CPU torch.Generator. `square`: whether
    the images are square (only then may they be transposed)."""
    shift = torch.randint(0, MAX_SHIFT, (2,), generator=generator)
    flips = torch.rand(3, generator=generator) < 0.5
    perm = torch.randint(0, len(PERMS), (), generator=generator)
    u = torch.rand((), generator=generator, dtype=torch.float32)
    return Draw(int(shift[0]), int(shift[1]), bool(flips[0]), bool(flips[1]),
                bool(flips[2]) and square, int(perm),
                float(u * 0.2 + 0.8))


def _translate(img, o, dim):
    """Rows (dim 1) or columns (dim 2) [o, o + n) of img reflect-padded
    by MAX_SHIFT after its end: img[o:] then the reflection
    img[n-2], ..., img[n-1-o]."""
    if o == 0:
        return img
    n = img.shape[dim]
    return torch.cat((img.narrow(dim, o, n - o),
                      img.narrow(dim, n - 1 - o, o).flip(dim)), dim=dim)


def apply_transform(img, draw):
    """The transform `draw` of an (N, H, W, 3) batch."""
    if min(img.shape[1], img.shape[2]) <= MAX_SHIFT:
        raise ValueError("E-LPIPS needs images larger than %d pixels, got %s"
                         % (MAX_SHIFT, tuple(img.shape)))
    img = _translate(_translate(img, draw.oy, 1), draw.ox, 2)
    if draw.fx:
        img = img.flip(2)
    if draw.fy:
        img = img.flip(1)
    if draw.ft and img.shape[1] == img.shape[2]:
        img = img.transpose(1, 2)
    if PERMS[draw.perm] != (0, 1, 2):
        img = img[..., list(PERMS[draw.perm])]
    return img * draw.scale
