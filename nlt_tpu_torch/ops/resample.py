"""Differentiable bilinear resampling through a per-pixel warp field
(port of nlt_tpu/ops/resample.py).

Semantics of ``tfa.image.resampler``, as nlt_tpu matches them:
``warp[..., 0]`` is the x (width) and ``warp[..., 1]`` the y (height)
source coordinate in pixel units; the 4 neighboring texels are combined
bilinearly; a tap outside [0, W-1] x [0, H-1] contributes 0, so queries
in (-1, 0) or (size-1, size) get partial contributions and queries
further out sample zeros.

The formulation is nlt_tpu's production one: a window table T[i] = the
2x2 neighborhood at flat index i (4C channels), one flat row take at the
clamped window base with the batch folded into the row index, then the
4 corner values selected and weighted. The take is ``TakeRows``: its
forward is a plain ``index_select`` (nlt_tpu leaves the gather to XLA),
its backward the row scatter-add of ops/scatter.py, which launches the
K1 kernel on CUDA. Gradients reach the image through it and the warp
through the bilinear weights.

With a static warp (the NLT training step), ``make_plan`` computes the
window rows, the per-slot weights and the backward's live rows once per
example, and ``resample_planned`` consumes them; only the image gets a
gradient on that path.
"""

import torch

from . import scatter as scatter_mod


def _resample_one(img, warp):
    """Reference formulation: four clipped corner gathers per query.
    img: (N, H, W, C); warp: (N, Ho, Wo, 2) -> (N, Ho, Wo, C). Kept to
    cross-check the production path (tests)."""
    n, h, w, c = img.shape
    ho, wo = warp.shape[1], warp.shape[2]
    x = warp[..., 0]
    y = warp[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = x - x0f
    ty = y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    flat = img.reshape(n, h * w, c)

    def tap(xi, yi, weight):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(n, -1)
        vals = torch.gather(flat, 1, idx[..., None].expand(n, ho * wo, c))
        wgt = torch.where(inb, weight, torch.zeros_like(weight))
        return vals.reshape(n, ho, wo, c) * wgt[..., None]

    return (tap(x0, y0, (1 - tx) * (1 - ty))
            + tap(x0 + 1, y0, tx * (1 - ty))
            + tap(x0, y0 + 1, (1 - tx) * ty)
            + tap(x0 + 1, y0 + 1, tx * ty))


def _window_table(img):
    """T[n, y, x, :] = [img[y,x], img[y,x+1], img[y+1,x], img[y+1,x+1]]
    channel-concatenated (the x=W-1 / y=H-1 edge slots are never read:
    window bases are clamped to [0, W-2] x [0, H-2])."""
    right = torch.cat((img[:, :, 1:], img[:, :, -1:]), dim=2)
    down = torch.cat((img[:, 1:], img[:, -1:]), dim=1)
    downright = torch.cat((right[:, 1:], right[:, -1:]), dim=1)
    return torch.cat((img, right, down, downright), dim=3)


class TakeRows(torch.autograd.Function):
    """table[idx] (a flat row take) whose backward scatter-adds the
    output gradient into the table's rows at `grad_rows` (rows < 0 are
    skipped): the K1 kernel on CUDA, its plain version on the CPU. For
    the unplanned resample grad_rows is idx itself; a plan drops its
    dead updates by marking them -1."""

    @staticmethod
    def forward(ctx, table, idx, grad_rows):
        ctx.save_for_backward(grad_rows)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (grad_rows,) = ctx.saved_tensors
        d_table = scatter_mod.scatter_add_rows(grad_rows, g.contiguous(),
                                               ctx.n_rows)
        return d_table, None, None


def _floor_parts(warp):
    """(x0, y0, tx, ty): integer corner and fractional offsets."""
    x = warp[..., 0]
    y = warp[..., 1]
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    return (x0f.to(torch.int32), y0f.to(torch.int32), x - x0f, y - y0f)


def _corners(x0, y0, tx, ty):
    return ((x0, y0, (1 - tx) * (1 - ty)),
            (x0 + 1, y0, tx * (1 - ty)),
            (x0, y0 + 1, (1 - tx) * ty),
            (x0 + 1, y0 + 1, tx * ty))


def _batch_offsets(n, h, w, device):
    return (torch.arange(n, dtype=torch.int32, device=device)
            * (h * w)).reshape(n, 1, 1)


def resample(img, warp):
    """img: (N, H, W, C); warp: (N, Ho, Wo, 2) source (x, y) per target
    pixel. Returns (N, Ho, Wo, C) in img's dtype; differentiable in img
    and warp."""
    n, h, w, c = img.shape
    x0, y0, tx, ty = _floor_parts(warp)
    # Window base, clamped so the 2x2 window is always in bounds; every
    # clipped corner then lands inside it, and corners further out carry
    # zero weight.
    bx = x0.clamp(0, w - 2)
    by = y0.clamp(0, h - 2)
    table = _window_table(img).reshape(n * h * w, 4 * c)
    base = (_batch_offsets(n, h, w, img.device) + by * w + bx).reshape(-1)
    win = TakeRows.apply(table, base, base).reshape(bx.shape + (4, c))

    out = 0
    for cx, cy, weight in _corners(x0, y0, tx, ty):
        sx = (cx.clamp(0, w - 1) == bx + 1)[..., None]
        sy = (cy.clamp(0, h - 1) == by + 1)[..., None]
        v = torch.where(sy, torch.where(sx, win[..., 3, :], win[..., 2, :]),
                        torch.where(sx, win[..., 1, :], win[..., 0, :]))
        inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        wgt = torch.where(inb, weight, torch.zeros_like(weight))
        out = out + v * wgt[..., None]
    return out


def make_plan(warp, h, w, zero_grad_texel=None):
    """The warp-only parts of resample() for an (h, w, C) source.

    Dead updates are dropped from the backward: a query whose four slot
    weights are all zero contributes nothing to the image gradient.
    With zero_grad_texel=(y, x) (a texel whose gradient the caller
    discards: the NLT model blacks out (0, 0) and routes background
    queries there), an update whose every nonzero-weight slot targets
    that texel is dropped as well. The forward is unchanged; the
    backward differs only at that texel.

    Returns per-example tensors (leading dim N, so a batch split splits
    them too): rows (N, Ho, Wo) int32 example-local window-base rows;
    wslot (N, Ho, Wo, 4) the 4 corner weights folded onto the window
    slots they clip to (out-of-bounds taps zeroed); grad_rows
    (N, Ho, Wo) int32, rows where the update is live and -1 where dead.
    """
    x0, y0, tx, ty = _floor_parts(warp)
    bx = x0.clamp(0, w - 2)
    by = y0.clamp(0, h - 2)
    rows = by * w + bx

    wslot = torch.zeros(tx.shape + (4,), dtype=tx.dtype, device=tx.device)
    slot_ids = torch.arange(4, dtype=torch.int32, device=tx.device)
    for cx, cy, wgt in _corners(x0, y0, tx, ty):
        j = ((cy.clamp(0, h - 1) == by + 1).to(torch.int32) * 2
             + (cx.clamp(0, w - 1) == bx + 1).to(torch.int32))
        inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        wgt = torch.where(inb, wgt, torch.zeros_like(wgt))
        wslot = wslot + torch.where(j[..., None] == slot_ids, wgt[..., None],
                                    torch.zeros_like(wgt[..., None]))

    # Slot j targets texel (by + j//2, bx + j%2). An update is dead iff
    # every slot with nonzero weight targets a texel whose gradient is
    # discarded.
    if zero_grad_texel is not None:
        zy, zx = zero_grad_texel
        slot_live = torch.stack(
            [(wslot[..., j] != 0)
             & ~((by + j // 2 == zy) & (bx + j % 2 == zx))
             for j in range(4)], dim=-1)
    else:
        slot_live = wslot != 0
    dead = ~slot_live.any(dim=-1)
    return {"rows": rows, "wslot": wslot,
            "grad_rows": torch.where(dead, -1, rows)}


def resample_planned(img, plan):
    """resample(img, warp) with the warp-only work precomputed by
    make_plan(warp, h, w). Differentiable in img only."""
    n, h, w, c = img.shape
    rows = plan["rows"]
    if rows.shape[0] != n:
        raise ValueError("plan batch dim %d != image batch %d"
                         % (rows.shape[0], n))
    offs = _batch_offsets(n, h, w, img.device)
    grad_rows = plan["grad_rows"]
    table = _window_table(img).reshape(n * h * w, 4 * c)
    win = TakeRows.apply(
        table, (rows + offs).reshape(-1),
        torch.where(grad_rows >= 0, grad_rows + offs, -1).reshape(-1))
    win = win.reshape(rows.shape + (4, c))
    return (win * plan["wslot"][..., None]).sum(dim=3)
