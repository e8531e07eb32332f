"""Seeded weights, made on the device in a few calls, and handed to the
program and to the reference alike.

The U-Net's kernels are glorot-uniform (Keras's Conv2D default, which
the recipe's model uses) and its biases zero. LPIPS's AlexNet convs are
He-normal with zero biases and its linear heads 1 / C: the recipe sets
``lpips_weights = none``, so the loss network is random features, here
from the run's seed. Names are the reference's (``reference/model.py::
weight_shapes``, ``conv<i>.w`` / ``lin<i>.w`` for LPIPS).

``into_program`` copies them into the program's params tree, found by
walking it: a stage is one conv's {w, b} or a list of layers whose
entries holding a 'w' are its convs in order; the LPIPS subtree is the
loss entry holding 'convs'. Every name and shape must match, or it
raises.
"""

import math

import torch

from ..reference import losses as ref_losses
from ..reference import model as ref_model
from .scene import generator


def _fill(g, shapes, draw, scale_of, device):
    """One draw over every leaf, scaled per leaf: {name: tensor}."""
    numel = [math.prod(s) for _, s in shapes]
    scales = torch.tensor([scale_of(s) for _, s in shapes], device=device)
    flat = draw(sum(numel), g) * torch.repeat_interleave(
        scales, torch.tensor(numel, device=device))
    return {name: t.view(shape) for (name, shape), t in
            zip(shapes, torch.split(flat, numel))}


def unet(cfg, seed, device):
    shapes = ref_model.weight_shapes(cfg)
    kernels = [(n, s) for n, s in shapes if n.endswith(".w")]
    out = _fill(
        generator(seed, device, "weights", "unet"), kernels,
        lambda n, g: torch.rand(n, generator=g, device=device) * 2 - 1,
        lambda s: math.sqrt(6.0 / (s[0] * s[1] * (s[2] + s[3]))), device)
    biases = [(n, s) for n, s in shapes if n.endswith(".b")]
    zeros = torch.zeros(sum(s[0] for _, s in biases), device=device)
    out.update({n: t for (n, _), t in zip(
        biases, torch.split(zeros, [s[0] for _, s in biases]))})
    return {n: out[n] for n, _ in shapes}


def lpips(seed, device):
    shapes, in_ch = [], 3
    for i, (o, k, _, _) in enumerate(ref_losses.ALEX):
        shapes.append(("conv%d.w" % i, (k, k, in_ch, o)))
        in_ch = o
    out = _fill(generator(seed, device, "weights", "lpips"), shapes,
                lambda n, g: torch.randn(n, generator=g, device=device),
                lambda s: math.sqrt(2.0 / (s[0] * s[1] * s[2])), device)
    for i, (o, _, _, _) in enumerate(ref_losses.ALEX):
        out["conv%d.b" % i] = torch.zeros(o, device=device)
        out["lin%d.w" % i] = torch.full((o,), 1.0 / o, device=device)
    return out


def _program_unet_leaves(net):
    for kind in ("query", "obs"):
        for i, stage in enumerate(net[kind]):
            convs = [stage] if isinstance(stage, dict) else [
                layer for layer in stage
                if isinstance(layer, dict) and "w" in layer]
            for j, conv in enumerate(convs):
                yield "%s.%d.%d.w" % (kind, i, j), conv["w"]
                yield "%s.%d.%d.b" % (kind, i, j), conv["b"]


def _program_lpips_leaves(loss_tree):
    trees = [t for t in loss_tree.values() if "convs" in t]
    if len(trees) != 1:
        raise ValueError("expected one LPIPS subtree, found %d" % len(trees))
    for i, conv in enumerate(trees[0]["convs"]):
        yield "conv%d.w" % i, conv["w"]
        yield "conv%d.b" % i, conv["b"]
    for i, lin in enumerate(trees[0]["lins"]):
        yield "lin%d.w" % i, lin["w"]


def _copy(pairs, values, what):
    pairs = list(pairs)
    names = [n for n, _ in pairs]
    if sorted(names) != sorted(values):
        raise ValueError("%s: the program's leaves %s are not the reference's"
                         " %s" % (what, names[:6], list(values)[:6]))
    for n, t in pairs:
        if tuple(t.shape) != tuple(values[n].shape):
            raise ValueError("%s: %s is %s in the program, %s here"
                             % (what, n, tuple(t.shape),
                                tuple(values[n].shape)))
    with torch.no_grad():
        torch._foreach_copy_([t for _, t in pairs],
                             [values[n] for n in names])


def into_program(params, unet_w, lpips_w=None):
    """Copy the weights into the program's params tree, in place."""
    _copy(_program_unet_leaves(params["net"]), unet_w, "U-Net")
    if lpips_w is not None:
        _copy(_program_lpips_leaves(params["loss"]), lpips_w, "LPIPS")
