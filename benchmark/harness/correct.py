"""The comparison that decides ``correct``: what the timed path produced,
against the plain float32 reference (``reference/``) on the same
seeded weights and wire-format inputs.

Training cells: the first ``compare_steps`` steps of the program's
training object (driven in set-up through the window's own call and
feed) against the reference's steps from the same weights on the same
batches:
- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_rel_l2``: the first gradient as the optimizer got it (AMSGrad's
  first moment after one step is (1 - b1) g): the L2 norm of its
  difference from the reference's over the reference's norm, all kept
  leaves together. The first step is the captured step's warm-up, which
  runs eagerly;
- ``last_grad_rel_l2``: the same of the last compared step's gradient,
  (mu_t - b1 mu_{t-1}) / (1 - b1) from the first moment before and after
  it: a replay of the graph that the window replays, so that a capture
  that bakes another precision or switch is seen;
- ``update_gap``: the parameters' change over the steps by the worst
  leaf, a leaf's gap being the gap between the program's norm and the
  reference's over the reference's norm of that leaf or of the median
  leaf, whichever is larger.
The gradient is compared by the norm of its difference, not by a gap of
norms: a gap of norms is blind to rounding noise across the gradient (it
grows with the noise's square), so float8 reads barely above bfloat16
there. The first gradient's gaps of norms by the median and the worst
leaves, the change's by the median leaf, and the worst leaves' names
(``leaf_report``) are printed beside the numbers and not compared.
Leaves whose reference gradient is under a thousandth of the median
leaf's (LPIPS's frozen weights, which neither side moves) are left out
of all of them, by that rule and not by name.

Serving cells: ``frame_rms_lsb``, the worst root-mean-square gap, in
uint8 levels, between a served frame and the reference's frame of the
same request, over a sample of the window's requests drawn from the
seed.
"""

import torch

GRAD_FLOOR = 1e-3   # leaves under this share of the median leaf's gradient


def _norms(tensors):
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tensors.items()}


def _median(values):
    vals = sorted(values)
    return vals[len(vals) // 2] if vals else 0.0


def leaf_gaps(got, want, keep):
    """{leaf: |‖got‖ - ‖want‖| / max(‖want‖, median leaf's ‖want‖)}."""
    g = _norms({k: got[k] for k in keep})
    w = _norms({k: want[k] for k in keep})
    med = _median(list(w.values()))
    return {k: abs(g[k] - w[k]) / max(w[k], med, 1e-30) for k in keep}


def leaf_report(prog, ref, w0, top=3):
    """The leaf gaps printed beside the numbers: the first gradient's and
    the change's by the median leaf, and the worst leaves of each:
    {name: value or [[leaf, gap], ...]}."""
    keep = _kept(ref[1][1])
    out = {}
    for name, gaps in (
            ("grad_gap", leaf_gaps(prog[1][1], ref[1][1], keep)),
            ("update_gap", leaf_gaps(*_changes(prog, ref, w0, keep), keep))):
        out[name + "_median_leaf"] = _median(list(gaps.values()))
        out[name + "_worst"] = [[k, v] for k, v in sorted(
            gaps.items(), key=lambda kv: -kv[1])[:top]]
    return out


def _changes(prog, ref, w0, keep):
    return ({k: prog[2][k].float() - w0[k] for k in keep},
            {k: ref[2][k].float() - w0[k] for k in keep})


def rel_l2(got, want, keep):
    """‖got - want‖ / ‖want‖ over the kept leaves together."""
    diff = sum(float(torch.sum((got[k].float() - want[k].float()) ** 2))
               for k in keep)
    norm = sum(float(torch.sum(want[k].float() ** 2)) for k in keep)
    return (diff / norm) ** 0.5 if norm > 0 else float("inf")


def _kept(ref_grads):
    norms = _norms(ref_grads)
    med = _median(list(norms.values()))
    return [k for k, v in norms.items() if v >= GRAD_FLOOR * med]


def train_numbers(prog, ref, w0):
    """prog / ref: (losses, grads, params_after), grads {step number from
    1: {name: tensor}} holding at least the first step's and, in prog,
    the last compared step's; w0: the weights both started from."""
    p_loss, p_grad, _ = prog
    r_loss, r_grad, _ = ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(p_loss, r_loss))
    keep = _kept(r_grad[1])
    last = max(p_grad)
    changes = leaf_gaps(*_changes(prog, ref, w0, keep), keep)
    return {"loss_gap": loss_gap,
            "grad_rel_l2": rel_l2(p_grad[1], r_grad[1], keep),
            "last_grad_rel_l2": rel_l2(p_grad[last], r_grad[last], keep),
            "update_gap": max(changes.values())}


def frame_rms_lsb(got, want):
    """Worst per-frame RMS gap in uint8 levels over pairs of (N, H, W, 3)
    uint8 frame batches."""
    worst = 0.0
    for g, w in zip(got, want):
        d = (torch.as_tensor(g).float() - torch.as_tensor(w).float())
        per_frame = d.pow(2).mean(dim=(1, 2, 3)).sqrt()
        worst = max(worst, float(per_frame.max()))
    return worst


def judge(numbers, limits):
    """(correct, {name: {'value', 'limit'}}): every number within its
    limit (a number with no limit fails)."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok &= limit is not None and value == value and value <= limit
    return bool(ok), checks
