"""Training and evaluation steps (port of nlt_tpu/parallel/train.py).

The training state is a plain tree {params, opt_state, step[,
ema_params]}. A step runs forward, loss and backward eagerly, then the
optimizer: AMSGrad exactly as optax 0.2.6 ``scale_by_amsgrad`` computes
it (the max is taken over the bias-corrected second moment, which is
where ``torch.optim.Adam(amsgrad=True)`` differs), preceded by
``clip_by_global_norm(mgm)`` when mgm > 0. The step computes a new
state beside the old one, so a guarded step (nan_guard) can keep the
old one; with ``donate=True`` it then writes the new values into the
old state's own tensors (``torch._foreach_copy_``), nlt_tpu's donation,
and returns a state whose leaves are the input's tensors.

On the card the training and eval steps run as CUDA graphs
(``parallel/graph.py``, nlt_tpu's jit): one graph per input shape,
replayed, the donated state used in place and every other input copied
into the graph's buffers; what stays eager is decided once, by
``graph.eager_reason`` (the CPU, a mesh over a process group, a
stochastic loss). Outputs follow the runner's contract: the loss and
``to_vis`` are fresh tensors on every call.

The loss network's weights (LPIPS) are detached inside the loss, so they
get no gradient; the optimizer walks them with zero gradients, as optax
does. The optimizer's work is a span for the profiler (``nlt::optimizer``,
``utils/trace.py``); like the losses' spans it exists only in eager
steps, since a CUDA graph's replay runs no host code.

BatchNorm (norm = batch): the forward runs inside
``elements.collect_bn_stats()``; after the optimizer update (which walks
the moving-statistics leaves with their zero gradient) the recorded
batch statistics, averaged over the microbatches, are EMA-merged into
the params, before nan_guard and the EMA of the params, as in nlt_tpu.
Stochastic losses (E-LPIPS) draw from a CPU torch.Generator seeded from
(17, step, microbatch): one fresh draw per step and microbatch, the
port's own stream (nlt_tpu folds the step into a JAX key).

Data parallel (``mesh``: a ``parallel.mesh.DataMesh``): each rank steps
on its contiguous block of the global batch. After the local loss and
gradients (and the grad_accum average), the gradients and the loss are
averaged over the ranks in one flat all-reduce, before the optimizer and
before nan_guard, so every rank takes the same update and the same skip.
BatchNorm takes the global batch's moments (``collect_bn_stats(mesh=)``),
so the recorded taps and the moving statistics are the single-process
run's. grad_accum's strided split stays local: with rank blocks whose
size divides by grad_accum, rank r's ``local[i::N]`` is its part of the
global microbatch ``global[i::N]``. The E-LPIPS draw is a function of
the step alone, so every rank draws the same transform; the EMA and the
BN merge then run on equal values everywhere.

Tile axis (a mesh of n_tile > 1): the ranks of a tile group step on the
same block, each running the U-Net on its rows (``halo.tile_rows``);
the prediction is gathered, so the resample, its backward (K1) and the
loss run whole on every rank of the group. A rank's U-Net gradients are
its rows' share, so the one all-reduce sums them over the tile group and
averages over the data group; the loss and the loss params' gradients,
whole on every rank of a group, are averaged over the world.
"""

import numpy as np
import torch

from ..networks import elements
from ..utils.trace import span
from ..utils.tree import tree_leaves, tree_map, tree_unflatten
from . import graph, halo

# optax.amsgrad's defaults (eps_root 0).
B1, B2, EPS = 0.9, 0.999, 1e-8


class AMSGrad:
    """optax.chain(clip_by_global_norm(mgm) if mgm > 0, amsgrad(lr)) on
    trees of tensors.

    State: {'count': int32 scalar, 'mu', 'nu', 'nu_max': trees like the
    params}."""

    def __init__(self, lr, mgm=-1.0):
        self.lr = float(lr)
        self.mgm = float(mgm) if mgm else -1.0

    def init(self, params):
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params),
                "nu_max": tree_map(torch.zeros_like, params)}

    @staticmethod
    def _dtype(leaves):
        dtypes = {x.dtype for x in leaves}
        if len(dtypes) != 1:
            raise ValueError("AMSGrad: params of one dtype expected, got %s"
                             % sorted(map(str, dtypes)))
        return dtypes.pop()

    def update(self, grads, state):
        """(updates, new_state) for a gradient tree like the params (one
        float dtype, as the port keeps them: float32)."""
        g = tree_leaves(grads)
        if self.mgm > 0:
            # Clips only when the norm reaches mgm; no epsilon.
            norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
            keep = norm < self.mgm
            g = [torch.where(keep, x, (x / norm.to(x.dtype)) * self.mgm)
                 for x in g]
        count = state["count"]
        count = torch.where(count < torch.iinfo(torch.int32).max, count + 1,
                            count)
        b1, b2 = B1, B2
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                torch._foreach_mul(tree_leaves(state["mu"]),
                                                   b1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
            torch._foreach_mul(tree_leaves(state["nu"]), b2))
        # Bias corrections in float64, divided in the moments' dtype; a
        # handful of launches per step however many leaves there are.
        c = count.double()
        mu_hat = torch._foreach_div(mu, (1 - b1 ** c).to(self._dtype(g)))
        nu_hat = torch._foreach_div(nu, (1 - b2 ** c).to(self._dtype(g)))
        nu_max = torch._foreach_maximum(tree_leaves(state["nu_max"]), nu_hat)
        denom = torch._foreach_add(torch._foreach_sqrt(nu_max), EPS)
        updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom),
                                     -self.lr)
        new_state = {"count": count,
                     "mu": tree_unflatten(state["mu"], mu),
                     "nu": tree_unflatten(state["nu"], nu),
                     "nu_max": tree_unflatten(state["nu_max"], nu_max)}
        return tree_unflatten(grads, updates), new_state


def make_optimizer(lr, mgm=-1.0):
    """AMSGrad with optional max-gradient-norm clipping."""
    return AMSGrad(lr, mgm)


def apply_updates(params, updates):
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params),
                                                     tree_leaves(updates)))


def init_state(model, tx, generator, ema_decay=0.0):
    """A fresh state from a torch.Generator, on the model's device."""
    params = model.init_params(generator)
    state = {"params": params, "opt_state": tx.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if ema_decay and ema_decay > 0:
        # Exponential moving average of the params, preferred at
        # eval/serve time.
        state["ema_params"] = tree_map(torch.clone, params)
    return state


def ema_params_of(state):
    """The params to evaluate or serve with: the EMA if the state keeps
    one, else the raw params."""
    return state.get("ema_params", state["params"])


def _split(tree, i, n):
    """Microbatch i of n: examples [i::n] of every leaf (nlt_tpu's
    strided split)."""
    return tree_map(lambda x: x[i::n], tree)


def _merge(parts):
    """Invert the strided split: microbatch outputs back to batch
    order."""
    return tree_map(
        lambda *xs: torch.stack(xs, dim=1).reshape(
            (-1,) + tuple(xs[0].shape[1:])), *parts)


def loss_generator(step, micro_i=0):
    """The CPU generator a stochastic loss draws from at `step` (an int)
    and microbatch `micro_i`."""
    seed = np.random.SeedSequence((17, step, micro_i)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(seed))


def _mean_taps(taps):
    """BN statistics of the microbatches averaged, name by name (the mean
    of the means and of the variances, as nlt_tpu takes them)."""
    return {name: {stat: torch.stack([t[name][stat] for t in taps]).mean(0)
                   for stat in ("mean", "var")}
            for name in taps[0]}


def make_train_step(model, tx, with_vis=True, cached_statics=False,
                    grad_accum=1, nan_guard=False, ema_decay=0.0, mesh=None,
                    donate=False):
    """train_step(state, batch[, statics]) -> (state, loss, to_vis), or
    (state, loss) without vis. batch: dict of tensors on the model's
    device (this rank's block of the global batch under a mesh of
    several ranks; the loss returned is the global batch's, to_vis this
    rank's rows).

    cached_statics: the step takes statics = {'feats', 'products'} from
    make_static_extractor and reuses them (static LPIPS features of the
    ground truth, warp products and the resample plan), with the same
    loss and gradients.

    grad_accum > 1: the batch is split into that many strided
    microbatches run in turn, and their mean gradient makes one update.

    nan_guard: a step whose loss or any gradient is non-finite keeps the
    previous params and optimizer state, BN moving statistics included
    (step still advances; the loss is returned as it was).

    donate: the step writes the new state into `state`'s tensors and
    returns them (the caller's old state is gone, as under nlt_tpu's
    donate_argnums); else it returns new tensors and leaves `state` as
    it was. On the card the step is a ``graph.Captured`` program unless
    ``graph.eager_reason`` keeps it eager.
    """
    stochastic = model.has_stochastic_loss()
    # The step counter on the host, for the stochastic losses' seeds: read
    # from the device once for a state this step did not make, then
    # carried along.
    host_step = {"tensor": None, "value": None}

    def step_of(state):
        if state["step"] is not host_step["tensor"]:
            host_step["value"] = int(state["step"])
        return host_step["value"]

    def loss_and_grads(params, batch, statics, loss_key):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        p = tree_unflatten(params, live)
        apply_kwargs = {}
        gt_feats = None
        if statics:
            gt_feats = statics["feats"] or None
            if statics["products"]:
                apply_kwargs["statics"] = statics["products"]
        with elements.collect_bn_stats(mesh=mesh) as taps, \
                halo.tile_rows(mesh):
            pred, gt, kwargs, to_vis = model.apply(p, batch, "train",
                                                   **apply_kwargs)
        kwargs["keep_batch"] = True
        if gt_feats:
            kwargs["gt_feats"] = gt_feats
        if loss_key is not None:
            kwargs["loss_key"] = loss_key
        loss = model.compute_loss(p, pred, gt, **kwargs).mean()
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(x) if gx is None else gx
                 for x, gx in zip(leaves, grads)]
        return (loss.detach(), grads, tree_map(torch.Tensor.detach, to_vis),
                taps)

    def train_step(state, batch, statics=None):
        params = state["params"]
        step = step_of(state) if stochastic else None

        def key(i):
            return loss_generator(step, i) if stochastic else None

        if grad_accum > 1:
            bs = next(iter(batch.values())).shape[0]
            if bs % grad_accum:
                raise ValueError("batch dim %d not divisible by grad_accum=%d"
                                 % (bs, grad_accum))
            loss, grads, vis, taps = 0.0, None, [], []
            for i in range(grad_accum):
                li, gi, vi, ti = loss_and_grads(
                    params, _split(batch, i, grad_accum),
                    _split(statics, i, grad_accum) if statics else None,
                    key(i))
                loss = loss + li
                grads = gi if grads is None else torch._foreach_add(grads, gi)
                vis.append(vi)
                taps.append(ti)
            loss = loss / grad_accum
            grads = torch._foreach_div(grads, grad_accum)
            to_vis = _merge(vis)
            taps = _mean_taps(taps) if taps[0] else {}
        else:
            loss, grads, to_vis, taps = loss_and_grads(params, batch, statics,
                                                       key(0))
        if mesh is not None:
            # The global batch's mean gradient and loss (equal blocks), in
            # one collective; NaN anywhere reaches every rank. Under the
            # tile axis a rank holds its rows' share of the U-Net's
            # gradients (summed over the tile group) and the whole of the
            # loss and the loss params' gradients.
            whole, split = [loss], []
            if mesh.n_tile > 1:
                is_net = tree_leaves(dict(
                    tree_map(lambda _: False, params),
                    net=tree_map(lambda _: True, params["net"])))
                for g, net in zip(grads, is_net):
                    (split if net else whole).append(g)
            else:
                whole += grads
            mesh.all_reduce_mean_(whole, split=split)
        grads = tree_unflatten(params, grads)
        with span("optimizer"):
            updates, opt_state = tx.update(grads, state["opt_state"])
            new_params = apply_updates(params, updates)
        # BN moving statistics; before nan_guard, so a guarded step keeps
        # the old ones.
        new_params = elements.merge_bn_stats(new_params, taps)
        if nan_guard:
            ok = torch.isfinite(loss)
            for g in tree_leaves(grads):
                ok = ok & torch.isfinite(g).all()
            new_params, opt_state = tree_map(
                lambda new, old: torch.where(ok, new, old),
                (new_params, opt_state), (params, state["opt_state"]))
        new_state = {"params": new_params, "opt_state": opt_state,
                     "step": state["step"] + 1}
        if "ema_params" in state:
            # d and 1 - d taken in float32, as nlt_tpu does.
            d = np.float32(ema_decay)
            new_state["ema_params"] = tree_map(
                lambda e, p: (float(d) * e.float() + float(np.float32(1) - d)
                              * p.float()).to(e.dtype),
                state["ema_params"], new_params)
        if donate:
            torch._foreach_copy_(
                [t for k in new_state for t in tree_leaves(state[k])],
                [t for k in new_state for t in tree_leaves(new_state[k])])
            new_state = state
        if stochastic:
            host_step.update(tensor=new_state["step"], value=step + 1)
        if with_vis:
            return new_state, loss, to_vis
        return new_state, loss

    reason = graph.eager_reason(model.device, model=model, mesh=mesh)
    by_address = (0,) if donate else ()
    if cached_statics:
        return graph.wrap(train_step, "train step (cached statics)", reason,
                          by_address)
    return graph.wrap(lambda state, batch: train_step(state, batch),
                      "train step", reason, by_address)


def make_static_extractor(model):
    """(params, batch) -> {'feats': {loss_i: gt features}, 'products':
    {...}}: every params-independent per-example intermediate, computed
    once (the loss network is frozen, so one extraction per example holds
    for the whole run)."""

    @torch.no_grad()
    def extract(params, batch):
        products = model.static_products(batch)
        feats = {}
        if model.feat_loss_indices():
            gt = (products["gt_camspc"] if "gt_camspc" in products
                  else model.gt_camspc(batch))
            feats = model.extract_gt_feats(params, gt)
        return {"feats": feats, "products": products}

    return extract


def make_eval_step(model, mesh=None):
    """eval_step(state, batch, sharded=False) -> (loss, to_vis), with the
    EMA weights when the state keeps them; BN on the moving statistics,
    E-LPIPS on its fixed seed. sharded: the batch is this rank's block of
    a batch split over the mesh's ranks, and the loss returned is the
    mean over the ranks (the whole batch's); a replicated batch's loss is
    its own. On the card a ``graph.Captured`` program reading the state
    where it lies, unless ``graph.eager_reason`` keeps it eager."""

    @torch.no_grad()
    def eval_step(state, batch, sharded=False):
        params = ema_params_of(state)
        with halo.tile_rows(mesh):
            pred, gt, kwargs, to_vis = model.apply(params, batch, "vali")
        kwargs["keep_batch"] = True
        loss = model.compute_loss(params, pred, gt, **kwargs).mean()
        if sharded and mesh is not None:
            mesh.all_reduce_mean_([loss])
        return loss, to_vis

    return graph.wrap(eval_step, "eval step",
                      graph.eager_reason(model.device, model=model,
                                         mesh=mesh), by_address=(0,))
