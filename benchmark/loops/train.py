"""One trainer, closed loop: trainvali's warm loop. Batches are
assembled on a loader thread (each epoch a permutation of the pool from
the seed), placed through ``DeviceExampleCache.shard_batch``, statics
from ``GTFeatureCache`` (extracted on first sight), the donated captured
step, the losses fetched at each epoch's end. Set-up runs the first
epoch, which fills both caches, as trainvali's does; its first
``compare_steps`` steps are the ones the reference follows.
"""

import queue
import threading
import time

import numpy as np
import torch

from ..harness import correct, runs, scene as scene_mod, weights
from ..reference import optim as ref_optim
from ..reference import steps as ref_steps


def epoch_order(seed, epoch, n):
    """The permutation of a pool of n examples that epoch `epoch` walks."""
    return np.random.default_rng(scene_mod.subseed(seed, "epoch", epoch)
                                 ).permutation(n)


class Loader:
    """trainvali's loader, on one thread: each epoch a permutation of the
    pool from the seed, batches of bs examples assembled (copied) ahead of
    the step, `depth` deep."""

    def __init__(self, scene, ids, names, bs, seed, depth):
        self.scene, self.ids, self.names, self.bs = scene, ids, names, bs
        self.seed = seed
        self.q = queue.Queue(maxsize=depth)
        self.stopped = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="bench-loader")
        self.thread.start()

    def _run(self):
        epoch = 0
        while not self.stopped.is_set():
            order = epoch_order(self.seed, epoch, len(self.ids))
            for i in range(0, len(order) - self.bs + 1, self.bs):
                pick = [self.ids[j] for j in order[i:i + self.bs]]
                item = (epoch, [self.names[e] for e in pick],
                        scene_mod.stack([self.scene.example(e)
                                         for e in pick]))
                while not self.stopped.is_set():
                    try:
                        self.q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self.stopped.is_set():
                    return
            epoch += 1

    def next(self):
        return self.q.get()

    def close(self):
        self.stopped.set()
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        self.thread.join(timeout=30)
        if self.thread.is_alive():
            raise RuntimeError("the loader thread did not stop")


def _named(tree_net):
    """{reference name: tensor} of a params-like tree's U-Net."""
    return dict(weights._program_unet_leaves(tree_net))


def run(run):
    from nlt_tpu_torch.models.nlt import Model
    from nlt_tpu_torch.parallel import device_cache, feat_cache
    from nlt_tpu_torch.parallel import train as train_mod

    cfg, mix, dev = run.cfg, run.mix, run.device
    bs, res = cfg["bs"], cfg["uvh"]
    model = Model(runs.program_config(cfg), device=dev)
    tx = train_mod.make_optimizer(cfg["lr"], cfg["mgm"])
    state = train_mod.init_state(model, tx, torch.Generator().manual_seed(0))
    weights.into_program(state["params"], weights.unet(cfg, run.seed, dev),
                         weights.lpips(run.seed, dev))
    run.mark("model")
    scene = scene_mod.Scene(run.seed, "train", res, mix["cams"],
                            mix["lights"], True, mix["coverage"], dev)
    run.mark("scene")
    held = {tuple(p) for p in mix["holdout"]}
    ids = [e for e in range(scene.n) if scene.cam_light(e) not in held]
    names = {e: "C%03d_L%03d" % scene.cam_light(e) for e in ids}
    step = train_mod.make_train_step(model, tx, cached_statics=True,
                                     donate=True)
    extract = train_mod.make_static_extractor(model)
    fcache = feat_cache.GTFeatureCache(list(names.values()),
                                       cap_mb=cfg["cache_static_mb"])
    dcache = device_cache.DeviceExampleCache(cap_mb=cfg["cache_device_mb"],
                                             device=dev)
    loader = Loader(scene, ids, names, bs, run.seed, mix["loader_depth"])
    run.info.update(bs=bs, live_per_example=scene.live, unit="step",
                    frames_per_unit=bs)
    spans = run.spans

    def one_step(item):
        nonlocal state
        _, batch_ids, arrays = item
        with spans.span("place"):
            placed = dcache.shard_batch(arrays, batch_ids)
            if fcache.has_all(batch_ids):
                statics = fcache.gather(batch_ids)
            else:
                statics = extract(state["params"], placed)
                if fcache.insert(batch_ids, statics):
                    statics = fcache.gather(batch_ids)
        with spans.span("step"):
            state, loss, _ = step(state, placed, statics)
        return loss

    def finite(losses):
        with spans.span("sync"):
            vals = torch.stack(losses).cpu() if losses else torch.zeros(0)
        return int((~torch.isfinite(vals)).sum())

    try:
        # Set-up: the first epoch, as trainvali's fills the caches; its
        # first compare_steps steps are the ones the reference follows.
        # The gradients the optimizer got come from AMSGrad's first moment
        # (mu_t = b1 mu_{t-1} + (1 - b1) g_t): the first step's, which is
        # the captured step's eager warm-up, and the last compared step's,
        # a replay of the graph the window replays.
        n_cmp = mix["compare_steps"]
        if n_cmp < 2:
            raise ValueError("compare_steps is %d; the comparison needs "
                             "a replayed step, so 2 or more" % n_cmp)
        per_epoch = len(ids) // bs
        batches, losses, grads, after, prev = [], [], {}, None, None
        b1 = ref_optim.B1
        for i in range(per_epoch):
            item = loader.next()
            loss = one_step(item)
            losses.append(loss)
            if i < n_cmp:
                batches.append(item[2])
            mu = _named(state["opt_state"]["mu"]["net"])
            if i == 0:
                grads[1] = {k: v / (1 - b1) for k, v in mu.items()}
            if i == n_cmp - 1:
                grads[n_cmp] = {k: (v - b1 * prev[k]) / (1 - b1)
                                for k, v in mu.items()}
                after = {k: v.clone() for k, v in
                         _named(state["params"]["net"]).items()}
            if i == n_cmp - 2:
                prev = {k: v.clone() for k, v in mu.items()}
        first_losses = [float(x) for x in losses[:n_cmp]]
        run.failed = finite(losses)
        run.mark("first_epoch")
        spans.items.clear()

        t0 = run.open_window()
        epoch, losses = 1, []
        while True:
            now = time.perf_counter()
            if now - t0 >= run.seconds:
                break
            run.maybe_trace(t0, now, run.units)
            with spans.span("load"):
                item = loader.next()
            if item[0] != epoch:
                run.failed += finite(losses)
                epoch, losses = item[0], []
            losses.append(one_step(item))
            run.units += 1
        run.failed += finite(losses)
        run.sync()
        run.window_s = time.perf_counter() - t0
        run.close_window()
    finally:
        loader.close()
    run.attempted = per_epoch + run.units    # set-up's steps and the window's
    run.e2e["train_texels_per_s"] = (run.units * bs * res * cfg["uvw"]
                                     / run.window_s)
    run.counters["feat_cache_mb"] = fcache.nbytes() / float(1 << 20)
    run.counters["device_cache"] = dcache.stats()
    del state, step, extract, fcache, dcache, model, tx, loader, scene
    runs.free()

    w0 = weights.unet(cfg, run.seed, dev)
    ref = ref_steps.train(cfg, w0, weights.lpips(run.seed, dev), batches)
    run.numbers = correct.train_numbers((first_losses, grads, after), ref,
                                        w0)
    run.info["leaves"] = correct.leaf_report(
        (first_losses, grads, after), ref, w0)
    run.outputs = {"batches": batches, "program": (first_losses, grads,
                                                   after)}
