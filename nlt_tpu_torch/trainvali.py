"""Training and validation entry point (port of nlt_tpu/trainvali.py,
one device):

    python -m nlt_tpu_torch.trainvali --config=<ini> [--debug]
        [--set KEY=VALUE ...] [--device cuda|cpu] [--profile]

Kept from nlt_tpu: the .ini config with ``--set`` overrides and the
snapshot of the effective config next to the xname-derived outdir, the
resume drift warning, train/vali datasets with the holdout split, the
gradient-accumulation fence, the fixed validation batches, ``init_from``
warm start, ``nan_guard``, ``ema_decay``, the static-feature cache
(``cache_static``/``lpips_cache_gt``), the device example cache
(``cache_device``), ``prefetch_batches``, JSONL scalars, train/vali vis
with retention queues, keep-best checkpoint retention, and the SIGTERM
checkpoint-and-exit. Every training option of the step runs here too:
with norm = batch the checkpoints carry the merged moving statistics,
and validation and vis run on them; E-LPIPS's ground truth is never
cached (cache_static keeps its warp products only).

The port's ways:
- the device's work is queued without waiting: each batch's loss stays a
  0-d device tensor, and the epoch's losses are fetched in one copy at
  its end; vis is packed on the device and copied into pinned host
  buffers without blocking, then read after its CUDA event;
- placement is an upload from pinned memory with ``non_blocking=True``,
  or, from an example's second sight on, the device cache's assembly;
- ``<outdir>/epoch_times.jsonl`` records per epoch where the host's time
  went (loader wait, placement, step dispatch, the end-of-epoch sync,
  checkpoint, vis, validation);
- ``--profile`` writes a ``torch.profiler`` trace of the training steps
  of the second epoch (the first one fed from the caches; the first
  epoch when there is only one) to ``<outdir>/profile/``, with a
  ``summary.json`` of its device and wall time.

A bare ``--config`` name is read from nlt_tpu's config directory, by
path: the .ini files are shared data. Several devices (the mesh, the
multi-host flags, ``--n_tile > 1``) wait for ROADMAP.md queue 1, item 5.
"""

import argparse
import json
import os
import signal
import time
from collections import deque
from glob import glob
from os.path import dirname, exists, join
from shutil import copyfile, rmtree

import numpy as np
import torch

from . import datasets as datasets_mod
from . import models as models_mod
from . import resolve_device
from .models.base import Model as BaseModel
from .parallel import device_cache as device_cache_mod
from .parallel import train as train_mod
from .utils import checkpoint as ckpt_mod
from .utils import config as config_mod
from .utils import img as imgutil
from .utils import io as ioutil
from .utils import logging as logutil
from .utils.tree import tree_map

logger = logutil.Logger(loggee="trainvali")

CONFIG_DIR = join(dirname(dirname(os.path.abspath(__file__))), "nlt_tpu",
                  "config")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", type=str, default="config.ini",
                   help="a .ini file in nlt_tpu/config/ or a full path")
    p.add_argument("--debug", action="store_true",
                   help="truncate every epoch after one batch")
    p.add_argument("--set", action="append", default=[],
                   dest="overrides", metavar="KEY=VALUE",
                   help="override a config key (repeatable), e.g. "
                        "--set epochs=250 --set n_obs=3. Overrides "
                        "apply before xname expansion, and the "
                        "EFFECTIVE config is snapshotted next to the "
                        "outdir, so nlt_test/serve see them.")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"],
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--n_tile", type=int, default=1,
                   help="devices along the texel-tile axis (only 1 is "
                        "ported)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the second "
                        "epoch's training steps to <outdir>/profile")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p.parse_args(argv)


def resolve_config_path(config_flag):
    if exists(config_flag):
        return config_flag
    return join(CONFIG_DIR, config_flag)


def strip_host_fields(batch):
    """Split a batch into (arrays, host metadata)."""
    arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
    meta = {k: v for k, v in batch.items() if isinstance(v, list)}
    return arrays, meta


class ScalarWriter:
    """JSONL scalar logs."""

    def __init__(self, outdir):
        os.makedirs(outdir, exist_ok=True)
        self.path = join(outdir, "scalars.jsonl")

    def scalar(self, tag, value, step):
        with open(self.path, "a") as h:
            h.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "wall_time": time.time()}) + "\n")

    def text(self, tag, value, step):
        self.scalar("text/" + tag, 0.0, step)
        with open(self.path, "a") as h:
            h.write(json.dumps(
                {"tag": tag, "text": str(value), "step": int(step)}) + "\n")


def maintain_epoch_queue(queue_, new_epoch_dir):
    """Keep only the most recent epoch vis dirs."""
    queue_.appendleft(new_epoch_dir)
    for epoch_dir in glob(join(dirname(new_epoch_dir), "*")):
        if epoch_dir not in queue_:
            rmtree(epoch_dir, ignore_errors=True)


# nlt_tpu's threshold, measured on a TPU with XLA's flat row gather (a
# bs-8 512^2 step slowed ~3x past it); it was not measured on this card.
# Kept so the port splits batches exactly where nlt_tpu does and the two
# compare; the flagship shape, 4 x 512^2 = 1,048,576 rows, is under it.
GATHER_CLIFF_ROWS = 1_500_000


def fence_grad_accum(config, n_devices=1, n_tile=1):
    """nlt_tpu's fence: if the per-device microbatch would cross
    GATHER_CLIFF_ROWS resample rows and grad_accum is not set, raise it
    to the smallest divisor of bs that fences it (the accumulated
    gradient is the same); if grad_accum is set, warn and keep it.
    Returns the grad_accum to use."""
    grad_accum = config.get_int("grad_accum", 1)
    n_data_devices = max(1, n_devices // max(n_tile, 1))
    bs_total = config.get_int("bs")

    def micro_rows(n_micro):
        per_dev_bs = max(1, (bs_total // n_micro) // n_data_devices)
        return per_dev_bs * config.get_int("uvh") * config.get_int("uvw")

    if micro_rows(grad_accum) > GATHER_CLIFF_ROWS:
        if config.has("grad_accum"):
            logger.warn(
                "Per-device microbatch (%d resample rows) exceeds nlt_tpu's "
                "%d-row gather fence; keeping the configured grad_accum.",
                micro_rows(grad_accum), GATHER_CLIFF_ROWS)
        else:
            auto = next(
                (d for d in range(grad_accum + 1, bs_total + 1)
                 if bs_total % d == 0
                 and micro_rows(d) <= GATHER_CLIFF_ROWS), None)
            if auto is not None:
                logger.warn(
                    "Auto-set grad_accum=%d: per-device bs %d at %dx%d UV "
                    "crosses nlt_tpu's %d-row gather fence (set grad_accum "
                    "explicitly to override).", auto,
                    bs_total // n_data_devices, config.get_int("uvh"),
                    config.get_int("uvw"), GATHER_CLIFF_ROWS)
                grad_accum = auto
            else:
                logger.warn(
                    "No divisor of bs=%d keeps the per-device microbatch "
                    "under nlt_tpu's %d-row gather fence.", bs_total,
                    GATHER_CLIFF_ROWS)
    return grad_accum


def _check_single_device(args):
    if (args.n_tile != 1 or args.coordinator_address
            or (args.num_processes or 1) > 1 or args.process_id):
        raise NotImplementedError(
            "several devices (mesh, --n_tile > 1, multi-host flags) are not "
            "ported yet (ROADMAP.md, queue 1, item 5)")


class VisStager:
    """Vis of a batch leaves the device without stopping it: packed on
    the device (uint8, or float16 for linear space), copied into pinned
    host buffers with non_blocking copies and a CUDA event, and read on
    the host after the event (materialize). The static fields (base, nn
    and gt in camera space never change for an example) are kept in a
    bounded host LRU, so later epochs copy only the prediction."""

    STATIC = ("base_camspc", "nn_camspc", "gt_camspc")
    CAP = 256

    def __init__(self, linear_space, dump_raw):
        self.linear_space = linear_space
        self.dump_raw = dump_raw
        self.host_cache = {}  # id -> statics; dict keeps insert order

    def stage(self, to_vis, meta):
        if not self.dump_raw:
            to_vis = {k: v for k, v in to_vis.items()
                      if k not in ("pred", "gt")}
        packed = imgutil.pack_vis(to_vis, linear_space=self.linear_space)
        ids = meta.get("id")
        statics_present = [k for k in self.STATIC if k in packed]
        hit = bool(ids) and all(i in self.host_cache for i in ids)
        if hit:
            fetch = {k: v for k, v in packed.items() if k not in self.STATIC}
            cached = {k: np.stack([self.host_cache[i][k] for i in ids])
                      for k in statics_present}
            for i in ids:  # refresh recency
                self.host_cache[i] = self.host_cache.pop(i)
        else:
            fetch, cached = dict(packed), None
        event = None
        host = {}
        for k, v in fetch.items():
            if v.device.type == "cuda":
                buf = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                buf.copy_(v, non_blocking=True)
                host[k] = buf
            else:
                host[k] = v.clone()
        if any(v.device.type == "cuda" for v in fetch.values()):
            event = torch.cuda.Event()
            event.record()
        return {"host": host, "event": event, "cached": cached, "ids": ids,
                "statics_present": statics_present, "meta": meta}

    def materialize(self, staged):
        if staged["event"] is not None:
            staged["event"].synchronize()
        out = {k: v.numpy() for k, v in staged["host"].items()}
        ids = staged["ids"]
        if staged["cached"] is not None:
            out.update(staged["cached"])
        elif ids:
            for j, i in enumerate(ids):
                self.host_cache.pop(i, None)  # re-insert as newest
                self.host_cache[i] = {
                    k: out[k][j].copy() for k in staged["statics_present"]}
            while len(self.host_cache) > self.CAP:
                self.host_cache.pop(next(iter(self.host_cache)))
        out.update(staged["meta"])
        return out


class _Profile:
    """torch.profiler over one epoch's training steps."""

    def __init__(self, outdir, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.outdir = join(outdir, "profile")
        self.prof = profile(activities=acts)
        self.device = device
        self.steps = 0

    def __enter__(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        os.makedirs(self.outdir, exist_ok=True)
        self.prof.export_chrome_trace(join(self.outdir, "trace.json"))
        device_us = 0.0
        for ev in self.prof.key_averages():
            if not str(getattr(ev, "device_type", "")).endswith("CUDA") \
                    or ev.key.startswith("nlt::"):
                continue
            device_us += getattr(ev, "self_device_time_total", 0.0)
        with open(join(self.outdir, "summary.json"), "w") as h:
            json.dump({"steps": self.steps, "wall_s": wall,
                       "device_s": device_us / 1e6}, h)
        logger.info("Profiler trace written to %s", self.outdir)
        return False


def main(argv=None):
    args = parse_args(argv)
    _check_single_device(args)
    device = resolve_device(args.device)
    if args.debug:
        logger.warn("Debug mode: On")
    config_ini = resolve_config_path(args.config)

    # Preemption-safe shutdown: on the first SIGTERM the run finishes
    # the in-flight batch, checkpoints and exits (resume replays the
    # interrupted epoch from the saved params); a second SIGTERM falls
    # through to the default handler.
    preempt = {"flag": False}

    def _on_sigterm(signum, frame):
        logger.warn("SIGTERM: will checkpoint after the in-flight batch and "
                    "exit (send again to kill)")
        preempt["flag"] = True
        signal.signal(signal.SIGTERM, signal.SIG_DFL)

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        pass  # non-main thread (embedded use): no handler

    config = config_mod.read_config(config_ini)
    base_dict = dict(config.to_dict())
    for kv in args.overrides:
        assert "=" in kv, "--set expects KEY=VALUE, got %r" % kv
        k, v = kv.split("=", 1)
        config.set(k.strip(), v.strip())

    xname = config.xname()
    outdir = join(config.get("outroot"), xname)
    overwrite = config.get_bool("overwrite")
    snapshot_f = outdir.rstrip("/") + ".ini"
    if not overwrite and os.path.isfile(snapshot_f):
        # Resuming: this command's config wins, but drift from the
        # config the checkpoint was trained under is surfaced loudly.
        snap = config_mod.read_config(snapshot_f)
        if snap.to_dict() != config.to_dict():
            changed = sorted(
                k for k in set(snap.to_dict()) | set(config.to_dict())
                if snap.to_dict().get(k) != config.to_dict().get(k))
            logger.warn(
                "Resuming with a DIFFERENT config than this run was "
                "started with (keys: %s; recorded snapshot: %s). "
                "Continuing with the new values and updating the "
                "snapshot — if unintended (e.g. a --set flag omitted "
                "on resume), re-run with the recorded values.",
                ", ".join(changed), snapshot_f)
    ioutil.prepare_outdir(outdir, overwrite=overwrite)
    if config.to_dict() == base_dict:
        copyfile(config_ini, snapshot_f)  # keeps the file's comments
    else:
        config.save(snapshot_f)  # the EFFECTIVE config
    logger.info("For results, see:\n\t%s", outdir)

    grad_accum = fence_grad_accum(config)
    if grad_accum > 1:
        assert config.get_int("bs") % grad_accum == 0, \
            "bs must be divisible by grad_accum"
        logger.info("Gradient accumulation: %d microbatches of %d",
                    grad_accum, config.get_int("bs") // grad_accum)

    # Datasets
    Dataset = datasets_mod.get_dataset_class(config.get("dataset"))
    dataset_train = Dataset(config, "train")
    no_batch = config.get_bool("no_batch", False)
    try:
        dataset_vali = Dataset(config, "vali")
    except (FileNotFoundError, AssertionError) as e:
        logger.warn("No validation data: %s", e)
        dataset_vali = None

    vali_batches = None
    if dataset_vali is not None:
        n_vali_batches = config.get_int("vali_batches", -1)
        vali_batches = []
        for i, b in enumerate(
                dataset_vali.iterate(seed=0, drop_remainder=False)):
            if 0 <= n_vali_batches <= i:
                break
            vali_batches.append(b)

    # Model + optimizer + state
    model = models_mod.get_model_class(config.get("model"))(
        config, device=device)
    tx = train_mod.make_optimizer(config.get_float("lr"),
                                  config.get_float("mgm", -1))
    ema_decay = config.get_float("ema_decay", 0.0)
    state = train_mod.init_state(model, tx, torch.Generator().manual_seed(0),
                                 ema_decay=ema_decay)

    ckptdir = join(outdir, "checkpoints")
    keep_recent = config.get_int("keep_recent_epochs", -1)
    keep_best = config.get_bool("keep_best", True)
    manager = ckpt_mod.CheckpointManager(
        ckptdir, max_to_keep=keep_recent,
        keep_best_metric="psnr_vali" if keep_best else None)
    state, epoch_restored = manager.restore(state)

    # Warm start: `init_from = <other outdir>/checkpoints` seeds the
    # params (and the EMA) from another run's checkpoint when this run
    # has none of its own; optimizer state and epoch start fresh.
    init_from = config.get("init_from", "")
    if init_from and manager.latest_step() is None:
        if not os.path.isdir(init_from):
            raise FileNotFoundError(
                "init_from checkpoint dir not found: %s" % init_from)
        src = ckpt_mod.CheckpointManager(init_from)
        tree = src.load()
        assert tree is not None, "init_from has no checkpoint: %s" % init_from
        seeded = {"params": ckpt_mod.fit_to(state["params"], tree["params"],
                                            init_from)}
        if "ema_params" in state:
            # A source without an EMA (a params-only checkpoint) starts
            # the EMA at the seeded params.
            seeded["ema_params"] = (
                ckpt_mod.fit_to(state["ema_params"], tree["ema_params"],
                                init_from) if "ema_params" in tree
                else tree_map(torch.clone, seeded["params"]))
        state = dict(state, **seeded)
        logger.info("Warm-started params from %s (step %d)", init_from,
                    src.latest_step())

    nan_guard = config.get_bool("nan_guard", False)
    train_step = train_mod.make_train_step(
        model, tx, grad_accum=grad_accum, nan_guard=nan_guard,
        ema_decay=ema_decay)
    eval_step = train_mod.make_eval_step(model)

    # Static per-example cache (gt loss features, warp products and the
    # resample plan): identical loss and gradients, computed once.
    feat_cache = None
    overrides_statics = (
        type(model).static_products is not BaseModel.static_products)
    if (config.get_bool("cache_static",
                        config.get_bool("lpips_cache_gt", False))
            and hasattr(model, "feat_loss_indices")
            and (model.feat_loss_indices() or overrides_statics)):
        if no_batch:
            logger.warn("cache_static disabled (no_batch run)")
        else:
            from .parallel import feat_cache as feat_cache_mod
            feat_cache = feat_cache_mod.GTFeatureCache(
                dataset_train.files,
                cap_mb=config.get_int("cache_static_mb", 6144))
            train_step_cached = train_mod.make_train_step(
                model, tx, cached_statics=True, grad_accum=grad_accum,
                nan_guard=nan_guard, ema_decay=ema_decay)
            extract_statics = train_mod.make_static_extractor(model)

    device_cache = None
    if config.get_bool("cache_device", True) and not no_batch:
        device_cache = device_cache_mod.DeviceExampleCache(
            cap_mb=config.get_int("cache_device_mb", 2048), device=device)

    writer_train = ScalarWriter(join(outdir, "summary_train"))
    writer_vali = ScalarWriter(join(outdir, "summary_vali"))
    train_vis_epoch_dir = join(outdir, "vis_train", "epoch{e:09d}")
    vali_vis_epoch_dir = join(outdir, "vis_vali", "epoch{e:09d}")
    keep = keep_recent if keep_recent > 0 else None
    train_deque = deque([], keep)
    vali_deque = deque([], keep)
    # On resume, seed the retention queues from the vis dirs on disk.
    for q, template in ((train_deque, train_vis_epoch_dir),
                        (vali_deque, vali_vis_epoch_dir)):
        for d in sorted(glob(join(dirname(template), "epoch*"))):
            q.appendleft(d)

    epochs = config.get_int("epochs")
    vis_train_batches = config.get_int("vis_train_batches", 4)
    ckpt_period = config.get_int("ckpt_period", 1)
    vali_period = config.get_int("vali_period", 1)
    dump_raw = config.get_bool("vis_dump_raw", False)
    stager = VisStager(config.get_bool("linear_space"), dump_raw)
    times_f = join(outdir, "epoch_times.jsonl")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # Upload/step overlap (prefetch_batches > 0): batch i+1 is placed on
    # a worker thread, on its own CUDA stream, while batch i's step is
    # queued; the step's stream waits on the placement's event. One
    # worker and a bounded queue keep the order, so losses are the same.
    prefetch_depth = config.get_int("prefetch_batches", 0)
    place_stream = (torch.cuda.Stream(device) if prefetch_depth > 0
                    and device.type == "cuda" else None)

    def place(batch):
        arrays, meta = strip_host_fields(batch)
        t0 = time.perf_counter()
        if device_cache is not None:
            arrays = device_cache.shard_batch(arrays, batch["id"])
        else:
            arrays = device_cache_mod.upload(arrays, device)
        return arrays, meta, batch["id"], time.perf_counter() - t0

    def place_on_stream(batch):
        with torch.cuda.stream(place_stream):
            out = place(batch)
            event = torch.cuda.Event()
            event.record(place_stream)
        return out, event

    place_pool = None
    if prefetch_depth > 0:
        from concurrent.futures import ThreadPoolExecutor
        place_pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="nlt_place")

    def shutdown_place_pool():
        if place_pool is not None:
            place_pool.shutdown(wait=False, cancel_futures=True)

    def placed_batches(batch_iter, clock):
        """Yield place(batch) results; clock['loader'] accumulates the
        time spent waiting on the loader."""
        def timed(it):
            while True:
                t0 = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                finally:
                    clock["loader"] += time.perf_counter() - t0
                yield b

        batch_iter = timed(iter(batch_iter))
        if place_pool is None:
            for b in batch_iter:
                yield place(b)
            return

        def finish(fut):
            out = fut.result()
            if place_stream is None:
                return out
            (arrays, meta, ids, dt), event = out
            cur = torch.cuda.current_stream(device)
            cur.wait_event(event)
            for t in arrays.values():
                t.record_stream(cur)
            return arrays, meta, ids, dt

        submit = place_on_stream if place_stream is not None else place
        futs = deque()
        for b in batch_iter:
            futs.append(place_pool.submit(submit, b))
            if len(futs) > prefetch_depth:
                yield finish(futs.popleft())
        while futs:
            yield finish(futs.popleft())

    def preempt_exit(step, where, already=False):
        if already:
            saved = "(already checkpointed at step %d)" % step
        else:
            saved = manager.save(step, state, force=True)
        shutdown_place_pool()
        logger.warn("Preempted %s; checkpointed to\n\t%s", where, saved)
        return outdir

    profile_epoch = (epoch_restored + 1 if epochs - epoch_restored > 1
                     else epoch_restored) if args.profile else None

    for epoch_i in range(epoch_restored, epochs):
        clock = {"loader": 0.0, "place": 0.0, "step": 0.0}
        batch_loss, batch_vis, n_batches = [], [], 0
        epoch_t0 = time.perf_counter()
        prof = (_Profile(outdir, device) if epoch_i == profile_epoch
                else None)
        if prof is not None:
            prof.__enter__()
        for batch_i, (arrays, meta, batch_ids, place_s) in enumerate(
                placed_batches(dataset_train.iterate(
                    seed=epoch_i, no_batch=no_batch), clock)):
            clock["place"] += place_s
            t0 = time.perf_counter()
            if feat_cache is not None:
                # Extract-then-step, even on first sight of an example:
                # the cached step skips exactly the work the extractor
                # just did.
                if feat_cache.has_all(batch_ids):
                    statics = feat_cache.gather(batch_ids)
                else:
                    statics = extract_statics(state["params"], arrays)
                    if feat_cache.insert(batch_ids, statics):
                        statics = feat_cache.gather(batch_ids)
                state, loss, to_vis = train_step_cached(state, arrays,
                                                        statics)
            else:
                state, loss, to_vis = train_step(state, arrays)
            clock["step"] += time.perf_counter() - t0
            n_batches += 1
            if prof is not None:
                prof.steps += 1
            # No sync here: the loss stays on the device until the
            # epoch's end.
            batch_loss.append(loss)
            if (batch_i < vis_train_batches
                    and (epoch_i + 1) % ckpt_period == 0):
                batch_vis.append(stager.stage(to_vis, meta))
            if preempt["flag"]:
                return preempt_exit(
                    epoch_i, "at epoch %d batch %d" % (epoch_i + 1, batch_i))
            if args.debug:
                logger.warn("Debug mode: Skipping the rest of this epoch")
                break
        if prof is not None:
            prof.__exit__(None, None, None)
        assert n_batches, "Dataset is empty"
        # One copy for the epoch's losses (the sync point of the epoch).
        t0 = time.perf_counter()
        batch_loss = [float(x) for x in torch.stack(batch_loss).cpu()]
        clock["sync"] = time.perf_counter() - t0
        train_s = time.perf_counter() - epoch_t0
        n_bad = sum(1 for x in batch_loss if not np.isfinite(x))
        if n_bad:
            logger.warn(
                "%d/%d batches had non-finite loss%s", n_bad,
                len(batch_loss),
                " (updates skipped: nan_guard)" if nan_guard
                else " (set nan_guard=True to skip such updates)")
        batch_time = train_s / n_batches
        step = epoch_i + 1

        # ---- checkpoint + train summaries/vis ----
        t0 = time.perf_counter()
        if step % ckpt_period == 0:
            saved = manager.save(step, state, force=True)
            logger.info("Checkpointed epoch %d:\n\t%s", step, saved)
        clock["ckpt"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if step % ckpt_period == 0:
            writer_train.scalar("loss_train", float(np.mean(batch_loss)),
                                step)
            writer_train.scalar("batch_time_train", batch_time, step)
            texels = (config.get_int("bs") * config.get_int("uvh")
                      * config.get_int("uvw"))
            writer_train.scalar("texels_per_sec", texels / batch_time, step)
            vis_dirs = []
            for batch_i, staged in enumerate(batch_vis):
                to_vis = stager.materialize(staged)
                vis_dir = join(train_vis_epoch_dir.format(e=step),
                               "batch%09d" % batch_i)
                raw_f = (join(train_vis_epoch_dir.format(e=step),
                              "batch%09d_raw.pickle" % batch_i)
                         if dump_raw else None)
                model.vis_batch(to_vis, vis_dir, mode="train",
                                dump_raw_to=raw_f)
                vis_dirs.append(vis_dir)
            if vis_dirs:
                comp_f = join(train_vis_epoch_dir.format(e=step), "all")
                view_at = model.compile_batch_vis(vis_dirs, comp_f,
                                                  mode="train")
                if view_at is not None:
                    writer_train.text("vis_train", view_at, step)
                maintain_epoch_queue(train_deque,
                                     train_vis_epoch_dir.format(e=step))
        clock["train_vis"] = time.perf_counter() - t0

        # ---- validation ----
        t0 = time.perf_counter()
        if vali_batches and vali_period > 0 and step % vali_period == 0:
            v_loss, v_vis, v_psnr = [], [], []
            for batch in vali_batches:
                if preempt["flag"]:
                    return preempt_exit(
                        step, "during validation at epoch %d" % step,
                        already=manager.latest_step() == step)
                arrays, meta = strip_host_fields(batch)
                if device_cache is not None:
                    arrays = device_cache.shard_batch(arrays, batch["id"])
                else:
                    arrays = device_cache_mod.upload(arrays, device)
                loss, to_vis = eval_step(state, arrays)
                v_loss.append(loss)
                v_vis.append(stager.stage(to_vis, meta))
            v_loss = [float(x) for x in torch.stack(v_loss).cpu()]
            v_vis = [stager.materialize(s) for s in v_vis]
            for to_vis in v_vis:
                if "gt_camspc" in to_vis:
                    gt01 = imgutil.vis_to_float01(to_vis["gt_camspc"])
                    pd01 = imgutil.vis_to_float01(to_vis["pred_camspc"])
                    ids = to_vis.get("id") or [None] * pd01.shape[0]
                    for i in range(pd01.shape[0]):
                        v_psnr.append((ids[i], model.psnr(gt01[i], pd01[i])))
            writer_vali.scalar("loss_vali", float(np.mean(v_loss)), step)
            finite = [(i, p) for i, p in v_psnr if np.isfinite(p)]
            if finite:
                vals = [p for _, p in finite]
                writer_vali.scalar("psnr_vali", float(np.mean(vals)), step)
                if len(vals) > 1:
                    writer_vali.scalar("psnr_vali_std",
                                       float(np.std(vals, ddof=1)), step)
                    writer_vali.scalar("psnr_vali_n", len(vals), step)
                if any(i for i, _ in finite):
                    writer_vali.text("psnr_vali_by_id", json.dumps(
                        {str(i): round(float(p), 4) for i, p in finite}),
                        step)
                    # Multi-scene runs: per-scene means (ids are
                    # namespaced '<scene>/<id>').
                    by_scene = {}
                    for i, p in finite:
                        if i and "/" in str(i):
                            by_scene.setdefault(
                                str(i).rsplit("/", 1)[0], []).append(p)
                    if len(by_scene) > 1:
                        for scene, ps in sorted(by_scene.items()):
                            writer_vali.scalar("psnr_vali/%s" % scene,
                                               float(np.mean(ps)), step)
            vis_dirs = []
            for batch_i, to_vis in enumerate(v_vis):
                vis_dir = join(vali_vis_epoch_dir.format(e=step),
                               "batch%09d" % batch_i)
                model.vis_batch(to_vis, vis_dir, mode="vali")
                vis_dirs.append(vis_dir)
            comp_f = join(vali_vis_epoch_dir.format(e=step), "all")
            view_at = model.compile_batch_vis(vis_dirs, comp_f, mode="vali")
            if view_at is not None:
                writer_vali.text("vis_vali", view_at, step)
            maintain_epoch_queue(vali_deque,
                                 vali_vis_epoch_dir.format(e=step))
        clock["vali"] = time.perf_counter() - t0

        # Keep-best retention, once this epoch's vali scalars are on disk.
        if step % ckpt_period == 0:
            manager.prune()

        if device_cache is not None and step == epoch_restored + 1:
            st = device_cache.stats()
            logger.info(
                "Device example cache after epoch 1: %d examples, %.0f MB "
                "(hits %d / misses %d)", st["examples"], st["mb"],
                st["hits"], st["misses"])
        with open(times_f, "a") as h:
            h.write(json.dumps(dict(
                {"epoch": step, "batches": n_batches, "train_s": train_s,
                 "epoch_s": time.perf_counter() - epoch_t0,
                 "feat_cache_mb": (feat_cache.nbytes() / float(1 << 20)
                                   if feat_cache is not None else 0.0),
                 "device_cache_mb": (device_cache.stats()["mb"]
                                     if device_cache is not None else 0.0)},
                **{k + "_s": v for k, v in clock.items()})) + "\n")
        logger.info("Epoch %d/%d  loss %.6f  (%.3f s/batch)", step, epochs,
                    float(np.mean(batch_loss)), batch_time)

        # Epoch boundary: a SIGTERM in the epoch tail exits here.
        if epoch_i + 1 < epochs and preempt["flag"]:
            return preempt_exit(step, "at the end of epoch %d" % step,
                                already=manager.latest_step() == step)

    shutdown_place_pool()
    sync()
    logger.info("Training done: %d epochs", epochs)
    return outdir


if __name__ == "__main__":
    main()
