"""Serving: low-latency relighting/view-synthesis inference (port of
nlt_tpu/serve.py, one device).

- the observation feature pyramid is computed once from training
  observations (``precompute_obs``) and substituted for the obs path at
  every request, so the obs stages do not run per request;
- ``predict`` computes only the requested fields and can quantize them
  on the device (``pack``) before the one device-to-host copy;
- ``predict(batch, ids=...)`` serves repeat queries from the device
  input cache (``parallel/device_cache.py``): a request whose ids were
  all seen before uploads nothing; ``invalidate`` drops entries;
- ``benchmark`` reports per-request latency and pipelined frames/sec;
- ``export`` writes the serving program, weights and pyramid included,
  as a bundle of ``torch.export`` programs, one per batch size, that
  ``ExportedServer`` serves without the model code, config or
  checkpoint.

Usage:
    server = Server(ckpt_dir)                  # device="cuda" by default
    server.precompute_obs(train_dataset)       # obs feature pyramid
    out = server.predict(batch_arrays)         # {'pred_camspc': ...}

CLI (latency benchmark, streamed and cached requests; or an export):
    python -m nlt_tpu_torch.serve --ckpt=<outdir>/checkpoints [--bs=1]
        [--pack uint8] [--export bundle.nltx --export_bs 1,4]
        [--device cuda|cpu]

Exported bundles differ from nlt_tpu's in two ways: a bundle serves on
the device type it was exported on (nlt_tpu lowers for cpu and tpu at
once), and the serving host imports ``nlt_tpu_torch.ops.fused_stage``,
which registers the two stage ops the programs call (nlt_tpu's needs
plain jax). Sharded serving (``shard``, ``--shard``) is not ported
(ROADMAP.md, queue 1, item 5).
"""

import argparse
import io
import json
import time

import numpy as np
import torch

from . import datasets as datasets_mod
from . import resolve_device
from .nlt_test import extract_feat, get_config_ini, restore_model, \
    tile_pyramid
from .parallel import device_cache as device_cache_mod
from .utils import config as config_mod
from .utils import img as imgutil
from .utils import logging as logutil
from .utils.tree import tree_leaves, tree_unflatten

logger = logutil.Logger(loggee="serve")

FIELDS = ("pred_camspc", "pred")
EXPORT_FORMAT = "nlt_tpu_torch.serve.export.v1"


def _arrays(batch):
    """The request's array fields as numpy (host metadata lists off)."""
    return {k: np.asarray(v) for k, v in batch.items()
            if not isinstance(v, list)}


def _fetch(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


class Server:
    def __init__(self, ckpt_dir, step=None, config=None, pack=None,
                 shard=False, fields=None, device="cuda"):
        """pack: None returns float32 predictions; 'uint8' / 'float16'
        quantizes them on the device before the fetch.
        fields: which outputs to compute and return (subset of
        {'pred_camspc', 'pred'}; default both)."""
        if shard:
            raise NotImplementedError(
                "sharded serving is not ported yet (ROADMAP.md, queue 1, "
                "item 5)")
        if config is None:
            config = config_mod.read_config(get_config_ini(ckpt_dir))
        self.config = config
        self.model, self.state = restore_model(config, ckpt_dir, step=step,
                                               device=device)
        self.device = self.model.device
        if pack not in (None, "uint8", "float16"):
            raise ValueError("pack must be None, 'uint8' or 'float16': %r"
                             % (pack,))
        self.pack = pack
        if fields is not None:
            fields = tuple(f.strip() for f in fields)
            if not fields or not set(fields) <= set(FIELDS):
                raise ValueError("fields must be a subset of %s: %r"
                                 % (FIELDS, fields))
        self.fields = fields
        self._feat_agg = None
        self._override = {}  # bs -> obs pyramid tiled to the batch
        # Request inputs are a pure function of the example id (the
        # dataset contract), so repeat queries can skip the upload.
        self._input_cache = device_cache_mod.DeviceExampleCache(
            cap_mb=config.get_int("cache_device_mb", 2048),
            device=self.device)

    def precompute_obs(self, dataset=None, n_obs_batches=1):
        """Average the observation feature pyramid from training batches
        (`dataset`: anything with iterate(seed=, drop_remainder=); None:
        the config's training split). Without reachable training data
        the requests' own observations feed the obs path, as in
        nlt_tpu."""
        self._override = {}
        self._feat_agg = None
        if dataset is None:
            try:
                dataset = datasets_mod.get_dataset_class(
                    self.config.get("dataset"))(self.config, "train")
            except (FileNotFoundError, AssertionError) as e:
                logger.warn("No training data for obs features (%s); "
                            "serving with the requests' own observations",
                            e)
                return
        self._feat_agg = extract_feat(self.model, self.state, dataset,
                                      n_obs_batches=n_obs_batches)

    def _override_for(self, bs):
        if self._feat_agg is None:
            return None
        ov = self._override.get(bs)
        if ov is None:
            ov = self._override[bs] = tile_pyramid(self._feat_agg, bs)
        return ov

    def _place(self, batch, ids=None):
        """The request's arrays on the device: from the input cache when
        `ids` are given, else one pinned, non-blocking upload."""
        arrays = _arrays(batch)
        if ids is not None:
            return self._input_cache.shard_batch(arrays, list(ids))
        return device_cache_mod.upload(arrays, self.device)

    def _compute(self, params, override, arrays):
        """Device-side prediction of placed arrays: {field: tensor}."""
        fields = self.fields or FIELDS
        with torch.no_grad():
            _, _, _, to_vis = self.model.apply(
                params, arrays, "test", obs_override=override,
                outputs=fields)
            out = {k: to_vis[k] for k in fields}
            if self.pack is not None:
                out = imgutil.pack_vis(out,
                                       linear_space=self.pack == "float16")
        return out

    def _forward(self, arrays):
        return self._compute(self.state["params"],
                             self._override_for(arrays["base"].shape[0]),
                             arrays)

    def invalidate(self, ids=None):
        """Drop device-cached request inputs (all, or the given ids).
        Call when a client reuses an id with other content: a cached id
        is otherwise served as cached."""
        self._input_cache.invalidate(ids)

    def predict(self, batch, ids=None):
        """batch: dict of numpy arrays (the standard array fields).
        ids (one per row, e.g. batch['id']): serve repeat queries from
        the device input cache. Returns {field: numpy array}."""
        return _fetch(self._forward(self._place(batch, ids)))

    def benchmark(self, batch, n=20, ids=None):
        """latency_s: median per-request time, placement to fetched
        result; fps: n requests enqueued back to back, fetched at the
        end. Each timed request places its inputs again: a fresh upload
        (ids None) or an assembly from the device input cache."""
        bs = _arrays(batch)["base"].shape[0]
        self.predict(batch, ids)  # warm-up
        lats = []
        for _ in range(max(5, n // 4)):
            t0 = time.perf_counter()
            self.predict(batch, ids)
            lats.append(time.perf_counter() - t0)
        latency = float(np.median(lats))
        t0 = time.perf_counter()
        outs = [self._forward(self._place(batch, ids)) for _ in range(n)]
        for out in outs:
            _fetch(out)
        dt = (time.perf_counter() - t0) / n
        return {"latency_s": latency, "throughput_batches_per_s": 1 / dt,
                "fps": bs / dt}

    def export(self, path, batch, bs_list=None):
        """Write the serving program to a bundle: per batch size, one
        ``torch.export`` program of this server's forward with the net
        params and the tiled obs pyramid as buffers, traced under
        no_grad on this server's device (the two stage ops enter it as
        the registered ``nlt_tpu_torch::`` ops).

        batch: a sample request fixing the fields and their shapes.
        bs_list: batch sizes to bundle (default: the sample's); the
        sample is repeated or cut to each.

        Layout (nlt_tpu's): an 8-byte little-endian header length, a
        JSON header {"format", "pack", "programs": [{"bs", "device",
        "fields": {name: [shape, dtype]}, "size"}]}, then each program's
        ``torch.export.save`` bytes in order."""
        arrays = _arrays(batch)
        bs0 = next(iter(arrays.values())).shape[0]
        bs_list = sorted(set(bs_list)) if bs_list else [bs0]
        programs, blobs = [], []
        for bs in bs_list:
            if bs < 1:
                raise ValueError("batch sizes must be >= 1: %r" % (bs_list,))
            arrs = {k: np.concatenate([v] * -(-bs // v.shape[0]))[:bs]
                    for k, v in arrays.items()}
            placed = device_cache_mod.upload(arrs, self.device)
            with torch.no_grad():
                program = torch.export.export(
                    _ServingProgram(self, bs), (placed,), strict=False)
            buf = io.BytesIO()
            torch.export.save(program, buf)
            blobs.append(buf.getvalue())
            programs.append({
                "bs": bs, "device": self.device.type,
                "fields": {k: [list(v.shape), str(v.dtype)]
                           for k, v in arrs.items()},
                "size": len(blobs[-1])})
        header = json.dumps({"format": EXPORT_FORMAT, "pack": self.pack,
                             "programs": programs}).encode("utf-8")
        with open(path, "wb") as h:
            h.write(len(header).to_bytes(8, "little"))
            h.write(header)
            for blob in blobs:
                h.write(blob)
        logger.info("Exported serving bundle (bs=%s, device %s, %.1f MB) "
                    "to\n\t%s", ",".join(str(b) for b in bs_list),
                    self.device.type,
                    (8 + len(header) + sum(map(len, blobs))) / 1e6, path)
        return path


class _ServingProgram(torch.nn.Module):
    """Server._compute at one batch size, the net params and the tiled
    obs pyramid held as buffers (what export bakes into a program)."""

    def __init__(self, server, bs):
        super().__init__()
        self._server = server
        self._net = server.state["params"]["net"]
        self._n_params = len(tree_leaves(self._net))
        for i, t in enumerate(tree_leaves(self._net)):
            self.register_buffer("param%d" % i, t)
        override = server._override_for(bs) or []
        self._n_obs = len(override)
        for i, t in enumerate(override):
            self.register_buffer("obs%d" % i, t)

    def forward(self, arrays):
        net = tree_unflatten(self._net, [getattr(self, "param%d" % i)
                                         for i in range(self._n_params)])
        override = [getattr(self, "obs%d" % i) for i in range(self._n_obs)]
        return self._server._compute({"net": net}, override or None, arrays)


class ExportedServer:
    """Serve from a ``Server.export`` bundle: weights and obs pyramid are
    in the programs, so no model code, config or checkpoint is needed;
    this module registers the stage ops they call. ``predict``
    dispatches on the request's leading dimension and checks every
    field's shape and dtype. A bundle serves only on the device type it
    was exported on; a stage op that cannot build or launch raises."""

    def __init__(self, path, device="cuda"):
        from .ops import fused_stage  # noqa: F401  (registers the ops)

        self.device = resolve_device(device)
        with open(path, "rb") as h:
            hlen = int.from_bytes(h.read(8), "little")
            self.meta = json.loads(h.read(hlen).decode("utf-8"))
            blob = h.read()
        if self.meta.get("format") != EXPORT_FORMAT:
            raise ValueError("Not a %s bundle: %s" % (EXPORT_FORMAT, path))
        self.pack = self.meta["pack"]
        self._programs = {}  # bs -> (fields, callable module)
        off = 0
        for prog in self.meta["programs"]:
            if prog["device"] != self.device.type:
                raise ValueError(
                    "The program for bs=%d was exported for %s; this "
                    "server runs on %s" % (prog["bs"], prog["device"],
                                           self.device.type))
            program = torch.export.load(
                io.BytesIO(blob[off:off + prog["size"]]))
            off += prog["size"]
            self._programs[int(prog["bs"])] = (prog["fields"],
                                               program.module())

    @property
    def batch_sizes(self):
        return sorted(self._programs)

    def _place(self, batch):
        arrays = _arrays(batch)
        bs = next(iter(arrays.values())).shape[0]
        if bs not in self._programs:
            raise ValueError("No bundled program for batch size %d (the "
                             "bundle serves %s)" % (bs, self.batch_sizes))
        fields, program = self._programs[bs]
        for k, (shape, dtype) in fields.items():
            if k not in arrays:
                raise ValueError("Request is missing field %r" % k)
            v = arrays[k]
            if list(v.shape) != shape or str(v.dtype) != dtype:
                raise ValueError(
                    "Field %r: got %s %s, the bundle expects %s %s"
                    % (k, list(v.shape), v.dtype, shape, dtype))
        return program, device_cache_mod.upload(
            {k: arrays[k] for k in fields}, self.device)

    def predict(self, batch):
        program, placed = self._place(batch)
        with torch.no_grad():
            return _fetch(program(placed))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--step", type=str, default=None,
                   help="checkpoint step: integer, or 'best' (best "
                        "logged psnr_vali among retained checkpoints)")
    p.add_argument("--bs", type=int, default=1)
    p.add_argument("--n_obs_batches", type=int, default=1)
    p.add_argument("--pack", type=str, default=None,
                   choices=["uint8", "float16"],
                   help="quantize predictions on the device before the "
                        "fetch")
    p.add_argument("--shard", nargs="?", const="data", default=False,
                   choices=["data", "tile"],
                   help="not ported (one device)")
    p.add_argument("--fields", type=str, default=None,
                   help="comma-separated output subset (pred_camspc,pred)")
    p.add_argument("--export", type=str, default=None,
                   help="write a serving bundle (weights + obs pyramid "
                        "in the programs) to this path instead of "
                        "benchmarking")
    p.add_argument("--export_bs", type=str, default=None,
                   help="comma-separated batch sizes to bundle (default: "
                        "just --bs)")
    p.add_argument("--device", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.shard:
        raise NotImplementedError(
            "sharded serving is not ported yet (ROADMAP.md, queue 1, "
            "item 5)")

    server = Server(args.ckpt, step=args.step, pack=args.pack,
                    fields=args.fields.split(",") if args.fields else None,
                    device=args.device)
    server.precompute_obs(n_obs_batches=args.n_obs_batches)

    Dataset = datasets_mod.get_dataset_class(server.config.get("dataset"))
    server.config.set("bs", args.bs)
    batch = next(iter(Dataset(server.config, "test").iterate(seed=0)))
    if args.export:
        bs_list = ([int(x) for x in args.export_bs.split(",")]
                   if args.export_bs else None)
        return server.export(args.export, batch, bs_list=bs_list)
    stats = server.benchmark(batch)
    logger.info("Serving benchmark (bs=%d, streamed): %.2f ms/request, "
                "%.1f frames/sec", args.bs, stats["latency_s"] * 1e3,
                stats["fps"])
    cached = server.benchmark(batch, ids=batch["id"])
    logger.info("Serving benchmark (bs=%d, repeat query via the device "
                "input cache): %.2f ms/request, %.1f frames/sec", args.bs,
                cached["latency_s"] * 1e3, cached["fps"])
    return {"streamed": stats, "cached": cached}


if __name__ == "__main__":
    main()
