"""Serving: low-latency relighting/view-synthesis inference (port of
nlt_tpu/serve.py).

- the observation feature pyramid is computed once from training
  observations (``precompute_obs``) and substituted for the obs path at
  every request, so the obs stages do not run per request;
- ``predict`` computes only the requested fields and can quantize them
  on the device (``pack``) before the one device-to-host copy;
- ``benchmark`` reports per-request latency and pipelined frames/sec.

Usage:
    server = Server(ckpt_dir, config=cfg)      # device="cuda" by default
    server.precompute_obs(train_dataset)       # obs feature pyramid
    out = server.predict(batch_arrays)         # {'pred_camspc': ...}

Not ported yet (they raise NotImplementedError): sharded serving
(``shard``), the device input cache (``ids``), ``export`` /
``ExportedServer`` and the CLI ``main``.
"""

import time

import numpy as np
import torch

from .nlt_test import extract_feat, get_config_ini, restore_model
from .utils import config as config_mod
from .utils import img as imgutil
from .utils import logging as logutil

logger = logutil.Logger(loggee="serve")

FIELDS = ("pred_camspc", "pred")


class Server:
    def __init__(self, ckpt_dir, step=None, config=None, pack=None,
                 shard=False, fields=None, device="cuda"):
        """pack: None returns float32 predictions; 'uint8' / 'float16'
        quantizes them on the device before the fetch.
        fields: which outputs to compute and return (subset of
        {'pred_camspc', 'pred'}; default both)."""
        if shard:
            raise NotImplementedError("sharded serving is not ported yet")
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

    def precompute_obs(self, dataset=None, n_obs_batches=1):
        """Average the observation feature pyramid from training batches
        (`dataset`: anything with iterate(seed=, drop_remainder=)).
        Without a dataset the requests' own observations feed the obs
        path, as nlt_tpu does when no training data is reachable."""
        self._override = {}
        if dataset is None:
            logger.warn("No training data for obs features; serving with "
                        "the requests' own observations")
            self._feat_agg = None
            return
        self._feat_agg = extract_feat(self.model, self.state, dataset,
                                      n_obs_batches=n_obs_batches)

    def _override_for(self, bs):
        if self._feat_agg is None:
            return None
        ov = self._override.get(bs)
        if ov is None:
            ov = [f.expand((bs,) + tuple(f.shape[1:])).contiguous()
                  for f in self._feat_agg]
            self._override[bs] = ov
        return ov

    def _place(self, batch):
        return {k: torch.as_tensor(np.asarray(v)).to(self.device,
                                                     non_blocking=True)
                for k, v in batch.items() if not isinstance(v, list)}

    def _forward(self, arrays):
        """Device-side prediction of one placed request: {field: tensor}."""
        bs = arrays["base"].shape[0]
        fields = self.fields or FIELDS
        with torch.no_grad():
            _, _, _, to_vis = self.model.apply(
                self.state["params"], arrays, "test",
                obs_override=self._override_for(bs), outputs=fields)
            out = {k: to_vis[k] for k in fields}
            if self.pack is not None:
                out = imgutil.pack_vis(out,
                                       linear_space=self.pack == "float16")
        return out

    @staticmethod
    def _fetch(out):
        return {k: v.cpu().numpy() for k, v in out.items()}

    def predict(self, batch, ids=None):
        """batch: dict of numpy arrays (the standard array fields).
        Returns {field: numpy array}."""
        if ids is not None:
            raise NotImplementedError(
                "the device input cache (ids) is not ported yet")
        return self._fetch(self._forward(self._place(batch)))

    def benchmark(self, batch, n=20, ids=None):
        """latency_s: median per-request time, upload to fetched result;
        fps: n requests enqueued back to back, fetched at the end."""
        if ids is not None:
            raise NotImplementedError(
                "the device input cache (ids) is not ported yet")
        bs = np.asarray(batch["base"]).shape[0]
        self.predict(batch)  # warm-up
        lats = []
        for _ in range(max(5, n // 4)):
            t0 = time.perf_counter()
            self.predict(batch)
            lats.append(time.perf_counter() - t0)
        latency = float(np.median(lats))
        t0 = time.perf_counter()
        outs = [self._forward(self._place(batch)) for _ in range(n)]
        for out in outs:
            self._fetch(out)
        dt = (time.perf_counter() - t0) / n
        return {"latency_s": latency, "throughput_batches_per_s": 1 / dt,
                "fps": bs / dt}

    def export(self, path, batch, bs_list=None):
        raise NotImplementedError(
            "export (torch.export of the serving program) is not ported yet")

    def invalidate(self, ids=None):
        raise NotImplementedError(
            "the device input cache (ids) is not ported yet")


class ExportedServer:
    def __init__(self, path):
        raise NotImplementedError("exported serving is not ported yet")


def main(argv=None):
    raise NotImplementedError(
        "the serving CLI needs the dataset port, which is not done yet")
