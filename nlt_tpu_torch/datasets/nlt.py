"""NLT dataset: loads the per-(cam, light) on-disk contract produced by
the data-generation pipeline.

Port of nlt_tpu/datasets/nlt.py (numpy only: the batches are
byte-identical to nlt_tpu's). The on-disk contract
(data_gen/postproc.py:96-108, data_gen/synthesize.py):

    <data_root>.json            file-list with per-ID relative paths and
                                a 'complete' existence flag
    <id>/cam.json light.json nn.json
    <id>/rgb.png (UV), rgb_camspc.png, alpha.png, cvis.png, lvis.png
    <id>/uv2cam.npy (float16 H x W x 2), cam2uv.npy
    <id>/diffuse.png, diffuse_camspc.png

Behavior kept:
- IDs are '{trainvali|test}_{i:09d}_{cam}_{light}'; the vali split is the
  cartesian product of holdout_cam x holdout_light, train is the rest,
  test is everything with the 'test' prefix (reference: :54-86);
- incomplete configs are skipped with a warning (:63-68);
- the nearest neighbor is looked up from nn.json via a regex over IDs
  (:88-100); missing neighbors yield zero placeholders so training
  proceeds (:152-157);
- n_obs > 1 (no reference counterpart: the reference loads exactly one
  neighbor) loads the k nearest observations from nn.json's optional
  "cams"/"lights" lists (data_gen get_neighbors --k / synthesize) and
  stacks nn_base/nn_rgb/nn_rgb_camspc with a leading obs axis
  (K, H, W, C); the model mean-aggregates the per-observation features
  exactly as the reference's obs list path does;
- images are normalized uint->[0,1], resized to (uvh, uvh) / (imh, imw);
  the warp field is NEVER resized — warp first, resize after
  (:140-148);
- test mode returns zero placeholders for rgb/rgb_camspc (:126-128).

Each example is a dict (not an 11-tuple): array fields
base/cvis/lvis/warp/rgb/rgb_camspc/nn_base/nn_rgb/nn_rgb_camspc plus
host-side strings id/nn_id.
"""

import os
from itertools import product

import numpy as np

from .. import io_native
from ..utils import io as ioutil
from ..utils import logging as logutil
from .base import Dataset as BaseDataset

logger = logutil.Logger(loggee="datasets/nlt")


class Dataset(BaseDataset):
    def __init__(self, config, mode, **kwargs):
        # Multi-scene training: data_root may be a comma-separated list
        # of roots (no reference counterpart — the reference trains one
        # scene per run). IDs from secondary scenes are namespaced
        # '<scene>/<id>' so neighbor lookups stay scene-local.
        self.data_roots = config.get_list("data_root")
        assert self.data_roots, "Empty data_root"
        multi = len(self.data_roots) > 1
        self.data_paths = {}
        for root in self.data_roots:
            data_status_path = root.rstrip("/") + ".json"
            if not os.path.exists(data_status_path):
                raise FileNotFoundError(
                    "Data status JSON not found at\n\t%s\nRun "
                    "data_gen/postproc.py (or data_gen/synthesize.py) to "
                    "generate it" % data_status_path)
            scene = os.path.basename(root.rstrip("/"))
            file_list = ioutil.read_json(data_status_path)
            for id_, paths in file_list.items():
                # Paths in the JSON are relative to their root.
                for k, v in paths.items():
                    if k != "complete":
                        paths[k] = os.path.join(root, v)
                key = "%s/%s" % (scene, id_) if multi else id_
                assert key not in self.data_paths, (
                    "Duplicate example ID %r" % key)
                self.data_paths[key] = paths
        self.device_normalize = config.get_bool("device_normalize", False)
        self.n_obs = config.get_int("n_obs", 1)
        assert self.n_obs >= 1, "n_obs must be >= 1"
        # obs_weighting = inverse_distance makes multi-observation
        # batches carry an 'nn_dist' field — the Euclidean (cam, light)
        # distance from this config to each observed neighbor, computed
        # from the per-config cam.json/light.json positions — which the
        # model turns into a 1/d weighted feature mean (the obs-list
        # aggregation knob the reference's dataset never fed;
        # reference: nlt/models/nlt.py:161-164).
        self.obs_weighting = (
            config.get("obs_weighting", "none") or "none").lower()
        assert self.obs_weighting in ("none", "inverse_distance"), (
            "Unknown obs_weighting %r" % self.obs_weighting)
        self._pos_cache = {}  # id -> (cam_pos, light_pos)
        # (scene, cam, light) -> trainvali ID: exact-match O(1) neighbor
        # lookup (a regex scan over all IDs per neighbor was O(N^2) over
        # the cold epoch and mis-matched names that prefix other names).
        # Names must not contain '_' — the reference's ID format
        # '{prefix}_{i:09d}_{cam}_{light}' has the same constraint.
        self._nn_index = {}
        for key in self.data_paths:
            tail = key.split("/")[-1]
            if not tail.startswith("trainvali_"):
                continue
            parts = tail.split("_")
            if len(parts) < 4:
                continue
            scene = key.rsplit("/", 1)[0] + "/" if "/" in key else ""
            k2 = (scene, parts[-2], parts[-1])
            if k2 in self._nn_index:
                raise ValueError(
                    "Duplicate (cam, light) config: %r and %r"
                    % (self._nn_index[k2], key))
            self._nn_index[k2] = key
        super().__init__(config, mode, **kwargs)

    def _glob(self):
        holdout_cam = self.config.get_list("holdout_cam")
        holdout_light = self.config.get_list("holdout_light")
        holdout = {"%s_%s" % x for x in product(holdout_cam, holdout_light)}

        ids = []
        want_prefix = "test" if self.mode == "test" else "trainvali"
        for id_, paths in self.data_paths.items():
            if not id_.split("/")[-1].startswith(want_prefix):
                continue
            if not paths["complete"]:
                logger.warn(
                    "Skipping '%s' because its data are incomplete", id_)
                continue
            ids.append(id_)

        if self.mode == "test":
            logger.info(
                "Number of '%s' camera-light combinations: %d",
                self.mode, len(ids))
            return ids

        ids_split = []
        for id_ in ids:
            cam_light = "_".join(id_.split("_")[-2:])
            in_holdout = cam_light in holdout
            if (self.mode == "vali") == in_holdout:
                ids_split.append(id_)
        logger.info(
            "Number of '%s' camera-light combinations: %d",
            self.mode, len(ids_split))
        return ids_split

    def _nn_pairs(self, nn):
        """The n_obs neighbor (cam, light) configs to observe: the j-th
        nearest cam paired with the j-th nearest light, from nn.json's
        optional "cams"/"lights" lists. Requests past the available
        lists clamp to the last entry (a duplicated real observation —
        the mean aggregation stays unbiased toward zeros)."""
        if self.n_obs == 1:
            return [{"cam": nn["cam"], "light": nn["light"]}]
        cams = nn.get("cams") or [nn["cam"]]
        lights = nn.get("lights") or [nn["light"]]
        return [
            {"cam": cams[min(j, len(cams) - 1)],
             "light": lights[min(j, len(lights) - 1)]}
            for j in range(self.n_obs)]

    def _get_nn_id(self, nn, scene_prefix=""):
        """Resolve nn.json's {cam, light} to a trainvali ID, within the
        same scene when multi-scene (reference: nlt/datasets/nlt.py:88-100
        does this with a regex scan; here an exact O(1) index lookup)."""
        return self._nn_index.get((scene_prefix, nn["cam"], nn["light"]))

    def _config_pos(self, id_):
        """Memoized (cam_position, light_position) of one config, from
        its cam.json/light.json (tiny; read once per id per run)."""
        pos = self._pos_cache.get(id_)
        if pos is None:
            paths = self.data_paths[id_]
            cam = ioutil.read_json(paths["cam"])
            light = ioutil.read_json(paths["light"])
            pos = (np.asarray(cam["position"], np.float64),
                   np.asarray(light["position"], np.float64))
            self._pos_cache[id_] = pos
        return pos

    def _nn_dists(self, id_, nn_ids):
        """Per-observation distances in joint (cam, light) space:
        sqrt(|cam - nn_cam|^2 + |light - nn_light|^2). Unresolvable
        neighbors (zero placeholders) get distance 1.0 — with every
        entry equal, the weighted mean degrades to the unweighted one."""
        own_cam, own_light = self._config_pos(id_)
        dists = []
        for nid in nn_ids:
            if nid is None:
                dists.append(1.0)
                continue
            nn_cam, nn_light = self._config_pos(nid)
            d2 = (np.sum((own_cam - nn_cam) ** 2)
                  + np.sum((own_light - nn_light) ** 2))
            dists.append(float(np.sqrt(d2)))
        return np.asarray(dists, np.float32)

    def _load_png(self, path, new_h, new_w=None, n_ch=None):
        """Decode + normalize + resize in one native call (C++ libpng via
        nlt_tpu_torch.io_native; PIL fallback inside). Replaces the reference's
        PIL-load -> normalize_uint -> cv2-resize chain
        (reference: nlt/datasets/nlt.py:121-146).

        With device_normalize, images stay uint8 on the host (requantized
        after any resize) and are normalized to [0,1] f32 ON DEVICE by the
        model — 4x less host->device traffic and no GIL-bound float
        expansion in the loader threads."""
        arr = io_native.load_png_f32(path, new_h=new_h, new_w=new_w)
        if n_ch is not None and arr.ndim == 3:
            arr = arr[:, :, :n_ch]
        if self.device_normalize:
            arr = np.round(arr * 255.0).astype(np.uint8)
        return arr

    def _load_item(self, id_):
        paths = self.data_paths[id_]
        imh = self.config.get_int("imh")
        imw = self.config.get_int("imw")
        uvh = self.config.get_int("uvh")
        submit = self._io_pool.submit

        # Fan the independent decodes out over the IO pool (the
        # reference's per-example load is fully serial inside
        # tf.py_function; reference: nlt/datasets/nlt.py:115-184).
        f_base = submit(self._load_png, paths["diffuse"], uvh, None, 3)
        f_cvis = submit(self._load_png, paths["cvis"], uvh)
        f_lvis = submit(self._load_png, paths["lvis"], uvh)
        f_warp = submit(ioutil.read_npy, paths["uv2cam"])
        is_test = self.mode == "test"
        if not is_test:
            f_rgb = submit(self._load_png, paths["rgb"], uvh, None, 3)
            f_rgb_cam = submit(
                self._load_png, paths["rgb_camspc"], imh, imw, 3)
        # NOTE: warp is never resized — warp first, then resize
        # (reference: nlt/datasets/nlt.py:147-148).

        nn = ioutil.read_json(paths["nn"])
        scene_prefix = id_.rsplit("/", 1)[0] + "/" if "/" in id_ else ""
        pairs = self._nn_pairs(nn)
        nn_ids = [self._get_nn_id(p, scene_prefix=scene_prefix)
                  for p in pairs]
        if self.n_obs > 1:
            # An unresolvable pair clamps to the first resolvable
            # observation (a duplicated real observation keeps the
            # per-stage feature mean unbiased); all-zero placeholders
            # only when nothing resolves (the reference's single-nn
            # behavior, :152-157).
            fallback = next(
                (nid for nid in nn_ids if nid is not None), None)
            if fallback is not None:
                nn_ids = [nid if nid is not None else fallback
                          for nid in nn_ids]
        labels = [
            nid if nid is not None
            else "incomplete-data_{cam}_{light}".format(**pair)
            for nid, pair in zip(nn_ids, pairs)]
        nn_futures = {}  # memoized by id: duplicates decode once
        for nid in nn_ids:
            if nid is None or nid in nn_futures:
                continue
            nn_paths = self.data_paths[nid]
            nn_futures[nid] = (
                submit(self._load_png, nn_paths["diffuse"], uvh, None, 3),
                submit(self._load_png, nn_paths["rgb"], uvh, None, 3),
                submit(self._load_png, nn_paths["rgb_camspc"],
                       imh, imw, 3))

        base = f_base.result()
        cvis = f_cvis.result()
        lvis = f_lvis.result()
        warp = f_warp.result()
        if is_test:
            rgb = np.zeros_like(base)
            rgb_camspc = np.zeros((imh, imw, 3), np.float32)
        else:
            rgb = f_rgb.result()
            rgb_camspc = f_rgb_cam.result()
        loaded = {nid: tuple(f.result() for f in futs)
                  for nid, futs in nn_futures.items()}
        zeros = (np.zeros_like(base), np.zeros_like(rgb),
                 np.zeros_like(rgb_camspc))
        triples = [loaded.get(nid, zeros) for nid in nn_ids]
        nn_id = ";".join(labels)
        if self.n_obs == 1:
            # Legacy single-observation contract: unstacked (H, W, C).
            (nn_base, nn_rgb, nn_rgb_camspc), = triples
        else:
            nn_base = np.stack([t[0] for t in triples])
            nn_rgb = np.stack([t[1] for t in triples])
            nn_rgb_camspc = np.stack([t[2] for t in triples])

        if self.device_normalize:
            img = lambda x: np.ascontiguousarray(x)  # noqa: E731 (uint8)
            # warp keeps its on-disk float16 precision over the wire.
            warp_out = np.ascontiguousarray(warp, np.float16)
        else:
            img = lambda x: np.ascontiguousarray(x, np.float32)  # noqa
            warp_out = np.ascontiguousarray(warp, np.float32)

        out = {
            "id": id_,
            "base": img(base),
            "cvis": img(cvis)[:, :, None],
            "lvis": img(lvis)[:, :, None],
            "warp": warp_out,
            "rgb": img(rgb),
            "rgb_camspc": img(rgb_camspc),
            "nn_id": nn_id,
            "nn_base": img(nn_base),
            "nn_rgb": img(nn_rgb),
            "nn_rgb_camspc": img(nn_rgb_camspc),
        }
        if self.obs_weighting != "none" and self.n_obs > 1:
            out["nn_dist"] = self._nn_dists(id_, nn_ids)
        return out
