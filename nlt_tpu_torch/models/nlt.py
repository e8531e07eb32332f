"""The NLT model (port of nlt_tpu/models/nlt.py).

Dataflow kept exactly:

- query input  x = concat(base, cvis, lvis); obs input nn_rgb - nn_base
  (one neighbor, or K of them as (N, K, H, W, C), mean- or
  inverse-distance-aggregated, folded into the batch or unrolled);
- the interleaved dual U-Net: at every contracting stage the obs path
  runs its stage, the query stage output is concatenated with the
  aggregate and pushed on the skip stack; expanding stages pop and
  concat; ``obs_override`` substitutes the aggregate at inference;
- a residual over the diffuse base when skip_connect_base;
- warp scaled to pixels, texel (0, 0) blacked out, resample to camera
  space, resize to (imh, imw);
- train/vali return gt_camspc = alpha_blend(rgb_camspc, fg_camspc); with
  cached ``statics`` (``static_products``) the fg and base resamples are
  skipped and the prediction is warped through the precomputed plan
  (``resample_planned``, whose backward drops background updates).

XLA drops work whose result is unused; eager PyTorch does not, so two
cases are explicit here: with ``obs_override`` (or without use_obs) the
obs stages do not run, and ``apply(..., outputs=...)`` computes only the
named outputs (a test-mode server never runs the fg/base resamples).

Concatenation promotes dtypes as jnp.concatenate does: a float32 obs
pyramid joined to a bfloat16 query feature map continues in float32.

With ``remat`` each U-Net stage runs under torch.utils.checkpoint: its
activations are recomputed in the backward, fused-stage kernels
included.

The losses live in ``models/base.py``. The host-side visualization
(``vis_batch``, ``compile_batch_vis``: the HTML gallery of train/vali
batches, the video of the test views that ``nlt_test.infer`` wrote; the
``psnr`` metric) is nlt_tpu's.
"""

import os
from glob import glob
from os.path import exists, join

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import losses as losses_mod
from .. import resolve_device
from ..metrics import PSNR
from ..networks import convnet
from ..networks import elements
from ..ops import resample as resample_mod
from ..utils import img as imgutil
from ..utils import io as ioutil
from ..utils import logging as logutil
from ..utils.tree import tree_map
from ..vis import html as htmlutil
from ..vis import video as videoutil
from .base import Model as BaseModel

logger = logutil.Logger(loggee="models/nlt")

# Channel counts of the fixed inputs: query = base(3) + cvis(1) + lvis(1);
# obs = nn_rgb - nn_base (3).
QUERY_IN_CH = 5
OBS_IN_CH = 3
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def normalize_batch(batch):
    """uint8 image fields -> [0, 1] float32, float16 -> float32."""
    def _norm(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.dtype == torch.uint8:
            return x.float() * (1.0 / 255.0)
        if x.dtype == torch.float16:
            return x.float()
        return x

    return {k: _norm(v) for k, v in batch.items()}


def _cat(a, b):
    """Channel concat with jnp.concatenate's dtype promotion."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat((a.to(dt), b.to(dt)), dim=-1)


def tree_to(tree, device):
    """Move every tensor of a nested dict/list to `device`."""
    return tree_map(lambda t: t.to(device), tree)


class Model(BaseModel):
    def __init__(self, config, device="cuda"):
        self.device = resolve_device(device)
        self.imh = config.get_int("imh")
        self.imw = config.get_int("imw")
        super().__init__(config)
        depth0 = config.get_int("depth0")
        depth = config.get_int("depth")
        kernel = config.get_int("kernel")
        stride = config.get_int("stride")
        norm = config.get_or_none("norm")
        net_kwargs = {"norm_type": norm, "act_type": config.get("act"),
                      "pool_type": config.get_or_none("pool")}
        self.net = {
            "query": convnet.Network(depth0, depth, kernel, stride,
                                     bn_prefix="query_", **net_kwargs),
            "obs": convnet.Network(depth0, depth, kernel, stride,
                                   bn_prefix="obs_", **net_kwargs),
        }
        # The obs path keeps only contracting stages.
        obs = self.net["obs"]
        keep = [i for i, c in enumerate(obs.is_contracting) if c]
        obs.stages = [obs.stages[i] for i in keep]
        obs.is_contracting = [True] * len(keep)

        self.uvh = config.get_int("uvh")
        self.uvw = config.get_int("uvw")
        self.use_obs = config.get_bool("use_obs")
        self.obs_weighting = (
            config.get("obs_weighting", "none") or "none").lower()
        if self.obs_weighting not in ("none", "inverse_distance"):
            raise ValueError("Unknown obs_weighting %r" % self.obs_weighting)
        self.obs_fold = config.get_bool("obs_fold", False)
        if self.obs_fold and norm == "batch":
            logger.warn(
                "obs_fold=True with norm=batch: the obs path's BN batch "
                "statistics run over the folded (N*K) axis, coupling "
                "observations (not equal to the unrolled per-observation "
                "loop)")
        # remat: each U-Net stage's activations are recomputed in the
        # backward pass (torch.utils.checkpoint) instead of kept; the same
        # numbers, less memory, a second forward of every stage.
        self.remat = config.get_bool("remat", False)
        self.skip_connect_base = config.get_bool("skip_connect_base")
        # nlt_tpu's two resample formulations compute the same function;
        # the port has one.
        if config.get("resample_impl", "xla") not in ("xla", "percorner"):
            raise ValueError("Unknown resample_impl %r"
                             % config.get("resample_impl"))
        self.compute_dtype = _DTYPES[config.get("compute_dtype", "float32")]
        self.psnr = PSNR(np.float32)

    def _stage_apply(self, stage, p, x):
        """stage.apply, under torch.utils.checkpoint when remat is set
        and autograd records. The recompute in the backward sees the
        same BatchNorm mode as the forward (batch statistics inside the
        train step's collector, not recorded twice), so it reproduces the
        forward's values, fused-stage kernels included."""
        if not (self.remat and torch.is_grad_enabled()):
            return stage.apply(p, x)
        batch_stats = elements.collecting_bn_stats()
        calls = []

        def run(p, x):
            if not calls:  # the forward: record into the active collector
                calls.append(1)
                return stage.apply(p, x)
            with elements.collect_bn_stats(enabled=batch_stats):
                return stage.apply(p, x)

        return checkpoint(run, p, x, use_reentrant=False,
                          preserve_rng_state=False)

    def _init_loss(self):
        """Barron needs the image size."""
        return losses_mod.build_losses(
            self.config.get("loss"), config=self.config, imh=self.imh,
            imw=self.imw)

    # ---- parameters ----

    def init_params(self, generator):
        """Fresh glorot-uniform params from a torch.Generator (CPU),
        placed on the model's device. Channel bookkeeping mirrors
        apply()'s interleaved dataflow: contracting query stages consume
        [query_out + obs_out] channels when use_obs, expanding stages
        [prev_out + skip]. Tree: {'net': {'query': [...], 'obs': [...]},
        'loss': {...}}; the loss state (LPIPS's random-feature AlexNet)
        is nlt_tpu's own.
        """
        query = self.net["query"]
        obs = self.net["obs"]
        query_params = [None] * len(query.stages)
        obs_params = [None] * len(obs.stages)
        obs_ch, q_ch = OBS_IN_CH, QUERY_IN_CH
        skip_chs = []
        obs_i = 0
        for i, (stage, contracting) in enumerate(
                zip(query.stages, query.is_contracting)):
            if contracting:
                obs_params[obs_i], obs_ch = obs.stages[obs_i].init(
                    generator, obs_ch)
                obs_i += 1
                query_params[i], q_out = stage.init(generator, q_ch)
                q_ch = q_out + obs_ch if self.use_obs else q_out
                skip_chs.append(q_ch)
            else:
                if skip_chs:
                    q_ch = q_ch + skip_chs.pop()
                query_params[i], q_ch = stage.init(generator, q_ch)
        return tree_to({"net": {"query": query_params, "obs": obs_params},
                        "loss": self.init_loss_params()}, self.device)

    # ---- forward ----

    def apply(self, params, batch, mode, obs_override=None, statics=None,
              outputs=None):
        """batch: dict of NHWC tensors (base, cvis, lvis, warp, and as
        needed rgb, rgb_camspc, nn_base, nn_rgb, nn_rgb_camspc, nn_dist)
        on the model's device. Returns (pred_camspc, gt_camspc, {},
        to_vis) in train/vali and (pred_camspc, None, None, to_vis) in
        test mode, as nlt_tpu does.

        statics: train/vali only; the cached ``static_products(batch)``
        (gt_camspc, base_camspc, pred_plan): the fg and base resamples
        are skipped and the prediction is warped through the plan, with
        the same outputs.

        outputs: test mode only; the to_vis keys to compute (subset of
        pred, pred_camspc, base_camspc, nn_camspc). None computes all.
        """
        self._validate_mode(mode)
        training = mode in ("train", "vali")
        if statics is not None and not training:
            raise ValueError("statics caching is a train/vali-path "
                             "optimization")
        if outputs is None or training:
            outputs = ("pred", "pred_camspc", "base_camspc", "nn_camspc")
        outputs = set(outputs)
        if not outputs <= {"pred", "pred_camspc", "base_camspc",
                           "nn_camspc"}:
            raise ValueError("Unknown outputs %s" % sorted(outputs))
        batch = normalize_batch(batch)
        base = batch["base"]
        x = torch.cat((base, batch["cvis"], batch["lvis"]), dim=3)

        y_obs, obs_weights = None, None
        if self.use_obs and obs_override is None:
            y_obs, obs_weights = self._obs_inputs(batch)
        x = x.to(self.compute_dtype)
        pred = self._apply_unet(params["net"], x, y_obs,
                                obs_weights=obs_weights,
                                obs_override=obs_override)
        pred = pred.float()
        if self.skip_connect_base:
            pred = pred + base

        to_vis = {"pred": pred}
        warp = None
        if outputs & {"pred_camspc", "base_camspc"}:
            warp = self._scale_warp(batch["warp"])
        if "pred_camspc" in outputs:
            pred_c = imgutil.set_left_top_corner(pred, 0.0)
            plan = statics.get("pred_plan") if statics is not None else None
            if plan is not None:
                warped = resample_mod.resample_planned(pred_c, plan)
            else:
                warped = resample_mod.resample(pred_c, warp)
            to_vis["pred_camspc"] = imgutil.resize(warped, self.imh,
                                                   self.imw)
        gt_camspc = None
        if statics is not None:
            gt_camspc = statics["gt_camspc"]
            to_vis["base_camspc"] = statics["base_camspc"]
        elif training or "base_camspc" in outputs:
            gt_camspc, to_vis["base_camspc"] = self._warp_bases(
                batch, warp, need_gt=training)
        if "nn_camspc" in outputs:
            nn_camspc = batch["nn_rgb_camspc"]
            to_vis["nn_camspc"] = (nn_camspc[:, 0] if nn_camspc.dim() == 5
                                   else nn_camspc)
        pred_camspc = to_vis.get("pred_camspc")
        if training:
            to_vis["gt"] = batch["rgb"]
            to_vis["gt_camspc"] = gt_camspc
            return pred_camspc, gt_camspc, {}, to_vis
        return pred_camspc, None, None, to_vis

    def static_products(self, batch):
        """Everything apply() computes from static per-example data and
        never from params: the training target gt_camspc, the warped
        base base_camspc and the plan of the prediction's resample
        (make_plan with zero_grad_texel=(0, 0): texel (0, 0) is blacked
        out before the resample and its gradient zeroed, so updates that
        only write there, all background queries, are dropped)."""
        if self.config.get_float("take_compact_frac", 0.0) > 0:
            raise NotImplementedError(
                "compact resample plans (take_compact_frac) are not ported "
                "(ROADMAP.md, queue 1, item 4)")
        batch = normalize_batch(batch)
        warp = self._scale_warp(batch["warp"])
        h, w = batch["base"].shape[1:3]
        gt_camspc, base_camspc = self._warp_bases(batch, warp)
        return {"gt_camspc": gt_camspc, "base_camspc": base_camspc,
                "pred_plan": resample_mod.make_plan(
                    warp, h, w, zero_grad_texel=(0, 0))}

    def gt_camspc(self, batch):
        """The training target, computed without the network."""
        return self.static_products(batch)["gt_camspc"]

    def _obs_inputs(self, batch):
        """The obs path's inputs (a list, or one (N, K, ...) tensor when
        folded) and the optional inverse-distance weights."""
        nn_rgb, nn_base = batch["nn_rgb"], batch["nn_base"]
        obs_weights = None
        if (self.obs_weighting == "inverse_distance"
                and nn_rgb.dim() == 5 and "nn_dist" in batch):
            obs_weights = (1.0 / (batch["nn_dist"] + 1e-6)).to(
                self.compute_dtype)
        if nn_rgb.dim() == 5:
            if self.obs_fold:
                y_obs = (nn_rgb - nn_base).to(self.compute_dtype)
            else:
                y_obs = [(nn_rgb[:, j] - nn_base[:, j]).to(self.compute_dtype)
                         for j in range(nn_rgb.shape[1])]
        else:
            y_obs = [(nn_rgb - nn_base).to(self.compute_dtype)]
        return y_obs, obs_weights

    def _scale_warp(self, warp):
        """Normalized [0, 1] warp -> source-pixel units."""
        return torch.stack(
            (warp[:, :, :, 0] * self.uvw, warp[:, :, :, 1] * self.uvh), dim=3)

    def _warp_bases(self, batch, warp, need_gt=True):
        """The warped diffuse base and, if need_gt, the training target
        gt_camspc (camera photo alpha-blended with the warped foreground
        mask). Returns (gt_camspc or None, base_camspc)."""
        base = batch["base"]
        n, h, w = base.shape[:3]
        base_c = imgutil.set_left_top_corner(base, 0.0)
        base_camspc = imgutil.resize(
            resample_mod.resample(base_c, warp), self.imh, self.imw)
        if not need_gt:
            return None, base_camspc
        fg = torch.ones((n, h, w, 3), dtype=torch.float32, device=base.device)
        fg = imgutil.set_left_top_corner(fg, 0.0)
        fg_camspc = imgutil.resize(
            resample_mod.resample(fg, warp), self.imh, self.imw)
        return imgutil.alpha_blend(batch["rgb_camspc"], fg_camspc), base_camspc

    def _apply_unet(self, net_params, query_x, obs_xs, obs_weights=None,
                    obs_override=None):
        """The interleaved dual U-Net. obs_xs: a list of (N, H, W, C) obs
        inputs, one (N, K, H, W, C) tensor (folded into the batch), or
        None (the obs path is dead: overridden, or use_obs is off).
        obs_override: one aggregated feature map per contracting stage."""
        query = self.net["query"]
        obs = self.net["obs"]
        q_params = net_params["query"]
        o_params = net_params["obs"]
        folded_k = None
        if obs_xs is not None and not isinstance(obs_xs, (list, tuple)):
            n, folded_k = obs_xs.shape[0], obs_xs.shape[1]
            obs_x = obs_xs.reshape((n * folded_k,) + obs_xs.shape[2:])
        if obs_weights is not None:
            if folded_k is not None:
                obs_weights = obs_weights.reshape(n, folded_k, 1, 1, 1)
            else:
                obs_weights = obs_weights.reshape(
                    obs_weights.shape[0], 1, 1, 1, -1)

        query_featmaps = []
        obs_i = 0
        query_y = None
        for i, (stage, contracting) in enumerate(
                zip(query.stages, query.is_contracting)):
            if contracting:
                obs_agg = None
                if obs_xs is not None and folded_k is not None:
                    obs_x = self._stage_apply(obs.stages[obs_i],
                                              o_params[obs_i], obs_x)
                    kview = obs_x.reshape((n, folded_k) + obs_x.shape[1:])
                    if obs_weights is None:
                        obs_agg = kview.mean(dim=1)
                    else:
                        obs_agg = ((obs_weights * kview).sum(dim=1)
                                   / obs_weights.sum(dim=1))
                    obs_i += 1
                elif obs_xs is not None:
                    obs_ys = [self._stage_apply(obs.stages[obs_i],
                                                o_params[obs_i], t)
                              for t in obs_xs]
                    if obs_weights is None and len(obs_ys) == 1:
                        obs_agg = obs_ys[0]
                    elif obs_weights is None:
                        obs_agg = torch.stack(obs_ys, dim=-1).mean(dim=-1)
                    else:
                        stacked = torch.stack(obs_ys, dim=-1)
                        obs_agg = ((obs_weights * stacked).sum(dim=-1)
                                   / obs_weights.sum(dim=-1))
                    obs_xs = obs_ys
                    obs_i += 1

                query_y = self._stage_apply(stage, q_params[i], query_x)
                if self.use_obs:
                    if obs_override is not None:
                        obs_agg = obs_override[i]
                    query_x = _cat(query_y, obs_agg)
                else:
                    query_x = query_y
                query_featmaps.append(query_x)
            else:
                if query_featmaps:
                    query_x = _cat(query_x, query_featmaps.pop())
                query_y = self._stage_apply(stage, q_params[i], query_x)
                query_x = query_y
        return query_y

    def extract_obs_features(self, net_params, x):
        """Run x through the obs path, returning every stage's feature
        map (the pyramid nlt_test averages)."""
        obs = self.net["obs"]
        feats = []
        for i in range(len(obs.stages)):
            x = obs.stages[i].apply(net_params["obs"][i], x)
            feats.append(x)
        return feats

    # ---- visualization (host-side) ----

    def vis_batch(self, data_dict, outdir, mode, dump_raw_to=None,
                  text_loc_ratio=0.05, text_size_ratio=0.05,
                  text_color=(1, 1, 1)):
        """Write per-sample pngs, APNG comparisons and metadata JSON with
        PSNRs from host arrays (uint8/float16 as pack_vis left them, or
        float32)."""
        is_linear = self.config.get_bool("linear_space")
        self._validate_mode(mode)
        os.makedirs(outdir, exist_ok=True)
        ids = [str(x) for x in data_dict["id"]]
        nn_ids = [str(x) for x in data_dict["nn_id"]]
        bases = imgutil.vis_to_float01(data_dict["base_camspc"])
        preds = imgutil.vis_to_float01(data_dict["pred_camspc"])
        nns = imgutil.vis_to_float01(data_dict["nn_camspc"])
        gts = (None if mode == "test"
               else imgutil.vis_to_float01(data_dict["gt_camspc"]))

        for i in range(len(ids)):
            imgs = {}
            base = np.clip(bases[i], 0, 1)
            pred = np.clip(preds[i], 0, 1)
            nn = np.clip(nns[i], 0, 1)
            gt = None if gts is None else np.clip(gts[i], 0, 1)
            if is_linear:
                base = imgutil.linear2srgb(base)
                pred = imgutil.linear2srgb(pred)
                nn = imgutil.linear2srgb(nn)
                gt = None if gt is None else imgutil.linear2srgb(gt)
            imgs["base"] = ioutil.write_img(
                base, join(outdir, "%d_base.png" % i))
            imgs["pred"] = ioutil.write_img(
                pred, join(outdir, "%d_pred.png" % i))
            ioutil.write_img(nn, join(outdir, "%d_nn.png" % i))
            imgs["gt"] = None if gt is None else ioutil.write_img(
                gt, join(outdir, "%d_gt.png" % i))

            hw = base.shape[:2]
            label_loc = (int(text_loc_ratio * hw[1]),
                         int(text_loc_ratio * hw[0]))
            font_size = int(text_size_ratio * hw[0])
            videoutil.make_apng(
                (imgs["base"], imgs["pred"]),
                labels=("Diffuse Base", "Prediction"),
                label_top_left_xy=label_loc, font_size=font_size,
                font_color=text_color,
                outpath=join(outdir, "%d_base-vs-pred.apng" % i))
            if imgs["gt"] is not None:
                videoutil.make_apng(
                    (imgs["gt"], imgs["pred"]),
                    labels=("Ground Truth", "Prediction"),
                    label_top_left_xy=label_loc, font_size=font_size,
                    font_color=text_color,
                    outpath=join(outdir, "%d_gt-vs-pred.apng" % i))

        for i, id_ in enumerate(ids):
            metadata = {"id": id_, "nn_id": nn_ids[i]}
            if gts is not None:
                pred = np.clip(preds[i], 0, 1)
                base = np.clip(bases[i], 0, 1)
                gt = np.clip(gts[i], 0, 1)
                # PSNR is inf on an exact match; null keeps the JSON
                # strictly parseable.
                for key, v in (("pred_psnr", self.psnr(gt, pred)),
                               ("base_psnr", self.psnr(gt, base))):
                    metadata[key] = float(v) if np.isfinite(v) else None
            ioutil.write_json(metadata, join(outdir, "%d_metadata.json" % i))

        if dump_raw_to is not None:
            raw = {k: np.asarray(v) if not isinstance(v, list) else v
                   for k, v in data_dict.items()}
            ioutil.write_pickle(raw, dump_raw_to)

    def compile_batch_vis(self, batch_vis_dirs, outpref, mode, fps=6):
        """HTML gallery for train/vali, a video of the predictions for
        test (an animated image where no video writer is installed)."""
        self._validate_mode(mode)
        if mode in ("train", "vali"):
            outpath = outpref + ".html"
            self._compile_into_webpage(batch_vis_dirs, outpath,
                                       title="NLT (%s)" % mode)
            return outpath
        return self._compile_into_video(batch_vis_dirs, outpref + ".mp4",
                                        fps=fps)

    @staticmethod
    def _compile_into_webpage(batch_dirs, out_html, title=None):
        rows, caps, types = [], [], []
        for batch_dir in batch_dirs:
            for metadata_path in sorted(
                    glob(join(batch_dir, "[0-9]*_metadata.json"))):
                prefix = metadata_path[:-len("metadata.json")]
                metadata = str(ioutil.read_json(metadata_path))
                rows.append([
                    metadata,
                    prefix + "base-vs-pred.apng",
                    prefix + "gt-vs-pred.apng",
                    prefix + "nn.png"])
                caps.append([
                    "Metadata", "Prediction vs. Diffuse Base",
                    "Prediction vs. Ground Truth", "Nearest Neighbor"])
                types.append(["text", "image", "image", "image"])
        assert rows, "No row"
        page = htmlutil.HTML(title=title)
        table = page.add_table()
        for r, rc, rt in zip(rows, caps, types):
            table.add_row(r, rt, captions=rc)
        page.save(out_html)

    @staticmethod
    def _compile_into_video(batch_dirs, out_mp4, fps=12):
        """Each batch dir's *_pred.png frames, ordered by their metadata
        id, written as one video; returns the path written."""
        frames = {}
        for batch_dir in batch_dirs:
            for metadata_path in glob(join(batch_dir,
                                           "[0-9]*_metadata.json")):
                prefix = metadata_path[:-len("metadata.json")]
                pred_path = prefix + "pred.png"
                if not exists(pred_path):
                    logger.warn("Skipping because of missing file:\n\t%s",
                                pred_path)
                    continue
                metadata = ioutil.read_json(metadata_path)
                frames[metadata["id"]] = ioutil.load_img(pred_path)
        frames_sorted = [frames[k] for k in sorted(frames)]
        return ioutil.write_video(frames_sorted, out_mp4, fps=fps)
