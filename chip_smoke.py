"""Drive the PyTorch/CUDA port (nlt_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass for the run to exit 0:

1. Build the CUDA kernels from nlt_tpu_torch/csrc (nvcc, sm_90a).
2. Hold each fused-stage kernel against its plain PyTorch version at
   every stage shape of the flagship U-Net (512^2, depth0 16, depth 256;
   query and obs paths), in bfloat16 and float32, and at small shapes
   with forced tilings (odd tile counts, ragged edges, one tile, odd
   channel counts). Time kernel, plain version and a cuDNN yardstick.
   Each stage op has two routes (ops/fused_stage.py): a split kernel
   (csrc/contract_split.cu, csrc/expand_split.cu: a thread-block
   cluster per tile) for the shapes with a measured plan, else the
   tiled kernel (csrc/fused_stage.cu). Each split kernel is checked at
   every flagship shape it is routed at, bs 1 and 4, in both dtypes
   and both slopes, at forced edge plans (every cluster size, 1x1
   tiles, ragged tiles, C not a multiple of the chunk; C = 33 must be
   refused), for determinism (two float32 launches bit-identical), for
   equality with the tiled kernel and for its shared-memory
   arithmetic; both routes are timed there at bs 1 and 4, with
   per-phase clocks. Both ops are also checked and timed at every stage
   shape of dragon_sss.ini (depth 1024, bs 4) and sphere_synthetic.ini
   (128^2, depth 32, bs 2), on whatever route each takes.
   The same for the 2x2 stride-2 conv stage kernel (K4) at nlt_tpu's
   three shapes at bs 4 (timed, with per-phase clocks), at the shapes
   of nlt_tpu's kernel tests, at an odd C = 5 / O = 3, with
   negative_slope 0, at the kernel's own edges (C in 1, 5, 33, 64, 128
   x O in 3, 64, 65, 128; C = 256 and 512, whose w is walked in K
   slices; x off a 16-byte boundary) and with its launch plan held
   against the Python mirror (ops/conv_stage.py::launch_plan). No path
   of the model runs K4 (as in nlt_tpu), so its main-path launches
   are 0.
3. Serve: a Server over the flagship config (bf16 compute, uint8
   responses) with params from a seeded torch.Generator bakes an
   observation pyramid from two synthetic bs-4 batches, then answers 8
   bs-1 requests and one bs-4 request with its launch counters reset;
   every request must launch 6 contract + 6 expand kernels.
4. The whole predict through the kernels against the plain path
   (NLT_TPU_FUSED_STAGE=0, same params): float32 compute to 1e-3 and
   uint8 within 1 LSB; bfloat16 compute at a bf16 tolerance.
5. Serving latency and frames/sec at bs 1 and bs 4, kernels and plain;
   device time per request and latency with each op's stages on the
   tiled route against the planner's routes, in turns; bs-1 latency
   and the host time of a stage call with the stage ops called through
   their registered custom ops, a direct ctypes launch and the launch
   registered with Library.define, in turns.
6. Training at the flagship recipe's full width (dragon_specular.ini:
   bs 4, 512^2, depth0 16 / depth 256, bf16, barron + LPIPS, AMSGrad
   lr 1e-3, cached statics): the resampler-backward scatter kernel (K1)
   against its plain version at the flagship shape, at forced edge
   cases and on both of its paths (float4 atomics; the scalar path for
   W % 4 != 0 or a table or updates off a 16-byte boundary; all-dead
   and all-duplicate updates), its launch plan against the Python
   mirror (ops/scatter.py::launch_plan); the fused stages' gradients,
   kernel forward against plain forward, at every flagship stage
   shape at bs 4 in float32 and bfloat16; then whole steps with the launch counters reset (each step
   must launch 12 contract + 6 expand + 1 scatter kernels), timed,
   profiled by category, and compared with the same steps through the
   plain versions of the three ops (float32 and bfloat16).
7. Training from disk through the entry point nlt_tpu_torch.trainvali:
   a 512^2 scene written by data_gen/synthesize.py (4 cameras x 4
   lights, holdout C03 x L003), nlt_tpu/config/sphere512_specular.ini
   (the flagship recipe's model, loss and optimizer keys: bf16, bs 4,
   disk cache, uint8 wire, cached statics) for 3 epochs with the launch
   counters reset (each train step 12 contract + 6 expand + 1 scatter,
   each validation batch 12 + 6); its outputs on disk; the same run
   through the plain versions of the three ops (float32 and bfloat16);
   the main run repeated as it was and with placement on a worker
   thread and its own CUDA stream (prefetch_batches = 1); a run stopped
   after epoch 2 and resumed to 3 against the run that was not stopped;
   restore_model(step='best') and a Server answering one request from
   the checkpoint; epoch times, the loader's share and the device's idle
   share of a warm epoch (a profiled run). The scene holds 9 test views
   (test batches of 4, 4 and 1 at the recipe's bs 4), which phase 8
   reads; trainvali never does.
8. Test-time inference and the rest of serving on phase 7's main run:
   python -m nlt_tpu_torch.nlt_test --step best in a subprocess (exit
   0, 9 frames with the 9 test ids, a 9-frame video); nlt_test.main in
   this process with the launch counters reset (6 contract for the obs
   batch of extract_feat, 6 + 6 per test batch), then through the plain
   versions (frames within 1 LSB, metadata equal), with seconds per
   test batch and the share of infer that is vis writing;
   Server.predict(ids=) at bs 1 and 4 (the first call misses, a repeat
   hits every row, bit-equal to the uploaded path, invalidate() serves
   new content under the same ids, no host-to-device copy in a cached
   request's device profile; device ms and latency against the uploaded
   path, in turns); the serve CLI (streamed and cached stats; an export
   bundle of bs 1 and 4) and ExportedServer on that bundle (bit-equal to
   the live Server, 6 + 6 launches a request, bs 2 refused; latency and
   device ms against the live server, in turns).
9. The rest of training at the flagship training width (phase 6's
   recipe, one key changed at a time), each option's steps with the
   launch counters reset: (a) loss = barron,1e+0elpips and
   barron,1e+0lpips,1e+0ssim (a warm-up and 5 timed steps, 12 + 6 + 1
   launches each; the same seed twice gives the same losses and draws,
   each step draws its own transform; kernels against plain with the
   same draws, bf16, and float32 for E-LPIPS); (b) norm = batch, float32
   and bf16 (0 + 0 + 1 launches: the norms turn the fused stages off;
   the moving statistics move and equal the plain path's after a step;
   an eval step runs on them; nan_guard on a poisoned batch keeps them);
   (c) norm = layer, instance, pixel (kernels against plain losses); (d)
   remat = True (launches a step as counted; loss and gradients against
   the step without remat, float32 and bf16; peak memory with and
   without); (e) one trainvali epoch on phase 7's scene from an .ini
   with norm = batch and loss = barron,1e+0elpips,1e+0ssim (launches;
   the checkpoint's moving statistics moved; restore_model and a Server
   request answer on them). Step times in turns against the barron +
   LPIPS step, and a profiled step (device idle share) for (a), (b) and
   (d).

Prints the card's name and power limit, one JSON line per check and
timing, a {"kernels": [...]} line, and last {"ok": true, "device": ...}.
Exits non-zero without printing a result when there is no CUDA device.

    python3 chip_smoke.py --expand-route tiled|auto --contract-route tiled|auto

sends every expand (contract) call of the run to the tiled kernel
(tiled), or leaves it to the planner (auto, the default: the split
kernel at the plans measured on the card, the tiled kernel elsewhere).

    python3 chip_smoke.py --sweep [--out DIR]

builds the kernels, then checks and times every split launch plan of
both ops at every flagship stage shape (bs 1 and 4) and every
RECIPE_STAGES shape, float32 and bfloat16, beside the tiled route,
writes one JSON line per plan to DIR/split_sweep.jsonl (default
chiprun_out) and a summary per stage to stdout, and exits; it prints no
result line.
"""

import argparse
import contextlib
import ctypes
import glob
import json
import shutil
import os
import subprocess
import sys
import time
import types

import numpy as np
import torch
from PIL import Image

from nlt_tpu_torch import trainvali
from nlt_tpu_torch.datasets import get_dataset_class
from nlt_tpu_torch.models.nlt import Model
from nlt_tpu_torch.nlt_test import restore_model
from nlt_tpu_torch.ops import _build
from nlt_tpu_torch.ops import conv_stage as cs
from nlt_tpu_torch.ops import fused_stage as fs
from nlt_tpu_torch.ops import scatter as sc
from nlt_tpu_torch.parallel import train as train_mod
from nlt_tpu_torch.serve import Server
from nlt_tpu_torch.utils import config as config_mod
from nlt_tpu_torch.utils.config import Config
from nlt_tpu_torch.utils.tree import tree_leaves

RES, DEPTH = 512, 256
HBM_BYTES_PER_S = 3.35e12            # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # float32 outside the tensor cores
# Kernel vs plain version, as a fraction of the plain output's largest
# magnitude (at least 1):
# - float32: the same products summed in another order, sums of up to
#   2048 terms: ~1e-5; 1e-4 leaves a 10x margin.
# - bfloat16: the kernel rounds y1 and y2 once each, after the float32
#   activation; the plain version (nlt_tpu's reference) rounds z1 before
#   the activation, every tap's sum and the running total (5 roundings
#   of 2^-9) and uses the bf16-rounded slope: 2^-5.
KERNEL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -5}
# K1 against index_add_: float atomics add duplicate rows in no fixed
# order; O(1) updates, a few per row: 1e-5 of the table's scale. Rows
# hit once must be exact.
SCATTER_TOL = 1e-5
# Stage gradients through the kernel forward against autograd of the
# plain forward, relative L2 per gradient (an entry whose LeakyReLU mask
# flips, where the two forwards' y differ in sign, moves single entries
# by up to 0.7 of their size, so the largest entry is no yardstick):
# - float32: y1/y2 and the gradients' sums in another order (~1e-7),
#   plus the odd mask flip (up to 5e-3 of the largest entry seen at
#   128 -> 128 @64^2): 1e-3.
# - bfloat16: the forwards round y1/y2 at other points (up to 2^-5 of
#   scale), masks flip where a y sits below that, and the plain
#   version's autograd rounds every intermediate gradient to bf16 where
#   the port's backward keeps float32. Emulated on a CPU at six flagship
#   shapes: 2-6%; 2^-3.
GRAD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2.0 ** -3}
# K4 against its plain version, as a fraction of the plain output's
# largest magnitude (at least 1): float32 sums of 4C <= 256 products in
# another order (~1e-6); 1e-4 leaves a margin of 100.
CONV_TOL = 1e-4
SOURCES = {"contract_stage": "nlt_tpu_torch/csrc/contract_split.cu + "
                             "nlt_tpu_torch/csrc/fused_stage.cu",
           "expand_stage": "nlt_tpu_torch/csrc/expand_split.cu + "
                           "nlt_tpu_torch/csrc/fused_stage.cu",
           "scatter_add_rows": "nlt_tpu_torch/csrc/scatter.cu",
           "conv2x2s2_lrelu": "nlt_tpu_torch/csrc/conv_stage.cu"}
REPLACES = {"contract_stage": "nlt_tpu/ops/fused_stage.py:115",
            "expand_stage": "nlt_tpu/ops/fused_stage.py:362",
            "scatter_add_rows": "nlt_tpu/ops/scatter_pallas.py:64",
            "conv2x2s2_lrelu": "nlt_tpu/ops/conv_stage_pallas.py:38"}
KERNELS = ("contract_stage", "expand_stage", "scatter_add_rows",
           "conv2x2s2_lrelu")
TRAIN_BS = 4
TRAIN_STEPS = 5            # timed steps after one warm-up step
TRAIN_LAUNCHES = {"contract_stage": 12, "expand_stage": 6,
                  "scatter_add_rows": 1, "conv2x2s2_lrelu": 0}
# A validation batch of the trainvali path runs the forward only.
EVAL_LAUNCHES = {"contract_stage": 12, "expand_stage": 6,
                 "scatter_add_rows": 0, "conv2x2s2_lrelu": 0}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def flagship_cfg(compute_dtype="bfloat16"):
    """The serving configuration bench.py times (nlt_tpu's flagship
    recipe at bs 1)."""
    return Config({
        "dataset": "nlt", "model": "nlt", "loss": "barron,1e+0lpips",
        "imh": RES, "imw": RES, "uvh": RES, "uvw": RES,
        "use_obs": True, "skip_connect_base": True, "linear_space": False,
        "depth0": 16, "depth": DEPTH, "kernel": 2, "stride": 2,
        "norm": "None", "act": "leakyrelu", "pool": "None",
        "bs": 1, "compute_dtype": compute_dtype, "lr": "1e-3"})


def make_batch(n, res, seed, coverage=0.5):
    """Synthetic flagship-shaped request: uniform images, an identity
    warp pinned to (0, 0) outside a centred disk covering `coverage` of
    the frame (the background convention of real scenes)."""
    rng = np.random.RandomState(seed)

    def img(c):
        return rng.uniform(0, 1, (n, res, res, c)).astype(np.float32)

    xs, ys = np.meshgrid(np.arange(res), np.arange(res))
    warp = np.stack([xs / res, ys / res], -1).astype(np.float32)
    r2 = ((xs - res / 2) ** 2 + (ys - res / 2) ** 2) / (res / 2) ** 2
    warp = warp * (r2 <= coverage * 4 / np.pi)[..., None]
    return {"base": img(3), "cvis": img(1), "lvis": img(1),
            "warp": np.tile(warp[None], (n, 1, 1, 1)), "rgb": img(3),
            "rgb_camspc": img(3), "nn_base": img(3), "nn_rgb": img(3),
            "nn_rgb_camspc": img(3)}


class Batches:
    """A dataset over fixed batches (the iterate() contract)."""

    def __init__(self, batches):
        self.batches = batches

    def iterate(self, seed=0, drop_remainder=True):
        return iter(self.batches)


def make_server(fused, compute_dtype, device, pyramid=None, pack="uint8",
                share_state_with=None):
    os.environ["NLT_TPU_FUSED_STAGE"] = "1" if fused else "0"
    no_ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "nlt_tpu_torch", "_build", "no_checkpoint")
    server = Server(no_ckpt, config=flagship_cfg(compute_dtype),
                    pack=pack, device=device)
    if share_state_with is not None:
        server.state = share_state_with.state
    if pyramid is not None:  # else the requests' own observations
        server.precompute_obs(pyramid, n_obs_batches=2)
    return server


# ---------------------------------------------------------------------------
# Kernel checks and timing
# ---------------------------------------------------------------------------


def time_ms(fn, reps=20, rounds=5):
    """Device time of one fn() call: `reps` calls captured in a CUDA
    graph, replayed `rounds` times between CUDA events, so the host's
    per-call overhead (checks, allocation, ctypes) is not in the number.
    Inputs stay where the previous replay left them (in L2 when they
    fit its 50 MB), as a stage's input is when the op before it has
    just written it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(rounds):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * rounds)


def stage_cost(kind, x, o):
    """(bytes, flops) the stage must move and do: each input read once,
    y2 written once (y1 stays on chip), 2 flops per multiply-add."""
    n, h, w, c = x.shape
    item = x.element_size()
    if kind == "contract_stage":
        out_px = n * (h // 2) * (w // 2)
        macs = out_px * (4 * c * o + 4 * o * o)
    else:
        out_px = n * 4 * h * w
        macs = n * h * w * 4 * c * o + out_px * 4 * o * o
    nbytes = item * (x.numel() + 4 * c * o + 4 * o * o + 2 * o + out_px * o)
    return nbytes, 2 * macs


def stage_bound_ms(kind, x, o):
    nbytes, flops = stage_cost(kind, x, o)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[x.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def library_stage(kind, x, w1, b1, w2, b2, slope):
    """The same stage as cuDNN calls on channels-last views: two
    convolutions (or transposed convolutions) and two leaky_relus."""
    f = torch.nn.functional
    xc = x.permute(0, 3, 1, 2)
    if kind == "contract_stage":
        y1 = f.leaky_relu(f.conv2d(xc, w1.permute(3, 2, 0, 1), b1, stride=2),
                          slope)
        y2 = f.conv2d(f.pad(y1, (0, 1, 0, 1)), w2.permute(3, 2, 0, 1), b2)
    else:
        h, w = 2 * x.shape[1], 2 * x.shape[2]
        y1 = f.leaky_relu(f.conv_transpose2d(
            xc, w1.permute(2, 3, 0, 1), b1, stride=2), slope)
        y2 = f.conv_transpose2d(y1, w2.permute(2, 3, 0, 1), b2)[:, :, :h, :w]
    return f.leaky_relu(y2, slope).permute(0, 2, 3, 1)


def random_stage(n, h, w, c, o, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def glorot(*shape):
        lim = (6.0 / (shape[0] * shape[1] * (shape[2] + shape[3]))) ** 0.5
        return (torch.rand(shape, generator=g) * 2 - 1) * lim

    args = [torch.randn((n, h, w, c), generator=g), glorot(2, 2, c, o),
            torch.randn(o, generator=g) * 0.1, glorot(2, 2, o, o),
            torch.randn(o, generator=g) * 0.1]
    return [a.to("cuda", dtype).contiguous() for a in args]


# The split-route planner of each op, as the package has it.
_PLANNERS = {"contract_stage": "_contract_split_plan",
             "expand_stage": "_split_plan"}
_AUTO_PLANS = {k: getattr(fs, v) for k, v in _PLANNERS.items()}
ROUTES = {"contract_stage": "auto", "expand_stage": "auto"}


def set_route(kind, route):
    """Send the calls of one op to one route: "tiled" (every call) or
    "auto" (its split planner as the package has it)."""
    setattr(fs, _PLANNERS[kind], {"tiled": lambda *a: None,
                                  "auto": _AUTO_PLANS[kind]}[route])
    ROUTES[kind] = route


def _tiled_plan(kind, x, o):
    return fs._plan(kind == "contract_stage", *x.shape, o, x.element_size())


def _route_of(kind, args, plan, split):
    """(route, plan) a _launch with these overrides takes."""
    x, w1, w2 = args[0], args[1], args[3]
    c, o = x.shape[3], w1.shape[3]
    if plan is None:
        route = fs._contract_route if kind == "contract_stage" \
            else fs._expand_route
        split = split or route(x, w1, w2, c, o)
        if split is not None:
            return "split", list(split)
    return "tiled", list(plan or _tiled_plan(kind, x, o))


def check_stage(kind, args, slope=0.3, plan=None, timing=False, label="",
                split=None, time_refs=True):
    """Kernel (y2 and y1) against the plain version on the same inputs;
    with timing, also kernel, plain and cuDNN times and the bound.
    `plan` forces the tiled kernel's tiling, `split` the split kernel's
    plan; neither: the op's route, through the op's own wrapper."""
    x, w1 = args[0], args[1]
    o = w1.shape[3]
    ref = fs.contract_stage_ref if kind == "contract_stage" \
        else fs.expand_stage_ref
    route, rplan = _route_of(kind, args, plan, split)

    def run(return_y1):
        if plan is None and split is None:
            return getattr(fs, kind)(*args, slope=slope, return_y1=return_y1)
        return fs._launch(kind, *args, slope, return_y1, plan=plan,
                          split=split)

    with torch.no_grad():
        y2k, y1k = run(True)
        y2p, y1p = ref(*args, slope)
        torch.cuda.synchronize()
        err = max(float((y2k.float() - y2p.float()).abs().max()),
                  float((y1k.float() - y1p.float()).abs().max()))
        scale = max(1.0, float(y2p.float().abs().max()),
                    float(y1p.float().abs().max()))
        ok = bool(torch.isfinite(y2k).all()) and err <= \
            KERNEL_TOL[x.dtype] * scale
        rec = {"check": "kernel_vs_plain", "kernel": kind, "label": label,
               "x": list(x.shape), "o": o, "dtype": str(x.dtype)[6:],
               "slope": slope, "route": route,
               "s": rplan[2] if route == "split" else 1, "plan": rplan,
               "max_abs_err": err, "scale": scale,
               "tol": KERNEL_TOL[x.dtype] * scale, "ok": ok}
        if route == "split":
            # Both routes sum in one order: y2 and y1 bit-equal to the
            # tiled kernel's (reported, not gated).
            y2t, y1t = fs._launch(kind, *args, slope, True,
                                  plan=_tiled_plan(kind, x, o))
            rec["equal_to_tiled"] = bool(torch.equal(y2k, y2t)
                                         and torch.equal(y1k, y1t))
            if x.dtype == torch.float32:
                y2b, y1b = fs._launch(kind, *args, slope, True, split=split
                                      or tuple(rplan))
                rec["deterministic"] = bool(torch.equal(y2k, y2b)
                                            and torch.equal(y1k, y1b))
                rec["ok"] = ok = ok and rec["deterministic"]
        if timing:
            rec["ms"] = time_ms(lambda: run(False))
            if time_refs:
                lib = library_stage(kind, *args, slope)
                rec["library_max_abs_err"] = float(
                    (lib.float() - y2p.float()).abs().max())
                rec["plain_ms"] = time_ms(lambda: ref(*args, slope))
                rec["library_ms"] = time_ms(
                    lambda: library_stage(kind, *args, slope))
            rec["bound_ms"], rec["bound_by"] = stage_bound_ms(kind, x, o)
    emit(**rec)
    return rec


# Every stage shape of the flagship U-Net: (kind, C, O, input H = W).
FLAGSHIP_STAGES = (
    [("contract_stage", c, o, h) for c, o, h in [
        (32, 16, 512), (32, 32, 256), (64, 64, 128), (128, 128, 64),
        (256, 256, 32), (512, 256, 16),          # query path
        (16, 16, 512), (16, 32, 256), (32, 64, 128), (64, 128, 64),
        (128, 256, 32), (256, 256, 16)]]         # obs path
    + [("expand_stage", c, o, h) for c, o, h in [
        (1024, 128, 8), (640, 64, 16), (320, 32, 32), (160, 16, 64),
        (80, 8, 128), (40, 4, 256)]])

# Every stage shape of two other shipped recipes' U-Nets, in the order
# their forward calls them (obs, then query, per contracting level):
# recipe -> (batch size, compute dtype, [(kind, C, O, input H = W)]).
# dragon_sss.ini (like the other *_sss.ini): 512^2, depth0 16 / depth
# 1024, bs 4, bf16; sphere_synthetic.ini (like sphere_viewsyn.ini and
# sphere_relight_identity.ini): 128^2, depth 32, bs 2, float32.
# tests/test_torch_fused_stage.py holds this list against the calls the
# port's model makes under each recipe's keys.
RECIPE_STAGES = {
    "dragon_sss.ini": (4, "bfloat16", [
        ("contract_stage", c, o, h) for c, o, h in [
            (16, 16, 512), (32, 16, 512), (16, 32, 256), (32, 32, 256),
            (32, 64, 128), (64, 64, 128), (64, 128, 64), (128, 128, 64),
            (128, 256, 32), (256, 256, 32), (256, 512, 16), (512, 512, 16),
            (512, 1024, 8), (1024, 1024, 8), (1024, 1024, 4),
            (2048, 1024, 4)]] + [
        ("expand_stage", c, o, h) for c, o, h in [
            (4096, 512, 2), (2560, 256, 4), (1280, 128, 8), (640, 64, 16),
            (320, 32, 32), (160, 16, 64), (80, 8, 128), (40, 4, 256)]]),
    "sphere_synthetic.ini": (2, "float32", [
        ("contract_stage", c, o, h) for c, o, h in [
            (16, 16, 128), (32, 16, 128), (16, 32, 64), (32, 32, 64),
            (32, 32, 32), (64, 32, 32)]] + [
        ("expand_stage", c, o, h) for c, o, h in [
            (128, 16, 16), (80, 8, 32), (40, 4, 64)]]),
}

# Small shapes with forced plans (th, tw, bn1, bn2): odd tile counts,
# ragged last tiles, a single tile, odd and thin channel counts.
EDGE_STAGES = [
    ("contract_stage", (2, 12, 10, 5), 7, (2, 2, 16, 16)),   # 3 x 3 tiles
    ("contract_stage", (1, 14, 18, 3), 4, (4, 4, 16, 32)),   # ragged
    ("contract_stage", (1, 8, 8, 9), 12, (4, 4, 32, 16)),    # one tile
    ("contract_stage", (1, 6, 6, 40), 33, (1, 1, 64, 64)),   # 1x1 tiles
    ("expand_stage", (2, 3, 5, 7), 5, (1, 2, 32, 16)),       # odd grid
    ("expand_stage", (1, 7, 6, 10), 4, (4, 4, 16, 16)),      # ragged
    ("expand_stage", (1, 4, 4, 40), 4, (4, 4, 16, 16)),      # one tile
    ("expand_stage", (1, 5, 3, 33), 17, (2, 2, 128, 32)),    # odd widths
]


# Forced split plans (th, tw, s, ch) on small shapes (n, h, w, c), o:
# every cluster size, 1x1 tiles, ragged last tiles (odd H, W), C below,
# above and not a multiple of the chunk, R = 2 and 4 pixels per thread.
# O / S is a multiple of 8, so bfloat16 rows are whole 16-byte copies.
SPLIT_EDGES = [
    ((2, 3, 5, 32), 8, (1, 1, 1, 32)),      # S = 1, 1x1 tiles, odd grid
    ((1, 5, 7, 64), 32, (2, 2, 2, 32)),     # S = 2, ragged
    ((1, 6, 6, 40), 32, (4, 4, 4, 32)),     # S = 4, C = 32 + 8
    ((2, 7, 3, 48), 64, (2, 1, 8, 32)),     # S = 8, C = 32 + 16, odd
    ((1, 4, 4, 16), 16, (1, 2, 2, 64)),     # C below one chunk
    ((1, 9, 9, 64), 64, (8, 8, 8, 64)),     # R1 = 4, R2 = 2, ragged
    ((1, 3, 3, 1024), 128, (1, 1, 8, 64)),  # 1x1 tiles, deep C
]


# Forced split contract plans (th, tw, s, ch) on small inputs (n, h, w,
# c), o: every cluster size (16, the non-portable size, must launch on
# the H100), 1x1 tiles, ragged last tiles (a y2 grid no multiple of the
# tile), last tiles whose halo row and column leave the image (every
# grid here), tiles no power of two, K = 4C below one chunk and not a
# multiple of it, and every pixels-per-thread pair that occurs, (R1, R2)
# = (1, 1), (2, 1), (2, 2), (4, 1), (4, 2).
# O / S is a multiple of 8, so bfloat16 rows are whole 16-byte copies.
CONTRACT_SPLIT_EDGES = [
    ((2, 6, 10, 32), 8, (1, 1, 1, 32)),     # S = 1, 1x1 tiles, 3 x 5 grid
    ((1, 10, 14, 64), 32, (2, 2, 2, 32)),   # S = 2, ragged 5 x 7 grid
    ((1, 12, 12, 40), 32, (4, 4, 4, 64)),   # S = 4, 4C = 2.5 chunks
    ((2, 14, 6, 56), 64, (2, 1, 8, 64)),    # S = 8, 4C = 3.5 chunks
    ((1, 8, 8, 8), 16, (1, 2, 2, 64)),      # 4C below one chunk
    ((1, 16, 16, 64), 64, (4, 4, 1, 32)),   # R1 = 2, R2 = 1, full tiles
    ((1, 14, 18, 32), 64, (5, 7, 2, 32)),   # R1 = R2 = 2, 5 x 7 tiles
    ((1, 18, 18, 64), 64, (8, 8, 2, 64)),   # R1 = 4, R2 = 2, ragged 9 x 9
    ((1, 8, 36, 32), 64, (1, 16, 1, 32)),   # R1 = 4, R2 = 1, 1 x 16 tiles
    ((1, 6, 6, 1024), 128, (1, 1, 8, 64)),  # 1x1 tiles, deep C
    ((1, 8, 8, 64), 256, (2, 2, 16, 64)),   # S = 16
]

# Each op's split planner: its measured plans, 16-byte rule, cluster
# sizes, candidate plans, shared-memory mirror and route.
SPLIT_API = {
    "contract_stage": types.SimpleNamespace(
        tuned=fs._CONTRACT_SPLIT_TUNED, fits=fs._contract_split_fits,
        sizes=fs._CONTRACT_SPLIT_S, candidates=fs._contract_split_candidates,
        geometry=fs._contract_split_geometry, route=fs._contract_route),
    "expand_stage": types.SimpleNamespace(
        tuned=fs._SPLIT_TUNED, fits=fs._split_fits, sizes=fs._SPLIT_S,
        candidates=fs._split_candidates, geometry=fs._split_geometry,
        route=fs._expand_route)}


def split_refusal_check(kind):
    """C = 33 with O = 16: no 16-byte copies fit, so the planner keeps
    the stage tiled and a forced split launch raises."""
    api = SPLIT_API[kind]
    shape = (1, 5, 3, 33) if kind == "expand_stage" else (1, 6, 10, 33)
    recs = []
    for dtype in (torch.float32, torch.bfloat16):
        args = random_stage(*shape, 16, dtype, 150)
        item = args[0].element_size()
        fit = [api.fits(33, 16, s, item) for s in api.sizes]
        try:
            fs._launch(kind, *args, 0.3, True, split=(1, 1, 1, 32))
            raised = ""
        except RuntimeError as e:
            raised = str(e)
        ok = not any(fit) and bool(raised) and api.route(
            args[0], args[1], args[3], 33, 16) is None
        emit(check="split_refuses_c33", kernel=kind, dtype=str(dtype)[6:],
             fits=fit, raised=raised, ok=ok)
        recs.append({"ok": ok})
        recs.append(check_stage(kind, args, label="edge_c33"))
    return recs


def split_flagship_checks(kind):
    """The split kernel of `kind` at every flagship shape of that kind,
    bs 1 and 4, both dtypes and slopes, at its measured plan, with its
    per-phase clocks; both routes timed at both batch sizes."""
    recs = []
    tuned = SPLIT_API[kind].tuned
    for i, (k, c, o, h) in enumerate(FLAGSHIP_STAGES):
        if k != kind:
            continue
        for n in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                args = random_stage(n, h, h, c, o, dtype, 40 + i)
                best = tuned.get((n, h, h, c, o, args[0].element_size()))
                if best is None:
                    emit(check="split_not_routed", kernel=kind,
                         x=[n, h, h, c], o=o, dtype=str(dtype)[6:],
                         note="no split plan measured faster than the "
                              "tiled kernel, or O / S cannot be whole "
                              "16-byte copies")
                    continue
                for slope in (0.3, 0.0):
                    recs.append(check_stage(kind, args, slope, split=best,
                                            timing=slope == 0.3,
                                            label="split_bs%d" % n))
                # Where a launch's cycles go, per phase (not gated).
                emit(phase="split_clocks", kernel=kind, x=[n, h, h, c], o=o,
                     dtype=str(dtype)[6:], plan=list(best),
                     **split_clocks(kind, args, best))
                recs.append(check_stage(kind, args,
                                        plan=_tiled_plan(kind, args[0], o),
                                        timing=True, time_refs=False,
                                        label="tiled_bs%d" % n))
    return recs


def smem_mirror_checks():
    """The libraries' shared-memory and thread-item arithmetic matches
    the planner's: the tiled plan of every flagship stage, and every
    split candidate of every flagship and recipe stage (bs 1 and 4)."""
    recs = []
    lib = fs._lib()
    for kind, c, o, h in FLAGSHIP_STAGES:
        for item in (2, 4):
            plan = fs._plan(kind == "contract_stage", 1, h, h, c, o, item)
            got = lib.nlt_stage_smem_bytes(int(kind == "contract_stage"),
                                           plan[0], plan[1], o, plan[2],
                                           plan[3], item)
            want = fs._smem_bytes(kind == "contract_stage", *plan[:2], o,
                                  *plan[2:], item)
            if got != want:
                recs.append({"ok": False})
                emit(check="smem_mirror", kernel=kind, c=c, o=o,
                     got=got, want=want, ok=False)
    checked = 0
    for kind, n, c, o, h in sweep_shapes():
        api, slib = SPLIT_API[kind], fs._split_lib(kind)
        for item in (2, 4):
            for th, tw, s, ch in api.candidates(n, h, h, c, o, item):
                got = (slib.smem_bytes(th, tw, o, s, ch, item),
                       slib.items(th, tw, o, s, ch, item, 1),
                       slib.items(th, tw, o, s, ch, item, 2))
                want = api.geometry(th, tw, o, s, ch, item)
                checked += 1
                if tuple(got) != tuple(want):
                    recs.append({"ok": False})
                    emit(check="split_smem_mirror", kernel=kind, c=c, o=o,
                         plan=[th, tw, s, ch], item=item, got=got,
                         want=want, ok=False)
    emit(check="split_smem_mirror", candidates=checked,
         ok=all(r["ok"] for r in recs))
    return recs


def recipe_checks():
    """Both stage kernels at every stage shape of the other recipes'
    U-Nets (RECIPE_STAGES), on whatever route each takes: the recipe's
    compute dtype timed beside cuDNN, the other dtype checked."""
    recs = []
    for recipe, (n, dname, stages) in RECIPE_STAGES.items():
        main = getattr(torch, dname)
        other = torch.float32 if main == torch.bfloat16 else torch.bfloat16
        for i, (kind, c, o, h) in enumerate(stages):
            for dtype in (main, other):
                args = random_stage(n, h, h, c, o, dtype, 400 + i)
                recs.append(check_stage(kind, args, timing=dtype is main,
                                        label="recipe_" + recipe))
                del args
    return recs


def kernel_phase():
    recs = []
    for i, (kind, shape, o, plan) in enumerate(EDGE_STAGES):
        for dtype in (torch.float32, torch.bfloat16):
            for slope in (0.3, 0.0):
                args = random_stage(*shape, o, dtype, 100 + i)
                recs.append(check_stage(kind, args, slope, plan=plan,
                                        label="edge"))
    for kind, edges, seed in (("expand_stage", SPLIT_EDGES, 120),
                              ("contract_stage", CONTRACT_SPLIT_EDGES, 160)):
        for i, (shape, o, split) in enumerate(edges):
            for dtype in (torch.float32, torch.bfloat16):
                for slope in (0.3, 0.0):
                    args = random_stage(*shape, o, dtype, seed + i)
                    recs.append(check_stage(kind, args, slope, split=split,
                                            label="split_edge"))
        recs += split_refusal_check(kind)
    for i, (kind, c, o, h) in enumerate(FLAGSHIP_STAGES):
        for dtype in (torch.bfloat16, torch.float32):
            args = random_stage(1, h, h, c, o, dtype, i)
            recs.append(check_stage(kind, args, timing=True,
                                    label="flagship_bs1"))
    recs += split_flagship_checks("expand_stage")
    recs += split_flagship_checks("contract_stage")
    recs += smem_mirror_checks()
    recs += recipe_checks()
    return all(r["ok"] for r in recs)


def split_clocks(kind, args, split, slope=0.3):
    """Per-phase clocks of one split launch (the library's clocks entry,
    nlt_<kind>_split_clocks: thread 0 of every block), averaged over
    the blocks: cycles of the prologue, phase 1 (and of it the wait for
    chunks and the issue of chunk copies), the y1 epilogue and first
    cluster barrier, the exchange and second barrier, phase 2 (and its
    wait and issue); ns per cycle from the blocks' global timer; the
    spread of the blocks' start times."""
    x, w1 = args[0], args[1]
    n, h, w, c = x.shape
    o = w1.shape[3]
    th, tw, s, ch = split
    if kind == "contract_stage":
        gh, gw, oh, ow = h // 2, w // 2, h // 2, w // 2
    else:
        gh, gw, oh, ow = h, w, 2 * h, 2 * w
    blocks = n * s * -(-gh // th) * -(-gw // tw)
    clk = torch.zeros((blocks, 12), dtype=torch.int64, device=x.device)
    y2 = torch.empty((n, oh, ow, o), dtype=x.dtype, device=x.device)
    lib = fs._split_lib(kind)
    err = lib.clocks(
        *[t.data_ptr() for t in args], y2.data_ptr(), None, n, h, w, c, o,
        *split, float(slope), int(x.dtype == torch.bfloat16),
        clk.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err != 0:
        return {"error": lib.error_string(err).decode()}
    k = clk.double().cpu()
    cyc = k[:, 6] - k[:, 1]
    parts = {"prologue": k[:, 2] - k[:, 1], "phase1": k[:, 3] - k[:, 2],
             "phase1_wait": k[:, 7], "phase1_issue": k[:, 10],
             "y1_epilogue_barrier1": k[:, 4] - k[:, 3],
             "exchange_barrier2": k[:, 5] - k[:, 4],
             "phase2": k[:, 6] - k[:, 5], "phase2_wait": k[:, 8],
             "phase2_issue": k[:, 11]}
    ns_per_cycle = float(((k[:, 9] - k[:, 0]) / cyc.clamp_min(1)).mean())
    return {"blocks": blocks, "cycles": float(cyc.mean()),
            "ns_per_cycle": ns_per_cycle,
            "mean_cycles": {p: float(v.mean()) for p, v in parts.items()},
            "block_start_spread_ns": float(k[:, 0].max() - k[:, 0].min()),
            "kernel_span_ns": float(k[:, 9].max() - k[:, 0].min())}


def sweep_shapes():
    """(kind, n, C, O, input H = W) of every flagship stage at bs 1 and 4
    and every recipe stage at its recipe's batch size, each once."""
    out = [(kind, n, c, o, h) for kind, c, o, h in FLAGSHIP_STAGES
           for n in (1, 4)]
    out += [(kind, n, c, o, h) for n, _, stages in RECIPE_STAGES.values()
            for kind, c, o, h in stages]
    return list(dict.fromkeys(out))


def split_sweep(out_dir):
    """Every split plan of both ops at every flagship shape (bs 1 and 4)
    and every recipe shape, float32 and bfloat16: checked against the
    plain version and the tiled kernel, and timed; the tiled route timed
    beside it. A launch the card refuses is recorded as such."""
    os.makedirs(out_dir, exist_ok=True)
    ok = True
    with open(os.path.join(out_dir, "split_sweep.jsonl"), "w") as fh:
        for i, (kind, n, c, o, h) in enumerate(sweep_shapes()):
            ref = fs.contract_stage_ref if kind == "contract_stage" \
                else fs.expand_stage_ref
            for dtype in (torch.float32, torch.bfloat16):
                item = 4 if dtype == torch.float32 else 2
                plans = SPLIT_API[kind].candidates(n, h, h, c, o, item)
                if not plans:
                    continue
                args = random_stage(n, h, h, c, o, dtype, 60 + i)
                with torch.no_grad():
                    y2p, y1p = ref(*args, 0.3)
                    tiled = _tiled_plan(kind, args[0], o)
                    y2t, y1t = fs._launch(kind, *args, 0.3, True, plan=tiled)
                    t_ms = time_ms(lambda: fs._launch(
                        kind, *args, 0.3, False, plan=tiled), 10, 3)
                    scale = max(1.0, float(y2p.float().abs().max()))
                    rows = []
                    for sp in plans:
                        r = {"kernel": kind, "x": [n, h, h, c], "o": o,
                             "dtype": str(dtype)[6:], "plan": list(sp)}
                        try:
                            y2k, y1k = fs._launch(kind, *args, 0.3, True,
                                                  split=sp)
                            torch.cuda.synchronize()
                        except RuntimeError as e:
                            r.update(refused=str(e), ok=True)
                            fh.write(json.dumps(r) + "\n")
                            continue
                        err = max(float((y2k.float() - y2p.float())
                                        .abs().max()),
                                  float((y1k.float() - y1p.float())
                                        .abs().max()))
                        r.update(ms=time_ms(lambda: fs._launch(
                            kind, *args, 0.3, False, split=sp), 10, 3),
                            equal_to_tiled=bool(torch.equal(y2k, y2t)
                                                and torch.equal(y1k, y1t)),
                            max_abs_err=err,
                            ok=err <= KERNEL_TOL[dtype] * scale)
                        ok &= r["ok"]
                        rows.append(r)
                        fh.write(json.dumps(r) + "\n")
                del args, y2p, y1p, y2t, y1t
                if not rows:
                    continue
                best = min(rows, key=lambda r: r["ms"])
                tuned = SPLIT_API[kind].tuned.get((n, h, h, c, o, item))
                emit(phase="split_sweep", kernel=kind, x=[n, h, h, c], o=o,
                     dtype=str(dtype)[6:], plans=len(plans),
                     launched=len(rows), tiled_plan=list(tiled),
                     tiled_ms=t_ms, best_plan=best["plan"],
                     best_ms=best["ms"], split_wins=best["ms"] < t_ms,
                     tuned_plan=tuned and list(tuned),
                     tuned_ms=next((r["ms"] for r in rows
                                    if tuple(r["plan"]) == tuned), None),
                     all_equal_to_tiled=all(r["equal_to_tiled"]
                                            for r in rows),
                     ok=all(r["ok"] for r in rows))
    return ok


def capture_stage_inputs(server, req):
    """The fused-stage calls of one request, with copies of their
    inputs, in order: [(kind, args)]. Not counted as main-path work."""
    seen = []
    orig = {k: getattr(fs, k) for k in ("contract_stage", "expand_stage")}

    def recorder(kind):
        def op(x, w1, b1, w2, b2, slope=0.3, return_y1=False):
            seen.append((kind, [t.clone() for t in (x, w1, b1, w2, b2)]))
            return orig[kind](x, w1, b1, w2, b2, slope, return_y1)
        return op

    try:
        for k in orig:
            setattr(fs, k, recorder(k))
        server.predict(req)
    finally:
        for k, v in orig.items():
            setattr(fs, k, v)
    return seen


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _category(name):
    if "contract_kernel" in name or "contract_split_kernel" in name:
        return "contract_stage kernel"
    if "expand_kernel" in name or "expand_split_kernel" in name:
        return "expand_stage kernel"
    if "Memcpy HtoD" in name or "Memcpy DtoH" in name:
        return name.split(" (")[0].lower()
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "matmul (1x1 convs)"
    if "gather" in name.lower() or "index" in name.lower():
        return "gather (resample)"
    return "other elementwise/copy"


def profile_requests(server, req, n=3, label="", ids=None):
    """Device time per request by category, from torch.profiler over n
    requests of the main path (from the device input cache if `ids`);
    the busy share is device time over the requests' wall time. Returns
    {category: ms per request} (empty when no device time was traced)."""
    from torch.profiler import ProfilerActivity, profile

    def request():
        return server.predict(req) if ids is None else server.predict(
            req, ids=ids)

    request()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            request()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    cats, total = {}, 0.0
    for ev in prof.key_averages():
        # Kernels and copies only: a CPU op's device time repeats theirs.
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        cat = _category(ev.key)
        cats[cat] = cats.get(cat, 0.0) + dev_us / 1e3 / n
        total += dev_us / 1e3 / n
    if total == 0:
        emit(phase="profile", label=label, wall_ms_per_request=wall_ms,
             device_ms_per_request="not measured",
             note="torch.profiler recorded no device time")
        return {}
    emit(phase="profile", label=label, bs=int(req["base"].shape[0]),
         wall_ms_per_request=wall_ms, device_ms_per_request=total,
         device_busy_share=total / wall_ms,
         by_category_ms=dict(sorted(cats.items(), key=lambda kv: -kv[1])))
    return cats


def compare_predict(a, b, reqs, f32_tol, lsb_tol, label):
    """Server a (kernels) against server b (plain) on the same requests:
    float outputs with pack=None, uint8 outputs with pack='uint8'."""
    worst_f, worst_q, ok = 0.0, 0, True
    for req in reqs:
        for pack in (None, "uint8"):
            a.pack = b.pack = pack
            oa, ob = a.predict(req), b.predict(req)
            for k in ob:
                ok &= oa[k].shape == ob[k].shape and oa[k].dtype == ob[k].dtype
                if pack is None:
                    ok &= bool(np.isfinite(oa[k]).all())
                    worst_f = max(worst_f, float(np.abs(oa[k] - ob[k]).max()))
                else:
                    worst_q = max(worst_q, int(np.abs(
                        oa[k].astype(int) - ob[k].astype(int)).max()))
    a.pack = b.pack = "uint8"
    ok &= worst_f <= f32_tol and worst_q <= lsb_tol
    emit(check="predict_kernels_vs_plain", label=label,
         max_abs_err=worst_f, tol=f32_tol, max_lsb=worst_q,
         lsb_tol=lsb_tol, ok=bool(ok))
    return bool(ok)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def train_cfg(compute_dtype="bfloat16"):
    """nlt_tpu/config/dragon_specular.ini's model, loss and optimizer keys
    (the flagship training recipe)."""
    return Config({
        "dataset": "nlt", "model": "nlt", "loss": "barron,1e+0lpips",
        "lpips_weights": "none", "lpips_cache_gt": True,
        "lr": "1e-3", "mgm": "-1", "bs": TRAIN_BS,
        "imh": RES, "imw": RES, "uvh": RES, "uvw": RES,
        "use_obs": True, "skip_connect_base": True, "linear_space": False,
        "depth0": 16, "depth": DEPTH, "kernel": 2, "stride": 2,
        "norm": "None", "act": "leakyrelu", "pool": "None",
        "compute_dtype": compute_dtype})


def scatter_plan(r, w, upd_addr, out_addr):
    """K1's launch plan from the library (csrc/scatter.cu's make_plan),
    as a dict of sc.PLAN_KEYS."""
    out = (ctypes.c_int * len(sc.PLAN_KEYS))()
    sc._lib().nlt_scatter_plan(r, w, upd_addr, out_addr, out)
    return dict(zip(sc.PLAN_KEYS, out))


def check_scatter(idx, upd, n_rows, label, exact=False, timing=False,
                  out_offset=None):
    """K1 against scatter_add_rows_ref on the same inputs, through the
    wrapper (or, with out_offset, through its launch into a table whose
    base lies out_offset floats into a fresh buffer); the plan the
    library took, held against its Python mirror. With timing, also
    kernel, plain and index_add_ times, the bound, and the op's two
    parts alone: the table's memset and the kernel on a zeroed table."""
    idx32 = idx.to(torch.int32).contiguous()
    r, w = upd.shape
    with torch.no_grad():
        before = sc.LAUNCHES["scatter_add_rows"]
        if out_offset is None:
            got = sc.scatter_add_rows(idx32, upd, n_rows)
        else:
            buf = torch.full((out_offset + n_rows * w,), float("nan"),
                             device=upd.device)
            got = sc._launch(idx32, upd, n_rows,
                             out=buf[out_offset:].view(n_rows, w))
        launched = sc.LAUNCHES["scatter_add_rows"] - before
        want = sc.scatter_add_rows_ref(idx, upd, n_rows)
        torch.cuda.synchronize()
        err = float((got - want).abs().max()) if got.numel() else 0.0
        scale = max([1.0] + ([float(want.abs().max())] if want.numel()
                             else []))
        ok = launched == 1 and bool(torch.isfinite(got).all()) and (
            bool(torch.equal(got, want)) if exact
            else err <= SCATTER_TOL * scale)
    plan = scatter_plan(r, w, upd.data_ptr(), got.data_ptr())
    mirror = sc.launch_plan(r, w, upd.data_ptr(), got.data_ptr())
    ok &= plan == mirror
    live = int(((idx >= 0) & (idx < n_rows)).sum())
    rec = {"check": "kernel_vs_plain", "kernel": "scatter_add_rows",
           "label": label, "rows": r, "w": w, "n_rows": n_rows,
           "live_rows": live, "exact_required": exact, "launched": launched,
           "path": "float4" if plan["wv"] else "scalar", "plan": plan,
           "plan_equals_mirror": plan == mirror, "max_abs_err": err,
           "tol": 0.0 if exact else SCATTER_TOL * scale, "ok": ok}
    if timing:
        rows = torch.where((idx >= 0) & (idx < n_rows), idx.long(), n_rows)
        rec["ms"] = time_ms(lambda: sc.scatter_add_rows(idx32, upd, n_rows))
        rec["plain_ms"] = time_ms(
            lambda: sc.scatter_add_rows_ref(idx, upd, n_rows))
        rec["library_ms"] = time_ms(lambda: torch.zeros(
            (n_rows + 1, w), device=upd.device).index_add_(0, rows, upd))
        table = torch.zeros((n_rows, w), device=upd.device)
        lib = sc._lib()
        # The kernel alone also with every row folded into the table's
        # first quarter (a quarter of the bytes, which stays in L2): what
        # the table's trips to device memory cost the kernel.
        folded = torch.where(idx32 >= 0, idx32 % max(1, n_rows // 4),
                             idx32).to(torch.int32)
        for part, ix, key in ((1, idx32, "memset_ms"),
                              (2, idx32, "kernel_only_ms"),
                              (2, folded, "kernel_only_quarter_table_ms")):
            rec[key] = time_ms(lambda: lib.nlt_scatter_add_rows_parts(
                ix.data_ptr(), upd.data_ptr(), table.data_ptr(), r, w,
                n_rows, part, torch.cuda.current_stream().cuda_stream))
        # Each input read once (the index of every update, the values of
        # the live ones), the table written once.
        nbytes = 4 * r + 4 * w * live + 4 * w * n_rows
        rec["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        rec["bound_by"] = "bytes"
        rec["memset_bound_ms"] = 4 * w * n_rows / HBM_BYTES_PER_S * 1e3
    emit(**rec)
    return rec


def scatter_phase():
    """K1 at the flagship training shape (4 x 512^2 rows of 12 floats),
    at forced edge cases, and on both paths of the kernel: W in 1, 3, 5,
    12, 16 with the op's own table (float4 path where W % 4 == 0) and
    with a table one float off a 16-byte boundary (scalar path), updates
    off a boundary, all updates dead, all updates on one row; then the
    library's launch plan against its mirror over a sweep of shapes and
    alignments."""
    g = torch.Generator(device="cuda").manual_seed(7)
    recs = []
    n_rows = TRAIN_BS * RES * RES
    idx = torch.randint(0, n_rows, (n_rows,), generator=g, device="cuda")
    idx[torch.rand(n_rows, generator=g, device="cuda") < 0.5] = -1
    upd = torch.rand((n_rows, 12), generator=g, device="cuda")
    recs.append(check_scatter(idx, upd, n_rows, "flagship_dup_dead"))
    perm = torch.randperm(n_rows, generator=g, device="cuda")
    recs.append(check_scatter(perm, upd, n_rows, "flagship_disjoint",
                              exact=True))
    for r, w, nr, dead in [(1000, 1, 300, 0.2), (257, 3, 64, 0.0),
                           (12345, 12, 777, 0.5), (4096, 12, 100, 1.0),
                           (1, 5, 1, 0.0)]:
        i = torch.randint(0, nr, (r,), generator=g, device="cuda")
        i[torch.rand(r, generator=g, device="cuda") < dead] = -1
        u = torch.randn((r, w), generator=g, device="cuda")
        recs.append(check_scatter(i, u, nr, "edge_r%d_w%d" % (r, w)))
    for w in (1, 3, 5, 12, 16):
        i = torch.randint(0, 500, (3000,), generator=g, device="cuda")
        i[torch.rand(3000, generator=g, device="cuda") < 0.3] = -1
        u = torch.randn((3000, w), generator=g, device="cuda")
        recs.append(check_scatter(i, u, 500, "w%d" % w))
        recs.append(check_scatter(i, u, 500, "w%d_table_offset" % w,
                                  out_offset=1))
        ok = recs[-2]["path"] == ("float4" if w % 4 == 0 else "scalar") \
            and recs[-1]["path"] == "scalar"
        recs.append({"ok": ok})
        uoff = torch.empty(1 + 3000 * w, device="cuda")[1:].view(3000, w)
        uoff.copy_(u)
        recs.append(check_scatter(i, uoff, 500, "w%d_upd_offset" % w))
        recs.append({"ok": recs[-1]["path"] == "scalar"})
    dead = torch.where(torch.rand(2048, generator=g, device="cuda") < 0.5,
                       -1, 600).to(torch.int32)
    recs.append(check_scatter(dead, torch.randn((2048, 12), generator=g,
                                                device="cuda"),
                              600, "all_dead", exact=True))
    # 64 positive updates on one row: float sums in any order are within
    # 63 roundings of the total, 3.8e-6 of it, inside SCATTER_TOL.
    for w in (12, 5):
        recs.append(check_scatter(
            torch.full((64,), 3, device="cuda"),
            torch.rand((64, w), generator=g, device="cuda"), 10,
            "all_duplicate_w%d" % w))
    checked, bad = 0, 0
    for r in (1, 255, 256, 257, 1 << 20, 3 << 22):
        for w in range(1, 21):
            for ua in (0, 4, 8):
                for oa in (0, 4):
                    a, b = (1 << 30) + ua, (1 << 31) + oa
                    checked += 1
                    bad += scatter_plan(r, w, a, b) != \
                        sc.launch_plan(r, w, a, b)
    emit(check="scatter_plan_mirror", plans=checked, mismatches=bad,
         ok=bad == 0)
    recs.append({"ok": bad == 0})
    return all(r["ok"] for r in recs)


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def check_stage_grad(kind, shape, o, dtype, seed):
    """Gradients of every input through the kernel forward (ContractStage
    / ExpandStage) against autograd of the plain forward."""
    args = random_stage(*shape, o, dtype, seed)
    ref = fs.contract_stage_ref if kind == "contract_stage" \
        else fs.expand_stage_ref
    tk = [a.clone().requires_grad_() for a in args]
    yk = getattr(fs, kind)(*tk)
    g = torch.randn(yk.shape, generator=torch.Generator().manual_seed(seed))
    g = g.to("cuda", dtype)
    yk.backward(g)
    tp = [a.clone().requires_grad_() for a in args]
    ref(*tp)[0].backward(g)
    torch.cuda.synchronize()
    errs = [_rel_l2(a.grad, b.grad) for a, b in zip(tk, tp)]
    ok = all(bool(torch.isfinite(a.grad).all()) and a.grad.dtype == dtype
             for a in tk) and max(errs) <= GRAD_TOL[dtype]
    emit(check="stage_grad_kernel_vs_plain", kernel=kind, x=list(shape),
         o=o, dtype=str(dtype)[6:], metric="rel_l2",
         errs_dx_dw1_db1_dw2_db2=errs, tol=GRAD_TOL[dtype], ok=ok)
    return ok


def _direct(kind):
    """The stage op's inference call as a bare ctypes launch."""
    def launch(x, w1, b1, w2, b2, slope):
        fs._check(kind, x, w1, b1, w2, b2)
        return fs._launch(kind, x, w1, b1, w2, b2, slope, False)
    return launch


_PROBE_LIB = []


def _probe_ops():
    """The two stage launches registered a second way, for timing only:
    torch.library.Library.define + impl (a Python kernel behind the C++
    dispatcher, none of custom_op's Python layers)."""
    if not _PROBE_LIB:
        lib = torch.library.Library("nlt_smoke_probe", "DEF")
        for kind in fs.OPS:
            lib.define(kind + "(Tensor x, Tensor w1, Tensor b1, Tensor w2, "
                       "Tensor b2, float slope) -> Tensor")
            lib.impl(kind, _direct(kind), "CUDA")
        _PROBE_LIB.append(lib)
    return {k: getattr(torch.ops.nlt_smoke_probe, k).default
            for k in fs.OPS}


@contextlib.contextmanager
def stage_dispatch(how):
    """'direct': the stage ops' inference calls launch through ctypes
    without the torch.library dispatcher (the path before the ops were
    registered); 'op': the registered custom ops (the port's path);
    'library': the same launch registered with Library.define + impl."""
    orig = dict(fs.OPS)
    if how == "direct":
        fs.OPS.update({kind: _direct(kind) for kind in orig})
    elif how == "library":
        fs.OPS.update(_probe_ops())
    try:
        yield
    finally:
        fs.OPS.update(orig)


@contextlib.contextmanager
def plain_ops():
    """The three ops' entries swapped for their plain versions (autograd
    of the plain stages; index_add_ for the scatter)."""
    orig = (fs.contract_stage, fs.expand_stage, sc.scatter_add_rows)

    def plain(ref):
        def op(x, w1, b1, w2, b2, slope=0.3, return_y1=False):
            y2, y1 = ref(x, w1, b1, w2, b2, slope)
            return (y2, y1) if return_y1 else y2
        return op

    fs.contract_stage = plain(fs.contract_stage_ref)
    fs.expand_stage = plain(fs.expand_stage_ref)
    sc.scatter_add_rows = sc.scatter_add_rows_ref
    try:
        yield
    finally:
        fs.contract_stage, fs.expand_stage, sc.scatter_add_rows = orig


def _train_batch(seed):
    return {k: torch.from_numpy(v).to("cuda")
            for k, v in make_batch(TRAIN_BS, RES, seed).items()}


def _launches():
    return dict(fs.LAUNCHES, **sc.LAUNCHES, **cs.LAUNCHES)


def _reset_launches():
    fs.reset_launches()
    sc.reset_launches()
    cs.reset_launches()


def _grads(mu):
    """The gradient of a first step from a fresh state, from the first
    moment (tree) it left in AMSGrad: mu = (1 - b1) g."""
    return [m / (1 - train_mod.B1) for m in tree_leaves(mu)]


def _train_category(name):
    for cat, keys in (("stage backward", ("ContractStageBackward",
                                          "ExpandStageBackward")),
                      ("LPIPS convolutions", ("convolution",)),
                      ("optimizer", ("nlt::optimizer",)),
                      ("Barron/wavelet forward", ("nlt::barron",)),
                      ("LPIPS forward, rest", ("nlt::lpips",))):
        if any(k in name for k in keys):
            return cat
    return None


def profile_train_step(step, state, batch, statics, label="barron_lpips"):
    """Device time of one step by category (torch.profiler). The three
    kernels are found by name; every other kernel goes to the first
    profiler range above the op that launched it that names a category
    (the autograd node of a stage backward, a convolution op, the
    optimizer's and the losses' ranges), else to 'other'."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, statics)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    named = {"contract_kernel": "fused forward (K2)",
             "contract_split_kernel": "fused forward (K2)",
             "expand_kernel": "fused forward (K3)",
             "expand_split_kernel": "fused forward (K3)",
             "scatter_add_rows_kernel": "resample backward scatter (K1)"}
    cats, total, rest, by_name = {}, 0.0, {}, {}
    for ev in prof.key_averages():
        # Device events only; the losses' and optimizer's ranges show up
        # there too, as GPU spans over their kernels: not added.
        if not str(getattr(ev, "device_type", "")).endswith("CUDA") \
                or ev.key.startswith("nlt::"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        total += dev_us / 1e3
        by_name[ev.key[:70]] = by_name.get(ev.key[:70], 0.0) + dev_us / 1e3
        for key, cat in named.items():
            if key in ev.key:
                cats[cat] = cats.get(cat, 0.0) + dev_us / 1e3
    for ev in prof.events():
        for k in getattr(ev, "kernels", []):
            if any(key in k.name for key in named):
                continue
            node, cat = ev, None
            while node is not None and cat is None:
                cat = _train_category(node.name)
                node = node.cpu_parent
            if cat is not None:
                cats[cat] = cats.get(cat, 0.0) + k.duration / 1e3
            else:
                key = "%s <- %s" % (k.name[:60], ev.name)
                rest[key] = rest.get(key, 0.0) + k.duration / 1e3
    if total == 0:
        emit(phase="train_profile", label=label, wall_ms_per_step=wall_ms,
             device_ms_per_step="not measured",
             note="torch.profiler recorded no device time")
        return
    cats["other (loss backward, resample, elementwise, copies)"] = max(
        0.0, total - sum(cats.values()))
    emit(phase="train_profile", label=label, bs=TRAIN_BS,
         wall_ms_per_step=wall_ms,
         device_ms_per_step=total, host_idle_share=1 - total / wall_ms,
         by_category_ms=dict(sorted(cats.items(), key=lambda kv: -kv[1])),
         top_other_kernels_ms=dict(sorted(
             rest.items(), key=lambda kv: -kv[1])[:15]),
         top_device_events_ms=dict(sorted(
             by_name.items(), key=lambda kv: -kv[1])[:15]))


def compare_steps(label, state, batches, statics, model, tx, f32):
    """The same steps through the kernels and through the plain versions
    of the three ops; returns (ok, kernel grads, plain grads)."""
    step = train_mod.make_train_step(model, tx, cached_statics=True,
                                     with_vis=False)
    runs = {}
    for path in ("kernels", "plain"):
        ctx = plain_ops() if path == "plain" else contextlib.nullcontext()
        with ctx:
            s, losses, first = state, [], None
            for b, st in zip(batches, statics):
                s, loss = step(s, b, st)
                losses.append(float(loss))
                first = first or s
            torch.cuda.synchronize()
        runs[path] = (losses, first)
    (lk, sk), (lp, sp) = runs["kernels"], runs["plain"]
    gk, gp = _grads(sk["opt_state"]["mu"]), _grads(sp["opt_state"]["mu"])
    grad_rel = _rel_l2(torch.cat([a.flatten() for a in gk]),
                       torch.cat([b.flatten() for b in gp]))
    leaf_rel = max(_rel_l2(a, b) for a, b in zip(gk, gp) if b.any())
    # Params after one AMSGrad step, lr * g / (|g| + eps) per entry: a
    # gradient entry that changes sign (a tiny one, or one moved by a
    # mask flip) moves its param by up to 2 lr, and one near eps moves
    # with its rounding; every other entry agrees to float32 rounding.
    # Count the entries with |g| >= 1e-6 that moved by more than 1e-6.
    moved = total = 0
    worst_param = 0.0
    for pa, pb, g in zip(tree_leaves(sk["params"]["net"]),
                         tree_leaves(sp["params"]["net"]),
                         _grads(sp["opt_state"]["mu"]["net"])):
        d = (pa - pb).abs()
        # |g| >= 100 eps: the step is within 1% of lr * sign(g) there
        # and rounding cannot move it; smaller entries may.
        firm = g.abs() >= 1e-6
        moved += int((d[firm] > 1e-6).sum())
        total += int(firm.sum())
        worst_param = max(worst_param, float(d.max()))
    ok = all(np.isfinite(lk))
    if f32:
        # Loss to 1e-4 (1e-3 after the updates); gradients to 1e-4
        # relative L2 over all leaves and 1e-2 per leaf (a bias gradient
        # sums entries, among them any moved by a mask flip); params
        # within a sign flip (2 lr), and at most 1e-3 of the counted
        # ones moved.
        ok &= abs(lk[0] - lp[0]) <= 1e-4 * abs(lp[0])
        ok &= all(abs(a - b) <= 1e-3 * abs(b) for a, b in zip(lk, lp))
        ok &= grad_rel <= 1e-4 and leaf_rel <= 1e-2
        ok &= worst_param <= 2e-3 + 1e-6 and moved <= 1e-3 * total
    else:
        # bf16: the two paths round the U-Net at other points (the stage
        # checks' 2^-3 per gradient), which averages out over a step's
        # gradients: loss to 1e-2, gradients to 1e-2 relative L2 over
        # all leaves; params within a sign flip (2 lr).
        ok &= all(abs(a - b) <= 1e-2 * abs(b) for a, b in zip(lk, lp))
        ok &= grad_rel <= 1e-2 and worst_param <= 2e-3 + 1e-6
    emit(check="train_step_kernels_vs_plain", label=label,
         loss_kernels=lk, loss_plain=lp, grad_rel_l2=grad_rel,
         worst_leaf_grad_rel_l2=leaf_rel, firm_params_moved=moved,
         firm_params=total, worst_param_abs=worst_param, ok=bool(ok))
    return bool(ok), gk, gp


def time_paths(model, tx, state, batches, statics, rounds=3):
    """Step time through the kernels and through the plain versions of
    the three ops, in turns (kernels, plain, kernels, plain, ...)."""
    step = train_mod.make_train_step(model, tx, cached_statics=True,
                                     with_vis=False)
    times = {"kernels": [], "plain": []}
    for i in range(rounds):
        for path in ("kernels", "plain"):
            ctx = plain_ops() if path == "plain" else contextlib.nullcontext()
            b, st = batches[i % len(batches)], statics[i % len(statics)]
            with ctx:
                torch.cuda.synchronize()
                t = time.perf_counter()
                step(state, b, st)
                torch.cuda.synchronize()
            times[path].append((time.perf_counter() - t) * 1e3)
    emit(phase="train_paths_timing", bs=TRAIN_BS, step_ms=times,
         median_ms={k: float(np.median(v)) for k, v in times.items()})


def train_phase():
    """Returns (ok, {kernel: main-path records}, launches)."""
    ok = True
    t0 = time.perf_counter()
    ok &= scatter_phase()
    for i, (kind, c, o, h) in enumerate(FLAGSHIP_STAGES):
        for dtype in (torch.float32, torch.bfloat16):
            ok &= check_stage_grad(kind, (TRAIN_BS, h, h, c), o, dtype,
                                   200 + i)
    emit(phase="train_kernel_checks", ok=bool(ok),
         seconds=time.perf_counter() - t0)

    # The main path: the flagship recipe's steps, counters reset.
    t0 = time.perf_counter()
    os.environ["NLT_TPU_FUSED_STAGE"] = "1"
    model = Model(train_cfg("bfloat16"), device="cuda")
    tx = train_mod.make_optimizer(model.config.get_float("lr"),
                                  model.config.get_float("mgm"))
    state0 = train_mod.init_state(model, tx, torch.Generator().manual_seed(0))
    extract = train_mod.make_static_extractor(model)
    batches = [_train_batch(30 + i) for i in range(TRAIN_STEPS + 1)]
    statics = [extract(state0["params"], b) for b in batches]
    step = train_mod.make_train_step(model, tx, cached_statics=True,
                                     with_vis=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    state, times, per_step, losses = state0, [], [], []
    for b, st in zip(batches, statics):
        before = _launches()
        t = time.perf_counter()
        state, loss = step(state, b, st)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(loss))
        per_step.append({k: v - before[k] for k, v in _launches().items()})
    launches = _launches()
    step_ok = (all(p == TRAIN_LAUNCHES for p in per_step)
               and all(np.isfinite(losses)) and int(state["step"]) ==
               len(batches))
    emit(phase="train", bs=TRAIN_BS, steps=len(batches), launches=launches,
         per_step=per_step[0], all_steps_12_6_1=step_ok, losses=losses,
         warmup_ms=times[0], step_ms=times[1:],
         median_ms_per_step=float(np.median(times[1:])),
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t0, ok=bool(step_ok))
    ok &= step_ok

    profile_train_step(step, state, batches[0], statics[0])
    time_paths(model, tx, state, batches, statics)

    # K1's inputs on the main path (one step, not counted): its record in
    # the kernels line.
    seen = []
    orig = sc.scatter_add_rows

    def recorder(idx, upd, n_rows):
        seen.append((idx.clone(), upd.clone(), n_rows))
        return orig(idx, upd, n_rows)

    sc.scatter_add_rows = recorder
    try:
        step(state, batches[0], statics[0])
    finally:
        sc.scatter_add_rows = orig
    main_recs = [check_scatter(*a, label="main_path", timing=True)
                 for a in seen]
    ok &= bool(main_recs) and all(r["ok"] for r in main_recs)

    # The same steps through the plain versions of the three ops.
    ok_b, gkb, gpb = compare_steps("bfloat16", state0, batches[:2],
                                   statics[:2], model, tx, f32=False)
    model32 = Model(train_cfg("float32"), device="cuda")
    ok_f, _, gpf = compare_steps("float32", state0, batches[:3],
                                 statics[:3], model32, tx, f32=True)
    # bf16 against float32 (same params, batch, statics): the kernels
    # path may be no further from the float32 gradient than the plain
    # path is (x1.5 + 0.01 for noise).
    flat = [torch.cat([a.flatten() for a in g]) for g in (gkb, gpb, gpf)]
    e_k, e_p = _rel_l2(flat[0], flat[2]), _rel_l2(flat[1], flat[2])
    ok_e = e_k <= 1.5 * e_p + 0.01
    emit(check="train_bf16_vs_f32_grads", kernels_rel_l2=e_k,
         plain_rel_l2=e_p, ok=bool(ok_e))
    ok &= ok_b and ok_f and ok_e
    return bool(ok), {"scatter_add_rows": main_recs}, launches


# ---------------------------------------------------------------------------
# The 2x2 stride-2 conv stage (K4)
# ---------------------------------------------------------------------------

# nlt_tpu's own shapes (conv_stage_pallas.py's docstring) at bs 4, timed.
CONV_TIMED = [(4, 512, 512, 32, 16), (4, 256, 256, 32, 32),
              (4, 128, 128, 64, 64)]
# tests/test_pallas_kernels.py's shapes, an odd C = 5 / O = 3 and a 1x1.
CONV_EDGE = [(2, 16, 32, 8, 16), (1, 64, 64, 16, 8), (3, 8, 8, 32, 32),
             (2, 6, 10, 5, 3), (1, 2, 2, 1, 1)]
# The kernel's own edges (csrc/conv_stage.cu): C in 1, 5, 33 (8-byte
# copies), 64, 128 (one to 16 K chunks) x O in 3 (one thin block), 64
# (one block), 65, 128 (two blocks along O), over several pixel tiles;
# C = 256 and 512 at O >= 64, whose w slice does not fit shared memory
# beside the ring and is walked in K slices.
CONV_CARD_EDGE = [(2, 34, 30, c, o) for c in (1, 5, 33, 64, 128)
                  for o in (3, 64, 65, 128)] + [(1, 12, 10, 256, 64),
                                                (1, 6, 4, 512, 65)]
CONV_SWEEP = [1, 3, 5, 8, 16, 32, 64, 65, 128, 256]


def conv_library(xc, wc, b, slope):
    """cuDNN's stride-2 conv on NCHW operands (permuted outside the
    timed region) and a leaky_relu."""
    f = torch.nn.functional
    return f.leaky_relu(f.conv2d(xc, wc, b, stride=2), slope)


def conv_plan(n_pix, c, o, x_addr):
    """K4's launch plan from the library (csrc/conv_stage.cu's make_plan),
    as a dict of cs.PLAN_KEYS."""
    out = (ctypes.c_int * len(cs.PLAN_KEYS))()
    cs._lib().nlt_conv_plan(n_pix, c, o, x_addr, out)
    return dict(zip(cs.PLAN_KEYS, out))


def check_conv(shape, slope, seed, timing=False, x_offset=0):
    """K4 through its wrapper against its plain version; x_offset > 0
    places x that many floats into a fresh buffer (an x off a 16-byte
    boundary takes 4- or 8-byte copies)."""
    n, h, w, c, o = shape
    g = torch.Generator().manual_seed(seed)
    lim = (6.0 / (4 * c + 4 * o)) ** 0.5
    x = torch.randn((n, h, w, c), generator=g).to("cuda")
    if x_offset:
        buf = torch.empty(x_offset + x.numel(), device="cuda")
        x = buf[x_offset:].view(n, h, w, c).copy_(x)
    wt = ((torch.rand((2, 2, c, o), generator=g) * 2 - 1) * lim).to("cuda")
    b = (torch.randn(o, generator=g) * 0.1).to("cuda")
    plan = conv_plan(n * (h // 2) * (w // 2), c, o, x.data_ptr())
    with torch.no_grad():
        # The wrapper, as a caller would call it: it must launch the
        # kernel exactly once (a plain-version stand-in launches nothing).
        before = cs.LAUNCHES["conv2x2s2_lrelu"]
        got = cs.conv2x2s2_lrelu(x, wt, b, slope)
        launched = cs.LAUNCHES["conv2x2s2_lrelu"] - before
        want = cs.conv2x2s2_lrelu_ref(x, wt, b, slope)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        ok = (launched == 1 and bool(torch.isfinite(got).all())
              and err <= CONV_TOL * scale)
    rec = {"check": "kernel_vs_plain", "kernel": "conv2x2s2_lrelu",
           "x": [n, h, w, c], "o": o, "negative_slope": slope,
           "x_offset": x_offset, "plan": plan,
           "launched": launched, "max_abs_err": err,
           "tol": CONV_TOL * scale, "ok": ok}
    if timing:
        xc = x.permute(0, 3, 1, 2).contiguous()
        wc = wt.permute(3, 2, 0, 1).contiguous()
        lib = conv_library(xc, wc, b, slope).permute(0, 2, 3, 1)
        rec["library_max_abs_err"] = float((lib - want).abs().max())
        rec["ms"] = time_ms(lambda: cs.conv2x2s2_lrelu(x, wt, b, slope))
        rec["plain_ms"] = time_ms(
            lambda: cs.conv2x2s2_lrelu_ref(x, wt, b, slope))
        rec["library_ms"] = time_ms(lambda: conv_library(xc, wc, b, slope))
        # Each input read once, the output written once; 2 flops per
        # multiply-add, float32 outside the tensor cores.
        nbytes = 4 * (x.numel() + wt.numel() + b.numel() + got.numel())
        flops = 2 * n * (h // 2) * (w // 2) * 4 * c * o
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[torch.float32] * 1e3
        rec.update(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        rec["clocks"] = conv_clocks(x, wt, b, slope)
    emit(**rec)
    return rec


def conv_clocks(x, wt, b, slope):
    """Per-phase clocks of one K4 launch (nlt_conv2x2s2_lrelu_clocks:
    thread 0 of every block), averaged over the blocks: cycles of the
    prologue (w staging and the first stages issued), of waiting for
    stages (cp.async wait and barrier), of issuing copies, of FMAs and
    of epilogues; ns per cycle from the blocks' global timer; tiles per
    block; the kernel's span."""
    n, h, w, c = x.shape
    o = wt.shape[3]
    plan = conv_plan(n * (h // 2) * (w // 2), c, o, x.data_ptr())
    clk = torch.zeros((plan["o_tiles"] * plan["pix_tiles"], 9),
                      dtype=torch.int64, device=x.device)
    y = torch.empty((n, h // 2, w // 2, o), device=x.device)
    lib = cs._lib()
    err = lib.nlt_conv2x2s2_lrelu_clocks(
        x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, w, c,
        o, float(slope), clk.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err != 0:
        return {"error": lib.nlt_conv_stage_error_string(err).decode()}
    k = clk[clk[:, 1] != 0].double().cpu()
    cyc = k[:, 7] - k[:, 1]
    parts = {"prologue": k[:, 2] - k[:, 1], "wait": k[:, 3],
             "issue": k[:, 4], "fma": k[:, 5], "epilogue": k[:, 6]}
    return {"blocks": int(k.shape[0]),
            "tiles_per_block": plan["pix_tiles"] * plan["o_tiles"]
            / max(1, int(k.shape[0])),
            "cycles": float(cyc.mean()),
            "ns_per_cycle": float(((k[:, 8] - k[:, 0])
                                   / cyc.clamp_min(1)).mean()),
            "mean_cycles": {p: float(v.mean()) for p, v in parts.items()},
            "kernel_span_ns": float(k[:, 8].max() - k[:, 0].min())}


def conv_plan_checks():
    """The library's launch plan equals its Python mirror
    (cs.launch_plan) at every shape this script runs K4 at and over the
    sweep of C and O, at three x alignments."""
    cases = [(n * (h // 2) * (w // 2), c, o)
             for n, h, w, c, o in CONV_TIMED + CONV_EDGE + CONV_CARD_EDGE]
    cases += [(n_pix, c, o) for c in CONV_SWEEP for o in CONV_SWEEP
              for n_pix in (1, 4 * 64 * 64 + 1)]
    bad = []
    for n_pix, c, o in cases:
        for addr in (1 << 30, (1 << 30) + 8, (1 << 30) + 4):
            got, want = conv_plan(n_pix, c, o, addr), \
                cs.launch_plan(n_pix, c, o, addr)
            if got != want:
                bad.append({"case": [n_pix, c, o, addr], "got": got,
                            "want": want})
    emit(check="conv_plan_mirror", plans=3 * len(cases), mismatches=bad[:5],
         ok=not bad)
    return not bad


def conv_phase():
    """Returns (ok, timed records)."""
    recs, timed = [], []
    for i, shape in enumerate(CONV_EDGE):
        for slope in (0.3, 0.0):
            recs.append(check_conv(shape, slope, 300 + i))
    for i, shape in enumerate(CONV_CARD_EDGE):
        recs.append(check_conv(shape, 0.3, 330 + i))
    # x one and two floats off a 16-byte boundary: 4- and 8-byte copies.
    for off in (1, 2):
        rec = check_conv((2, 34, 30, 64, 64), 0.3, 370 + off, x_offset=off)
        rec["ok"] &= rec["plan"]["vw"] == (1 if off == 1 else 2)
        recs.append(rec)
    for i, shape in enumerate(CONV_TIMED):
        recs.append(check_conv(shape, 0.0, 310 + i))
        timed.append(check_conv(shape, 0.3, 320 + i, timing=True))
    ok = conv_plan_checks()
    return ok and all(r["ok"] for r in recs + timed), timed


# ---------------------------------------------------------------------------
# Training from disk: nlt_tpu_torch.trainvali
# ---------------------------------------------------------------------------

TV_CONFIG = "sphere512_specular.ini"
TV_EPOCHS = 3
# Per-epoch loss_train, kernels path against the plain path:
# - float32: sums in another order (stages, K1's atomics) and the odd
#   LeakyReLU mask flip; phase 6's whole steps agree to 1e-6, and
#   AMSGrad's first steps (~lr sign(g)) move a param by 2 lr where a tiny
#   gradient flips sign: 1e-4.
# - bfloat16: the two paths round the U-Net at other points (2^-5 of a
#   stage's scale); phase 6's bf16 step losses agree to ~3e-6, and over
#   9 steps of updates the epochs read 5.5e-5 apart (H100): 1e-3, 20x
#   that reading and 1/40 of the loss's change from epoch 1 to 3.
TV_TOL = {"float32": 1e-4, "bfloat16": 1e-3}
# Two runs of one path (resumed against uninterrupted, the main run
# repeated, with or without prefetched placement): on the H100 the
# resumed float32 run read equal bit for bit and the prefetched bf16 run
# 1.6e-7 apart. K1's float atomics add in no fixed order, so equality is
# not promised, and a flipped last bit of a tiny gradient becomes a 2 lr
# AMSGrad step: 1e-5, under a fifth of the kernels-vs-plain float32 gap
# (1.9e-5), so a lost optimizer state or a misordered batch still fails.
TV_REPEAT_TOL = 1e-5


def _scalars(outdir, split):
    out = {}
    with open(os.path.join(outdir, "summary_%s" % split,
                           "scalars.jsonl")) as h:
        for line in h:
            r = json.loads(line)
            if "value" in r and not r["tag"].startswith("text/"):
                out.setdefault(r["tag"], {})[r["step"]] = r["value"]
    return out


def _epoch_times(outdir):
    with open(os.path.join(outdir, "epoch_times.jsonl")) as h:
        return [json.loads(line) for line in h]


def run_trainvali(scene, outroot, xname, *sets, profile=False):
    """One nlt_tpu_torch.trainvali run of the recipe on the scene."""
    os.environ["NLT_TPU_FUSED_STAGE"] = "1"
    argv = ["--config", TV_CONFIG, "--set", "data_root=" + scene,
            "--set", "outroot=" + outroot, "--set", "xname=" + xname,
            "--set", "epochs=%d" % TV_EPOCHS, "--set", "ckpt_period=1",
            "--set", "vali_period=1"]
    for kv in sets:
        argv += ["--set", kv]
    if profile:
        argv.append("--profile")
    t0 = time.perf_counter()
    outdir = trainvali.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    torch.cuda.empty_cache()
    return outdir, seconds


def _losses_close(a, b, rtol):
    return sorted(a) == sorted(b) and all(
        np.isfinite(a[e]) and abs(a[e] - b[e]) <= rtol * abs(b[e])
        for e in a)


def trainvali_phase(work, card):
    """Returns (ok, launches of the main run, the main run's outdir or
    None)."""
    ok = True
    t0 = time.perf_counter()
    scene = os.path.join(work, "scene512")
    outroot = os.path.join(work, "out")
    repo = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, os.path.join(repo, "data_gen", "synthesize.py"),
         "--outroot", scene, "--imh", "512", "--uvs", "512", "--n_cams",
         "4", "--n_lights", "4", "--n_test", str(N_TEST)],
        capture_output=True, text=True)
    emit(phase="trainvali_scene", rc=proc.returncode,
         seconds=time.perf_counter() - t0,
         stderr_tail=proc.stderr[-500:] if proc.returncode else "")
    if proc.returncode != 0:
        return False, {}, None

    # The main path: 3 epochs of the recipe, counters reset.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    main_out, main_s = run_trainvali(scene, outroot, "main")
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    times = _epoch_times(main_out)
    n_steps = sum(t["batches"] for t in times)
    tr, va = _scalars(main_out, "train"), _scalars(main_out, "vali")
    n_vali = len(va.get("loss_vali", {}))
    want = {k: TRAIN_LAUNCHES[k] * n_steps + EVAL_LAUNCHES[k] * n_vali
            for k in KERNELS}
    files_ok = (
        os.path.isfile(os.path.join(main_out, "checkpoints",
                                    "%d.pt" % TV_EPOCHS))
        and bool(glob.glob(os.path.join(main_out, "vis_train", "epoch*",
                                        "all.html")))
        and bool(glob.glob(os.path.join(main_out, "vis_vali", "epoch*",
                                        "all.html")))
        and bool(glob.glob(os.path.join(main_out, "vis_train", "epoch*",
                                        "batch*", "*_pred.png"))))
    losses_ok = (sorted(tr.get("loss_train", {})) == list(
        range(1, TV_EPOCHS + 1)) and all(
        np.isfinite(v) for v in tr["loss_train"].values()))
    psnr_ok = len(va.get("psnr_vali", {})) == TV_EPOCHS and all(
        np.isfinite(v) for v in va["psnr_vali"].values())
    main_ok = (launches == want and files_ok and losses_ok and psnr_ok
               and n_steps == 3 * TV_EPOCHS)
    emit(phase="trainvali", config=TV_CONFIG, epochs=TV_EPOCHS,
         steps=n_steps, vali_batches=n_vali, launches=launches,
         launches_expected=want,
         launches_rule="12/6/1 per train step + 12/6/0 per vali batch",
         loss_train=tr.get("loss_train"), loss_vali=va.get("loss_vali"),
         psnr_vali=va.get("psnr_vali"), files_ok=files_ok,
         seconds=main_s, ok=bool(main_ok))
    ok &= main_ok

    # Where the time went (host clock), cold epoch and warm epochs.
    texels = tr.get("texels_per_sec", {})
    for t in times:
        n = max(t["batches"], 1)
        emit(phase="trainvali_epoch", card=card, epoch=t["epoch"],
             warm=t["epoch"] > 1, epoch_s=t["epoch_s"], train_s=t["train_s"],
             s_per_batch=t["train_s"] / n,
             loader_wait_s_per_batch=t["loader_s"] / n,
             place_s_per_batch=t["place_s"] / n,
             step_dispatch_s_per_batch=t["step_s"] / n,
             epoch_end_sync_s=t["sync_s"], ckpt_s=t["ckpt_s"],
             train_vis_s=t["train_vis_s"], vali_s=t["vali_s"],
             texels_per_sec=texels.get(t["epoch"]),
             feat_cache_mb=t["feat_cache_mb"],
             device_cache_mb=t["device_cache_mb"])
    emit(phase="trainvali_memory", card=card, peak_mem_bytes=peak,
         feat_cache_mb=times[-1]["feat_cache_mb"],
         device_cache_mb=times[-1]["device_cache_mb"])

    # The device's idle share of a warm epoch: device time over wall time
    # of one profiled window (epoch 2's training loop of a traced run).
    prof_out, _ = run_trainvali(scene, outroot, "profiled", "epochs=2",
                                profile=True)
    with open(os.path.join(prof_out, "profile", "summary.json")) as h:
        prof = json.load(h)
    emit(phase="trainvali_idle", card=card, profiled_steps=prof["steps"],
         device_s=prof["device_s"], profiled_wall_s=prof["wall_s"],
         idle_share=(1 - prof["device_s"] / prof["wall_s"]
                     if prof["device_s"] > 0 else "not measured"))

    # The main run repeated as it was, then with placement on a worker
    # thread and its own CUDA stream (prefetch_batches): the same batches
    # in the same order, so the same per-epoch losses; the repeat shows
    # how far two runs of one path drift on the card.
    for xname, sets in (("repeat", ()),
                        ("prefetch", ("prefetch_batches=1",))):
        rep_out, rep_s = run_trainvali(scene, outroot, xname, *sets)
        lp = _scalars(rep_out, "train")["loss_train"]
        rel = max((abs(lp[e] - v) / abs(v)
                   for e, v in tr["loss_train"].items() if e in lp),
                  default=float("inf"))
        warm = _epoch_times(rep_out)[1:]
        p_ok = _losses_close(lp, tr["loss_train"], TV_REPEAT_TOL)
        emit(check="trainvali_%s_vs_main" % xname, sets=list(sets),
             loss_train=lp, loss_train_main=tr["loss_train"],
             bit_equal=lp == tr["loss_train"], max_rel_diff=rel,
             rtol=TV_REPEAT_TOL, card=card,
             warm_s_per_batch=[t["train_s"] / max(t["batches"], 1)
                               for t in warm],
             warm_place_s_per_batch=[t["place_s"] / max(t["batches"], 1)
                                     for t in warm],
             seconds=rep_s, ok=bool(p_ok))
        ok &= p_ok

    # Kernels against plain, per-epoch loss_train: bf16 against the main
    # run; float32 kernels against float32 plain.
    runs = {}
    with plain_ops():
        runs["plain_bf16"] = run_trainvali(scene, outroot, "plain_bf16")[0]
        runs["plain_f32"] = run_trainvali(scene, outroot, "plain_f32",
                                          "compute_dtype=float32")[0]
    runs["kernels_f32"] = run_trainvali(scene, outroot, "kernels_f32",
                                        "compute_dtype=float32")[0]
    lt = {k: _scalars(v, "train")["loss_train"] for k, v in runs.items()}
    lt["kernels_bf16"] = tr["loss_train"]
    for dtype in ("bfloat16", "float32"):
        tag = "bf16" if dtype == "bfloat16" else "f32"
        a, b = lt["kernels_" + tag], lt["plain_" + tag]
        c_ok = _losses_close(a, b, TV_TOL[dtype])
        emit(check="trainvali_kernels_vs_plain", dtype=dtype,
             loss_train_kernels=a, loss_train_plain=b, rtol=TV_TOL[dtype],
             ok=bool(c_ok))
        ok &= c_ok

    # Resume: float32 kernels stopped after epoch 2, then resumed to 3.
    sets = ("compute_dtype=float32", "overwrite=False")
    run_trainvali(scene, outroot, "resume", "epochs=2", *sets)
    res_out, _ = run_trainvali(scene, outroot, "resume", *sets)
    lr_ = _scalars(res_out, "train")["loss_train"]
    r_ok = _losses_close(lr_, lt["kernels_f32"], TV_REPEAT_TOL)
    emit(check="trainvali_resume_vs_uninterrupted", loss_train_resumed=lr_,
         loss_train_uninterrupted=lt["kernels_f32"], rtol=TV_REPEAT_TOL,
         ok=bool(r_ok))
    ok &= r_ok

    # Restore the best checkpoint of the main run and serve one request.
    ckpt_dir = os.path.join(main_out, "checkpoints")
    cfg = config_mod.read_config(main_out.rstrip("/") + ".ini")
    model, st = restore_model(cfg, ckpt_dir, step="best", device="cuda")
    server = Server(ckpt_dir, step="best", config=cfg, pack="uint8")
    vali = get_dataset_class("nlt")(cfg, "vali")
    batch = next(iter(vali.iterate(seed=0, drop_remainder=False)))
    out = server.predict({k: v for k, v in batch.items()
                          if not isinstance(v, list)})
    n = len(batch["id"])
    s_ok = (st["step"] in range(1, TV_EPOCHS + 1)
            and out["pred_camspc"].dtype == np.uint8
            and out["pred_camspc"].shape == (n, 512, 512, 3)
            and out["pred"].shape == (n, 512, 512, 3))
    best = max(va["psnr_vali"].items(), key=lambda kv: kv[1])[0]
    emit(check="trainvali_restore_best_and_serve", best_step=st["step"],
         best_by_scalars=best, served_step=server.state["step"],
         shapes={k: list(v.shape) for k, v in out.items()},
         ok=bool(s_ok and st["step"] == best == server.state["step"]))
    ok &= s_ok and st["step"] == best == server.state["step"]
    del model, server
    emit(phase="trainvali_all", seconds=time.perf_counter() - t0,
         ok=bool(ok))
    return bool(ok), launches, main_out


# ---------------------------------------------------------------------------
# 8. Test-time inference and the rest of serving, on phase 7's main run
# ---------------------------------------------------------------------------

# Test views of phase 7's scene (synthesize.py --n_test); at the recipe's
# bs 4 they make batches of 4, 4 and a remainder of 1.
N_TEST = 9
# Per test batch (and per request with the pyramid): the query path's 6
# contract + 6 expand stages; per obs batch of extract_feat: 6 contract.
QUERY_LAUNCHES = {"contract_stage": 6, "expand_stage": 6}
OBS_LAUNCHES = {"contract_stage": 6, "expand_stage": 0}


def _read_vis(vis_root):
    """{view id: (pred frame, metadata)} of a vis_test root, and the
    sorted batch dir names."""
    out, dirs = {}, sorted(os.listdir(vis_root)) if os.path.isdir(
        vis_root) else []
    for d in dirs:
        for meta_path in glob.glob(os.path.join(vis_root, d,
                                                "*_metadata.json")):
            with open(meta_path) as h:
                meta = json.load(h)
            pred = meta_path[:-len("metadata.json")] + "pred.png"
            out[meta["id"]] = (np.asarray(Image.open(pred)), meta)
    return out, dirs


def _video_frames(path):
    """Frames in the compiled video (or its GIF fallback)."""
    if path.endswith((".gif", ".png", ".apng")):
        return Image.open(path).n_frames
    import imageio
    return len(imageio.mimread(path))


def run_nlt_test(ckpt_dir):
    """nlt_tpu_torch.nlt_test.main(--step best) in this process, counters
    reset: (video path, launches of extract_feat, launches in all,
    {infer_s, vis_s: host seconds in Model.vis_batch, batches})."""
    from nlt_tpu_torch import nlt_test

    clock, feat_launches = {"vis_s": 0.0, "batches": 0}, {}
    orig_infer, orig_feat = nlt_test.infer, nlt_test.extract_feat
    orig_vis = Model.vis_batch

    def extract_feat(*a, **kw):
        out = orig_feat(*a, **kw)
        feat_launches.update(fs.LAUNCHES)
        return out

    def infer(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig_infer(*a, **kw)
        torch.cuda.synchronize()
        clock["infer_s"] = time.perf_counter() - t0
        return out

    def vis_batch(*a, **kw):
        t0 = time.perf_counter()
        out = orig_vis(*a, **kw)
        clock["vis_s"] += time.perf_counter() - t0
        clock["batches"] += 1
        return out

    nlt_test.infer, nlt_test.extract_feat = infer, extract_feat
    Model.vis_batch = vis_batch
    _reset_launches()
    try:
        video = nlt_test.main(["--ckpt", ckpt_dir, "--step", "best"])
    finally:
        nlt_test.infer, nlt_test.extract_feat = orig_infer, orig_feat
        Model.vis_batch = orig_vis
    return video, feat_launches, dict(fs.LAUNCHES), clock


def _host(batch, n=None):
    """A test batch's array fields (its first n rows) and ids."""
    arrays = {k: v[:n] for k, v in batch.items() if not isinstance(v, list)}
    return arrays, list(batch["id"][:n])


def _bit_equal(a, b):
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)


def _median_latency_ms(predict, req, n=20):
    predict(req)
    lats = []
    for _ in range(n):
        t0 = time.perf_counter()
        predict(req)
        lats.append(time.perf_counter() - t0)
    return float(np.median(lats)) * 1e3


def inference_phase(main_out, card):
    """Returns (ok, launches by path: nlt_test, serve_cached, exported)."""
    from nlt_tpu_torch import serve as serve_mod
    from nlt_tpu_torch.utils import checkpoint as ckpt_mod

    ok = True
    ckpt = os.path.join(main_out, "checkpoints")
    cfg = config_mod.read_config(main_out.rstrip("/") + ".ini")
    test_set = get_dataset_class("nlt")(cfg, "test")
    test_ids = sorted(test_set.files)
    best = ckpt_mod.resolve_step(ckpt, "best")
    vis_test = os.path.join(main_out, "vis_test")
    vis_root = os.path.join(vis_test, "ckpt-%d_pred" % best)
    n_batches = -(-N_TEST // cfg.get_int("bs"))
    repo = os.path.dirname(os.path.abspath(__file__))

    # The nlt_test CLI, as a user runs it.
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "nlt_tpu_torch.nlt_test", "--ckpt", ckpt,
         "--step", "best"], capture_output=True, text=True, cwd=repo,
        timeout=900)
    frames, dirs = _read_vis(vis_root)
    videos = glob.glob(vis_root + ".*")
    n_video = _video_frames(videos[0]) if len(videos) == 1 else 0
    cli_ok = (proc.returncode == 0 and sorted(frames) == test_ids
              and len(test_ids) == N_TEST and len(dirs) == n_batches
              and n_video == N_TEST)
    emit(check="nlt_test_cli", rc=proc.returncode, step=best,
         batch_dirs=dirs, frames=len(frames), ids_equal=sorted(frames) ==
         test_ids, video=os.path.basename(videos[0]) if videos else None,
         video_frames=n_video, seconds=time.perf_counter() - t0,
         stderr_tail=proc.stderr[-800:] if proc.returncode else "",
         ok=bool(cli_ok))
    ok &= cli_ok
    shutil.rmtree(vis_test, ignore_errors=True)

    # In this process, counted (the main path), then the plain versions.
    runs = {}
    for path in ("kernels", "plain"):
        ctx = plain_ops() if path == "plain" else contextlib.nullcontext()
        with ctx:
            video, feat_l, all_l, clock = run_nlt_test(ckpt)
        runs[path] = _read_vis(vis_root)[0]
        n_video = _video_frames(video)
        shutil.rmtree(vis_test, ignore_errors=True)
        want = {k: OBS_LAUNCHES[k] + QUERY_LAUNCHES[k] * n_batches
                for k in QUERY_LAUNCHES}
        if path == "kernels":
            nlt_test_launches = all_l
            run_ok = (feat_l == OBS_LAUNCHES and all_l == want
                      and sorted(runs[path]) == test_ids
                      and n_video == N_TEST)
        else:
            run_ok = sum(all_l.values()) == 0 and sorted(runs[path]) == \
                test_ids
        emit(phase="nlt_test", path=path, card=card, batches=clock.get(
             "batches"), launches_extract_feat=feat_l, launches=all_l,
             launches_expected=want if path == "kernels" else 0,
             infer_s=clock.get("infer_s"),
             s_per_test_batch=clock["infer_s"] / max(clock["batches"], 1),
             vis_write_share_of_infer=clock["vis_s"] / clock["infer_s"],
             ok=bool(run_ok))
        ok &= run_ok
    kern, plain = runs["kernels"], runs["plain"]
    lsb = max((int(np.abs(kern[i][0].astype(int)
                          - plain[i][0].astype(int)).max())
               for i in kern if i in plain), default=255)
    meta_eq = sorted(kern) == sorted(plain) and all(
        kern[i][1] == plain[i][1] for i in kern)
    emit(check="nlt_test_kernels_vs_plain", frames=len(kern), max_lsb=lsb,
         lsb_tol=1, metadata_equal=meta_eq, ok=bool(lsb <= 1 and meta_eq))
    ok &= lsb <= 1 and meta_eq

    # Server.predict(ids=) on the device input cache, bs 1 and 4.
    server = Server(ckpt, step="best", config=cfg, pack="uint8")
    server.precompute_obs()  # the config's training split
    batches = list(test_set.iterate(seed=0, drop_remainder=False))
    ok &= server._feat_agg is not None and [
        len(b["id"]) for b in batches] == [4, 4, 1]
    cache = server._input_cache
    cached_launches = {k: 0 for k in QUERY_LAUNCHES}
    for bs in (1, 4):
        req, ids = _host(batches[0], bs)
        other, _ = _host(batches[1], bs)
        server.invalidate()
        streamed = server.predict(req)
        h0, m0 = cache.hits, cache.misses
        _reset_launches()
        first = server.predict(req, ids=ids)
        missed = (cache.hits - h0, cache.misses - m0) == (0, bs)
        again = server.predict(req, ids=ids)
        hit = (cache.hits - h0, cache.misses - m0) == (bs, bs)
        two = dict(fs.LAUNCHES)
        for k in cached_launches:
            cached_launches[k] += two[k]
        launches_ok = two == {k: 2 * v for k, v in QUERY_LAUNCHES.items()}
        stale = server.predict(other, ids=ids)  # the cached content wins
        server.invalidate(ids)
        fresh = server.predict(other, ids=ids)
        new_ok = (_bit_equal(stale, streamed)
                  and _bit_equal(fresh, server.predict(other))
                  and not _bit_equal(fresh, streamed))
        c_ok = (missed and hit and launches_ok and new_ok
                and _bit_equal(first, streamed)
                and _bit_equal(again, streamed))
        # Uploaded against cached, in turns: device profile and latency.
        server.invalidate(ids)
        profiles, lats = {}, {}
        for path in ("uploaded", "cached", "cached", "uploaded"):
            use = ids if path == "cached" else None
            cats = profile_requests(server, req, ids=use,
                                    label="serve_%s_bs%d" % (path, bs))
            profiles.setdefault(path, []).append(
                (sum(cats.values()), cats.get("memcpy htod", 0.0)))
            lats.setdefault(path, []).append(
                server.benchmark(req, n=20, ids=use)["latency_s"] * 1e3)
        no_htod = all(htod == 0.0 for _, htod in profiles["cached"])
        traced = all(dev > 0 for v in profiles.values() for dev, _ in v)
        emit(check="serve_cached", bs=bs, card=card, first_call_misses=missed,
             repeat_hits_every_row=hit, bit_equal_to_uploaded=_bit_equal(
                 first, streamed) and _bit_equal(again, streamed),
             new_content_after_invalidate=new_ok,
             launches_two_requests=two,
             device_ms={p: [d for d, _ in v] for p, v in profiles.items()},
             memcpy_htod_ms={p: [h for _, h in v]
                             for p, v in profiles.items()},
             latency_ms=lats, cache=cache.stats(),
             ok=bool(c_ok and no_htod and traced))
        ok &= c_ok and no_htod and traced

    # The serve CLI: benchmark stats, then an export bundle of bs 1 and 4
    # served by ExportedServer against the live server.
    work = os.path.dirname(main_out)
    stats = serve_mod.main(["--ckpt", ckpt, "--step", "best", "--bs", "1",
                            "--pack", "uint8"])
    stats_ok = sorted(stats) == ["cached", "streamed"] and all(
        v["latency_s"] > 0 for v in stats.values())
    emit(check="serve_cli", card=card, bs=1, pack="uint8",
         streamed_latency_ms=stats["streamed"]["latency_s"] * 1e3,
         cached_latency_ms=stats["cached"]["latency_s"] * 1e3,
         streamed_fps=stats["streamed"]["fps"],
         cached_fps=stats["cached"]["fps"], ok=bool(stats_ok))
    ok &= stats_ok
    bundle = os.path.join(work, "serve.nltx")
    t0 = time.perf_counter()
    serve_mod.main(["--ckpt", ckpt, "--step", "best", "--pack", "uint8",
                    "--export", bundle, "--export_bs", "1,4"])
    export_s = time.perf_counter() - t0
    exported = serve_mod.ExportedServer(bundle)
    export_launches = {k: 0 for k in QUERY_LAUNCHES}
    e_ok = exported.batch_sizes == [1, 4]
    for bs in (1, 4):
        req, _ = _host(batches[0], bs)
        _reset_launches()
        got = exported.predict(req)
        per_request = dict(fs.LAUNCHES)
        for k in export_launches:
            export_launches[k] += per_request[k]
        want = server.predict(req)
        equal = _bit_equal(got, want)
        lats, profiles = {}, {}
        for path, srv in (("live", server), ("exported", exported),
                          ("exported", exported), ("live", server)):
            lats.setdefault(path, []).append(
                _median_latency_ms(srv.predict, req))
            profiles.setdefault(path, []).append(sum(profile_requests(
                srv, req, label="%s_bs%d" % (path, bs)).values()))
        emit(check="exported_vs_live", bs=bs, card=card, bit_equal=equal,
             launches_per_request=per_request, latency_ms=lats,
             device_ms=profiles, ok=bool(equal
                                         and per_request == QUERY_LAUNCHES))
        e_ok &= equal and per_request == QUERY_LAUNCHES
    try:
        exported.predict(_host(batches[0], 2)[0])
        refused = False
    except ValueError:
        refused = True
    emit(check="exported_bundle", bytes=os.path.getsize(bundle),
         export_s=export_s, batch_sizes=exported.batch_sizes,
         refuses_bs2=refused, ok=bool(e_ok and refused))
    ok &= e_ok and refused
    return bool(ok), {"nlt_test": nlt_test_launches,
                      "serve_cached": cached_launches,
                      "exported": export_launches}


# ---------------------------------------------------------------------------
# 9. The rest of training: E-LPIPS and SSIM, BatchNorm and the other
#    norms, remat, and a trainvali epoch with them
# ---------------------------------------------------------------------------

# A step of a norm = batch (layer, instance, pixel) net runs no fused
# stage (nlt_tpu turns them off for any norm): K1 only, in the
# resampler's backward.
NORM_LAUNCHES = {"contract_stage": 0, "expand_stage": 0,
                 "scatter_add_rows": 1, "conv2x2s2_lrelu": 0}
# BN moving statistics, kernels path against plain path after one step,
# as a fraction of their scale (at least 1): the forward that records
# them runs no kernel on this path, so they should agree exactly; 1e-5.
BN_STATS_TOL = 1e-5
# remat against the same step without it, float32, relative: the
# recompute reruns the stage kernels on the same inputs (bit-equal), and
# K1's float atomics add in no fixed order (~1e-7): 1e-5.
REMAT_TOL = 1e-5


def options_cfg(compute_dtype="bfloat16", **over):
    """train_cfg() with some keys changed."""
    cfg = train_cfg(compute_dtype)
    for k, v in over.items():
        cfg.set(k, str(v))
    return cfg


def _moving(params):
    """{path: tensor} of the BN moving statistics in a params tree."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                if isinstance(v, torch.Tensor):
                    if k.startswith("moving_"):
                        out[path + (k,)] = v
                else:
                    walk(v, path + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (i,))

    walk(params, ())
    return out


def _reset_moving(params):
    """params with every BN moving statistic at its init (0 / 1)."""
    if isinstance(params, dict):
        return {k: (torch.full_like(v, 0.0 if k.startswith("moving_mean")
                                    else 1.0)
                    if k.startswith("moving_") else _reset_moving(v))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_reset_moving(v) for v in params]
    return params


def _stats_err(a, b):
    """Largest |a - b| over BN statistics, as a fraction of b's scale."""
    ma, mb = _moving(a), _moving(b)
    assert sorted(ma) == sorted(mb)
    return max((float((ma[k] - mb[k]).abs().max())
                / max(1.0, float(mb[k].abs().max())) for k in mb),
               default=0.0)


class Run9:
    """One option's model, optimizer, fresh state, batches and their
    statics (the recipe's cached-statics step)."""

    def __init__(self, cfg, n_batches):
        self.model = Model(cfg, device="cuda")
        self.tx = train_mod.make_optimizer(cfg.get_float("lr"),
                                           cfg.get_float("mgm"))
        self.state0 = train_mod.init_state(self.model, self.tx,
                                           torch.Generator().manual_seed(0))
        self.batches = [_train_batch(30 + i) for i in range(n_batches)]
        extract = train_mod.make_static_extractor(self.model)
        self.statics = [extract(self.state0["params"], b)
                        for b in self.batches]
        self.step = train_mod.make_train_step(
            self.model, self.tx, cached_statics=True, with_vis=False)

    def args(self, i):
        return self.batches[i], self.statics[i]

    def drive(self, label, counted=True):
        """All batches from state0 (the first one the warm-up), each
        step's launches and time; the counters reset just before when
        counted (the option's main path). Returns (state after the
        first step, last state, record)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if counted:
            _reset_launches()
        state, first, per_step, times, losses = self.state0, None, [], [], []
        for i in range(len(self.batches)):
            before = _launches()
            t = time.perf_counter()
            state, loss = self.step(state, *self.args(i))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(loss))
            per_step.append({k: v - before[k]
                             for k, v in _launches().items()})
            first = first or state
        rec = {"label": label, "launches": _launches() if counted else None,
               "per_step": per_step, "losses": losses, "warmup_ms": times[0],
               "step_ms": times[1:],
               "median_ms_per_step": float(np.median(times[1:]))
               if len(times) > 1 else None,
               "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        return first, state, rec


def time_in_turns(fns, rounds=5):
    """Host-clock ms of one call of each fn, in turns (the order reversed
    every round), median per fn."""
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(rounds):
        for k in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fns[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
    return {k: float(np.median(v)) for k, v in times.items()}, times


def losses_phase(flag):
    """(a) barron + E-LPIPS and barron + LPIPS + SSIM at the flagship
    width. Returns (ok, {label: launches})."""
    from nlt_tpu_torch import losses as losses_mod

    ok, launches = True, {}
    drawn = []
    orig_draw = losses_mod.ELPIPS.draw

    def recording_draw(self, generator, gt):
        out = orig_draw(self, generator, gt)
        drawn.append(out)
        return out

    losses_mod.ELPIPS.draw = recording_draw
    try:
        for name, loss in (("elpips", "barron,1e+0elpips"),
                           ("ssim", "barron,1e+0lpips,1e+0ssim")):
            run = Run9(options_cfg(loss=loss), TRAIN_STEPS + 1)
            drawn.clear()
            _, _, rec = run.drive("train_" + name)
            launches["train_" + name] = rec["launches"]
            main_draws = list(drawn)
            step_ok = (all(p == TRAIN_LAUNCHES for p in rec["per_step"])
                       and all(np.isfinite(rec["losses"])))
            # The same seed twice: the same draws, and the same losses up
            # to K1's atomic order (phase 7's repeat tolerance).
            drawn.clear()
            _, _, again = run.drive("repeat", counted=False)
            repeat_rel = max(abs(a - b) / abs(b) for a, b in
                             zip(again["losses"], rec["losses"]))
            repeat_ok = repeat_rel <= TV_REPEAT_TOL and drawn == main_draws
            fresh = (name != "elpips" or (
                len(main_draws) == len(run.batches)
                and len({repr(d) for d in main_draws}) == len(main_draws)))
            emit(phase="train_options", option=name, loss=loss, bs=TRAIN_BS,
                 steps=len(run.batches), launches=rec["launches"],
                 per_step=rec["per_step"][0],
                 all_steps_12_6_1=step_ok, losses=rec["losses"],
                 warmup_ms=rec["warmup_ms"], step_ms=rec["step_ms"],
                 median_ms_per_step=rec["median_ms_per_step"],
                 peak_mem_bytes=rec["peak_mem_bytes"],
                 same_seed_same_losses=repeat_ok,
                 repeat_max_rel_diff=repeat_rel, repeat_rtol=TV_REPEAT_TOL,
                 draws_per_step_distinct=fresh,
                 draws=[list(d[0]) for d in main_draws[:3]],
                 ok=bool(step_ok and repeat_ok and fresh))
            ok &= step_ok and repeat_ok and fresh
            # Kernels against plain with the same draws (the generator
            # is seeded from the step, and both paths start at step 0).
            ok_b, _, _ = compare_steps(name + "_bfloat16", run.state0,
                                       run.batches[:2], run.statics[:2],
                                       run.model, run.tx, f32=False)
            ok &= ok_b
            if name == "elpips":
                r32 = Run9(options_cfg("float32", loss=loss), 3)
                ok_f, _, _ = compare_steps(name + "_float32", r32.state0,
                                           r32.batches, r32.statics,
                                           r32.model, r32.tx, f32=True)
                ok &= ok_f
                del r32
            medians, times = time_in_turns({
                "barron_lpips": lambda: flag.step(flag.state0, *flag.args(0)),
                name: lambda: run.step(run.state0, *run.args(0))})
            emit(phase="train_options_timing", option=name, bs=TRAIN_BS,
                 median_ms=medians, step_ms=times)
            profile_train_step(run.step, run.state0, run.batches[0],
                               run.statics[0], label=name)
            del run
            torch.cuda.empty_cache()
    finally:
        losses_mod.ELPIPS.draw = orig_draw
    return bool(ok), launches


def norms_phase(flag):
    """(b) norm = batch in float32 and bfloat16, (c) the layer, instance
    and pixel norms. Returns (ok, {label: launches})."""
    ok, launches = True, {}
    for dtype in ("float32", "bfloat16"):
        run = Run9(options_cfg(dtype, norm="batch"), 3)
        label = "train_bn_" + ("f32" if dtype == "float32" else "bf16")
        s1, _, rec = run.drive(label)
        launches[label] = rec["launches"]
        step_ok = (all(p == NORM_LAUNCHES for p in rec["per_step"])
                   and all(np.isfinite(rec["losses"])))
        m0, m1 = _moving(run.state0["params"]), _moving(s1["params"])
        changed = bool(m0) and all(not torch.equal(m0[k], m1[k]) for k in m0)
        # The plain path's first step from the same state.
        with plain_ops():
            p1, p_loss = run.step(run.state0, *run.args(0))
        torch.cuda.synchronize()
        stats_err = _stats_err(s1["params"], p1["params"])
        gk = _grads(s1["opt_state"]["mu"])
        gp = _grads(p1["opt_state"]["mu"])
        grad_rel = _rel_l2(torch.cat([a.flatten() for a in gk]),
                           torch.cat([b.flatten() for b in gp]))
        loss_rel = abs(float(p_loss) - rec["losses"][0]) / abs(float(p_loss))
        tol = 1e-4 if dtype == "float32" else 1e-2
        plain_ok = (stats_err <= BN_STATS_TOL and grad_rel <= tol
                    and loss_rel <= tol)
        # Evaluation on the moving statistics.
        ev = train_mod.make_eval_step(run.model)
        b = run.batches[0]
        e_moving = float(ev(s1, b)[0])
        e_init = float(ev({"params": _reset_moving(s1["params"])}, b)[0])
        eval_ok = np.isfinite(e_moving) and e_moving != e_init
        # nan_guard on a poisoned batch keeps them.
        bad = dict(b, base=torch.full_like(b["base"], float("nan")))
        guarded = train_mod.make_train_step(run.model, run.tx,
                                            nan_guard=True, with_vis=False)
        g1, g_loss = guarded(s1, bad)
        guard_ok = (not np.isfinite(float(g_loss))
                    and _stats_err(g1["params"], s1["params"]) == 0.0
                    and int(g1["step"]) == int(s1["step"]) + 1)
        r_ok = step_ok and changed and plain_ok and eval_ok and guard_ok
        emit(phase="train_options", option="norm_batch", dtype=dtype,
             bs=TRAIN_BS, steps=len(run.batches), launches=rec["launches"],
             per_step=rec["per_step"][0], all_steps_0_0_1=step_ok,
             losses=rec["losses"], warmup_ms=rec["warmup_ms"],
             step_ms=rec["step_ms"],
             median_ms_per_step=rec["median_ms_per_step"],
             peak_mem_bytes=rec["peak_mem_bytes"], moving_stats=len(m0),
             moving_changed=changed, stats_kernels_vs_plain=stats_err,
             stats_tol=BN_STATS_TOL, grad_rel_l2_vs_plain=grad_rel,
             loss_rel_vs_plain=loss_rel, tol=tol, eval_loss=e_moving,
             eval_loss_init_stats=e_init, nan_guard_keeps_stats=guard_ok,
             ok=bool(r_ok))
        ok &= r_ok
        if dtype == "bfloat16":
            medians, times = time_in_turns({
                "barron_lpips": lambda: flag.step(flag.state0, *flag.args(0)),
                "norm_batch": lambda: run.step(run.state0, *run.args(0))})
            emit(phase="train_options_timing", option="norm_batch",
                 bs=TRAIN_BS, median_ms=medians, step_ms=times)
            profile_train_step(run.step, run.state0, run.batches[0],
                               run.statics[0], label="norm_batch")
        del run
        torch.cuda.empty_cache()

    for norm in ("layer", "instance", "pixel"):
        run = Run9(options_cfg(norm=norm), 2)
        label = "train_" + norm
        _, _, rec = run.drive(label)
        launches[label] = rec["launches"]
        with plain_ops():
            _, _, prec = run.drive("plain", counted=False)
        close = all(abs(a - b) <= 1e-2 * abs(b)
                    for a, b in zip(rec["losses"], prec["losses"]))
        n_ok = (all(p == NORM_LAUNCHES for p in rec["per_step"])
                and all(np.isfinite(rec["losses"])) and close)
        emit(phase="train_options", option="norm_" + norm, dtype="bfloat16",
             bs=TRAIN_BS, steps=len(run.batches), launches=rec["launches"],
             per_step=rec["per_step"][0], losses=rec["losses"],
             losses_plain=prec["losses"], rtol=1e-2,
             step_ms=rec["step_ms"], ok=bool(n_ok))
        ok &= n_ok
        del run
        torch.cuda.empty_cache()
    return bool(ok), launches


def remat_phase(flag):
    """(d) remat on the fused flagship config: launches a step, the step
    against the same step without remat, peak memory with and without.
    Returns (ok, {label: launches})."""
    ok = True
    run = Run9(options_cfg(remat="true"), TRAIN_STEPS + 1)
    _, _, rec = run.drive("train_remat")
    fused_twice = all(p["contract_stage"] >= TRAIN_LAUNCHES["contract_stage"]
                      and p["expand_stage"] >= TRAIN_LAUNCHES["expand_stage"]
                      and p["scatter_add_rows"] == 1
                      for p in rec["per_step"])
    # Peak memory of one step, with and without remat (same state and
    # batch, statics in place for both).
    peaks = {}
    for name, r in (("remat", run), ("no_remat", flag)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        r.step(r.state0, *r.args(0))
        torch.cuda.synchronize()
        peaks[name] = {"peak_bytes": torch.cuda.max_memory_allocated(),
                       "above_start_bytes":
                       torch.cuda.max_memory_allocated() - base}
    # The step against the same step without remat (float32 and bf16).
    errs = {}
    for dtype in ("float32", "bfloat16"):
        a = Run9(options_cfg(dtype, remat="true"), 1)
        b_model = Model(options_cfg(dtype), device="cuda")
        b_step = train_mod.make_train_step(b_model, a.tx, cached_statics=True,
                                           with_vis=False)
        sa, la = a.step(a.state0, *a.args(0))
        sb, lb = b_step(a.state0, *a.args(0))
        torch.cuda.synchronize()
        ga, gb = _grads(sa["opt_state"]["mu"]), _grads(sb["opt_state"]["mu"])
        errs[dtype] = {
            "loss_rel": abs(float(la) - float(lb)) / abs(float(lb)),
            "grad_rel_l2": _rel_l2(torch.cat([x.flatten() for x in ga]),
                                   torch.cat([x.flatten() for x in gb]))}
        del a, b_model
        torch.cuda.empty_cache()
    cmp_ok = (errs["float32"]["loss_rel"] <= REMAT_TOL
              and errs["float32"]["grad_rel_l2"] <= REMAT_TOL
              and errs["bfloat16"]["loss_rel"] <= 1e-2
              and errs["bfloat16"]["grad_rel_l2"] <= 1e-2)
    r_ok = fused_twice and all(np.isfinite(rec["losses"])) and cmp_ok
    emit(phase="train_options", option="remat", dtype="bfloat16",
         bs=TRAIN_BS, steps=len(run.batches), launches=rec["launches"],
         per_step=rec["per_step"][0], losses=rec["losses"],
         warmup_ms=rec["warmup_ms"], step_ms=rec["step_ms"],
         median_ms_per_step=rec["median_ms_per_step"], memory=peaks,
         vs_no_remat=errs, tol_float32=REMAT_TOL, tol_bfloat16=1e-2,
         ok=bool(r_ok))
    ok &= r_ok
    medians, times = time_in_turns({
        "barron_lpips": lambda: flag.step(flag.state0, *flag.args(0)),
        "remat": lambda: run.step(run.state0, *run.args(0))})
    emit(phase="train_options_timing", option="remat", bs=TRAIN_BS,
         median_ms=medians, step_ms=times)
    profile_train_step(run.step, run.state0, run.batches[0], run.statics[0],
                       label="remat")
    launches = {"train_remat": rec["launches"]}
    del run
    torch.cuda.empty_cache()
    return bool(ok), launches


def trainvali_options_phase(work, main_out):
    """(e) one trainvali epoch on phase 7's scene from an .ini that sets
    norm = batch and loss = barron + E-LPIPS + SSIM; the checkpoint's
    moving statistics; restore_model and a Server request on them.
    Returns (ok, launches)."""
    cfg = config_mod.read_config(main_out.rstrip("/") + ".ini")
    for k, v in (("norm", "batch"), ("loss", "barron,1e+0elpips,1e+0ssim"),
                 ("epochs", "1"), ("ckpt_period", "1"), ("vali_period", "1"),
                 ("xname", "options"), ("overwrite", "True")):
        cfg.set(k, v)
    ini = os.path.join(work, "options.ini")
    cfg.save(ini)
    os.environ["NLT_TPU_FUSED_STAGE"] = "1"
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    outdir = trainvali.main(["--config", ini])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launches()
    times = _epoch_times(outdir)
    n_steps = sum(t["batches"] for t in times)
    want = {k: NORM_LAUNCHES[k] * n_steps for k in KERNELS}
    ckpt_dir = os.path.join(outdir, "checkpoints")
    from nlt_tpu_torch.utils import checkpoint as ckpt_mod
    tree = ckpt_mod.CheckpointManager(ckpt_dir).load()
    moving = _moving(tree["params"])
    fresh = _moving(_reset_moving(tree["params"]))
    moved = bool(moving) and all(not torch.equal(moving[k], fresh[k])
                                 for k in moving)
    # restore_model and a Server request answer on the moving statistics.
    model, st = restore_model(cfg, ckpt_dir, device="cuda")
    server = Server(ckpt_dir, config=cfg, device="cuda")
    vali = get_dataset_class("nlt")(cfg, "vali")
    batch = next(iter(vali.iterate(seed=0, drop_remainder=False)))
    req = {k: v for k, v in batch.items() if not isinstance(v, list)}
    out = server.predict(req)
    placed = {k: torch.from_numpy(np.asarray(v)).to("cuda")
              for k, v in req.items()}
    with torch.no_grad():
        want_pred = model.apply(st["params"], placed, "test")[3]["pred"]
        init_pred = model.apply(_reset_moving(st["params"]), placed,
                                "test")[3]["pred"]
    served_err = float(np.abs(out["pred"] - want_pred.cpu().numpy()).max())
    init_gap = float((want_pred - init_pred).abs().max())
    scalars = _scalars(outdir, "train")
    ok = (launches == want and moved and served_err <= 1e-5
          and init_gap > 1e-3 and np.isfinite(
              scalars["loss_train"][1]))
    emit(phase="trainvali_options", config=ini, norm="batch",
         loss="barron,1e+0elpips,1e+0ssim", steps=n_steps, launches=launches,
         launches_expected=want, loss_train=scalars["loss_train"],
         loss_vali=_scalars(outdir, "vali").get("loss_vali"),
         moving_stats=len(moving), moving_changed=moved,
         served_vs_model_max_abs=served_err,
         pred_gap_to_init_stats=init_gap, seconds=seconds, ok=bool(ok))
    return bool(ok), launches


def options_phase(work, main_out):
    """Phase 9 (a)-(e). Returns (ok, {label: launches})."""
    os.environ["NLT_TPU_FUSED_STAGE"] = "1"
    t0 = time.perf_counter()
    flag = Run9(train_cfg("bfloat16"), 1)  # the yardstick of the timings
    ok, launches = True, {}
    for fn in (losses_phase, norms_phase, remat_phase):
        f_ok, f_l = fn(flag)
        ok &= f_ok
        launches.update(f_l)
    if main_out:
        tv_ok, tv_l = trainvali_options_phase(work, main_out)
        ok &= tv_ok
        launches["trainvali_options"] = tv_l
    else:
        ok = False
    emit(phase="train_options_all", seconds=time.perf_counter() - t0,
         ok=bool(ok))
    return bool(ok), launches


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for kind in ("expand", "contract"):
        ap.add_argument("--%s-route" % kind, choices=("auto", "tiled"),
                        default="auto")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chiprun_out"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    set_route("expand_stage", args.expand_route)
    set_route("contract_stage", args.contract_route)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["NLT_TPU_FUSED_STAGE"] = "1"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi: " + smi.stderr.strip()
    print(card, flush=True)
    emit(phase="env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), card=card)
    ok = True

    # 1. Build.
    t0 = time.perf_counter()
    sources = sorted(f[:-3] for f in os.listdir(_build.CSRC)
                     if f.endswith(".cu"))
    _build.build(sources)
    fs._lib()
    for kind in fs._SPLIT_SOURCES:
        fs._split_lib(kind)
    ptxas = [ln.strip() for name in sources
             for ln in _build.BUILD_LOGS.get(name, "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", sources=sources,
         seconds=time.perf_counter() - t0, ptxas=ptxas)
    if args.sweep:
        ok = split_sweep(args.out)
        emit(phase="split_sweep_all", ok=bool(ok))
        return 0 if ok else 1

    # 2. Kernels against their plain versions.
    t0 = time.perf_counter()
    kernels_ok = kernel_phase()
    conv_ok, conv_recs = conv_phase()
    emit(phase="kernels", ok=kernels_ok, conv_stage_ok=conv_ok,
         seconds=time.perf_counter() - t0)
    ok &= kernels_ok and conv_ok

    # 3. Serving: the main path.
    t0 = time.perf_counter()
    pyramid = Batches([make_batch(4, RES, seed=1), make_batch(4, RES, seed=2)])
    server = make_server(True, "bfloat16", "cuda", pyramid)
    reqs1 = [make_batch(1, RES, seed=10 + i) for i in range(8)]
    req4 = make_batch(4, RES, seed=20)
    server.predict(reqs1[0])  # warm-up (cuDNN/cuBLAS handles, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    per_request = []
    outs = []
    _reset_launches()
    for req in reqs1 + [req4]:
        before = dict(fs.LAUNCHES)
        outs.append(server.predict(req))
        per_request.append({k: fs.LAUNCHES[k] - before[k]
                            for k in fs.LAUNCHES})
    launches = dict(fs.LAUNCHES)
    serve_ok = all(p == {"contract_stage": 6, "expand_stage": 6}
                   for p in per_request)
    for req, out in zip(reqs1 + [req4], outs):
        n = req["base"].shape[0]
        for k in ("pred_camspc", "pred"):
            serve_ok &= out[k].shape == (n, RES, RES, 3) and \
                out[k].dtype == np.uint8
    emit(phase="serve", requests=len(per_request), launches=launches,
         per_request=per_request[0], all_requests_6_6=serve_ok,
         peak_mem_bytes=torch.cuda.max_memory_allocated(),
         seconds=time.perf_counter() - t0, ok=serve_ok)
    ok &= serve_ok

    # The main path's own stage inputs (one bs-1 request), timed and
    # checked: the numbers of the kernels line.
    main_calls = capture_stage_inputs(server, reqs1[0])
    per_kernel = {}
    for kind, args in main_calls:
        rec = check_stage(kind, args, timing=True, label="main_path")
        ok &= rec["ok"]
        per_kernel.setdefault(kind, []).append(rec)

    # 4. Whole predict, kernels against the plain path, same params.
    plain = make_server(False, "bfloat16", "cuda", pyramid,
                        share_state_with=server)
    # bf16 compute: stage outputs round at other points in the two paths
    # (see KERNEL_TOL) through 13 stages; 0.05 is the bf16-vs-f32
    # tolerance of nlt_tpu's fused-stage tests.
    ok &= compare_predict(server, plain, [reqs1[0], req4], 0.05, 13,
                          "bfloat16_baked_pyramid")
    s32 = make_server(True, "float32", "cuda", pyramid)
    p32 = make_server(False, "float32", "cuda", pyramid,
                      share_state_with=s32)
    # float32: sums in another order only; 1e-3 on [0, 1]-scale outputs
    # and 1 LSB where a value sits on a rounding edge.
    ok &= compare_predict(s32, p32, [reqs1[0], req4], 1e-3, 1,
                          "float32_baked_pyramid")
    del s32, p32
    # Without a pyramid (bench.py's serving shape) the obs path runs per
    # request and the whole U-Net stays in bf16.
    nopyr = make_server(True, "bfloat16", "cuda", None)
    nopyr_plain = make_server(False, "bfloat16", "cuda", None,
                              share_state_with=nopyr)
    ok &= compare_predict(nopyr, nopyr_plain, [reqs1[0]], 0.05, 13,
                          "bfloat16_no_pyramid")

    # 5. Serving latency and throughput, and where a request's time goes;
    # the stages of each op on the tiled route against this run's routes,
    # in turns (tiled, run, run, tiled), the other op on its run route.
    for kind, tag in (("expand_stage", "expand"),
                      ("contract_stage", "contract")):
        route = ROUTES[kind]
        for r in ("tiled", route, route, "tiled"):
            set_route(kind, r)
            label = "%s_route_%s" % (tag, r)
            profile_requests(server, reqs1[0], label=label)
            profile_requests(server, req4, label=label)
            profile_requests(nopyr, reqs1[0], label="no_pyramid_" + label)
            for name, srv in (("kernels", server),
                              ("kernels_no_pyramid", nopyr)):
                for req in (reqs1[0], req4):
                    stats = srv.benchmark(req, n=20)
                    emit(phase="serving_benchmark", path=name,
                         **{tag + "_route": r},
                         bs=int(req["base"].shape[0]), pack="uint8",
                         latency_ms=stats["latency_s"] * 1e3,
                         fps=stats["fps"])
        set_route(kind, route)
    for name, srv in (("plain", plain), ("plain_no_pyramid", nopyr_plain)):
        for req in (reqs1[0], req4):
            stats = srv.benchmark(req, n=20)
            emit(phase="serving_benchmark", path=name,
                 bs=int(req["base"].shape[0]), pack="uint8",
                 latency_ms=stats["latency_s"] * 1e3, fps=stats["fps"])
    # The stage ops' dispatch: through the registered custom ops (the
    # port's path) against a direct ctypes launch, in turns; bs-1 latency
    # and the host time of one stage call (a tiny stage, so the host, not
    # the device, sets the pace of 500 calls queued back to back).
    tiny = random_stage(1, 4, 4, 16, 16, torch.float32, seed=5)
    for d in ("direct", "op", "library", "library", "op", "direct"):
        with stage_dispatch(d):
            stats = server.benchmark(reqs1[0], n=20)
            fs.contract_stage(*tiny)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fs.contract_stage(*tiny)
            host_us = (time.perf_counter() - t0) / 500 * 1e6
            torch.cuda.synchronize()
        emit(phase="serving_dispatch", dispatch=d, bs=1, pack="uint8",
             latency_ms=stats["latency_s"] * 1e3, fps=stats["fps"],
             stage_call_host_us=host_us, stage_x=list(tiny[0].shape))

    # 6. Training: the flagship recipe's steps.
    t0 = time.perf_counter()
    train_ok, train_recs, train_launches = train_phase()
    emit(phase="training", ok=train_ok, seconds=time.perf_counter() - t0)
    ok &= train_ok
    per_kernel.update(train_recs)
    per_kernel["conv2x2s2_lrelu"] = conv_recs

    # 7. Training from disk through nlt_tpu_torch.trainvali.
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "nlt_tpu_torch", "_build", "smoke")
    shutil.rmtree(work, ignore_errors=True)
    try:
        tv_ok, tv_launches, main_out = trainvali_phase(work, card)
        ok &= tv_ok

        # 8. Test-time inference (nlt_tpu_torch.nlt_test) and the rest of
        # serving (input cache, CLI, export) on the main run's checkpoint.
        t0 = time.perf_counter()
        inf_ok, inf_launches = (inference_phase(main_out, card)
                                if main_out else (False, {}))
        emit(phase="inference", ok=bool(inf_ok),
             seconds=time.perf_counter() - t0)
        ok &= inf_ok

        # 9. The rest of training: E-LPIPS, SSIM, the norms, remat, and a
        # trainvali epoch with them on phase 7's scene.
        opt_ok, opt_launches = options_phase(work, main_out)
        ok &= opt_ok
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = []
    for kind in KERNELS:
        recs = per_kernel.get(kind, [])
        bound = sum(r["bound_ms"] for r in recs)
        by_bytes = sum(r["bound_ms"] for r in recs
                       if r["bound_by"] == "bytes")
        by_path = {"serve": launches.get(kind, 0),
                   "train": train_launches.get(kind, 0),
                   "trainvali": tv_launches.get(kind, 0)}
        by_path.update({p: v.get(kind, 0) for p, v in inf_launches.items()})
        by_path.update({p: v.get(kind, 0) for p, v in opt_launches.items()})
        kernels.append({
            "name": kind, "route": "cuda", "source": SOURCES[kind],
            "replaces": REPLACES[kind], "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max((r["max_abs_err"] for r in recs), default=None),
            "ms": sum(r["ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= bound - by_bytes
            else "operations",
            "library_ms": sum(r["library_ms"] for r in recs)})
        ok &= bool(recs)
        if kind != "conv2x2s2_lrelu":  # on no path, as in nlt_tpu
            ok &= train_launches[kind] > 0 and tv_launches.get(kind, 0) > 0
        if kind in QUERY_LAUNCHES:  # the inference paths' stages
            ok &= all(v.get(kind, 0) > 0 for v in inf_launches.values())
        # Phase 9: every path runs K1; the fused-stage paths K2 and K3.
        for p, v in opt_launches.items():
            if kind == "scatter_add_rows" or (
                    kind in QUERY_LAUNCHES and p in ("train_elpips",
                                                     "train_ssim",
                                                     "train_remat")):
                ok &= v.get(kind, 0) > 0
    emit(phase="summary", ok=bool(ok),
         note="kernel ms/plain_ms/bound_ms/library_ms: contract/expand "
              "summed over the stages of one bs-1 request of the serving "
              "path; scatter_add_rows: the one launch of a bs-4 training "
              "step; conv2x2s2_lrelu: summed over nlt_tpu's three shapes "
              "at bs 4 (no path runs it). launches: the serving requests, "
              "the training steps, the trainvali run, the nlt_test run, "
              "the cached requests, the exported requests and phase 9's "
              "option paths (E-LPIPS, SSIM, the norms, remat, the options "
              "trainvali epoch), each counted from 0")
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
