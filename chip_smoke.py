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
10. Data-parallel distribution (nlt_tpu_torch.parallel.mesh) on phase
   7's scene and phase 8's checkpoint, the ranks started as
   subprocesses of this script (--rank-worker) on a free localhost port,
   each with a timeout; a rank that fails fails the run. Two ranks of
   one run share cuda:0 and talk through gloo (NCCL refuses two ranks of
   one communicator on one device). (a) trainvali on two ranks, 2
   epochs, bs 4 (2 a rank), float32, init_from phase 7's run, against
   the same run in one process: per-epoch losses to 1e-5, the final
   params of both two-rank runs within the larger of 1e-5 and 3x the
   spread of two runs of each (relative L2; spread_bar) of both
   one-process runs, 12 / 6 / 1 launches a step on each rank, only
   rank 0 writes; each rank's warm s/batch and rank 0's traced idle share; (b) the same
   run at world size 1 over NCCL; (c) one norm = batch step at the
   flagship training width (bf16 and float32) on two ranks against the
   one-process step on the whole batch, and the all-reduce of the
   flagship recipe's float32 gradient bucket timed; (d) nlt_test
   --n_data 2 on two ranks against phase 8's frames (1 LSB); (e) a
   sharded Server on two ranks (bs 4, bs 3 replicated, a repeat from
   ids=) against one process's answers (1 LSB); (f) a SIGTERM to rank 1
   during training stops both ranks with a checkpoint, and a resumed run
   finishes.

11. Compact resample plans, the general conv path and a converted
   checkpoint. (a) The training step of phase 6 (bf16 and float32, bs 4,
   512^2, cached statics) on batches whose warps cover 40% of the frame,
   with take_compact_frac 0.5 on route take and on route scatter, against
   the full plan from the same state and batch: the loss bit-equal,
   gradients within the larger of 1e-6 and the spread of three full-plan
   steps (relative L2), 12 + 6 + 1 launches a compact step; the compact
   and full steps timed in turns, and the device ms of the take, the
   combine and the reconstruction; take_compact_frac 0.3 refused at
   feat_cache.insert; then five steady-state steps of feat_cache.gather
   and the captured donated cached step under
   torch.cuda.set_sync_debug_mode("error"), which must raise nothing
   (the slot indices go up through pinned memory). (b) Phase 3's
   serving config with kernel 3 / stride 2, kernel 4 / stride 2, and
   kernel 5 / stride 1 / max pooling
   (the general conv path, no stage kernel): predict in bf16 and float32
   against the CPU port on one request (float32 1e-4, bf16 2e-2, uint8
   within 1 LSB) and with torch's default TF32 switches against the
   script's (off); the layers that took the general path; device ms per
   bs-1 request; one float32 training step with the switches at torch's
   defaults against off (K1 alone launched). (c) Phase 7's best
   checkpoint rewritten into the form Orbax restores a nlt_tpu
   checkpoint in without a template (dicts, None, lists, numpy leaves),
   converted by convert.state_from_restored into a new run dir with the
   .ini and the vali scalars: the state equal to the original leaf for
   leaf, nlt_test --step best frames bit-equal to phase 8's, and one
   trainvali epoch resumed from it against one resumed from the original
   (phase 7's repeat tolerance).

12. The tile axis (nlt_tpu_torch/parallel/halo.py): each request's or
   example's U-Net rows split over ranks that share cuda:0 over gloo,
   started as in phase 10. (a) Server(shard='tile') on 2 and 4 ranks at
   phase 3's serving shape (512^2, depth 256, use_obs, seeded params):
   bf16 uint8 with the baked pyramid and without, a float32 and a bf16
   server without packing, bs 1 and 4 (bs 4 through ids= too; 4 ranks:
   bs 1 but for the first), against the one-process server: uint8 within
   1 LSB, float32 1e-5 and bf16 2e-2 of scale, bit-equality printed; per
   rank and request the K2/K3 launches (6 / 6 with the pyramid), the
   route of every halo-extended stage, device ms, the tile collectives'
   count and ms, wall ms. (b) trainvali --n_tile 2 on phase 7's scene
   (float32, 2 epochs, init_from phase 7's run) against one process with
   the statics cache off, as the tile run has it (in turns: tile, one
   process, tile profiled, one process): per-epoch losses
   1e-6 relative, final params max(1e-5, 3x the spread of two runs
   of each) as 10(a),
   12 / 6 / 1 launches a step on each rank, cache_static off with
   nlt_tpu's warning, a rank's warm s/batch, the gradient all-reduce ms,
   rank 0's idle share of a traced warm epoch, peak memory per rank. (c)
   One bf16 step at phase 6's training width on n_data 2 x n_tile 2 ranks
   against the one-process step: loss 1e-4, each leaf's gradient 1e-2 of
   its largest. The ranks share one card: this measures what the tile
   layer costs, not how it scales.

13. The tile axis for every U-Net option (the halos of every SAME
   window, the norms' moments over the ranks, the remat recompute's
   rows), two ranks sharing cuda:0 over gloo as in phase 12, one spawn
   for all of it. (a) Server(shard='tile') at phase 3's serving shape
   (512^2, depth 256, use_obs, the requests' own observations), float32,
   bs 1, for norm = batch (moving statistics away from their
   init), instance, layer, pixel; kernel / stride 3 / 2, 4 / 2, 5 / 1 +
   max pooling; 2 / 1 + avg pooling: against the one-process server,
   float32 to 1e-5 of scale, uint8 (pack_vis's rounding) within 1 LSB,
   no stage kernel launched (the options turn the fused stages off, as
   in nlt_tpu). (b) One step of each at phase 6's training width (bs 4,
   512^2, depth 256, barron + LPIPS, AMSGrad) in float32, and remat with
   the fused stages in float32, norm = batch and remat in bf16, against
   the one-process step: float32 loss 1e-5 and gradient 1e-3 relative
   L2; bf16 loss 1e-4 (1e-2 with BN), each leaf's gradient 1e-2 of its
   largest (under BN, or the one-process bf16 step's own distance from
   float32 if larger; a bias before batch or instance norm, zero in exact
   arithmetic, of the tree's largest); BN's moving statistics; one state
   on both ranks;
   launches 0 / 0 / 1 a step, and a remat step 24 K2 + 12 K3 + 1 K1 on
   each rank, each stage kernel on halo-extended rows in the forward and
   the recompute. (c) Per request and step: a rank's device ms, the
   collectives' count and ms (halo all_gathers, row gathers, the moments'
   and the gradients' reduces), wall ms against one process.

15. The compiled programs (nlt_tpu_torch/parallel/graph.py: CUDA graphs
   over in-place state, nlt_tpu's jit with donation). Every earlier
   phase's main path already runs through them (the training and eval
   steps and the serving forward are captured on the card by default,
   and a replay adds to the launch counters what its capture counted);
   where an earlier phase intercepts Python calls (recorders, the plain
   ops, route and dispatch switches, TF32 switches, profiles by
   category) it runs eagerly inside graph.disabled(), and so do the
   one-process trainvali runs that phases 10(a) and 12(b) hold their
   ranks against (the ranks are eager by graph's rule). (a) Phase 6's
   recipe (bs 4, 512^2, cached statics, barron + LPIPS), bf16 and
   float32: 6 donated steps eager, captured, eager, captured, eager
   from one state and one set of batches: each captured run's losses
   and final params within max(1e-6, 3x the spread) of each eager run's
   (the losses' spread that of the eager runs, the params' the largest
   of two runs of either path: spread_bar), the state's tensors kept,
   12 + 6 + 1 launches a captured step; step time eager and captured in
   turns, device ms and idle share. The same for 3 bf16 steps of
   norm = batch, remat and compact plans on both routes (their launch
   counts: 0 + 0 + 1, 24 + 12 + 1, 12 + 6 + 1). (b) Phase 7's trainvali
   run for 2 epochs, eager, captured, captured, eager (the last two
   profiled): per-epoch loss_train of each captured run within the
   losses' bar of each eager run's, psnr_vali within 0.05 dB, the steps
   and eval steps replayed; warm s/batch and idle share. (c)
   Phase 5's serving shape (bf16, the baked pyramid), bs 1 and 4,
   streamed and ids=: captured uint8 answers bit-equal to eager, a
   float32 server's within 1e-6 of scale, 6 + 6 launches a captured
   request; latency, fps, device ms and idle share in turns.

Prints the card's name and power limit, one JSON line per check and
timing, a {"kernels": [...]} line, and last {"ok": true, "device": ...}.
Exits non-zero without printing a result when there is no CUDA device.

    python3 chip_smoke.py --expand-route tiled|auto --contract-route tiled|auto

sends every expand (contract) call of the run to the tiled kernel
(tiled), or leaves it to the planner (auto, the default: the split
kernel at the plans measured on the card, the tiled kernel elsewhere).

    python3 chip_smoke.py --sweep [--sweep-recipe NAME ...] [--out DIR]

builds the kernels, then checks and times every split launch plan of
both ops at every flagship stage shape (bs 1 and 4) and every
RECIPE_STAGES shape (or at the named recipes' shapes alone), float32
and bfloat16, beside the tiled route,
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
import re
import signal
import socket
import subprocess
import sys
import time
import types

import numpy as np
import torch
from PIL import Image

from nlt_tpu_torch import trainvali
from nlt_tpu_torch.datasets import get_dataset_class
from nlt_tpu_torch.models.nlt import Model, tree_to
from nlt_tpu_torch.nlt_test import restore_model
from nlt_tpu_torch.ops import _build
from nlt_tpu_torch.ops import conv_stage as cs
from nlt_tpu_torch.ops import fused_stage as fs
from nlt_tpu_torch.ops import scatter as sc
from nlt_tpu_torch.parallel import graph
from nlt_tpu_torch.parallel import train as train_mod
from nlt_tpu_torch.serve import Server
from nlt_tpu_torch.utils import config as config_mod
from nlt_tpu_torch.utils.config import Config
from nlt_tpu_torch.utils.tree import tree_leaves, tree_map

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
# The stage backward's kernels (csrc/stage_bwd.cu) against the plain
# backward (contract_stage_bwd / expand_stage_bwd) on the same saved
# tensors, per gradient as a fraction of the plain gradient's largest
# magnitude. Both form the same float32 products (bf16 operands exact,
# dz1 as three exact bf16 terms) and differ in the order of the float32
# sums alone:
# - float32: sums of up to 4 * 10^6 products in another order; 1e-4,
#   the forward checks' float32 bound;
# - bfloat16: the same, then each gradient rounded to bf16 once on both
#   sides, where two float32 sums a few ulps apart can round one bf16
#   step apart (2^-8 of an entry): 2^-7.
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
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


# The checks and phases that failed, named on stderr at the end.
FAILED = []


def emit(**kw):
    if "ok" in kw and not kw["ok"]:
        FAILED.append(kw.get("check") or kw.get("phase"))
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
# 1024, bs 4, bf16; the same recipe at uvh = uvw = 1024, the UV size its
# SSS scenes are rendered at ("@uv1024": every stage at twice the side);
# sphere_synthetic.ini (like sphere_viewsyn.ini and
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
    "dragon_sss.ini@uv1024": (4, "bfloat16", [
        ("contract_stage", c, o, h) for c, o, h in [
            (16, 16, 1024), (32, 16, 1024), (16, 32, 512), (32, 32, 512),
            (32, 64, 256), (64, 64, 256), (64, 128, 128), (128, 128, 128),
            (128, 256, 64), (256, 256, 64), (256, 512, 32), (512, 512, 32),
            (512, 1024, 16), (1024, 1024, 16), (1024, 1024, 8),
            (2048, 1024, 8)]] + [
        ("expand_stage", c, o, h) for c, o, h in [
            (4096, 512, 4), (2560, 256, 8), (1280, 128, 16), (640, 64, 32),
            (320, 32, 64), (160, 16, 128), (80, 8, 256), (40, 4, 512)]]),
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


def sweep_shapes(recipes=None):
    """(kind, n, C, O, input H = W) of every flagship stage at bs 1 and 4
    and every recipe stage at its recipe's batch size, each once; with
    `recipes`, the stages of those RECIPE_STAGES entries alone."""
    out = [] if recipes else [(kind, n, c, o, h)
                              for kind, c, o, h in FLAGSHIP_STAGES
                              for n in (1, 4)]
    out += [(kind, n, c, o, h) for name, (n, _, stages)
            in RECIPE_STAGES.items() if not recipes or name in recipes
            for kind, c, o, h in stages]
    return list(dict.fromkeys(out))


def split_sweep(out_dir, shapes=None):
    """Every split plan of both ops at every flagship shape (bs 1 and 4)
    and every recipe shape (or at `shapes`, sweep_shapes' tuples),
    float32 and bfloat16: checked against the plain version and the
    tiled kernel, and timed; the tiled route timed beside it. A launch
    the card refuses is recorded as such."""
    os.makedirs(out_dir, exist_ok=True)
    ok = True
    with open(os.path.join(out_dir, "split_sweep.jsonl"), "w") as fh:
        for i, (kind, n, c, o, h) in enumerate(shapes or sweep_shapes()):
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
    inputs, in order: [(kind, args)]. Not counted as main-path work; an
    eager request (a replay makes no Python calls)."""
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
        with graph.disabled():
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
    if any(k in name.lower() for k in ("conv", "cudnn", "xmma", "wgrad",
                                       "dgrad")):
        return "convolution (general path)"
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


def spread_bar(refs, tests, dist, floor, tests_spread=True):
    """Float32 training runs held against each other. K1's atomics add in
    no fixed order and AMSGrad's first steps amplify that by an amount
    that depends on which near-zero gradients flip their step, so two
    runs of one program land a varying distance apart: on the H100 one
    pair read from 3e-8 to 5e-5 relative L2 between runs of this script,
    and one pair's distance is no yardstick. The spread is the largest
    distance between two runs of one program (either program; each is
    run twice or more; of the references alone with tests_spread=False);
    every test run must lie within max(floor, 3x the spread) of every
    reference run. Returns (cross, spread, bar): cross is the largest
    test-to-reference distance; it passes if cross <= bar."""
    pairs = [(a, b) for runs in ((refs, tests) if tests_spread else (refs,))
             for i, a in enumerate(runs) for b in runs[i + 1:]]
    spread = max(dist(a, b) for a, b in pairs)
    cross = max(dist(t, r) for t in tests for r in refs)
    return cross, spread, max(floor, 3 * spread)


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


# Small backward shapes (kind, n, h, w, c, o): odd and thin channel counts
# (one-element copies, O below one k16 step), grids no multiple of the
# 8 x 8 tile (ragged tiles, tiles over several images), a 1 x 1 grid, odd
# expand heights, C far above and below O, one pixel chunk and several.
BWD_EDGES = [
    ("contract_stage", 2, 12, 10, 5, 7),
    ("contract_stage", 1, 14, 18, 3, 4),
    ("contract_stage", 3, 2, 2, 9, 12),
    ("contract_stage", 1, 6, 6, 40, 33),
    ("contract_stage", 2, 34, 66, 16, 8),
    ("contract_stage", 1, 8, 8, 1024, 8),
    ("expand_stage", 2, 3, 5, 7, 5),
    ("expand_stage", 1, 7, 6, 10, 4),
    ("expand_stage", 3, 1, 1, 33, 17),
    ("expand_stage", 1, 5, 3, 64, 128),
    ("expand_stage", 2, 17, 33, 40, 4),
]


def bwd_sets():
    """{set: [(kind, n, h, w, c, o)]} of the stage backwards to check: the
    three training cells' stages (bs 4, every stage call of a step), the
    flagship stages at bs 2 (two data ranks) and on two tile ranks (H/2 +
    2 input rows for contract, H/2 + 1 for expand), and BWD_EDGES."""
    sets = {"specular": [(k, 4, h, h, c, o) for k, c, o, h
                         in FLAGSHIP_STAGES]}
    for name, label in (("dragon_sss.ini", "sss"),
                        ("dragon_sss.ini@uv1024", "sss_uv1024")):
        n, _, stages = RECIPE_STAGES[name]
        sets[label] = [(k, n, h, h, c, o) for k, c, o, h in stages]
    sets["bs2"] = [(k, 2, h, h, c, o) for k, c, o, h in FLAGSHIP_STAGES]
    sets["tile2"] = [
        (k, 4, h // 2 + (2 if k == "contract_stage" else 1), h, c, o)
        for k, c, o, h in FLAGSHIP_STAGES]
    sets["edge"] = BWD_EDGES
    return sets


def bwd_shapes(edges=True):
    """(set, kind, n, h, w, c, o) of every shape of bwd_sets, each once
    (under the first set that has it)."""
    out, seen = [], set()
    for label, shapes in bwd_sets().items():
        if label == "edge" and not edges:
            continue
        for shape in shapes:
            if shape not in seen:
                seen.add(shape)
                out.append((label,) + shape)
    return out


def stage_bwd_cost(kind, n, h, w, c, o, item):
    """(bytes, flops) the backward must move and do: x, y1, y2 and g read
    once, dx written once, the weights read and their gradients written
    once; 2 flops per multiply-add of the four products."""
    if kind == "contract_stage":
        py = n * (h // 2) * (w // 2)
        macs = py * (4 * o * o + 4 * c * o) * 2
    else:
        py = n * 4 * h * w
        macs = py * 4 * o * o * 2 + n * h * w * 4 * c * o * 2
    nbytes = item * (2 * n * h * w * c + 3 * py * o
                     + 2 * (4 * c * o + 4 * o * o + 2 * o))
    return nbytes, 2 * macs


def check_stage_bwd(label, kind, n, h, w, c, o, dtype, seed, slope=0.3,
                    timing=False):
    """The backward's kernels against the plain backward on one set of
    saved tensors (the kernel forward's), twice (the same bits)."""
    args = random_stage(n, h, w, c, o, dtype, seed)
    y2, y1 = fs._launch(kind, *args, slope, True)
    g = torch.randn(y2.shape, generator=torch.Generator().manual_seed(
        seed + 1)).to("cuda", dtype)
    saved = (*args, y1, y2, g, slope)
    plain = fs._BWDS[kind](*saved)
    got = fs._bwd_launch(kind, *saved)
    again = fs._bwd_launch(kind, *saved)
    torch.cuda.synchronize()
    names = ("dx", "dw1", "db1", "dw2", "db2")
    errs = {nm: float((a.float() - b.float()).abs().max()
                      / max(float(b.float().abs().max()), 1e-30))
            for nm, a, b in zip(names, got, plain)}
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(a).all()) for a in got)
    ok = (same and finite and max(errs.values()) <= BWD_TOL[dtype]
          and all(a.dtype == b.dtype and a.shape == b.shape
                  for a, b in zip(got, plain)))
    contract = kind == "contract_stage"
    plan = fs.bwd_plan(contract, n, h, w, c, o)
    # The library's shared memory per kernel against the planner's mirror.
    item = args[0].element_size()
    smem = [fs.bwd_smem_bytes(k, contract, item, plan) for k in range(3)]
    lib_smem = [fs._bwd_lib().nlt_stage_bwd_smem_bytes(
        k, int(contract), item, plan.th, plan.tw, bn)
        for k, bn in enumerate((plan.bn_dz1, plan.bn_dx, plan.bn_w))]
    ok = ok and smem == lib_smem
    rec = {"check": "stage_bwd_vs_plain", "set": label, "kernel": kind,
           "x": [n, h, w, c], "o": o, "dtype": str(dtype)[6:],
           "slope": slope, "plan": vars(plan), "rel_err": errs,
           "tol": BWD_TOL[dtype], "same_bits": same, "smem": smem,
           "smem_mirror": smem == lib_smem, "ok": ok}
    if timing:
        rec["ms"] = time_ms(lambda: fs._bwd_launch(kind, *saved), 5, 3)
        rec["plain_ms"] = time_ms(lambda: fs._BWDS[kind](*saved), 5, 3)
        nbytes, flops = stage_bwd_cost(kind, n, h, w, c, o,
                                       args[0].element_size())
        t_b = nbytes / HBM_BYTES_PER_S * 1e3
        t_o = flops / PEAK_FLOPS[dtype] * 1e3
        rec.update(bound_ms=max(t_b, t_o),
                   bound_by="bytes" if t_b >= t_o else "operations",
                   launches=4 + (plan.ks > 1) + (plan.ksx > 1),
                   kernel_us=bwd_kernel_us(kind, saved))
    emit(**rec)
    return rec


def bwd_kernel_us(kind, saved):
    """Device microseconds of each launch of one stage backward
    (torch.profiler), by kernel name."""
    from torch.profiler import ProfilerActivity, profile

    fs._bwd_launch(kind, *saved)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fs._bwd_launch(kind, *saved)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us:
            name = re.sub(r"^void \(anonymous namespace\)::", "", ev.key)
            out[name[:48]] = round(float(us), 2)
    return out


def bwd_check_phase(edges=True):
    """Every backward shape of bwd_shapes in both dtypes (both slopes on
    the edges); the cells' shapes timed in bf16 beside the plain
    backward. Returns (ok, per-set totals)."""
    recs, totals = [], {}
    for i, (label, kind, n, h, w, c, o) in enumerate(bwd_shapes(edges)):
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype is torch.bfloat16 and label in (
                "specular", "sss", "sss_uv1024")
            for slope in ((0.3, 0.0) if label == "edge" else (0.3,)):
                r = check_stage_bwd(label, kind, n, h, w, c, o, dtype,
                                    500 + i, slope, timing=timed)
                recs.append(r)
                if timed:
                    t = totals.setdefault(label, {"ms": 0.0, "plain_ms": 0.0,
                                                  "bound_ms": 0.0,
                                                  "stages": 0})
                    for k in ("ms", "plain_ms", "bound_ms"):
                        t[k] += r[k]
                    t["stages"] += 1
        torch.cuda.empty_cache()
    ok = all(r["ok"] for r in recs)
    worst = {}
    for r in recs:
        key = "%s_%s" % (r["set"], r["dtype"])
        worst[key] = max(worst.get(key, 0.0), max(r["rel_err"].values()))
    emit(phase="stage_bwd_checks", checked=len(recs), totals_bf16=totals,
         worst_rel_err=worst, ok=ok)
    return ok, totals


@contextlib.contextmanager
def plain_backward():
    """The stage backward on the card as the plain version (the path
    before csrc/stage_bwd.cu), eagerly."""
    orig = fs._backward
    fs._backward = lambda kind, *a: fs._BWDS[kind](*a)
    try:
        with graph.disabled():
            yield
    finally:
        fs._backward = orig


def bwd_profile_phase():
    """The flagship training step (bs 4, bf16) profiled by category with
    the plain backward and with the kernels: the kernels launched under
    the stage backward's autograd nodes, none of them a GEMM, cast or
    stack. Returns ok."""
    os.environ["NLT_TPU_FUSED_STAGE"] = "1"
    model = Model(train_cfg("bfloat16"), device="cuda")
    tx = train_mod.make_optimizer(model.config.get_float("lr"),
                                  model.config.get_float("mgm"))
    state = train_mod.init_state(model, tx, torch.Generator().manual_seed(0))
    extract = train_mod.make_static_extractor(model)
    batch = _train_batch(30)
    statics = extract(state["params"], batch)
    step = train_mod.make_train_step(model, tx, cached_statics=True,
                                     with_vis=False)
    with graph.disabled():
        step(state, batch, statics)   # warm-up
    # The layout of every gradient the kernels get (a channel slice of a
    # wider tensor goes as it is; any other is copied first).
    layouts, launch = [], fs._bwd_launch

    def recorded(kind, *a):
        g = a[-2]
        layouts.append((kind, tuple(g.shape), tuple(g.stride()),
                        fs._pixel_stride(g)))
        return launch(kind, *a)

    out = {}
    for label, ctx in (("plain_backward", plain_backward),
                       ("kernels", contextlib.nullcontext)):
        with ctx():
            step(state, batch, statics)
            if label == "kernels":
                fs._bwd_launch = recorded
            try:
                out[label] = profile_train_step(step, state, batch, statics,
                                                label="stage_bwd_" + label)
            finally:
                fs._bwd_launch = launch
    names = (out["kernels"] or {}).get("stage_backward_kernels", {})
    ours = ("stage_dz1_kernel", "stage_dz1_sum_kernel", "stage_dx_kernel",
            "stage_dx_sum_kernel", "stage_wgrad_kernel",
            "stage_wgrad_sum_kernel")
    others = {k: v for k, v in names.items()
              if not any(o in k for o in ours)}
    # No GEMM, cast or concatenation of the plain backward's is left.
    banned = {k: v for k, v in others.items() if any(
        b in k for b in ("gemm", "cutlass", "cublas", "xmma", "direct_copy",
                         "CatArray", "splitK"))}
    copied = [r for r in layouts if r[3] is None]
    ok = bool(names) and not banned
    emit(phase="stage_bwd_profile",
         stage_backward_ms={k: (v or {}).get("by_category_ms", {}).get(
             "stage backward") for k, v in out.items()},
         device_ms_per_step={k: (v or {}).get("device_ms_per_step")
                             for k, v in out.items()},
         kernels_under_stage_backward=names, other_kernels=others,
         banned_kernels=banned, launches_seen=len(layouts),
         gradients_copied=copied, ok=ok)
    return ok


def bwd_steps_phase(seconds=3, seed=2 ** 31 + 7):
    """Each training cell of the benchmark run briefly in this process:
    per step, BWD_LAUNCHES equals the forward's LAUNCHES (12 + 6 in
    dragon_specular, 16 + 8 in dragon_sss and at 1024^2), ROUTES sum to
    LAUNCHES, and the cell stays correct. Returns ok."""
    root = os.path.dirname(os.path.abspath(__file__))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import run as bench_run
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    want = {"dragon_specular.train": (12, 6), "dragon_sss.train": (16, 8),
            "dragon_sss_uv1024.train": (16, 8)}
    ok = True
    for cell, (nc, ne) in want.items():
        _reset_launches()
        line, run = bench_run.run_cell(bench, cell, seed, seconds, False)
        steps = run.attempted
        fwd, bwd = dict(fs.LAUNCHES), dict(fs.BWD_LAUNCHES)
        routes = {k: sum(fs.ROUTES[k].values()) for k in fs.ROUTES}
        per_step = {k: bwd[k] / max(steps, 1) for k in bwd}
        cell_ok = (bool(line.get("correct")) and fwd == bwd
                   and routes == fwd
                   and fwd == {"contract_stage": nc * steps,
                               "expand_stage": ne * steps})
        emit(phase="stage_bwd_steps", cell=cell, steps=steps,
             launches=fwd, bwd_launches=bwd, routes=routes,
             bwd_per_step=per_step, correct=line.get("correct"),
             end_to_end={k: line.get(k) for k in (
                 "train_texels_per_s", "setup_s")},
             checks=line.get("checks"), ok=cell_ok)
        ok &= cell_ok
        del run
        torch.cuda.empty_cache()
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
    of the plain stages; index_add_ for the scatter), eagerly: a graph
    captured through the kernels would replay them."""
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
        with graph.disabled():
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
    optimizer's and the losses' ranges), else to 'other'. An eager step:
    a replay's kernels have no ranges above them (phase 15 profiles the
    captured step)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            graph.disabled():
        t0 = time.perf_counter()
        step(state, batch, statics)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    named = {"contract_kernel": "fused forward (K2)",
             "contract_split_kernel": "fused forward (K2)",
             "expand_kernel": "fused forward (K3)",
             "expand_split_kernel": "fused forward (K3)",
             "scatter_add_rows_kernel": "resample backward scatter (K1)"}
    cats, total, rest, by_name, bwd_names = {}, 0.0, {}, {}, {}
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
                if cat == "stage backward":
                    bwd_names[k.name[:150]] = (
                        bwd_names.get(k.name[:150], 0.0) + k.duration / 1e3)
            else:
                key = "%s <- %s" % (k.name[:60], ev.name)
                rest[key] = rest.get(key, 0.0) + k.duration / 1e3
    if total == 0:
        emit(phase="train_profile", label=label, wall_ms_per_step=wall_ms,
             device_ms_per_step="not measured",
             note="torch.profiler recorded no device time")
        return None
    cats["other (loss backward, resample, elementwise, copies)"] = max(
        0.0, total - sum(cats.values()))
    rec = dict(phase="train_profile", label=label, bs=TRAIN_BS,
               wall_ms_per_step=wall_ms,
               device_ms_per_step=total, host_idle_share=1 - total / wall_ms,
               by_category_ms=dict(sorted(cats.items(),
                                          key=lambda kv: -kv[1])),
               stage_backward_kernels=dict(sorted(
                   bwd_names.items(), key=lambda kv: -kv[1])),
               top_other_kernels_ms=dict(sorted(
                   rest.items(), key=lambda kv: -kv[1])[:15]),
               top_device_events_ms=dict(sorted(
                   by_name.items(), key=lambda kv: -kv[1])[:15]))
    emit(**rec)
    return rec


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
    the three ops, in turns (kernels, plain, kernels, plain, ...), both
    eager (phase 15 times the captured step)."""
    step = train_mod.make_train_step(model, tx, cached_statics=True,
                                     with_vis=False)
    times = {"kernels": [], "plain": []}
    for i in range(rounds):
        for path in ("kernels", "plain"):
            ctx = plain_ops() if path == "plain" else graph.disabled()
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
        with graph.disabled():
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


# The frames of phase 8's counted nlt_test run: {view id: (frame, meta)}.
PHASE8_FRAMES = {}


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
    PHASE8_FRAMES.update(kern)  # phase 10's single-process reference
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


def _stats_rel(a, b):
    """Largest |a - b| over BN statistics, as a fraction of the largest
    |b| of its leaf."""
    ma, mb = _moving(a), _moving(b)
    assert sorted(ma) == sorted(mb)
    return max((float((ma[k] - mb[k]).abs().max())
                / max(float(mb[k].abs().max()), 1e-30) for k in mb),
               default=0.0)


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
        with graph.disabled():  # a replay's memory is its pool's
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


# ---------------------------------------------------------------------------
# 10. Data-parallel distribution: ranks as subprocesses of this script
# ---------------------------------------------------------------------------

# Two ranks of one run on the one card share cuda:0; NCCL refuses two
# ranks of a communicator on one device, so they talk through gloo (CUDA
# tensors for all_reduce and broadcast), and NCCL runs at world size 1.
DIST_RANK_TIMEOUT = 420
# Per-epoch loss_train and final params, two ranks (or NCCL at world 1)
# against one process, float32: the same sums split over two processes
# (each rank's half batch, then a mean of two means) and K1's atomics in
# no fixed order; phase 7's repeat tolerance, 1e-5. The params are held
# to the larger of this and 3x the spread of two runs of each
# (spread_bar).
DIST_TOL = 1e-5
# norm = batch, two ranks against one process, one step at the flagship
# training width, the moving statistics relative to each leaf's largest
# value: float32 to 1e-6 (the global moments merged in float32 from two
# halves, the one-process moments summed in one pass); bf16, and the
# loss, to compare_steps' bf16 tolerance, 1e-2 (the moments are merged in
# float32, the one-process path takes them in bf16).
DIST_BN_TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _dist_flags(rank, world, port, backend):
    return ["--coordinator_address", "localhost:%d" % port,
            "--num_processes", str(world), "--process_id", str(rank),
            "--dist_backend", backend]


def run_ranks(kind, work, world=2, backend="gloo", rest=(), opts=(),
              rank_opts=None):
    """Start `world` rank processes of this script (--rank-worker kind) at
    once, each with its own log, and wait for all of them (a timeout
    kills every one). rest: the entry point's argv (the multi-process
    flags are appended); rank_opts(rank): extra worker options. Returns
    [{rc, log, result}] in rank order; result is the worker's JSON."""
    port = _free_port()
    tag = "%s_%d" % (kind, port)
    procs, outs = [], []
    for r in range(world):
        out = os.path.join(work, "%s.rank%d" % (tag, r))
        outs.append(out)
        argv = ([sys.executable, os.path.abspath(__file__), "--rank-worker",
                 kind, "--rank", str(r), "--world", str(world), "--port",
                 str(port), "--backend", backend, "--result", out + ".json"]
                + list(opts) + list(rank_opts(r) if rank_opts else [])
                + ["--"] + list(rest) + _dist_flags(r, world, port, backend))
        with open(out + ".log", "w") as h:
            procs.append(subprocess.Popen(argv, stdout=h,
                                          stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=DIST_RANK_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = []
    for p, out in zip(procs, outs):
        with open(out + ".log") as h:
            log = h.read()
        result = None
        if os.path.isfile(out + ".json"):
            with open(out + ".json") as h:
                result = json.load(h)
        res.append({"rc": p.returncode, "log": log, "result": result})
    return res


def _ranks_ok(res):
    return all(r["rc"] == 0 and r["result"] is not None for r in res)


def _log_tails(res):
    return [r["log"][-1500:] for r in res if r["rc"] != 0]


def _s_per_batch(log):
    """{epoch: s/batch} from a rank's 'Epoch e/E loss x (t s/batch)'."""
    return {int(m.group(1)): float(m.group(2)) for m in re.finditer(
        r"Epoch (\d+)/\d+\s+loss \S+\s+\((\S+) s/batch\)", log)}


def _unique_scalars(outdir, split):
    """Whether every scalar of the run was written once per step."""
    seen = set()
    with open(os.path.join(outdir, "summary_%s" % split,
                           "scalars.jsonl")) as h:
        for line in h:
            r = json.loads(line)
            key = (r["tag"], r["step"], "text" in r)
            if key in seen:
                return False
            seen.add(key)
    return True


def _params_rel_l2(dir_a, dir_b, step, part=None):
    """Relative L2 of two checkpoints' params (or of their `part`
    subtree: 'net', 'loss')."""
    from nlt_tpu_torch.utils import checkpoint as ckpt_mod

    a = ckpt_mod.CheckpointManager(dir_a).load(step)["params"]
    b = ckpt_mod.CheckpointManager(dir_b).load(step)["params"]
    if part is not None:
        a, b = a[part], b[part]
    return _rel_l2(torch.cat([x.flatten().double() for x in tree_leaves(a)]),
                   torch.cat([x.flatten().double() for x in tree_leaves(b)]))


def _warm_s_per_batch(outdir):
    """Epoch 2's training s/batch of a one-process run."""
    t = _epoch_times(outdir)[1]
    return t["train_s"] / max(t["batches"], 1)


def _dist_trainvali_argv(scene, outroot, xname, init_from, *sets):
    argv = ["--config", TV_CONFIG]
    for kv in (("data_root=" + scene, "outroot=" + outroot,
                "xname=" + xname, "epochs=2", "ckpt_period=1",
                "vali_period=1", "compute_dtype=float32",
                "init_from=" + init_from) + tuple(sets)):
        argv += ["--set", kv]
    return argv


def dist_routes():
    """The route each flagship stage takes at a rank's batch (bs 2 of a
    bs-4 run) and at bs 4: 'split' where the planner has a measured plan,
    else 'tiled' (the two are bit-equal)."""
    out = {}
    for n in (2, 4):
        for itemsize, dtype in ((2, "bf16"), (4, "f32")):
            routes = {"split": 0, "tiled": 0}
            for kind, c, o, h in FLAGSHIP_STAGES:
                plan = getattr(fs, _PLANNERS[kind])(n, h, h, c, o, itemsize)
                routes["tiled" if plan is None else "split"] += 1
            out["bs%d_%s" % (n, dtype)] = routes
    return out


def dist_phase(work, main_out, card):
    """Phase 10 (a)-(f). Returns (ok, {label: launches of one rank})."""
    from nlt_tpu_torch.utils import checkpoint as ckpt_mod

    ok, launches = True, {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    scene = os.path.join(work, "scene512")
    outroot = os.path.join(work, "dist")
    init_from = os.path.join(main_out, "checkpoints")
    emit(phase="dist_routes", card=card, routes=dist_routes(),
         note="the split route has plans for bs 1 and 4 at the flagship "
              "shapes; a rank of a bs-4 run takes bs 2")

    # (a) Two ranks over gloo on cuda:0 against one process, in turns.
    # The one-process runs are eager, as the ranks are (graph's rule
    # keeps a mesh over a process group eager): the check is about the
    # data axis; captured against eager is phase 15's.
    t0 = time.perf_counter()
    with graph.disabled():
        single, single_s = run_trainvali(
            scene, outroot, "p10_single", "epochs=2",
            "compute_dtype=float32", "init_from=" + init_from)
    t1 = time.perf_counter()
    res = run_ranks("trainvali", work, rest=_dist_trainvali_argv(
        scene, outroot, "p10_dist", init_from))
    dist_s = time.perf_counter() - t1
    # The pair again in the other order, for the warm s/batch in turns.
    res_b = run_ranks("trainvali", work, rest=_dist_trainvali_argv(
        scene, outroot, "p10_dist_b", init_from))
    with graph.disabled():
        single_b, _ = run_trainvali(
            scene, outroot, "p10_single_b", "epochs=2",
            "compute_dtype=float32", "init_from=" + init_from)
    a_ok = _ranks_ok(res) and _ranks_ok(res_b)
    rec = {"ok": False}
    if a_ok:
        dist = res[0]["result"]["outdir"]
        ls = _scalars(single, "train")["loss_train"]
        ld = _scalars(dist, "train")["loss_train"]
        rel = max((abs(ld[e] - v) / abs(v) for e, v in ls.items()
                   if e in ld), default=float("inf"))
        times = _epoch_times(dist)
        n_steps = sum(t["batches"] for t in times)
        n_vali = len(_scalars(dist, "vali").get("loss_vali", {}))
        want = {k: TRAIN_LAUNCHES[k] * n_steps + EVAL_LAUNCHES[k] * n_vali
                for k in KERNELS}
        per_rank = [r["result"]["launches"] for r in res]
        writes_ok = (_unique_scalars(dist, "train")
                     and _unique_scalars(dist, "vali") and len(times) == 2
                     and ckpt_mod.CheckpointManager(os.path.join(
                         dist, "checkpoints")).all_steps() == [1, 2]
                     and "Checkpointed epoch" in res[0]["log"]
                     and "Checkpointed epoch" not in res[1]["log"])
        # The params of both two-rank runs against both one-process
        # runs, at spread_bar's bar (the losses keep 1e-5).
        ckpts = [os.path.join(o, "checkpoints") for o in
                 (single, single_b, dist, res_b[0]["result"]["outdir"])]

        def params_dist(a, b):
            return _params_rel_l2(a, b, 2)

        p_rel, p_spread, p_tol = spread_bar(ckpts[:2], ckpts[2:],
                                            params_dist, DIST_TOL)
        a_ok = (_losses_close(ld, ls, DIST_TOL) and p_rel <= p_tol
                and all(p == want for p in per_rank) and writes_ok)
        rec = dict(
            loss_train_two_ranks=ld, loss_train_one_process=ls,
            max_rel_diff=rel, final_params_rel_l2=p_rel, rtol=DIST_TOL,
            final_params_tol=p_tol,
            final_params_rel_l2_by_part={
                part: _params_rel_l2(os.path.join(single, "checkpoints"),
                                     os.path.join(dist, "checkpoints"), 2,
                                     part) for part in ("net", "loss")},
            final_params_spread=p_spread,
            one_process_repeat_params_rel_l2=params_dist(*ckpts[:2]),
            two_ranks_repeat_params_rel_l2=params_dist(*ckpts[2:]),
            steps_per_rank=n_steps, vali_batches=n_vali,
            launches_per_rank=per_rank, launches_expected=want,
            only_rank0_writes=writes_ok,
            turns="one process, two ranks, two ranks, one process",
            warm_s_per_batch_by_rank=[[_s_per_batch(r["log"]).get(2)
                                       for r in rr] for rr in (res, res_b)],
            warm_s_per_batch_one_process=[_warm_s_per_batch(o)
                                          for o in (single, single_b)],
            one_process_s=single_s, two_ranks_s=dist_s)
        launches["dist_trainvali_rank0"] = per_rank[0]
        launches["dist_trainvali_rank1"] = per_rank[1]
    emit(check="dist_trainvali_two_ranks_gloo", card=card,
         seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
         **dict(rec, ok=bool(a_ok)))
    ok &= a_ok

    # (b) World size 1 over NCCL, the process group really initialized.
    t0 = time.perf_counter()
    res = run_ranks("trainvali", work, world=1, backend="nccl",
                    rest=_dist_trainvali_argv(scene, outroot, "p10_nccl",
                                              init_from))
    b_ok = _ranks_ok(res)
    rec = {}
    if b_ok:
        ln = _scalars(res[0]["result"]["outdir"], "train")["loss_train"]
        ls = _scalars(single, "train")["loss_train"]
        group_up = "rank 0 of 1 (nccl" in res[0]["log"]
        b_ok = _losses_close(ln, ls, DIST_TOL) and group_up
        rec = dict(loss_train_nccl_world1=ln, loss_train_one_process=ls,
                   rtol=DIST_TOL, process_group_up=group_up,
                   launches=res[0]["result"]["launches"],
                   warm_s_per_batch=_s_per_batch(res[0]["log"]).get(2))
        launches["dist_nccl_world1"] = res[0]["result"]["launches"]
    emit(check="dist_trainvali_nccl_world1", card=card,
         seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
         **dict(rec, ok=bool(b_ok)))
    ok &= b_ok

    # (c) norm = batch, one step over gloo at the flagship training width,
    # float32 and bf16; the gradient bucket's all-reduce timed there.
    for dtype in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        res = run_ranks("bn_step", work, opts=["--dtype", dtype])
        c_ok = _ranks_ok(res)
        rec = {}
        if c_ok:
            r0, r1 = res[0]["result"], res[1]["result"]
            tol = DIST_BN_TOL[dtype]
            loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
            c_ok = (r0["stats_rel"] <= tol and loss_rel <= max(tol, 1e-5)
                    and r0["params_sum"] == r1["params_sum"]
                    and r0["loss"] == r1["loss"]
                    and r0["launches"] == r1["launches"] == NORM_LAUNCHES
                    and r0["moving_moved"])
            rec = dict(loss_two_ranks=r0["loss"], loss_one_process=r0[
                "ref_loss"], loss_rel=loss_rel,
                moving_stats_rel=r0["stats_rel"],
                moving_stats_err_of_scale=r0["stats_err"], tol=tol,
                ranks_equal=r0["params_sum"] == r1["params_sum"],
                launches_per_rank=[r0["launches"], r1["launches"]],
                step_ms_by_rank=[r0["step_ms"], r1["step_ms"]],
                one_process_step_ms=r0["ref_step_ms"])
            if dtype == "float32":
                rec.update(grad_bucket_params=r0["bucket_params"],
                           grad_bucket_mb=r0["bucket_params"] * 4 / 1e6,
                           allreduce_ms_by_rank=[r0["allreduce_ms"],
                                                 r1["allreduce_ms"]])
            launches["dist_bn_%s_rank0" % dtype] = r0["launches"]
        emit(check="dist_bn_step_two_ranks_gloo", dtype=dtype, card=card,
             seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
             **dict(rec, ok=bool(c_ok)))
        ok &= c_ok

    # (d) nlt_test --n_data 2 on two ranks, against phase 8's frames.
    t0 = time.perf_counter()
    run = os.path.join(work, "p10_nlt_test")
    for d in ("checkpoints", "summary_vali"):  # 'best' reads the scalars
        shutil.copytree(os.path.join(main_out, d), os.path.join(run, d))
    shutil.copyfile(main_out.rstrip("/") + ".ini", run + ".ini")
    res = run_ranks("nlt_test", work, rest=[
        "--ckpt", os.path.join(run, "checkpoints"), "--step", "best",
        "--n_data", "2"])
    d_ok = _ranks_ok(res) and bool(PHASE8_FRAMES)
    rec = {}
    if d_ok:
        best = ckpt_mod.resolve_step(os.path.join(run, "checkpoints"),
                                     "best")
        frames, dirs = _read_vis(os.path.join(run, "vis_test",
                                              "ckpt-%d_pred" % best))
        ids_ok = sorted(frames) == sorted(PHASE8_FRAMES)
        lsb = max((int(np.abs(frames[i][0].astype(int) - PHASE8_FRAMES[i][
            0].astype(int)).max()) for i in frames if i in PHASE8_FRAMES),
            default=255)
        n_diff = sum(int((frames[i][0] != PHASE8_FRAMES[i][0]).sum())
                     for i in frames if i in PHASE8_FRAMES)
        per_rank = [r["result"]["launches"] for r in res]
        n_batches = -(-N_TEST // 4)
        want = {k: OBS_LAUNCHES[k] + QUERY_LAUNCHES[k] * n_batches
                for k in QUERY_LAUNCHES}
        l_ok = all({k: p.get(k, 0) for k in want} == want for p in per_rank)
        once = ("Compilation available" in res[0]["log"]
                and "Compilation available" not in res[1]["log"])
        d_ok = ids_ok and lsb <= 1 and l_ok and once and len(dirs) == \
            n_batches
        rec = dict(frames=len(frames), batch_dirs=dirs, max_lsb=lsb,
                   pixels_differing=n_diff, lsb_tol=1,
                   launches_per_rank=per_rank, launches_expected=want,
                   written_once_by_rank0=once)
        launches["dist_nlt_test_rank0"] = per_rank[0]
        launches["dist_nlt_test_rank1"] = per_rank[1]
    emit(check="dist_nlt_test_two_ranks", card=card,
         seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
         **dict(rec, ok=bool(d_ok)))
    ok &= d_ok

    # (e) A sharded Server on two ranks against one process's answers.
    t0 = time.perf_counter()
    ckpt = os.path.join(main_out, "checkpoints")
    cfg = config_mod.read_config(main_out.rstrip("/") + ".ini")
    server = Server(ckpt, step="best", config=cfg, pack="uint8",
                    device="cuda")
    server.precompute_obs()
    req, ids = _dist_requests(cfg)
    want = {"bs4": server.predict(req),
            "bs3": server.predict({k: v[:3] for k, v in req.items()})}
    del server
    torch.cuda.empty_cache()
    res = run_ranks("serve", work, opts=["--ckpt", ckpt])
    e_ok = _ranks_ok(res)
    rec = {}
    if e_ok:
        lsbs, caches, per_rank = [], [], []
        for r in res:
            got = np.load(r["result"]["answers"])
            for key, ref in (("bs4", "bs4"), ("bs3", "bs3"), ("ids", "bs4")):
                for f, v in want[ref].items():
                    g = got["%s/%s" % (key, f)]
                    lsbs.append(int(np.abs(g.astype(int) - v.astype(
                        int)).max()) if g.shape == v.shape and
                        g.dtype == np.uint8 else 255)
            caches.append(r["result"]["cache"])
            per_rank.append(r["result"]["launches"])
        cache_ok = all(c["hits"] == 2 and c["misses"] == 2 for c in caches)
        # Per rank: 6 contract for the pyramid (precompute_obs), then
        # 6 + 6 for each of the 4 requests (bs 4, bs 3, bs 4 twice).
        want_l = {k: OBS_LAUNCHES[k] + 4 * QUERY_LAUNCHES[k]
                  for k in QUERY_LAUNCHES}
        l_ok = all({k: p.get(k, 0) for k in want_l} == want_l
                   for p in per_rank)
        e_ok = max(lsbs) <= 1 and cache_ok and l_ok
        rec = dict(max_lsb=max(lsbs), lsb_tol=1, requests=["bs4 (2 a rank)",
                   "bs3 (replicated)", "bs4 ids= (cache)"],
                   cache_by_rank=caches, launches_per_rank=per_rank,
                   launches_expected=want_l,
                   latency_ms_by_rank=[r["result"]["latency_ms"]
                                       for r in res])
        launches["dist_serve_rank0"] = per_rank[0]
        launches["dist_serve_rank1"] = per_rank[1]
    emit(check="dist_serve_two_ranks", card=card,
         seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
         **dict(rec, ok=bool(e_ok)))
    ok &= e_ok

    # (f) SIGTERM to rank 1 during training: both ranks checkpoint and
    # exit 0; a resumed run continues from that step. The resumed run
    # traces rank 0's last (warm) epoch: the device's idle share of a
    # two-rank loop (a traced rank 0 slows its partner, so (a) is not
    # traced).
    t0 = time.perf_counter()
    sets = ("epochs=3", "preempt_sync_batches=1")
    argv = _dist_trainvali_argv(scene, outroot, "p10_preempt", init_from,
                                *sets)
    res = run_ranks("trainvali", work, rest=argv, rank_opts=lambda r: (
        ["--sigterm-after", "4"] if r == 1 else []))
    f_ok = _ranks_ok(res)
    rec = {}
    if f_ok:
        out = res[0]["result"]["outdir"]
        mgr = ckpt_mod.CheckpointManager(os.path.join(out, "checkpoints"))
        stopped = [("Preempted at epoch 2 batch 0" in r["log"]) for r in res]
        saved = mgr.latest_step()
        res2 = run_ranks("trainvali", work, rest=argv + [
            "--set", "overwrite=False", "--profile"])
        resumed = _ranks_ok(res2)
        steps = sorted(_scalars(out, "train")["loss_train"]) if resumed \
            else []
        f_ok = (all(stopped) and saved == 1 and resumed
                and steps == [1, 2, 3] and mgr.latest_step() == 3)
        prof = {}
        if f_ok:
            with open(os.path.join(out, "profile", "summary.json")) as h:
                prof = json.load(h)
        rec = dict(sigterm_to="rank 1, after its 4th step (epoch 2, batch 0)",
                   both_preempted=stopped, checkpoint_step=saved,
                   resumed_ok=resumed, loss_train_steps=steps,
                   final_step=mgr.latest_step(),
                   failed_resume_logs=_log_tails(res2) if not resumed
                   else [],
                   rank0_traced_steps=prof.get("steps"),
                   rank0_device_s=prof.get("device_s"),
                   rank0_wall_s=prof.get("wall_s"),
                   rank0_idle_share=(1 - prof["device_s"] / prof["wall_s"]
                                     if prof.get("device_s") else
                                     "not measured"))
    emit(check="dist_sigterm_one_rank", card=card,
         seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
         **dict(rec, ok=bool(f_ok)))
    ok &= f_ok
    emit(phase="dist_all", seconds=time.perf_counter() - t_phase,
         ok=bool(ok))
    return bool(ok), launches


def _dist_requests(cfg):
    """The first test batch of phase 7's scene (4 views) and its ids."""
    batch = next(iter(get_dataset_class("nlt")(cfg, "test").iterate(
        seed=0, drop_remainder=False)))
    return ({k: v for k, v in batch.items() if not isinstance(v, list)},
            list(batch["id"]))


def rank_worker(args, rest):
    """The code of one rank of phases 10 and 12 (this script run with
    --rank-worker); writes its result as JSON to args.result."""
    from nlt_tpu_torch import nlt_test
    from nlt_tpu_torch.parallel import mesh as mesh_mod

    os.environ["NLT_TPU_FUSED_STAGE"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {"rank": args.rank}
    if args.rank_worker == "trainvali":
        if args.time_reduce:
            # Time each step's gradient all-reduce (host clock around a
            # synchronize): the tile group's sum, the data group's mean.
            reduce_ms, orig = [], mesh_mod.DataMesh.all_reduce_mean_

            def timed(self, *a, **kw):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = orig(self, *a, **kw)
                torch.cuda.synchronize()
                reduce_ms.append((time.perf_counter() - t) * 1e3)
                return out

            mesh_mod.DataMesh.all_reduce_mean_ = timed
        if args.sigterm_after > 0:
            make = train_mod.make_train_step

            def make_train_step(*a, **kw):
                step, calls = make(*a, **kw), []

                def counted(*s):
                    out = step(*s)
                    calls.append(1)
                    if len(calls) == args.sigterm_after:
                        os.kill(os.getpid(), signal.SIGTERM)
                    return out

                return counted

            train_mod.make_train_step = make_train_step
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        result["outdir"] = trainvali.main(rest)
        torch.cuda.synchronize()
        result["launches"] = _launches()
        result["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        if args.time_reduce:
            result["reduce_ms"] = float(np.median(reduce_ms[1:]))
    elif args.rank_worker == "tile_serve":
        mesh_mod.initialize_distributed(
            "localhost:%d" % args.port, args.world, args.rank,
            backend=args.backend, device="cuda")
        try:
            result.update(_tile_serve_rank(args))
        finally:
            mesh_mod.shutdown()
    elif args.rank_worker == "nlt_test":
        _reset_launches()
        nlt_test.main(rest)
        torch.cuda.synchronize()
        result["launches"] = _launches()
    else:
        mesh_mod.initialize_distributed(
            "localhost:%d" % args.port, args.world, args.rank,
            backend=args.backend, device="cuda")
        mesh = mesh_mod.DataMesh(mesh_mod.device_for_rank("cuda", args.rank),
                                 n_tile=args.n_tile or 1)
        try:
            if args.rank_worker == "bn_step":
                result.update(_bn_step_rank(args, mesh))
            elif args.rank_worker == "tile_step":
                result.update(_tile_step_rank(args, mesh))
            elif args.rank_worker == "tile_options":
                result.update(_tile_options_rank(args, mesh))
            else:
                result.update(_serve_rank(args))
        finally:
            mesh_mod.shutdown()
    with open(args.result, "w") as h:
        json.dump(result, h)
    return 0


def _bn_step_rank(args, mesh):
    """(c): one norm = batch step of this rank's block of the flagship
    batch; rank 0 also runs the one-process step on the whole batch."""
    cfg = options_cfg(args.dtype, norm="batch")
    model = Model(cfg, device="cuda")
    tx = train_mod.make_optimizer(cfg.get_float("lr"), cfg.get_float("mgm"))
    state0 = train_mod.init_state(model, tx, torch.Generator().manual_seed(0))
    batch = _train_batch(30)  # the same seed on every rank
    local, _ = mesh.shard_rows(batch)
    extract = train_mod.make_static_extractor(model)
    step = train_mod.make_train_step(model, tx, cached_statics=True,
                                     with_vis=False, mesh=mesh)
    statics = extract(state0["params"], local)
    step(state0, local, statics)  # warm-up
    torch.cuda.synchronize()
    _reset_launches()
    t = time.perf_counter()
    s1, loss = step(state0, local, statics)
    torch.cuda.synchronize()
    out = {"step_ms": (time.perf_counter() - t) * 1e3, "loss": float(loss),
           "launches": _launches(),
           "params_sum": float(sum(p.double().abs().sum()
                                   for p in tree_leaves(s1["params"])))}
    m0, m1 = _moving(state0["params"]), _moving(s1["params"])
    out["moving_moved"] = bool(m0) and all(not torch.equal(m0[k], m1[k])
                                           for k in m0)
    if mesh.rank == 0:
        ref = train_mod.make_train_step(model, tx, cached_statics=True,
                                        with_vis=False)
        full = extract(state0["params"], batch)
        ref(state0, batch, full)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r1, rloss = ref(state0, batch, full)
        torch.cuda.synchronize()
        out.update(ref_step_ms=(time.perf_counter() - t) * 1e3,
                   ref_loss=float(rloss),
                   stats_err=_stats_err(s1["params"], r1["params"]),
                   stats_rel=_stats_rel(s1["params"], r1["params"]))
    if args.dtype == "float32":
        # The gradient bucket of the flagship recipe (norm None), float32.
        flat = Model(options_cfg("float32"), device="cuda").init_params(
            torch.Generator().manual_seed(0))
        grads = [torch.randn_like(p) for p in tree_leaves(flat)]
        out["bucket_params"] = sum(g.numel() for g in grads)
        times = []
        for i in range(8):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mesh.all_reduce_mean_(grads)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        out["allreduce_ms"] = float(np.median(times[2:]))
    return out


def _serve_rank(args):
    """(e): a sharded Server's answers to a bs-4, a bs-3 and a cached bs-4
    request, saved for the parent to compare."""
    ckpt = args.ckpt
    cfg = config_mod.read_config(os.path.dirname(ckpt).rstrip("/") + ".ini")
    _reset_launches()
    server = Server(ckpt, step="best", config=cfg, pack="uint8", shard=True,
                    device="cuda")
    server.precompute_obs()
    req, ids = _dist_requests(cfg)
    answers = {"bs4": server.predict(req),
               "bs3": server.predict({k: v[:3] for k, v in req.items()})}
    server.predict(req, ids=ids)
    answers["ids"] = server.predict(req, ids=ids)
    torch.cuda.synchronize()
    launches = _launches()
    t = time.perf_counter()
    for _ in range(5):
        server.predict(req)
    latency = (time.perf_counter() - t) / 5 * 1e3
    path = args.result + ".answers.npz"
    np.savez(path, **{"%s/%s" % (k, f): v for k, a in answers.items()
                      for f, v in a.items()})
    return {"answers": path, "cache": server._input_cache.stats(),
            "launches": launches, "latency_ms": latency}


# ---------------------------------------------------------------------------
# 11. Compact resample plans, the general conv path, a converted checkpoint
# ---------------------------------------------------------------------------


def orbax_form(state, clipped):
    """A port state rewritten into the form in which Orbax restores a
    nlt_tpu checkpoint without a template (pinned on the CPU by
    tests/test_torch_convert_ckpt.py): numpy leaves, optax's AMSGrad
    state as a dict, EmptyState as None, chain tuples as lists; with
    clipped, the chain after clip_by_global_norm."""
    def host(tree):
        if isinstance(tree, dict):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [host(v) for v in tree]
        return (tree.detach().cpu().numpy()
                if isinstance(tree, torch.Tensor) else tree)

    out = host(state)
    amsgrad = [out["opt_state"], None]
    out["opt_state"] = [None, amsgrad] if clipped else amsgrad
    return out


# Compact plans: nlt_tpu's take_compact_frac at half the frame, on
# batches whose warps cover 40% of it (so no example is truncated), and a
# capacity below that coverage, which feat_cache.insert must refuse.
COMPACT_FRAC = 0.5
COMPACT_COVERAGE = 0.4
COMPACT_TOO_SMALL = 0.3
# Compact against full plan gradients, relative L2. The resample's image
# gradient (float32 in both dtypes: the prediction is float32 there) is
# the same arithmetic per live row, but K1's float atomics may add the
# same updates in another order (~1e-7 of scale): 1e-6, or the largest
# spread among three full-plan steps of one state and batch if larger.
# The params' gradient too in float32. In bf16 the U-Net's backward
# rounds to bf16 after every stage, so an image gradient that differs in
# its last bits flips roundings there: on the H100 (700 W) one bf16
# compact step read 1.1e-4 from the full plan's while its loss was
# bit-equal and the float32 gradients agreed to 2.3e-8; the params'
# gradient is held to the port's bf16 step bar (phase 6's kernels
# against plain, 1e-2).
COMPACT_GRAD_TOL = 1e-6
COMPACT_BF16_PARAM_TOL = 1e-2
# General-path U-Nets (phase 3's serving config with kernel / stride /
# pool changed). None is fusable (k == s == 2 only), so no stage kernel
# runs: the general convs, the shift matmuls and K1 in a step.
GENERAL_VARIANTS = (("k3s2", {"kernel": 3, "stride": 2}),
                    ("k4s2", {"kernel": 4, "stride": 2}),
                    ("k5s1_maxpool", {"kernel": 5, "stride": 1,
                                      "pool": "max"}))
GENERAL_LAUNCHES = {"contract_stage": 0, "expand_stage": 0,
                    "scatter_add_rows": 1, "conv2x2s2_lrelu": 0}
# The port's bars: the card against the CPU port on one request (float32
# 1e-4 and bfloat16 2e-2 of the output's scale, at least 1; uint8 within
# 1 LSB), and the card with torch's default TF32 switches against the
# card with them off (the general path turns cuDNN's TF32 off itself, so
# they agree; a TF32 sum would move float32 outputs by ~1e-3).
GENERAL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@contextlib.contextmanager
def torch_default_switches():
    """cuDNN's and cuBLAS's TF32 switches at torch's defaults (cuDNN on,
    matmul off) inside, eagerly (a graph replays what its capture chose);
    the script runs with both off."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with graph.disabled():
            yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _flat_grads(state):
    return torch.cat([g.flatten().float()
                      for g in _grads(state["opt_state"]["mu"])])


@contextlib.contextmanager
def image_grad(out):
    """Append to `out` the gradient of the image that the model's
    planned resample warps (the prediction, float32), one per step, of
    eager steps (a replay runs no hook)."""
    from nlt_tpu_torch.ops import resample as rs

    orig = rs.resample_planned

    def spy(img, plan, **kw):
        if img.requires_grad:
            img.register_hook(lambda g: out.append(g.detach().clone()))
        return orig(img, plan, **kw)

    rs.resample_planned = spy
    try:
        with graph.disabled():
            yield
    finally:
        rs.resample_planned = orig


def compact_cfg(dtype, route=None, frac=COMPACT_FRAC):
    over = {} if route is None else {"take_compact_frac": frac,
                                     "take_compact_route": route}
    return options_cfg(dtype, **over)


def compact_pieces(statics, n):
    """Device ms (CUDA-graph replay) of the resample's pieces at the
    step's shapes, full plan against compact plan: the row take, the
    weighted combine, and the compact grid's reconstruction (forward of
    each route, and the backward's row take)."""
    from nlt_tpu_torch.ops import resample as rs

    img = torch.rand((n, RES, RES, 3), device="cuda",
                     generator=torch.Generator("cuda").manual_seed(3))
    table = rs._window_table(img).reshape(n * RES * RES, 12)
    offs = (torch.arange(n, dtype=torch.int32, device="cuda")
            * (RES * RES))
    out = {}
    with torch.no_grad():
        for name, st in statics.items():
            plan = st["products"]["pred_plan"]
            compact = "cpos" in plan
            rows = plan["crows" if compact else "rows"]
            idx = (rows + offs.reshape((n,) + (1,) * (rows.dim() - 1))
                   ).reshape(-1)
            wslot = plan["cwslot" if compact else "wslot"]
            win = table.index_select(0, idx).reshape(rows.shape + (4, 3))
            ms = {"take": time_ms(lambda: table.index_select(0, idx)),
                  "combine": time_ms(
                      lambda: (win * wslot[..., None]).sum(dim=-2))}
            if compact:
                k = rows.shape[1]
                vals = (win * wslot[..., None]).sum(dim=-2).reshape(-1, 3)
                per_ex = torch.arange(n, dtype=torch.int32,
                                      device="cuda")[:, None]
                cpos = plan["cpos"]
                dest = torch.where(cpos < 0, n * RES * RES,
                                   cpos + per_ex * (RES * RES)
                                   ).reshape(-1).long()
                inv = torch.where(plan["cinv"] > 0,
                                  plan["cinv"] + per_ex * k, 0
                                  ).reshape(-1).long()
                g = torch.rand((n * RES * RES, 3), device="cuda")
                ms["reconstruct_take"] = time_ms(
                    lambda: rs.ExpandRowsTake.apply(vals, inv, dest))
                ms["reconstruct_scatter"] = time_ms(
                    lambda: rs.ExpandRows.apply(vals, dest, n * RES * RES))
                ms["reconstruct_backward"] = time_ms(
                    lambda: rs._take_at(g, dest))
            out[name] = ms
    return out


def compact_phase(card):
    """11(a). Returns (ok, launches of the counted compact steps)."""
    from nlt_tpu_torch.parallel import feat_cache as feat_cache_mod

    ok, t0 = True, time.perf_counter()
    launches = {k: 0 for k in KERNELS}
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in make_batch(
        TRAIN_BS, RES, 40 + i, coverage=COMPACT_COVERAGE).items()}
        for i in range(2)]
    tx = train_mod.make_optimizer(1e-3, -1)
    for dtype in ("bfloat16", "float32"):
        models = {"full": Model(compact_cfg(dtype), device="cuda")}
        for route in ("take", "scatter"):
            models[route] = Model(compact_cfg(dtype, route), device="cuda")
        state0 = train_mod.init_state(models["full"], tx,
                                      torch.Generator().manual_seed(0))
        statics = {name: [train_mod.make_static_extractor(m)(
            state0["params"], b) for b in batches]
            for name, m in models.items()}
        steps = {name: train_mod.make_train_step(
            m, tx, cached_statics=True, with_vis=False)
            for name, m in models.items()}
        plan = statics["take"][0]["products"]["pred_plan"]
        k_rows = int(plan["cpos"].shape[1])
        live = [int(c) for c in plan["clive"]]
        # Each path's step from one state on one batch; the full plan's
        # three times (its spread). The compact steps are counted.
        losses, grads, d_img, per_step = {}, {}, {}, {}
        for name in ("full", "take", "full", "scatter", "full"):
            _reset_launches()
            with image_grad(d_img.setdefault(name, [])):
                s, loss = steps[name](state0, batches[0], statics[name][0])
                torch.cuda.synchronize()
            per_step[name] = _launches()
            if name != "full":
                for k, v in per_step[name].items():
                    launches[k] += v
            losses.setdefault(name, []).append(float(loss))
            grads.setdefault(name, []).append(_flat_grads(s))
        pairs = ((0, 1), (0, 2), (1, 2))
        spread = max(_rel_l2(grads["full"][i], grads["full"][j])
                     for i, j in pairs)
        img_spread = max(_rel_l2(d_img["full"][i], d_img["full"][j])
                         for i, j in pairs)
        img_bar = max(COMPACT_GRAD_TOL, img_spread)
        bar = (max(COMPACT_GRAD_TOL, spread) if dtype == "float32"
               else COMPACT_BF16_PARAM_TOL)
        for route in ("take", "scatter"):
            rel = _rel_l2(grads[route][0], grads["full"][0])
            img_rel = _rel_l2(d_img[route][0], d_img["full"][0])
            c_ok = (losses[route][0] == losses["full"][0]
                    and np.isfinite(losses[route][0]) and rel <= bar
                    and img_rel <= img_bar
                    and per_step[route] == TRAIN_LAUNCHES
                    and max(live) <= k_rows)
            emit(check="compact_step_vs_full", dtype=dtype, route=route,
                 frac=COMPACT_FRAC, capacity_rows=k_rows, live_rows=live,
                 loss=losses[route][0], loss_full=losses["full"],
                 loss_bit_equal=losses[route][0] == losses["full"][0],
                 image_grad_rel_l2=img_rel,
                 image_grad_bit_equal=bool(torch.equal(
                     d_img[route][0], d_img["full"][0])),
                 full_image_grad_spread=img_spread, image_grad_tol=img_bar,
                 grad_rel_l2=rel, full_spread_rel_l2=spread, tol=bar,
                 launches_per_step=per_step[route], ok=bool(c_ok))
            ok &= c_ok
        if dtype != "bfloat16":
            continue
        # Step time in turns (the recipe's dtype), and the pieces.
        times = {name: [] for name in models}
        order = ("full", "take", "scatter", "scatter", "take", "full")
        for i in range(2):
            for name in order:
                b, st = batches[i % 2], statics[name][i % 2]
                torch.cuda.synchronize()
                t = time.perf_counter()
                with graph.disabled():  # eager, as the steps above
                    steps[name](state0, b, st)
                torch.cuda.synchronize()
                times[name].append((time.perf_counter() - t) * 1e3)
        emit(phase="compact_timing", card=card, dtype=dtype, bs=TRAIN_BS,
             step_ms=times, median_step_ms={k: float(np.median(v))
                                            for k, v in times.items()},
             device_ms=compact_pieces({k: v[0] for k, v in statics.items()},
                                      TRAIN_BS))
    # A capacity below the scene's coverage: truncated plans, refused.
    small = Model(compact_cfg("bfloat16", "take", COMPACT_TOO_SMALL),
                  device="cuda")
    st = train_mod.make_static_extractor(small)(state0["params"],
                                                batches[0])
    cache = feat_cache_mod.GTFeatureCache(range(TRAIN_BS))
    try:
        cache.insert(list(range(TRAIN_BS)), st)
        refused, msg = False, ""
    except ValueError as e:
        refused, msg = True, str(e)
    emit(check="compact_capacity_refused", frac=COMPACT_TOO_SMALL,
         coverage=COMPACT_COVERAGE, refused=refused, message=msg[:200],
         ok=refused)
    ok &= refused
    emit(phase="compact_all", seconds=time.perf_counter() - t0,
         ok=bool(ok))
    return bool(ok), launches


# Steady-state cached steps enqueue without waiting for the card: under
# torch.cuda.set_sync_debug_mode("error") any call that synchronises
# raises, as a pageable upload of the slot indices in feat_cache.gather
# does. Between epoch ends a trainer makes no such call.
SYNC_FREE_STEPS = 5


def sync_free_phase(card):
    """11(a'): SYNC_FREE_STEPS steady-state steps of feat_cache.gather and
    the captured donated cached step (the flagship recipe at bs 4, two
    batches in turns) under set_sync_debug_mode("error"). Returns ok."""
    from nlt_tpu_torch.parallel import feat_cache as feat_cache_mod

    t0 = time.perf_counter()
    model = Model(options_cfg("bfloat16"), device="cuda")
    tx = train_mod.make_optimizer(1e-3, -1)
    state = train_mod.init_state(model, tx, torch.Generator().manual_seed(0))
    extract = train_mod.make_static_extractor(model)
    step = train_mod.make_train_step(model, tx, cached_statics=True,
                                     donate=True)
    ids = [list(range(i * TRAIN_BS, (i + 1) * TRAIN_BS)) for i in range(2)]
    batches = [{k: torch.from_numpy(v).to("cuda") for k, v in make_batch(
        TRAIN_BS, RES, 90 + i).items()} for i in range(2)]
    cache = feat_cache_mod.GTFeatureCache(ids[0] + ids[1])
    for b_ids, b in zip(ids, batches):
        cache.insert(b_ids, extract(state["params"], b))
    for i in range(2):    # the key's warm-up, then its capture
        state, _, _ = step(state, batches[i], cache.gather(ids[i]))
    torch.cuda.synchronize()
    pinned, replays = feat_cache_mod.INDEX_UPLOADS["pinned"], step.replays
    losses, error = [], ""
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(SYNC_FREE_STEPS):
            statics = cache.gather(ids[i % 2])
            state, loss, _ = step(state, batches[i % 2], statics)
            losses.append(loss)
    except RuntimeError as e:
        error = str(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    losses = [float(x) for x in losses]
    pinned = feat_cache_mod.INDEX_UPLOADS["pinned"] - pinned
    replays = step.replays - replays
    ok = (not error and len(losses) == SYNC_FREE_STEPS
          and bool(np.isfinite(losses).all())
          and pinned == replays == SYNC_FREE_STEPS)
    emit(check="cached_steps_sync_free", card=card, steps=SYNC_FREE_STEPS,
         steps_done=len(losses), error=error[:300], losses=losses,
         pinned_uploads=pinned, replays=replays,
         seconds=time.perf_counter() - t0, ok=bool(ok))
    del model, state, step, extract, cache, batches
    torch.cuda.empty_cache()
    return bool(ok)


def _rel_max(got, want):
    return float(np.abs(got.astype(np.float64) - want).max()
                 / max(float(np.abs(want).max()), 1.0))


@contextlib.contextmanager
def general_calls(log):
    """Record every general-path conv / deconv: kind, kernel, stride and
    input shape."""
    from nlt_tpu_torch.networks import elements as el

    orig = (el._general_conv, el._general_deconv)

    def wrap(kind, fn):
        def call(x, w, stride):
            log.append((kind, int(w.shape[0]), int(stride),
                        list(x.shape)))
            return fn(x, w, stride)
        return call

    el._general_conv = wrap("conv", orig[0])
    el._general_deconv = wrap("deconv", orig[1])
    try:
        yield
    finally:
        el._general_conv, el._general_deconv = orig


def general_phase(card):
    """11(b). Returns (ok, launches of the counted general-path steps)."""
    ok, t0 = True, time.perf_counter()
    launches = {k: 0 for k in KERNELS}
    req = make_batch(1, RES, seed=60)
    batch = {k: torch.from_numpy(v).to("cuda")
             for k, v in make_batch(TRAIN_BS, RES, 61).items()}
    for tag, over in GENERAL_VARIANTS:
        preds = {}
        for dtype in ("bfloat16", "float32"):
            cfg = flagship_cfg(dtype)
            for k, v in over.items():
                cfg.set(k, str(v))
            card_srv = Server(os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "nlt_tpu_torch", "_build", "no_checkpoint"),
                config=cfg, device="cuda")
            calls = []
            _reset_launches()
            with general_calls(calls):
                off = card_srv.predict(req)
            req_launches = _launches()
            with torch_default_switches():
                default = card_srv.predict(req)
            cpu_srv = Server(os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "nlt_tpu_torch", "_build", "no_checkpoint"),
                config=cfg, device="cpu")
            cpu_srv.state = {"params": tree_to(card_srv.state["params"],
                                               "cpu"),
                             "step": card_srv.state["step"]}
            cpu = cpu_srv.predict(req)
            errs = {k: _rel_max(off[k], cpu[k]) for k in cpu}
            lsb = max(int(np.abs(
                np.round(np.clip(off[k], 0, 1) * 255).astype(int)
                - np.round(np.clip(cpu[k], 0, 1) * 255).astype(int)).max())
                for k in cpu)
            switch = {k: _rel_max(default[k], off[k]) for k in off}
            g_ok = (max(errs.values()) <= GENERAL_TOL[dtype]
                    and max(switch.values()) <= GENERAL_TOL[dtype]
                    and all(np.isfinite(v).all() for v in off.values())
                    and bool(calls) and sum(req_launches.values()) == 0
                    and (lsb <= 1 or dtype != "float32"))
            kinds = sorted({"%s%dx%ds%d" % (c[0], c[1], c[1], c[2])
                            for c in calls})
            emit(check="general_predict", variant=tag, dtype=dtype,
                 card_vs_cpu_rel_max=errs, tol=GENERAL_TOL[dtype],
                 uint8_max_lsb_vs_cpu=lsb,
                 default_switches_vs_off_rel_max=switch,
                 default_switches_bit_equal=all(
                     np.array_equal(default[k], off[k]) for k in off),
                 general_layers=kinds, general_calls=len(calls),
                 launches=req_launches, ok=bool(g_ok))
            ok &= g_ok
            preds[dtype] = card_srv
        cats = profile_requests(preds["bfloat16"], req,
                                label="general_" + tag)
        emit(phase="general_request", variant=tag, card=card, bs=1,
             dtype="bfloat16", device_ms_per_request=sum(cats.values()),
             by_category_ms=cats)
        # One float32 training step (barron: LPIPS's own convolutions
        # take TF32 at torch's default switches, which this check is not
        # about), switches off against torch's defaults; counted.
        cfg = options_cfg("float32", loss="barron", **over)
        model = Model(cfg, device="cuda")
        tx = train_mod.make_optimizer(1e-3, -1)
        state0 = train_mod.init_state(model, tx,
                                      torch.Generator().manual_seed(0))
        st = train_mod.make_static_extractor(model)(state0["params"], batch)
        step = train_mod.make_train_step(model, tx, cached_statics=True,
                                         with_vis=False)
        res = {}
        for name in ("off", "default"):
            ctx = (torch_default_switches() if name == "default"
                   else contextlib.nullcontext())
            _reset_launches()
            with ctx:
                s, loss = step(state0, batch, st)
                torch.cuda.synchronize()
            per_step = _launches()
            if name == "off":
                for k, v in per_step.items():
                    launches[k] += v
            res[name] = (float(loss), _flat_grads(s), per_step)
        rel = _rel_l2(res["default"][1], res["off"][1])
        loss_rel = abs(res["default"][0] - res["off"][0]) / abs(
            res["off"][0])
        s_ok = (np.isfinite(res["off"][0]) and loss_rel <= 1e-5
                and rel <= GENERAL_TOL["float32"]
                and res["off"][2] == GENERAL_LAUNCHES)
        emit(check="general_step", variant=tag, dtype="float32",
             loss=res["off"][0], loss_default_switches=res["default"][0],
             loss_rel=loss_rel, grad_rel_l2_default_vs_off=rel,
             tol=GENERAL_TOL["float32"], launches_per_step=res["off"][2],
             ok=bool(s_ok))
        ok &= s_ok
        del preds, model, state0, st
        torch.cuda.empty_cache()
    emit(phase="general_all", seconds=time.perf_counter() - t0,
         ok=bool(ok))
    return bool(ok), launches


def converted_phase(work, main_out, card):
    """11(c). Returns (ok, launches by path)."""
    from nlt_tpu_torch import convert
    from nlt_tpu_torch.utils import checkpoint as ckpt_mod

    ok, t0 = True, time.perf_counter()
    ckpt = os.path.join(main_out, "checkpoints")
    best = ckpt_mod.resolve_step(ckpt, "best")
    tree = ckpt_mod.CheckpointManager(ckpt).load(best)
    cfg = config_mod.read_config(main_out.rstrip("/") + ".ini")
    clipped = cfg.get_float("mgm", -1.0) > 0
    # What convert_nlt_tpu_checkpoint.py does, from the Orbax form on.
    state = convert.state_from_restored(orbax_form(tree, clipped), "cpu")
    outroot = os.path.join(work, "out")
    conv_out = os.path.join(outroot, "p11_converted")
    ckpt_mod.CheckpointManager(os.path.join(conv_out, "checkpoints")).save(
        best, state, force=True)
    shutil.copyfile(main_out.rstrip("/") + ".ini", conv_out + ".ini")
    os.makedirs(os.path.join(conv_out, "summary_vali"))
    shutil.copyfile(os.path.join(main_out, "summary_vali", "scalars.jsonl"),
                    os.path.join(conv_out, "summary_vali", "scalars.jsonl"))
    same = (ckpt_mod._structure(state) == ckpt_mod._structure(tree)
            and all(a.dtype == b.dtype and torch.equal(a, b) for a, b in
                    zip(tree_leaves(state), tree_leaves(tree))))
    emit(check="converted_state", step=best, clipped=clipped,
         leaves=len(tree_leaves(state)), equal_to_original=same, ok=same)
    ok &= same

    conv_ckpt = os.path.join(conv_out, "checkpoints")
    resolved = ckpt_mod.resolve_step(conv_ckpt, "best")
    _, feat_l, all_l, _ = run_nlt_test(conv_ckpt)
    frames = _read_vis(os.path.join(conv_out, "vis_test",
                                    "ckpt-%d_pred" % best))[0]

    def lsb_to(ref):
        return max((int(np.abs(frames[i][0].astype(int)
                               - ref[i][0].astype(int)).max())
                    for i in frames if i in ref), default=255)

    bit_equal = sorted(frames) == sorted(PHASE8_FRAMES) and all(
        np.array_equal(frames[i][0], PHASE8_FRAMES[i][0])
        and frames[i][1] == PHASE8_FRAMES[i][1] for i in frames)
    repeat_equal = None
    if not bit_equal:
        # Is the original itself bit-equal from run to run?
        vis_test = os.path.join(main_out, "vis_test")
        shutil.rmtree(vis_test, ignore_errors=True)
        run_nlt_test(ckpt)
        again = _read_vis(os.path.join(vis_test, "ckpt-%d_pred" % best))[0]
        shutil.rmtree(vis_test, ignore_errors=True)
        repeat_equal = sorted(again) == sorted(PHASE8_FRAMES) and all(
            np.array_equal(again[i][0], PHASE8_FRAMES[i][0]) for i in again)
    lsb = lsb_to(PHASE8_FRAMES)
    n_ok = (resolved == best and sorted(frames) == sorted(PHASE8_FRAMES)
            and len(frames) == N_TEST
            and (bit_equal or (repeat_equal is False and lsb <= 1)))
    emit(check="converted_nlt_test_vs_phase8", step=best,
         resolved_best=resolved, frames=len(frames), bit_equal=bit_equal,
         original_repeat_bit_equal=repeat_equal, max_lsb=lsb,
         launches=all_l, launches_extract_feat=feat_l, ok=bool(n_ok))
    ok &= n_ok

    # One trainvali epoch resumed from each (copies, so phase 7's run
    # stays as it is), counted for the converted one.
    scene = os.path.join(work, "scene512")
    resumed, resume_launches = {}, {}
    for name, src in (("p11_resume_original", tree),
                      ("p11_resume_converted", state)):
        ckpt_mod.CheckpointManager(os.path.join(
            outroot, name, "checkpoints")).save(best, src, force=True)
        _reset_launches()
        out, _ = run_trainvali(scene, outroot, name, "epochs=%d" % (best + 1),
                               "overwrite=False")
        if name == "p11_resume_converted":
            resume_launches = _launches()
        resumed[name] = _scalars(out, "train")["loss_train"]
    a, b = resumed["p11_resume_converted"], resumed["p11_resume_original"]
    r_ok = sorted(a) == [best + 1] and _losses_close(a, b, TV_REPEAT_TOL)
    emit(check="converted_resume_vs_original", step=best, loss_train=a,
         loss_train_original=b, bit_equal=a == b, rtol=TV_REPEAT_TOL,
         launches=resume_launches, ok=bool(r_ok))
    ok &= r_ok
    emit(phase="converted_all", seconds=time.perf_counter() - t0,
         ok=bool(ok))
    return bool(ok), {"converted_nlt_test": all_l,
                      "converted_resume": resume_launches}


def phase11(work, main_out, card):
    """Compact plans, the general conv path and a converted checkpoint.
    Returns (ok, launches by path)."""
    t0 = time.perf_counter()
    c_ok, c_l = compact_phase(card)
    c_ok &= sync_free_phase(card)
    g_ok, g_l = general_phase(card)
    v_ok, v_l = (converted_phase(work, main_out, card) if main_out
                 else (False, {}))
    emit(phase="phase11_all", seconds=time.perf_counter() - t0,
         ok=bool(c_ok and g_ok and v_ok))
    return bool(c_ok and g_ok and v_ok), dict(
        v_l, compact_steps=c_l, general_steps=g_l)


# ---------------------------------------------------------------------------
# 12. The tile axis: a request's or an example's U-Net rows over ranks
# ---------------------------------------------------------------------------

# Tile-sharded answers against the one-process server's, as a fraction of
# the one-process output's largest magnitude: the tile ranks run the same
# stages on row blocks (the kernels sum each pixel in one order whatever
# the block), so float32 differs only where a stage takes another route
# at a halo-extended shape (split and tiled sum alike: bit-equal) or a
# 1x1 conv's matmul blocks differently: 1e-5. bf16 at the port's bf16
# server bar, 2e-2; uint8 within 1 LSB.
TILE_SERVE_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# The tile trainvali run against one process, float32: per-epoch losses to
# 1e-6 relative (the forward is the one-process forward on row blocks;
# the U-Net's gradients are summed in another order, and K1's atomics
# reorder from run to run); final params to max(1e-5, 3x the spread of
# two runs of each), as phase 10(a) (spread_bar).
TILE_TV_TOL = 1e-6
# One bf16 step on n_data 2 x n_tile 2 ranks against one process on the
# whole batch, at the port's bf16 step bar: the loss to 1e-4 relative,
# each leaf's gradient to 1e-2 of its largest entry.
TILE_STEP_TOL = {"loss": 1e-4, "grad": 1e-2}
TILE_SERVE_VARIANTS = (
    # (label, compute dtype, pack, baked pyramid, batch sizes)
    ("bf16_uint8_pyramid", "bfloat16", "uint8", True, (1, 4)),
    ("bf16_uint8_no_pyramid", "bfloat16", "uint8", False, (1, 4)),
    ("f32_pyramid", "float32", None, True, (1,)),
    ("bf16_pyramid", "bfloat16", None, True, (1,)),
)


def _tile_requests():
    return {1: make_batch(1, RES, seed=10), 4: make_batch(4, RES, seed=20)}


def _tile_pyramid():
    return Batches([make_batch(4, RES, seed=1), make_batch(4, RES, seed=2)])


@contextlib.contextmanager
def stage_routes(record):
    """Record (kind, input shape, dtype, route) of every stage kernel
    launched inside: the planners' answers at the shapes the calls
    bring (halo-extended under the tile axis)."""
    orig = {k: getattr(fs, k) for k in ("_contract_route", "_expand_route")}

    def wrap(kind, fn):
        def route(x, w1, w2, c, o):
            plan = fn(x, w1, w2, c, o)
            record.append((kind, list(x.shape), str(x.dtype).split(".")[-1],
                           "tiled" if plan is None else "split"))
            return plan
        return route

    try:
        fs._contract_route = wrap("contract_stage", orig["_contract_route"])
        fs._expand_route = wrap("expand_stage", orig["_expand_route"])
        yield record
    finally:
        for k, v in orig.items():
            setattr(fs, k, v)


@contextlib.contextmanager
def timed_collectives(mesh, record, names=None):
    """Count and time (host clock around a synchronize) the tile group's
    collectives inside: halo all_gathers, row gathers, reduces (`names`:
    {mesh method: label}, other methods)."""
    names = names or {"tile_all_gather": "halo",
                      "gather_tile_rows": "gather",
                      "tile_all_reduce_": "reduce"}
    orig = {k: getattr(mesh, k) for k in names}

    def wrap(name, fn):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            rec = record.setdefault(names[name], {"count": 0, "ms": 0.0})
            rec["count"] += 1
            rec["ms"] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    try:
        for k in names:
            setattr(mesh, k, wrap(k, orig[k]))
        yield record
    finally:
        for k in names:
            delattr(mesh, k)


def _tile_serve_rank(args):
    """(a): a tile-sharded Server of each variant answers its requests;
    per request: launches, the stages' routes, device ms, the tile
    collectives' count and ms, and wall ms; the answers are saved for
    the parent to compare."""
    reqs, answers, per = _tile_requests(), {}, []
    pyramid = _tile_pyramid()
    only_bs1 = args.world > 2
    for label, dtype, pack, baked, sizes in TILE_SERVE_VARIANTS:
        os.environ["NLT_TPU_FUSED_STAGE"] = "1"
        no_ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "nlt_tpu_torch", "_build", "no_checkpoint")
        server = Server(no_ckpt, config=flagship_cfg(dtype), pack=pack,
                        shard="tile", device="cuda")
        if baked:
            server.precompute_obs(pyramid, n_obs_batches=2)
        for bs in sizes:
            if only_bs1 and bs > 1 and label != "bf16_uint8_pyramid":
                continue
            req = reqs[bs]
            server.predict(req)  # warm-up
            torch.cuda.synchronize()
            _reset_launches()
            out = server.predict(req)
            torch.cuda.synchronize()
            launches = _launches()
            key = "%s/bs%d" % (label, bs)
            answers.update({"%s/%s" % (key, f): v for f, v in out.items()})
            routes, coll = [], {}
            with stage_routes(routes), timed_collectives(server.mesh, coll):
                server.predict(req)
            cats = profile_requests(server, req, label="tile_" + key)
            wall = _median_latency_ms(server.predict, req, n=5)
            rec = {"request": key, "launches": launches, "routes": routes,
                   "collectives": coll, "wall_ms": wall,
                   "device_ms": sum(cats.values()) if cats else
                   "not measured", "device_ms_by_category": cats}
            if label == "bf16_uint8_pyramid" and bs == 4:
                ids = ["r%d" % i for i in range(bs)]
                server.predict(req, ids=ids)
                cached = server.predict(req, ids=ids)
                answers.update({"%s_ids/%s" % (key, f): v
                                for f, v in cached.items()})
                rec["cache"] = server._input_cache.stats()
                rec["ids_wall_ms"] = _median_latency_ms(
                    lambda r: server.predict(r, ids=ids), req, n=5)
            per.append(rec)
        del server
        torch.cuda.empty_cache()
    path = args.result + ".answers.npz"
    np.savez(path, **answers)
    return {"answers": path, "requests": per}


def _tile_step_rank(args, mesh):
    """(c): one bf16 step of the flagship training width on this rank's
    block (data index) and rows (tile index); rank 0 also runs the
    one-process step on the whole batch and compares."""
    cfg = train_cfg("bfloat16")
    model = Model(cfg, device="cuda")
    tx = train_mod.make_optimizer(cfg.get_float("lr"), cfg.get_float("mgm"))
    state0 = train_mod.init_state(model, tx, torch.Generator().manual_seed(0))
    batch = _train_batch(30)  # the same seed on every rank
    local, _ = mesh.shard_rows(batch)
    step = train_mod.make_train_step(model, tx, with_vis=False, mesh=mesh)
    step(state0, local)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t = time.perf_counter()
    s1, loss = step(state0, local)
    torch.cuda.synchronize()
    out = {"step_ms": (time.perf_counter() - t) * 1e3, "loss": float(loss),
           "launches": _launches(),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "params_sum": float(sum(p.double().abs().sum()
                                   for p in tree_leaves(s1["params"])))}
    # The gradient bucket's reduce over the world of n_data x n_tile.
    grads = [torch.randn_like(p) for p in tree_leaves(state0["params"])]
    times = []
    for _ in range(8):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mesh.all_reduce_mean_([grads[0]], split=grads[1:])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out["bucket_params"] = sum(g.numel() for g in grads)
    out["allreduce_ms"] = float(np.median(times[2:]))
    if mesh.rank == 0:
        ref = train_mod.make_train_step(model, tx, with_vis=False)
        ref(state0, batch)
        torch.cuda.synchronize()
        t = time.perf_counter()
        r1, rloss = ref(state0, batch)
        torch.cuda.synchronize()
        g = _grads(s1["opt_state"]["mu"])
        gr = _grads(r1["opt_state"]["mu"])
        worst = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(g, gr) if b.abs().max() > 0)
        out.update(ref_step_ms=(time.perf_counter() - t) * 1e3,
                   ref_loss=float(rloss), worst_leaf_grad_err=worst,
                   grad_rel_l2=_rel_l2(torch.cat([a.flatten() for a in g]),
                                       torch.cat([b.flatten()
                                                  for b in gr])))
    return out


def _tile_serve_check(res, want, world, card):
    """Compare each rank's tile answers with the one-process answers;
    emit one line per rank and request. Returns (ok, launches of
    rank 0's requests)."""
    ok = _ranks_ok(res)
    worst = {}
    if not ok:
        return False, {}
    for r in res:
        got = np.load(r["result"]["answers"])
        for key in got.files:
            label, bs_f = key.split("/", 1)
            ref = want[label + "/" + bs_f.replace("_ids", "")]
            g = got[key]
            if g.shape != ref.shape or g.dtype != ref.dtype:
                ok = False
                continue
            if g.dtype == np.uint8:
                err = int(np.abs(g.astype(int) - ref.astype(int)).max())
                tol = 1
            else:
                scale = max(float(np.abs(ref).max()), 1.0)
                err = float(np.abs(g - ref).max()) / scale
                tol = TILE_SERVE_TOL["float32" if label.startswith("f32")
                                     else "bfloat16"]
                ok &= bool(np.isfinite(g).all())
            w = worst.setdefault(label, {"err": 0, "tol": tol,
                                         "bit_equal": True})
            w["err"] = max(w["err"], err)
            w["bit_equal"] &= bool(np.array_equal(g, ref))
            ok &= err <= tol
        for rec in r["result"]["requests"]:
            want_l = dict(QUERY_LAUNCHES) if "no_pyramid" not in \
                rec["request"] else {k: QUERY_LAUNCHES[k] + OBS_LAUNCHES[k]
                                     for k in QUERY_LAUNCHES}
            l_ok = {k: rec["launches"].get(k, 0) for k in want_l} == want_l
            ok &= l_ok
            routes = {}
            for kind, shape, dtype, route in rec["routes"]:
                routes.setdefault(route, []).append([kind, shape, dtype])
            emit(check="tile_serve_request", world=world,
                 rank=r["result"]["rank"],
                 card=card, request=rec["request"],
                 launches=rec["launches"], launches_expected=want_l,
                 launches_ok=l_ok,
                 routes={k: len(v) for k, v in routes.items()},
                 stages_by_route=routes, collectives=rec["collectives"],
                 device_ms=rec["device_ms"],
                 device_ms_by_category=rec["device_ms_by_category"],
                 wall_ms=rec["wall_ms"],
                 cache=rec.get("cache"), ids_wall_ms=rec.get("ids_wall_ms"))
            if "cache" in rec:
                ok &= rec["cache"]["hits"] == 4 and \
                    rec["cache"]["misses"] == 4
    emit(check="tile_serve_answers", world=world, card=card,
         by_variant=worst, ok=bool(ok),
         note="two or more ranks share one card and talk through the "
              "host (gloo): what the tile layer costs, not how it scales")
    first = res[0]["result"]["requests"][0]
    return bool(ok), first["launches"]


def tile_phase(work, main_out, card):
    """Phase 12 (a)-(c). Returns (ok, {label: launches of one rank})."""
    ok, launches = True, {}
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()

    # (a) Tile serving at the flagship serving shape, 2 and 4 ranks,
    # against the one-process servers (the same seeded params).
    t0 = time.perf_counter()
    reqs, pyramid, want = _tile_requests(), _tile_pyramid(), {}
    for label, dtype, pack, baked, sizes in TILE_SERVE_VARIANTS:
        server = make_server(True, dtype, "cuda", pyramid if baked else None,
                             pack=pack)
        for bs in sizes:
            out = server.predict(reqs[bs])
            want.update({"%s/bs%d/%s" % (label, bs, f): v
                         for f, v in out.items()})
        if label == "bf16_uint8_pyramid":
            for bs in sizes:
                emit(phase="tile_serve_one_process", card=card, bs=bs,
                     wall_ms=_median_latency_ms(server.predict, reqs[bs],
                                                n=5))
        del server
    torch.cuda.empty_cache()
    for world in (2, 4):
        res = run_ranks("tile_serve", work, world=world)
        a_ok, first = _tile_serve_check(res, want, world, card)
        emit(check="tile_serve", world=world, card=card,
             seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
             ok=bool(a_ok))
        ok &= a_ok
        for r in res if a_ok else []:
            launches["tile_serve_%d_rank%d" % (world, r["result"]["rank"])] \
                = r["result"]["requests"][0]["launches"]
        t0 = time.perf_counter()

    # (b) trainvali --n_tile 2 on phase 7's scene, float32, 2 epochs,
    # from phase 7's run, against one process with the statics cache off
    # as the tile run has it (the same code path but for the tile layer),
    # in turns: tile, one process, tile (profiled), one process. The
    # one-process runs are eager, as the tile ranks are (phase 10(a)).
    t0 = time.perf_counter()
    scene = os.path.join(work, "scene512")
    outroot = os.path.join(work, "tile")
    init_from = os.path.join(main_out, "checkpoints")
    sets = ("epochs=2", "compute_dtype=float32", "init_from=" + init_from,
            "cache_static=False")
    res = run_ranks("trainvali", work, rest=_dist_trainvali_argv(
        scene, outroot, "p12_tile", init_from) + ["--n_tile", "2"])
    with graph.disabled():
        single, _ = run_trainvali(scene, outroot, "p12_single", *sets)
    res_b = run_ranks("trainvali", work, opts=["--time-reduce"], rest=(
        _dist_trainvali_argv(scene, outroot, "p12_tile_b", init_from)
        + ["--n_tile", "2", "--profile"]))
    with graph.disabled():
        single_b, _ = run_trainvali(scene, outroot, "p12_single_b", *sets)
    b_ok = _ranks_ok(res) and _ranks_ok(res_b)
    rec = {}
    if b_ok:
        tile = res[0]["result"]["outdir"]
        ls = _scalars(single, "train")["loss_train"]
        lt = _scalars(tile, "train")["loss_train"]
        lv, lvs = (_scalars(tile, "vali")["loss_vali"],
                   _scalars(single, "vali")["loss_vali"])
        rel = max((abs(lt[e] - v) / abs(v) for e, v in ls.items()
                   if e in lt), default=float("inf"))
        ckpts = [os.path.join(o, "checkpoints") for o in
                 (single, single_b, tile, res_b[0]["result"]["outdir"])]

        def params_dist(a, b):
            return _params_rel_l2(a, b, 2)

        p_rel, p_spread, p_tol = spread_bar(ckpts[:2], ckpts[2:],
                                            params_dist, DIST_TOL)
        times = _epoch_times(tile)
        n_steps = sum(t["batches"] for t in times)
        n_vali = len(lv)
        want_l = {k: TRAIN_LAUNCHES[k] * n_steps + EVAL_LAUNCHES[k] * n_vali
                  for k in KERNELS}
        per_rank = [r["result"]["launches"] for r in res]
        warned = all("cache_static disabled (tile-sharded/no_batch run)"
                     in r["log"] for r in res)
        writes_ok = ("Checkpointed epoch" in res[0]["log"]
                     and "Checkpointed epoch" not in res[1]["log"])
        with open(os.path.join(res_b[0]["result"]["outdir"], "profile",
                               "summary.json")) as h:
            prof = json.load(h)
        b_ok = (_losses_close(lt, ls, TILE_TV_TOL)
                and _losses_close(lv, lvs, TILE_TV_TOL) and p_rel <= p_tol
                and all(p == want_l for p in per_rank) and warned
                and writes_ok)
        rec = dict(
            loss_train_tile=lt, loss_train_one_process=ls,
            loss_vali_tile=lv, loss_vali_one_process=lvs,
            max_rel_diff=rel, rtol=TILE_TV_TOL, final_params_rel_l2=p_rel,
            final_params_tol=p_tol, final_params_spread=p_spread,
            one_process_repeat_params_rel_l2=params_dist(*ckpts[:2]),
            tile_repeat_params_rel_l2=params_dist(*ckpts[2:]),
            final_params_rel_l2_by_part={
                part: _params_rel_l2(os.path.join(single, "checkpoints"),
                                     os.path.join(tile, "checkpoints"), 2,
                                     part) for part in ("net", "loss")},
            steps_per_rank=n_steps, vali_batches=n_vali,
            launches_per_rank=per_rank, launches_expected=want_l,
            launches_per_step_per_rank={k: TRAIN_LAUNCHES[k]
                                        for k in KERNELS},
            cache_static_warned=warned, only_rank0_writes=writes_ok,
            turns="tile, one process, tile (profiled), one process",
            warm_s_per_batch_by_rank=[_s_per_batch(r["log"]).get(2)
                                      for r in res],
            warm_s_per_batch_one_process=[_warm_s_per_batch(o)
                                          for o in (single, single_b)],
            grad_reduce_ms_by_rank=[r["result"].get("reduce_ms")
                                    for r in res_b],
            peak_mem_bytes_by_rank=[r["result"].get("peak_mem_bytes")
                                    for r in res],
            rank0_traced_steps=prof.get("steps"),
            rank0_device_s=prof.get("device_s"),
            rank0_wall_s=prof.get("wall_s"),
            rank0_idle_share=(1 - prof["device_s"] / prof["wall_s"]
                              if prof.get("device_s") else "not measured"),
            note="two ranks share one card and talk through the host "
                 "(gloo): expect no speed-up")
        launches["tile_trainvali_rank0"] = per_rank[0]
        launches["tile_trainvali_rank1"] = per_rank[1]
    emit(check="tile_trainvali_two_ranks", card=card,
         seconds=time.perf_counter() - t0,
         failed_logs=_log_tails(res) + _log_tails(res_b),
         **dict(rec, ok=bool(b_ok)))
    ok &= b_ok

    # (c) n_data 2 x n_tile 2: one bf16 step at the flagship training
    # width on four ranks against one process.
    t0 = time.perf_counter()
    res = run_ranks("tile_step", work, world=4, opts=["--n-tile", "2"])
    c_ok = _ranks_ok(res)
    rec = {}
    if c_ok:
        r0 = res[0]["result"]
        loss_rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
        per_rank = [r["result"]["launches"] for r in res]
        c_ok = (loss_rel <= TILE_STEP_TOL["loss"]
                and r0["worst_leaf_grad_err"] <= TILE_STEP_TOL["grad"]
                and len({r["result"]["params_sum"] for r in res}) == 1
                and all(p == TRAIN_LAUNCHES for p in per_rank))
        rec = dict(loss_four_ranks=r0["loss"], loss_one_process=r0[
            "ref_loss"], loss_rel=loss_rel,
            worst_leaf_grad_err=r0["worst_leaf_grad_err"],
            grad_rel_l2=r0["grad_rel_l2"], tol=TILE_STEP_TOL,
            ranks_equal=len({r["result"]["params_sum"] for r in res}) == 1,
            launches_per_rank=per_rank,
            step_ms_by_rank=[r["result"]["step_ms"] for r in res],
            one_process_step_ms=r0["ref_step_ms"],
            peak_mem_bytes_by_rank=[r["result"]["peak_mem_bytes"]
                                    for r in res],
            grad_bucket_params=r0["bucket_params"],
            allreduce_ms_by_rank=[r["result"]["allreduce_ms"] for r in res])
        for r in res:
            launches["tile_step_rank%d" % r["result"]["rank"]] = \
                r["result"]["launches"]
    emit(check="tile_step_data2_tile2", card=card,
         seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
         **dict(rec, ok=bool(c_ok)))
    ok &= c_ok
    emit(phase="tile_all", seconds=time.perf_counter() - t_phase,
         ok=bool(ok))
    return bool(ok), launches


# ---------------------------------------------------------------------------
# 13. The tile axis for every U-Net option
# ---------------------------------------------------------------------------

# The U-Net options nlt_tpu's GSPMD splits, at phase 3's serving shape
# and phase 6's training width, each a change of the flagship keys.
TILE_OPTION_VARIANTS = (
    ("norm_batch", {"norm": "batch"}),
    ("norm_instance", {"norm": "instance"}),
    ("norm_layer", {"norm": "layer"}),
    ("norm_pixel", {"norm": "pixel"}),
    ("k3s2", {"kernel": 3, "stride": 2}),
    ("k4s2", {"kernel": 4, "stride": 2}),
    ("k5s1_maxpool", {"kernel": 5, "stride": 1, "pool": "max"}),
    ("k2s1_avgpool", {"kernel": 2, "stride": 1, "pool": "avg"}),
)
# (label, compute dtype, overrides) of the training steps: every serving
# variant in float32, remat (the fused stages on: K2 and K3 on
# halo-extended rows in the forward and the recompute), and norm = batch
# and remat in bf16.
TILE_OPTION_STEPS = tuple(
    [(label, "float32", over) for label, over in TILE_OPTION_VARIANTS]
    + [("remat_fused", "float32", {"remat": True}),
       ("norm_batch", "bfloat16", {"norm": "batch"}),
       ("remat_fused", "bfloat16", {"remat": True})])
# A remat step launches each stage kernel twice (the forward and the
# recompute): 24 K2, 12 K3 and the one K1 a step on every tile rank.
REMAT_LAUNCHES = {"contract_stage": 24, "expand_stage": 12,
                  "scatter_add_rows": 1, "conv2x2s2_lrelu": 0}
# Tile steps against the one-process step. float32: the loss to 1e-5
# relative, the gradient to phase 6's float32 bar, 1e-3 relative L2 (the
# worst leaf is printed: under a norm, sums that cancel turn the 1x1
# convs' other matmul blocking into 1e-3-2e-2 of a leaf's largest). bf16:
# each leaf's gradient to phase 12(c)'s 1e-2 of its largest (a leaf whose
# gradient is zero in exact arithmetic, a conv bias in front of batch or
# instance norm, of the tree's largest), or under BN, where bf16 itself
# moves a leaf more, to the one-process bf16 step's own distance from
# the float32 step (BN's gamma and beta get sums that cancel, and a tile
# rank rounds its share of the sum to bf16 before the ranks add them);
# the loss to phase 12(c)'s 1e-4, and to phase 10(c)'s 1e-2 under BN (the
# merged moments are float32, the one-process ones bf16).
TILE_OPTION_TOL = {"float32": {"loss": 1e-5, "grad_rel_l2": 1e-3},
                   "bfloat16": {"loss": 1e-4, "grad": 1e-2}}
TILE_OPTION_BN_BF16_LOSS_TOL = DIST_BN_TOL["bfloat16"]
# Served answers against one process: float32 to 1e-5 of scale, and the
# uint8 responses (pack_vis's rounding of the same answers) within 1 LSB.
# bs 1 only: bs 4 as well takes the phase over its budget of 150 s.
TILE_OPTION_SERVE_TOL = 1e-5
TILE_OPTION_SERVE_BS = (1,)
TILE_OPTION_COLLECTIVES = {
    "tile_all_gather": "halo", "gather_tile_rows": "gather",
    "tile_all_reduce_": "tile_reduce", "all_reduce_sum_": "bn_reduce",
    "all_reduce_mean_": "grad_reduce"}


def with_moving_stats(params):
    """params with every BN moving statistic set away from its init
    (means 0.1 sin, variances 1 + 0.5 cos of the channel index): what a
    trained BN network serves on."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k.startswith("moving_"):
                i = torch.arange(v.numel(), dtype=torch.float32,
                                 device=v.device).reshape(v.shape)
                out[k] = (0.1 * torch.sin(i + 1.0) if k.startswith(
                    "moving_mean") else 1.0 + 0.5 * torch.cos(i))
            else:
                out[k] = with_moving_stats(v)
        return out
    if isinstance(params, (list, tuple)):
        return [with_moving_stats(v) for v in params]
    return params


def _option_server(over, shard=False):
    """A float32 server (no pyramid: each request's observations run the
    obs U-Net) of one variant, params from the seeded init, with moving
    statistics away from their init."""
    os.environ["NLT_TPU_FUSED_STAGE"] = "1"
    cfg = flagship_cfg("float32")
    for k, v in over.items():
        cfg.set(k, str(v))
    no_ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "nlt_tpu_torch", "_build", "no_checkpoint")
    server = Server(no_ckpt, config=cfg, pack=None,
                    shard="tile" if shard else False, device="cuda")
    server.state = dict(server.state,
                        params=with_moving_stats(server.state["params"]))
    return server


def _norm_cancelled(params, norm):
    """[bool] in tree_leaves(params)'s order: True at the biases whose
    gradient is zero in exact arithmetic (a conv's bias in front of batch
    or instance norm: the norm's mean removes it)."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if not isinstance(t, (list, tuple)):
            return False
        out = [walk(v) for v in t]
        for j in range(len(t) - 1):
            if (norm in ("batch", "instance") and isinstance(t[j], dict)
                    and "b" in t[j] and isinstance(t[j + 1], dict)
                    and "gamma" in t[j + 1]):
                out[j] = dict(out[j], b=True)
        return out
    return tree_leaves(walk(params))


def worst_leaf_grad(g, gr, cancelled):
    """Largest |g - gr| of a leaf as a fraction of its largest |gr|; a
    leaf zero in exact arithmetic (cancelled, or below 1e-6 of the
    tree's largest) as a fraction of the tree's largest."""
    top = max(float(b.abs().max()) for b in gr)
    worst = 0.0
    for a, b, zero in zip(g, gr, cancelled):
        scale = float(b.abs().max())
        if zero or scale < 1e-6 * top:
            scale = top
        worst = max(worst, float((a.float() - b.float()).abs().max())
                    / max(scale, 1e-30))
    return worst


def _timed_step(step, state, batch):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = step(state, batch)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _profiled_device_ms(fn):
    """Device ms of one fn() call (torch.profiler, kernels and copies), or
    'not measured' when the profiler traced none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA") \
                or ev.key.startswith("nlt::"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        total += dev_us / 1e3
    return total if total > 0 else "not measured"


def _tile_options_rank(args, mesh):
    """(a) each variant's tile-sharded server answers a bs-1 and a bs-4
    request; (b) one step of each training variant on this rank's rows;
    rank 0 also runs the one-process step and compares. Per request and
    step: launches, collectives' count and ms, device ms, wall ms."""
    reqs = {bs: make_batch(bs, RES, seed=70 + bs)
            for bs in TILE_OPTION_SERVE_BS}
    answers, serve = {}, []
    for label, over in TILE_OPTION_VARIANTS:
        t0 = time.perf_counter()
        server = _option_server(over, shard=True)
        for bs, req in reqs.items():
            server.predict(req)  # warm-up
            torch.cuda.synchronize()
            _reset_launches()
            out = server.predict(req)
            torch.cuda.synchronize()
            launches = _launches()
            answers.update({"%s/bs%d/%s" % (label, bs, f): v
                            for f, v in out.items()})
            coll = {}
            with timed_collectives(server.mesh, coll,
                                   TILE_OPTION_COLLECTIVES):
                server.predict(req)
            serve.append({
                "variant": label, "bs": bs, "launches": launches,
                "collectives": coll,
                "device_ms": _profiled_device_ms(
                    lambda: server.predict(req)),
                "wall_ms": _median_latency_ms(server.predict, req, n=3),
                "seconds": time.perf_counter() - t0})
        del server
        torch.cuda.empty_cache()
    path = args.result + ".answers.npz"
    np.savez(path, **answers)

    batch = _train_batch(72)  # the same seed on every rank
    steps = []
    for label, dtype, over in TILE_OPTION_STEPS:
        t0 = time.perf_counter()
        os.environ["NLT_TPU_FUSED_STAGE"] = "1"
        cfg = options_cfg(dtype, **over)
        model = Model(cfg, device="cuda")
        tx = train_mod.make_optimizer(cfg.get_float("lr"),
                                      cfg.get_float("mgm"))
        state0 = train_mod.init_state(model, tx,
                                      torch.Generator().manual_seed(0))
        step = train_mod.make_train_step(model, tx, with_vis=False,
                                         mesh=mesh)
        routes = []
        _reset_launches()
        with stage_routes(routes):
            (s1, loss), _ = _timed_step(step, state0, batch)
        rec = {"variant": label, "dtype": dtype, "loss": float(loss),
               "launches": _launches(),
               "stage_rows": [[kind, shape[1]] for kind, shape, _, _
                              in routes]}
        rec["wall_ms"] = _timed_step(step, state0, batch)[1]
        coll = {}
        with timed_collectives(mesh, coll, TILE_OPTION_COLLECTIVES):
            _timed_step(step, state0, batch)
        rec["collectives"] = coll
        rec["device_ms"] = _profiled_device_ms(
            lambda: step(state0, batch))
        if mesh.rank == 0:
            ref = train_mod.make_train_step(model, tx, with_vis=False)
            _timed_step(ref, state0, batch)  # warm-up
            (r1, rloss), rec["one_process_wall_ms"] = _timed_step(
                ref, state0, batch)
            g, gr = _grads(s1["opt_state"]["mu"]), _grads(
                r1["opt_state"]["mu"])
            cancelled = _norm_cancelled(state0["params"],
                                        over.get("norm"))
            rec.update(
                one_process_loss=float(rloss),
                loss_rel=abs(float(loss) - float(rloss)) / abs(float(rloss)),
                worst_leaf_grad_err=worst_leaf_grad(g, gr, cancelled),
                grad_rel_l2=_rel_l2(torch.cat([a.flatten() for a in g]),
                                    torch.cat([b.flatten() for b in gr])))
            if over.get("norm") == "batch":
                rec["moving_stats_rel"] = _stats_rel(s1["params"],
                                                     r1["params"])
            if dtype == "bfloat16":
                # How far bf16 itself moves each leaf: the one-process
                # float32 step from the same params.
                m32 = Model(options_cfg("float32", **over), device="cuda")
                f32 = train_mod.make_train_step(m32, tx, with_vis=False)
                (r32, _), _ = _timed_step(f32, state0, batch)
                rec["bf16_own_grad_err"] = worst_leaf_grad(
                    gr, _grads(r32["opt_state"]["mu"]), cancelled)
                del m32, f32, r32
            del r1, ref
        rec["params_sum"] = float(sum(p.double().abs().sum()
                                      for p in tree_leaves(s1["params"])))
        rec["seconds"] = time.perf_counter() - t0
        steps.append(rec)
        del model, state0, s1, step
        torch.cuda.empty_cache()
    return {"answers": path, "serve": serve, "steps": steps}


def _remat_rows_ok(rec, tile, n_tile):
    """K2 and K3 each ran twice a stage (forward, recompute) on
    halo-extended rows: K2 on its block plus two rows of the rank below
    on every rank but the last, K3 on its block plus one row of the rank
    above on every rank but the first; blocks of RES / n_tile rows
    halving at each contracting stage (six at depth 256; query and
    obs)."""
    from nlt_tpu_torch.networks.convnet import Network

    h0 = RES // n_tile
    n = sum(Network(16, DEPTH, 2, 2).is_contracting) - 1
    got_c = sorted(r for k, r in rec["stage_rows"] if k == "contract_stage")
    got_e = sorted(r for k, r in rec["stage_rows"] if k == "expand_stage")
    want_c = sorted(4 * [(h0 >> i) + (2 if tile < n_tile - 1 else 0)
                         for i in range(n)])
    want_e = sorted(2 * [(h0 >> (n - j)) + (1 if tile > 0 else 0)
                         for j in range(n)])
    return got_c == want_c and got_e == want_e


def tile_options_phase(work, card):
    """Phase 13 (a)-(c). Returns (ok, {label: launches of one rank})."""
    ok, launches = True, {}
    t_phase = time.perf_counter()
    # (a) The one-process answers, each variant's server with the same
    # seeded params and moving statistics.
    reqs = {bs: make_batch(bs, RES, seed=70 + bs)
            for bs in TILE_OPTION_SERVE_BS}
    want, one_wall = {}, {}
    for label, over in TILE_OPTION_VARIANTS:
        server = _option_server(over)
        for bs, req in reqs.items():
            want.update({"%s/bs%d/%s" % (label, bs, f): v
                         for f, v in server.predict(req).items()})
            one_wall["%s/bs%d" % (label, bs)] = _median_latency_ms(
                server.predict, req, n=3)
        del server
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks("tile_options", work, world=2, opts=["--n-tile", "2"])
    r_ok = _ranks_ok(res)
    emit(check="tile_options_ranks", card=card, ranks=2,
         seconds=time.perf_counter() - t0, failed_logs=_log_tails(res),
         ok=bool(r_ok))
    if not r_ok:
        return False, launches

    # (a) Served answers against one process.
    for label, _ in TILE_OPTION_VARIANTS:
        for bs in reqs:
            errs, lsb, a_ok = [], 0, True
            for r in res:
                got = np.load(r["result"]["answers"])
                for f in ("pred_camspc", "pred"):
                    key = "%s/bs%d/%s" % (label, bs, f)
                    g, w = got[key], want[key]
                    a_ok &= g.shape == w.shape and bool(np.isfinite(g).all())
                    errs.append(float(np.abs(g - w).max())
                                / max(float(np.abs(w).max()), 1.0))
                    lsb = max(lsb, int(np.abs(
                        np.round(np.clip(g, 0, 1) * 255).astype(int)
                        - np.round(np.clip(w, 0, 1) * 255).astype(int)
                    ).max()))
            recs = [rec for r in res for rec in r["result"]["serve"]
                    if rec["variant"] == label and rec["bs"] == bs]
            a_ok &= (max(errs) <= TILE_OPTION_SERVE_TOL and lsb <= 1
                     and all(sum(rec["launches"].values()) == 0
                             for rec in recs))
            emit(check="tile_options_serve", card=card, variant=label,
                 bs=bs, dtype="float32", ranks=2,
                 max_rel_err=max(errs), tol=TILE_OPTION_SERVE_TOL,
                 uint8_max_lsb=lsb,
                 launches_by_rank=[rec["launches"] for rec in recs],
                 collectives_by_rank=[rec["collectives"] for rec in recs],
                 device_ms_by_rank=[rec["device_ms"] for rec in recs],
                 wall_ms_by_rank=[rec["wall_ms"] for rec in recs],
                 one_process_wall_ms=one_wall["%s/bs%d" % (label, bs)],
                 rank_seconds=[rec["seconds"] for rec in recs],
                 ok=bool(a_ok))
            ok &= a_ok

    # (b) Training steps against one process; (c) their cost.
    for i, (label, dtype, over) in enumerate(TILE_OPTION_STEPS):
        recs = [r["result"]["steps"][i] for r in res]
        r0, tol = recs[0], dict(TILE_OPTION_TOL[dtype])
        if dtype == "bfloat16" and over.get("norm") == "batch":
            tol["loss"] = TILE_OPTION_BN_BF16_LOSS_TOL
        remat = bool(over.get("remat"))
        want_l = REMAT_LAUNCHES if remat else NORM_LAUNCHES
        l_ok = all({k: rec["launches"].get(k, 0) for k in want_l} == want_l
                   for rec in recs)
        rows_ok = (all(_remat_rows_ok(rec, t, 2)
                       for t, rec in enumerate(recs)) if remat else True)
        if dtype == "bfloat16" and over.get("norm"):
            tol["grad"] = max(tol["grad"], r0["bf16_own_grad_err"])
        grad_ok = (r0["grad_rel_l2"] <= tol["grad_rel_l2"]
                   if dtype == "float32"
                   else r0["worst_leaf_grad_err"] <= tol["grad"])
        b_ok = (np.isfinite(r0["loss"]) and r0["loss_rel"] <= tol["loss"]
                and grad_ok
                and len({rec["params_sum"] for rec in recs}) == 1
                and l_ok and rows_ok)
        if over.get("norm") == "batch":
            b_ok &= r0["moving_stats_rel"] <= (
                BN_STATS_TOL if dtype == "float32" else DIST_BN_TOL[dtype])
        emit(check="tile_options_step", card=card, variant=label,
             dtype=dtype, bs=TRAIN_BS, ranks=2, loss_tile=r0["loss"],
             loss_one_process=r0["one_process_loss"],
             loss_rel=r0["loss_rel"],
             worst_leaf_grad_err=r0["worst_leaf_grad_err"],
             grad_rel_l2=r0["grad_rel_l2"], tol=tol,
             bf16_own_grad_err=r0.get("bf16_own_grad_err"),
             moving_stats_rel=r0.get("moving_stats_rel"),
             ranks_equal=len({rec["params_sum"] for rec in recs}) == 1,
             launches_by_rank=[rec["launches"] for rec in recs],
             launches_expected=want_l, launches_ok=l_ok,
             halo_extended_rows_ok=rows_ok if remat else None,
             stage_rows_by_rank=([rec["stage_rows"] for rec in recs]
                                 if remat else None),
             collectives_by_rank=[rec["collectives"] for rec in recs],
             device_ms_by_rank=[rec["device_ms"] for rec in recs],
             wall_ms_by_rank=[rec["wall_ms"] for rec in recs],
             one_process_wall_ms=r0["one_process_wall_ms"],
             rank_seconds=[rec["seconds"] for rec in recs], ok=bool(b_ok))
        ok &= b_ok
        if remat:
            for t, rec in enumerate(recs):
                launches["tile_remat_%s_rank%d" % (dtype, t)] = \
                    rec["launches"]
    emit(phase="tile_options_all", seconds=time.perf_counter() - t_phase,
         note="two ranks share one card and talk through the host (gloo): "
              "what the tile layer costs for each option, not how it "
              "scales", ok=bool(ok))
    return bool(ok), launches


# ---------------------------------------------------------------------------
# 15. The compiled programs: CUDA graphs over in-place state
# ---------------------------------------------------------------------------

CAPTURE_STEPS = 6
# 15(a)'s runs of each variant, in this order, from one state.
CAPTURE_RUNS = ("eager_a", "captured_a", "eager_b", "captured_b",
                "eager_c")
# Captured against eager, each step's loss (relative) and the params
# after the last step (relative L2): the larger of 1e-6 and 3x the
# spread of the same steps (K1's atomics add in no fixed order, so two
# runs need not agree bit for bit; spread_bar): the losses' spread that
# of the eager runs, the params' the largest of two runs of either path.
CAPTURE_FLOOR = 1e-6
CAPTURE_PSNR_DB = 0.05
CAPTURE_TV_EPOCHS = 2
# A float32 server's captured answers against its eager ones, as a
# fraction of the eager answer's largest magnitude.
CAPTURE_SERVE_F32_TOL = 1e-6


def _params_flat(state):
    return torch.cat([p.detach().flatten().float()
                      for p in tree_leaves(state["params"])])


def _device_and_wall_ms(fn, n=3):
    """(device ms, wall ms) of one fn() call, over n calls traced by
    torch.profiler; device 'not measured' when it traced no kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    total = 0.0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA") \
                or ev.key.startswith("nlt::"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        total += dev_us / 1e3 / n
    return (total if total > 0 else "not measured"), wall


def _idle(dev, wall):
    return 1 - dev / wall if isinstance(dev, float) else "not measured"


# (a)'s variants: (label, compute dtype, .ini keys changed, steps,
# launches a step, warp coverage of the batches). The recipe in both
# dtypes, and the options that change the step's program: BatchNorm's
# batch statistics and merge, remat's recompute, the compact plans'
# take and scatter (on warps that leave room for their capacity, as
# phase 11 runs them).
CAPTURE_VARIANTS = (
    ("recipe", "bfloat16", {}, CAPTURE_STEPS, TRAIN_LAUNCHES, 0.5),
    ("recipe", "float32", {}, CAPTURE_STEPS, TRAIN_LAUNCHES, 0.5),
    ("norm_batch", "bfloat16", {"norm": "batch"}, 3, NORM_LAUNCHES, 0.5),
    ("remat", "bfloat16", {"remat": "true"}, 3, REMAT_LAUNCHES, 0.5),
    ("compact_take", "bfloat16", {"take_compact_frac": COMPACT_FRAC,
                                  "take_compact_route": "take"}, 3,
     TRAIN_LAUNCHES, COMPACT_COVERAGE),
    ("compact_scatter", "bfloat16", {"take_compact_frac": COMPACT_FRAC,
                                     "take_compact_route": "scatter"}, 3,
     TRAIN_LAUNCHES, COMPACT_COVERAGE))


def capture_step_phase(card):
    """15(a): the flagship recipe's donated step (bs 4, 512^2, cached
    statics, barron + LPIPS), bf16 and float32, and the options that
    change its program (CAPTURE_VARIANTS): the same steps eager,
    captured and eager again from one state and one set of batches; the
    captured steps counted. Returns (ok, launches)."""
    ok, launches = True, {k: 0 for k in KERNELS}
    for label, dtype, over, n_steps, want, coverage in CAPTURE_VARIANTS:
        model = Model(options_cfg(dtype, **over), device="cuda")
        tx = train_mod.make_optimizer(1e-3, -1)
        state0 = train_mod.init_state(model, tx,
                                      torch.Generator().manual_seed(0))
        extract = train_mod.make_static_extractor(model)
        batches = [{k: torch.from_numpy(v).to("cuda") for k, v in
                    make_batch(TRAIN_BS, RES, 80 + i,
                               coverage=coverage).items()}
                   for i in range(n_steps)]
        statics = [extract(state0["params"], b) for b in batches]
        step = train_mod.make_train_step(model, tx, cached_statics=True,
                                         donate=True)
        runs, per_step, peak = {}, [], {}
        for name in CAPTURE_RUNS:
            is_captured = name.startswith("captured")
            state = tree_map(torch.clone, state0)
            ptrs = [t.data_ptr() for t in tree_leaves(state)]
            ctx = (contextlib.nullcontext() if is_captured
                   else graph.disabled())
            losses = []
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with ctx:
                for b, st in zip(batches, statics):
                    before = _launches()
                    state, loss, _ = step(state, b, st)
                    losses.append(float(loss))
                    if is_captured:
                        per_step.append({k: v - before[k]
                                         for k, v in _launches().items()})
            peak[name] = torch.cuda.max_memory_allocated()
            in_place = [t.data_ptr() for t in tree_leaves(state)] == ptrs
            runs[name] = (losses, _params_flat(state), in_place, state)
        for p in per_step:
            for k, v in p.items():
                launches[k] += v
        eager_runs = [n for n in CAPTURE_RUNS if n.startswith("eager")]
        capt_runs = [n for n in CAPTURE_RUNS if n.startswith("captured")]

        def loss_dist(a, b):
            return max(abs(x - y) / abs(y)
                       for x, y in zip(runs[a][0], runs[b][0]))

        def params_dist(a, b):
            return _rel_l2(runs[a][1], runs[b][1])

        loss_rel, spread_loss, bar_loss = spread_bar(
            eager_runs, capt_runs, loss_dist, CAPTURE_FLOOR,
            tests_spread=False)
        params_rel, spread_params, bar_params = spread_bar(
            eager_runs, capt_runs, params_dist, CAPTURE_FLOOR)
        in_place = all(r[2] for r in runs.values())
        sg = runs[capt_runs[0]][3]
        s_ok = (isinstance(step, graph.Captured) and step.replays > 0
                and in_place and all(np.isfinite(runs[n][0]).all()
                                     for n in capt_runs)
                and loss_rel <= bar_loss and params_rel <= bar_params
                and all(p == want for p in per_step))
        emit(check="capture_step", card=card, variant=label, dtype=dtype,
             bs=TRAIN_BS, steps=n_steps,
             losses={n: runs[n][0] for n in CAPTURE_RUNS},
             loss_rel=loss_rel, eager_spread_loss_rel=spread_loss,
             loss_bar=bar_loss, params_rel_l2=params_rel,
             spread_params_rel_l2=spread_params,
             params_rel_l2_pairs={"%s|%s" % (a, b): params_dist(a, b)
                                  for i, a in enumerate(CAPTURE_RUNS)
                                  for b in CAPTURE_RUNS[i + 1:]},
             params_bar=bar_params, state_in_place=bool(in_place),
             captures=step.captures, replays=step.replays,
             launches_per_step=per_step[-1], launches_expected=want,
             peak_mem_bytes=peak, ok=bool(s_ok))
        ok &= s_ok
        if (label, dtype) == ("recipe", "bfloat16"):
            # Eager and captured in turns, on the captured run's state
            # (its graph's addresses) and a clone of it.
            eager_state = tree_map(torch.clone, sg)
            b, st = batches[0], statics[0]

            def eager():
                with graph.disabled():
                    step(eager_state, b, st)

            def captured():
                step(sg, b, st)

            medians, times = time_in_turns({"eager": eager,
                                            "captured": captured})
            prof = {name: _device_and_wall_ms(fn) for name, fn in
                    (("eager", eager), ("captured", captured))}
            emit(phase="capture_step_timing", card=card, dtype=dtype,
                 bs=TRAIN_BS, median_ms=medians, step_ms=times,
                 device_ms={k: v[0] for k, v in prof.items()},
                 profiled_wall_ms={k: v[1] for k, v in prof.items()},
                 idle_share={k: _idle(*v) for k, v in prof.items()},
                 replays=step.replays)
        del model, state0, statics, step, runs, sg
        torch.cuda.empty_cache()
    return bool(ok), launches


def capture_trainvali_phase(work, card):
    """15(b): phase 7's trainvali run for CAPTURE_TV_EPOCHS epochs, eager
    and captured in turns (eager, captured, captured profiled, eager
    profiled). Returns (ok, launches of the first captured run)."""
    scene = os.path.join(work, "scene512")
    outroot = os.path.join(work, "out")
    sets = ("epochs=%d" % CAPTURE_TV_EPOCHS,)
    runs, launches = {}, {}
    for name, captured, profile in (("eager_a", False, False),
                                    ("captured_a", True, False),
                                    ("captured_b", True, True),
                                    ("eager_b", False, True)):
        before = dict(graph.REPLAYS)
        _reset_launches()
        with (contextlib.nullcontext() if captured else graph.disabled()):
            out, seconds = run_trainvali(scene, outroot, "p15_" + name,
                                         *sets, profile=profile)
        if name == "captured_a":
            launches = _launches()
        replays = {k: v - before.get(k, 0) for k, v in graph.REPLAYS.items()
                   if v != before.get(k, 0)}
        times = _epoch_times(out)[1:]
        rec = {"loss_train": _scalars(out, "train")["loss_train"],
               "psnr_vali": _scalars(out, "vali").get("psnr_vali", {}),
               "warm_s_per_batch": [t["train_s"] / max(t["batches"], 1)
                                    for t in times],
               "warm_step_dispatch_s_per_batch": [
                   t["step_s"] / max(t["batches"], 1) for t in times],
               "seconds": seconds, "replays": replays}
        if profile:
            with open(os.path.join(out, "profile", "summary.json")) as h:
                p = json.load(h)
            rec["idle_share"] = (1 - p["device_s"] / p["wall_s"]
                                 if p["device_s"] > 0 else "not measured")
            rec["profiled_device_s"] = p["device_s"]
            rec["profiled_wall_s"] = p["wall_s"]
        runs[name] = rec
    eager, capt = ["eager_a", "eager_b"], ["captured_a", "captured_b"]

    def loss_dist(a, b):
        la, lb = runs[a]["loss_train"], runs[b]["loss_train"]
        return max((abs(la[e] - lb[e]) / abs(lb[e]) for e in lb),
                   default=float("inf"))

    loss_rel, spread, bar = spread_bar(eager, capt, loss_dist,
                                       CAPTURE_FLOOR, tests_spread=False)
    psnr_diff = max((abs(runs[c]["psnr_vali"][e] - runs[r]["psnr_vali"][e])
                     for c in capt for r in eager
                     for e in runs[r]["psnr_vali"]), default=float("inf"))
    replayed = all(any("train step" in k for k in runs[n]["replays"])
                   and any("eval step" in k for k in runs[n]["replays"])
                   for n in capt)
    eager_clean = not any(runs[n]["replays"] for n in eager)
    t_ok = (all(sorted(r["loss_train"]) == list(range(
        1, CAPTURE_TV_EPOCHS + 1)) for r in runs.values())
            and loss_rel <= bar and psnr_diff <= CAPTURE_PSNR_DB
            and replayed and eager_clean)
    emit(check="capture_trainvali", card=card, config=TV_CONFIG,
         epochs=CAPTURE_TV_EPOCHS, runs=runs, loss_rel=loss_rel,
         eager_spread_loss_rel=spread, loss_bar=bar,
         psnr_vali_max_diff_db=psnr_diff, psnr_tol_db=CAPTURE_PSNR_DB,
         launches=launches, ok=bool(t_ok))
    return bool(t_ok), launches


def capture_serve_phase(pyramid, card):
    """15(c): phase 5's serving shape (512^2, depth 256, bf16, the baked
    pyramid), bs 1 and 4, streamed and from the input cache (ids=):
    captured answers against eager ones (uint8 bit-equal; a float32
    server's within CAPTURE_SERVE_F32_TOL of scale), the captured
    requests counted; latency, fps, device ms and idle share, eager and
    captured in turns. Returns (ok, launches)."""
    ok, launches = True, {k: 0 for k in KERNELS}
    for pack in ("uint8", None):
        server = make_server(True, "bfloat16", "cuda", pyramid, pack=pack)
        ok &= isinstance(server._program, graph.Captured)
        for bs in (1, 4):
            req = make_batch(bs, RES, seed=90 + bs)
            ids = ["p15_%d_%d" % (bs, i) for i in range(bs)]
            for use in (None, ids):
                with graph.disabled():
                    want = server.predict(req, ids=use)
                server.predict(req, ids=use)   # warm-up
                _reset_launches()
                got = [server.predict(req, ids=use) for _ in range(3)]
                per = _launches()
                if pack is not None:
                    for k in per:
                        launches[k] += per[k]
                if pack is None:
                    err = max(_rel_max(g[k], want[k]) for g in got
                              for k in want)
                    a_ok = err <= CAPTURE_SERVE_F32_TOL
                else:
                    err = None
                    a_ok = all(_bit_equal(g, want) for g in got)
                l_ok = per == {k: 3 * QUERY_LAUNCHES.get(k, 0)
                               for k in KERNELS}
                rec = {"pack": pack, "bs": bs, "cached": use is not None,
                       "equal_to_eager": a_ok, "rel_max": err,
                       "launches_three_requests": per}
                if pack is not None:
                    stats, prof = {}, {}
                    for path in ("eager", "captured", "captured", "eager"):
                        ctx = (graph.disabled() if path == "eager"
                               else contextlib.nullcontext())
                        with ctx:
                            b = server.benchmark(req, n=20, ids=use)
                            prof.setdefault(path, []).append(
                                _device_and_wall_ms(
                                    lambda: server.predict(req, ids=use)))
                        stats.setdefault(path, []).append(
                            (b["latency_s"] * 1e3, b["fps"]))
                    rec.update(
                        latency_ms={p: [x[0] for x in v]
                                    for p, v in stats.items()},
                        fps={p: [x[1] for x in v] for p, v in stats.items()},
                        device_ms={p: [x[0] for x in v]
                                   for p, v in prof.items()},
                        idle_share={p: [_idle(*x) for x in v]
                                    for p, v in prof.items()})
                rec["replays"] = server._program.replays
                r_ok = a_ok and l_ok and server._program.replays > 0
                emit(check="capture_serve", card=card, ok=bool(r_ok), **rec)
                ok &= r_ok
        del server
        torch.cuda.empty_cache()
    return bool(ok), launches


def capture_phase(work, main_out, pyramid, card):
    """15. Returns (ok, {path: launches})."""
    t0 = time.perf_counter()
    a_ok, a_l = capture_step_phase(card)
    emit(phase="capture_step_all", seconds=time.perf_counter() - t0,
         ok=bool(a_ok))
    t1 = time.perf_counter()
    b_ok, b_l = (capture_trainvali_phase(work, card) if main_out
                 else (False, {}))
    emit(phase="capture_trainvali_all", seconds=time.perf_counter() - t1,
         ok=bool(b_ok))
    t1 = time.perf_counter()
    c_ok, c_l = capture_serve_phase(pyramid, card)
    emit(phase="capture_all", seconds=time.perf_counter() - t0,
         serve_seconds=time.perf_counter() - t1,
         ok=bool(a_ok and b_ok and c_ok))
    return bool(a_ok and b_ok and c_ok), {
        "captured_steps": a_l, "captured_trainvali": b_l,
        "captured_requests": c_l}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for kind in ("expand", "contract"):
        ap.add_argument("--%s-route" % kind, choices=("auto", "tiled"),
                        default="auto")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--sweep-recipe", action="append", default=None,
                    choices=sorted(RECIPE_STAGES))
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "chiprun_out"))
    # One rank of phase 10 (started by the script itself).
    ap.add_argument("--rank-worker", default=None,
                    choices=("trainvali", "nlt_test", "bn_step", "serve",
                             "tile_serve", "tile_step", "tile_options"))
    for name in ("--rank", "--world", "--port", "--sigterm-after",
                 "--n-tile"):
        ap.add_argument(name, type=int, default=0)
    ap.add_argument("--time-reduce", action="store_true")
    # The stage backward's phase alone: checks, profile and the cells'
    # steps (--bwd), or the checks alone (--bwd-quick).
    ap.add_argument("--bwd", action="store_true")
    ap.add_argument("--bwd-quick", action="store_true")
    for name in ("--backend", "--result", "--dtype", "--ckpt"):
        ap.add_argument(name, default=None)
    argv = list(sys.argv[1:] if argv is None else argv)
    rest = argv[argv.index("--") + 1:] if "--" in argv else []
    args = ap.parse_args(argv[:argv.index("--")] if "--" in argv else argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if args.rank_worker:
        return rank_worker(args, rest)
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
    fs._bwd_lib()
    ptxas = [ln.strip() for name in sources
             for ln in _build.BUILD_LOGS.get(name, "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", sources=sources,
         seconds=time.perf_counter() - t0, ptxas=ptxas)
    if args.sweep:
        ok = split_sweep(args.out, sweep_shapes(args.sweep_recipe))
        emit(phase="split_sweep_all", ok=bool(ok))
        return 0 if ok else 1
    if args.bwd or args.bwd_quick:
        t0 = time.perf_counter()
        ok, _ = bwd_check_phase()
        if not args.bwd_quick:
            ok &= bwd_profile_phase()
            ok &= bwd_steps_phase()
        emit(phase="stage_bwd_all", seconds=time.perf_counter() - t0,
             ok=bool(ok))
        if not ok:
            print("chip_smoke: FAILED (%s)" % ", ".join(
                dict.fromkeys(map(str, FAILED))), file=sys.stderr)
        return 0 if ok else 1

    # 2. Kernels against their plain versions.
    t0 = time.perf_counter()
    kernels_ok = kernel_phase()
    conv_ok, conv_recs = conv_phase()
    emit(phase="kernels", ok=kernels_ok, conv_stage_ok=conv_ok,
         seconds=time.perf_counter() - t0)
    ok &= kernels_ok and conv_ok

    # 2b. The stage backward's kernels against the plain backward.
    t0 = time.perf_counter()
    bwd_ok, _ = bwd_check_phase()
    bwd_ok &= bwd_profile_phase()
    emit(phase="stage_bwd", ok=bool(bwd_ok), seconds=time.perf_counter() - t0)
    ok &= bwd_ok

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
    # Eager, as before graphs: the routes and the dispatch are chosen
    # in Python at each call (phase 15 times the captured requests).
    with graph.disabled():
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

        # 10. Data-parallel distribution: ranks as subprocesses.
        dist_ok, dist_launches = (dist_phase(work, main_out, card)
                                  if main_out else (False, {}))
        ok &= dist_ok

        # 11. Compact resample plans, the general conv path, and phase
        # 7's checkpoint through the Orbax form and the converter.
        p11_ok, p11_launches = phase11(work, main_out, card)
        ok &= p11_ok

        # 12. The tile axis: U-Net rows over ranks sharing the card.
        tile_ok, tile_launches = (tile_phase(work, main_out, card)
                                  if main_out else (False, {}))
        ok &= tile_ok

        # 13. The tile axis for every U-Net option.
        opt13_ok, opt13_launches = tile_options_phase(work, card)
        ok &= opt13_ok

        # 15. The compiled programs: captured against eager.
        cap_ok, cap_launches = capture_phase(work, main_out, pyramid, card)
        ok &= cap_ok
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
        by_path.update({p: v.get(kind, 0)
                        for p, v in dist_launches.items()})
        by_path.update({p: v.get(kind, 0)
                        for p, v in p11_launches.items()})
        by_path.update({p: v.get(kind, 0)
                        for p, v in tile_launches.items()})
        by_path.update({p: v.get(kind, 0)
                        for p, v in opt13_launches.items()})
        by_path.update({p: v.get(kind, 0)
                        for p, v in cap_launches.items()})
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
        # Phase 10: each rank's trainvali runs K2, K3 and K1; its
        # nlt_test and serving K2 and K3.
        if kind != "conv2x2s2_lrelu":
            ok &= all(dist_launches.get(p, {}).get(kind, 0) > 0 for p in (
                "dist_trainvali_rank0", "dist_trainvali_rank1"))
        if kind in QUERY_LAUNCHES:
            ok &= all(dist_launches.get(p, {}).get(kind, 0) > 0 for p in (
                "dist_nlt_test_rank0", "dist_nlt_test_rank1",
                "dist_serve_rank0", "dist_serve_rank1"))
        # Phase 11: the compact steps and the converted checkpoint's
        # resumed epoch run K1, K2 and K3, its nlt_test K2 and K3; the
        # general-path steps K1 alone.
        if kind != "conv2x2s2_lrelu":
            ok &= all(p11_launches.get(p, {}).get(kind, 0) > 0 for p in (
                "compact_steps", "converted_resume"))
        if kind in QUERY_LAUNCHES:
            ok &= p11_launches.get("converted_nlt_test", {}).get(
                kind, 0) > 0
        if kind == "scatter_add_rows":
            ok &= p11_launches.get("general_steps", {}).get(kind, 0) > 0
        # Phase 12: every tile rank's requests run K2 and K3 on row
        # blocks; its trainvali run and its step K2, K3 and K1.
        if kind in QUERY_LAUNCHES:
            ok &= all(tile_launches.get("tile_serve_%d_rank%d" % (w, r),
                                        {}).get(kind, 0) > 0
                      for w in (2, 4) for r in range(w))
        if kind != "conv2x2s2_lrelu":
            ok &= all(tile_launches.get(p, {}).get(kind, 0) > 0 for p in (
                ["tile_trainvali_rank0", "tile_trainvali_rank1"]
                + ["tile_step_rank%d" % r for r in range(4)]))
        # Phase 13: each tile rank's remat step runs K2, K3 (forward and
        # recompute) and K1, in float32 and bf16.
        if kind != "conv2x2s2_lrelu":
            ok &= all(opt13_launches.get("tile_remat_%s_rank%d" % (d, r),
                                         {}).get(kind, 0) > 0
                      for d in ("float32", "bfloat16") for r in range(2))
        # Phase 15: the captured steps and trainvali run replay K2, K3
        # and K1, the captured requests K2 and K3.
        if kind != "conv2x2s2_lrelu":
            ok &= all(cap_launches.get(p, {}).get(kind, 0) > 0 for p in (
                "captured_steps", "captured_trainvali"))
        if kind in QUERY_LAUNCHES:
            ok &= cap_launches.get("captured_requests", {}).get(kind, 0) > 0
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
              "the cached requests, the exported requests, phase 9's "
              "option paths (E-LPIPS, SSIM, the norms, remat, the options "
              "trainvali epoch), phase 10's ranks (two-rank trainvali, "
              "NCCL world 1, norm = batch steps, nlt_test and serving; "
              "one rank each where noted) and phase 11's paths (the "
              "compact-plan steps, the general-path steps, nlt_test and "
              "a resumed epoch on the converted checkpoint) and phase "
              "12's tile ranks (a bs-1 request of each rank of the 2- and "
              "4-rank tile servers, each rank's --n_tile 2 trainvali run, "
              "each rank's n_data 2 x n_tile 2 step) and phase 13's "
              "(each tile rank's remat step, float32 and bf16) and phase "
              "15's captured paths (the donated steps, the trainvali run, "
              "the requests; replays add what their capture counted), "
              "each counted from 0")
    if not ok:
        print("chip_smoke: FAILED (%s)" % ", ".join(map(str, FAILED)),
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
