"""Drive the PyTorch/CUDA port (nlt_tpu_torch) on one GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass for the run to exit 0:

1. Build the CUDA kernels from nlt_tpu_torch/csrc (nvcc, sm_90a).
2. Hold each fused-stage kernel against its plain PyTorch version at
   every stage shape of the flagship U-Net (512^2, depth0 16, depth 256;
   query and obs paths), in bfloat16 and float32, and at small shapes
   with forced tilings (odd tile counts, ragged edges, one tile, odd
   channel counts). Time kernel, plain version and a cuDNN yardstick.
3. Serve: a Server over the flagship config (bf16 compute, uint8
   responses) with params from a seeded torch.Generator bakes an
   observation pyramid from two synthetic bs-4 batches, then answers 8
   bs-1 requests and one bs-4 request with its launch counters reset;
   every request must launch 6 contract + 6 expand kernels.
4. The whole predict through the kernels against the plain path
   (NLT_TPU_FUSED_STAGE=0, same params): float32 compute to 1e-3 and
   uint8 within 1 LSB; bfloat16 compute at a bf16 tolerance.
5. Serving latency and frames/sec at bs 1 and bs 4, kernels and plain.

Prints the card's name and power limit, one JSON line per check and
timing, a {"kernels": [...]} line, and last {"ok": true, "device": ...}.
Exits non-zero without printing a result when there is no CUDA device.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from nlt_tpu_torch.ops import _build
from nlt_tpu_torch.ops import fused_stage as fs
from nlt_tpu_torch.serve import Server
from nlt_tpu_torch.utils.config import Config

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
SOURCE = "nlt_tpu_torch/csrc/fused_stage.cu"
REPLACES = {"contract_stage": "nlt_tpu/ops/fused_stage.py:115",
            "expand_stage": "nlt_tpu/ops/fused_stage.py:362"}


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


def check_stage(kind, args, slope=0.3, plan=None, timing=False, label=""):
    """Kernel (y2 and y1) against the plain version on the same inputs;
    with timing, also kernel, plain and cuDNN times and the bound."""
    x, w1 = args[0], args[1]
    o = w1.shape[3]
    ref = fs.contract_stage_ref if kind == "contract_stage" \
        else fs.expand_stage_ref
    with torch.no_grad():
        y2k, y1k = fs._launch(kind, *args, slope, True, plan=plan)
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
               "plan": list(plan or fs._plan(
                   kind == "contract_stage", *x.shape, o, x.element_size())),
               "max_abs_err": err, "scale": scale,
               "tol": KERNEL_TOL[x.dtype] * scale, "ok": ok}
        if timing:
            op = getattr(fs, kind)
            lib = library_stage(kind, *args, slope)
            rec["library_max_abs_err"] = float(
                (lib.float() - y2p.float()).abs().max())
            rec["ms"] = time_ms(lambda: op(*args, slope=slope))
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


def kernel_phase():
    recs = []
    for i, (kind, shape, o, plan) in enumerate(EDGE_STAGES):
        for dtype in (torch.float32, torch.bfloat16):
            for slope in (0.3, 0.0):
                args = random_stage(*shape, o, dtype, 100 + i)
                recs.append(check_stage(kind, args, slope, plan=plan,
                                        label="edge"))
    for i, (kind, c, o, h) in enumerate(FLAGSHIP_STAGES):
        for dtype in (torch.bfloat16, torch.float32):
            args = random_stage(1, h, h, c, o, dtype, i)
            recs.append(check_stage(kind, args, timing=True,
                                    label="flagship_bs1"))
    # The library's shared-memory arithmetic matches the planner's.
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
    return all(r["ok"] for r in recs)


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
    if "contract_kernel" in name:
        return "contract_stage kernel"
    if "expand_kernel" in name:
        return "expand_stage kernel"
    if "Memcpy HtoD" in name or "Memcpy DtoH" in name:
        return name.split(" (")[0].lower()
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "matmul (1x1 convs)"
    if "gather" in name.lower() or "index" in name.lower():
        return "gather (resample)"
    return "other elementwise/copy"


def profile_requests(server, req, n=3):
    """Device time per request by category, from torch.profiler over n
    requests of the main path; the busy share is device time over the
    requests' wall time."""
    from torch.profiler import ProfilerActivity, profile

    server.predict(req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            server.predict(req)
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
        emit(phase="profile", wall_ms_per_request=wall_ms,
             device_ms_per_request="not measured",
             note="torch.profiler recorded no device time")
        return
    emit(phase="profile", bs=int(req["base"].shape[0]),
         wall_ms_per_request=wall_ms, device_ms_per_request=total,
         device_busy_share=total / wall_ms,
         by_category_ms=dict(sorted(cats.items(), key=lambda kv: -kv[1])))


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
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
    ptxas = [ln.strip() for name in sources
             for ln in _build.BUILD_LOGS.get(name, "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", sources=sources,
         seconds=time.perf_counter() - t0, ptxas=ptxas)

    # 2. Kernels against their plain versions.
    t0 = time.perf_counter()
    kernels_ok = kernel_phase()
    emit(phase="kernels", ok=kernels_ok, seconds=time.perf_counter() - t0)
    ok &= kernels_ok

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
    fs.reset_launches()
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

    # 5. Serving latency and throughput, and where a request's time goes.
    profile_requests(server, reqs1[0])
    profile_requests(server, req4)
    profile_requests(nopyr, reqs1[0])
    for name, srv in (("kernels", server), ("plain", plain),
                      ("kernels_no_pyramid", nopyr),
                      ("plain_no_pyramid", nopyr_plain)):
        for req in (reqs1[0], req4):
            stats = srv.benchmark(req, n=20)
            emit(phase="serving_benchmark", path=name,
                 bs=int(req["base"].shape[0]), pack="uint8",
                 latency_ms=stats["latency_s"] * 1e3, fps=stats["fps"])

    kernels = []
    for kind in ("contract_stage", "expand_stage"):
        recs = per_kernel.get(kind, [])
        bound = sum(r["bound_ms"] for r in recs)
        by_bytes = sum(r["bound_ms"] for r in recs
                       if r["bound_by"] == "bytes")
        kernels.append({
            "name": kind, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kind], "launches": launches[kind],
            "max_abs_err": max((r["max_abs_err"] for r in recs), default=None),
            "ms": sum(r["ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": bound,
            "bound_by": "bytes" if by_bytes >= bound - by_bytes
            else "operations",
            "library_ms": sum(r["library_ms"] for r in recs)})
        ok &= bool(recs) and launches[kind] > 0
    emit(phase="summary", ok=bool(ok),
         note="kernel ms/plain_ms/bound_ms/library_ms: sums over the "
              "stages of one bs-1 request of the main path")
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
