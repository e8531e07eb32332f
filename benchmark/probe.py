#!/usr/bin/env python3
"""The measurements the benchmark's limits and fixed rate are set from,
on the card (never part of a cell's run):

    python3 benchmark/probe.py readings --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 3]
    python3 benchmark/probe.py rates --workload <cell> --seed <n> \
        --rates 200,300,400 [--seconds 10]

``readings``: the cell once a seed (set-up, a short window, the
comparison), printing the numbers compared with the reference; for each
control seed also the control, the reference computed in float8 e4m3 in
the program's place, and the faults planted in the reference (training:
every step on half its batch; serving: each sampled request given
another request's answer; training also: no step changes the state),
each against the float32 reference, on the same weights and inputs as
that seed's run.

``rates``: the open loop at each offered rate, printing its latency
percentiles and whether the backlog grew over the window (the last
fifth of the requests later than the first fifth by more than 50%).

One JSON line each, on standard output and in chiprun_out/.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run as bench_run  # noqa: E402
from benchmark.harness import correct, registry, weights  # noqa: E402
from benchmark.reference import steps as ref_steps  # noqa: E402


def _ints(s):
    return [int(x) for x in s.split(",") if x]


def emit(out, **kw):
    line = json.dumps(kw)
    print(line, flush=True)
    out.write(line + "\n")
    out.flush()


def readings(args, bench, out):
    control = set(_ints(args.control_seeds))
    for seed in _ints(args.seeds):
        result, run = bench_run.run_cell(
            bench, args.workload, seed, args.seconds, False, sets=args.set,
            t_start=time.perf_counter())
        emit(out, kind="program", seed=seed, numbers=run.numbers,
             correct=result["correct"], metrics=result["metrics"],
             attempted=run.attempted, failed=run.failed)
        cfg, dev = run.cfg, run.device
        w0 = weights.unet(cfg, seed, dev)
        if run.mix["loop"] == "train":
            # The reference rounded to bfloat16 where the configuration
            # rounds: what the precision alone gives on this seed.
            lp = weights.lpips(seed, dev)
            batches = run.outputs["batches"]
            ref = ref_steps.train(cfg, w0, lp, batches)
            emit(out, kind="reference_bfloat16", seed=seed,
                 numbers=correct.train_numbers(ref_steps.train(
                     cfg, w0, lp, batches, precision="bfloat16"), ref, w0))
            emit(out, kind="program_leaves", seed=seed, leaves=correct
                 .leaf_report(run.outputs["program"], ref, w0),
                 ref_losses=ref[0], program_losses=run.outputs["program"][0])
        if seed not in control:
            continue
        if run.mix["loop"] == "train":
            for kind, kw in (("control_fp8", {"precision": "fp8"}),
                             ("fault_half_batch", {"half": True}),
                             ("fault_state_unchanged", {"frozen": True})):
                got = ref_steps.train(cfg, w0, lp, batches, **kw)
                emit(out, kind=kind, seed=seed,
                     numbers=correct.train_numbers(got, ref, w0),
                     leaves=correct.leaf_report(got, ref, w0))
        else:
            reqs, obs = run.outputs["requests"], run.outputs["obs_batch"]
            ref = ref_steps.frames(cfg, w0, obs, reqs)
            ctl = ref_steps.frames(cfg, w0, obs, reqs, precision="fp8")
            emit(out, kind="control_fp8", seed=seed, numbers={
                "frame_rms_lsb": correct.frame_rms_lsb(ctl, ref)})
            other = ref[1:] + ref[:1]
            emit(out, kind="fault_other_answer", seed=seed, numbers={
                "frame_rms_lsb": correct.frame_rms_lsb(other, ref)})
        del run
        torch.cuda.empty_cache()


def rates(args, bench, out):
    for rate in [float(r) for r in args.rates.split(",")]:
        result, run = bench_run.run_cell(
            bench, args.workload, args.seed, args.seconds, False,
            sets=list(args.set) + ["mix.rate_per_s=%r" % rate],
            t_start=time.perf_counter())
        lat = np.asarray(run.outputs["latency_s"]) * 1e3
        fifth = max(1, len(lat) // 5)
        first, last = float(np.mean(lat[:fifth])), float(np.mean(
            lat[-fifth:]))
        emit(out, kind="rate", rate_per_s=rate, requests=len(lat),
             p50_ms=float(np.percentile(lat, 50)),
             p95_ms=result["metrics"]["serve_p95_ms"]["value"],
             p99_ms=float(np.percentile(lat, 99)),
             first_fifth_mean_ms=first, last_fifth_mean_ms=last,
             backlog_grew=bool(last > 1.5 * first), failed=run.failed,
             hit_share=run.counters["input_cache"],
             correct=result["correct"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("readings", "rates"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--set", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA card", file=sys.stderr)
        return 2
    bench = registry.load_benchmark(ROOT)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "probe_%s_%s.jsonl"
                        % (args.what, args.workload))
    with open(path, "a") as out:
        (readings if args.what == "readings" else rates)(args, bench, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
