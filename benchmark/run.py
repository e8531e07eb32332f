#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (the kernels built or loaded from nlt_tpu_torch/_build/, weights
and inputs from the seed, every shape the cell uses warmed up and
captured), then `seconds` of the cell's traffic, then the comparison
with the reference. The last line of standard output is one JSON
object: correct, attempted, failed, the cell's end-to-end metrics
(--trace 0) or per-layer metrics (--trace 1), the device, and the
numbers compared with their limits (key ``checks``, last). Exits 2
without a result when there is no CUDA card (or fewer than the cell
asks for), 3 when the process holds jax, jaxlib, flax or nlt_tpu after
the window.

"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "benchmark", "_cache")
# Build and kernel caches at fixed paths inside the checkout (the port
# builds its CUDA libraries into nlt_tpu_torch/_build/ itself).
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark.harness import correct, registry, runs  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nlt_tpu")


def _typed(v):
    try:
        return json.loads(v)
    except ValueError:
        return v


def apply_sets(cfg, mix, sets):
    """'config.<key>=<json>' or 'mix.<key>=<json>' over the loaded files
    (the probe's rate sweep, the tests' small sizes)."""
    for s in sets or ():
        key, _, value = s.partition("=")
        where, _, name = key.rpartition(".")
        (cfg if where == "config" else mix)[name] = _typed(value)


def card():
    """The card's name and power limit, from nvidia-smi."""
    if shutil.which("nvidia-smi") is None:
        return "not measured"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        "not measured")


def run_cell(bench, name, seed, seconds, traced, device="cuda", sets=(),
             t_start=None):
    """Run the cell once; returns (result line, Run)."""
    cell = registry.cell(bench, name)
    cfg = registry.config(cell["config"])
    mix = registry.mix(cell["traffic"])
    apply_sets(cfg, mix, sets)
    os.environ.update(cfg.get("env", {}))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    run = runs.Run(name, cfg, mix, seed, seconds, traced, device,
                   T_START if t_start is None else t_start)
    registry.loop(mix["loop"])(run)
    ok, checks = correct.judge(run.numbers, cfg.get("limits", {}))

    metrics = {}
    if not traced:
        for m in registry.metrics_of(bench, name, "end_to_end"):
            value = run.setup_s if m["name"] == "setup_s" else run.e2e.get(
                m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in registry.metrics_of(bench, name, "per_layer"):
            value = registry.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    result = {
        "correct": ok, "attempted": run.attempted, "failed": run.failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": run.memory_peak_bytes}}
    if traced and run.slice is not None:
        result["device"]["busy_s"] = run.slice.busy_s()
        result["device"]["window_s"] = run.slice.window_s
        result["breakdown"] = run.slice.breakdown()
    result["checks"] = checks
    return result, run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.load_benchmark(ROOT)
    chips = registry.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print("benchmark: %s needs %d CUDA card(s); this machine has %d"
              % (args.workload, chips, torch.cuda.device_count()
                 if torch.cuda.is_available() else 0), file=sys.stderr)
        return 2
    result, run = run_cell(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if loaded:
        print("benchmark: the process holds %s" % ", ".join(loaded),
              file=sys.stderr)
        return 3
    power = card()
    print(json.dumps({"info": run.info, "counters": run.counters,
                      "card": power, "window_s": run.window_s}), flush=True)
    print("card %s" % power, file=sys.stderr)
    for key, c in result["checks"].items():
        print("check %s %r limit %r" % (key, c["value"], c["limit"]),
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
