"""On the card, at each cell's own size: the program's run is correct
and its control (the reference in float8 in the program's place) is not,
for one seed (probe.py readings does it for a dozen). Run on the card:
``python3 -m pytest benchmark/tests -m chip``."""

import time

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import correct, registry, weights
from benchmark.reference import steps as ref_steps


def _cells():
    return [w["name"] for w in registry.load_benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("cell", _cells())
def test_cell_correct_and_control_not(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seed = 2 ** 35 + 17
    result, run = bench_run.run_cell(registry.load_benchmark(), cell, seed,
                                     3.0, False, t_start=time.perf_counter())
    assert result["correct"], result["checks"]
    cfg = run.cfg
    w0 = weights.unet(cfg, seed, run.device)
    if run.mix["loop"] == "train":
        lp = weights.lpips(seed, run.device)
        batches = run.outputs["batches"]
        numbers = correct.train_numbers(
            ref_steps.train(cfg, w0, lp, batches, precision="fp8"),
            ref_steps.train(cfg, w0, lp, batches), w0)
    else:
        args = (cfg, w0, run.outputs["obs_batch"], run.outputs["requests"])
        numbers = {"frame_rms_lsb": correct.frame_rms_lsb(
            ref_steps.frames(*args, precision="fp8"),
            ref_steps.frames(*args))}
    ok, checks = correct.judge(numbers, cfg["limits"])
    assert not ok, checks
