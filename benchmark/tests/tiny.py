"""A cell at a size a CPU test can hold: 32^2, depth 32, float32
compute (where the program and the reference agree to rounding), a few
cameras and lights."""

import time

from benchmark import run as bench_run
from benchmark.harness import registry

SIZE = ["config.uvh=32", "config.uvw=32", "config.imh=32", "config.imw=32",
        "config.depth=32", "mix.cams=4"]
MIX = {"train": ["mix.lights=4", "mix.holdout=[[0,0],[1,1],[2,2],[3,3]]"],
       "open": ["mix.lights=8", "mix.rate_per_s=40"],
       "closed": ["mix.lights=8"]}


def sets(cell, dtype="float32"):
    bench = registry.load_benchmark()
    loop = registry.mix(registry.cell(bench, cell)["traffic"])["loop"]
    return SIZE + MIX[loop] + ["config.compute_dtype=%s" % dtype]


def run(cell, seed=1234567890123, seconds=1.0, traced=False, **kw):
    """(result line, Run) of the cell on the CPU at the tiny size."""
    return bench_run.run_cell(registry.load_benchmark(), cell, seed, seconds,
                              traced, device="cpu", sets=sets(cell, **kw),
                              t_start=time.perf_counter())
