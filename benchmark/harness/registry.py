"""Find everything a cell needs by the names in ``BENCHMARK.json``:

- ``configs/<config>.json``: the configuration (the recipe's keys as the
  cell runs them, its source and cuts, the comparison's limits);
- ``traffic/<mix>.json``: the traffic mix, a file of parameters; its key
  ``loop`` names the loop that reads them;
- ``loops/<loop>.py``: one loop, ``run(run)``, that drives the program
  under a mix's parameters;
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(run)``
  returning a number, or None when it found nothing to read.

A cell named in ``BENCHMARK.json`` needs no code of its own: a new cell
is a new entry, and at most a new configuration, mix, loop or metric
file.
"""

import importlib
import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(bench, name):
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError("no workload %r in BENCHMARK.json" % name)


def _json(kind, name):
    path = os.path.join(BENCH_DIR, kind, name + ".json")
    with open(path) as f:
        return json.load(f)


def config(name):
    """configs/<name>.json."""
    return _json("configs", name)


def mix(name):
    """traffic/<name>.json."""
    return _json("traffic", name)


def loop(name):
    """run() of loops/<name>.py."""
    if not re.match(r"^[A-Za-z_][A-Za-z0-9_]*$", name):
        raise ValueError("loop %r is not a module name" % name)
    return importlib.import_module(
        "%s.loops.%s" % (os.path.basename(BENCH_DIR), name)).run


def metric_reader(name):
    """read() of metrics/<name>.py."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench, cell_name, kind):
    """The `kind` ('end_to_end' or 'per_layer') metrics the cell reports:
    an end-to-end metric where its `workloads` list the cell or it has
    none; a per-layer metric where its `workloads` list the cell or,
    without that list, where the cell reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if kind == "end_to_end":
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
