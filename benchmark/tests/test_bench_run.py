"""run.py refuses a machine without a card; the harness and the
reference load neither JAX nor the JAX package, and the reference loads
nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import registry

ROOT = registry.ROOT


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dragon_specular.train", "--seed", str(2 ** 34 + 5), "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def _loaded_after(imports):
    code = ("import sys; sys.path.insert(0, %r)\n%s\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % (ROOT, imports))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    top = _loaded_after("import benchmark.run, benchmark.probe\n"
                        "from benchmark.harness import layer, runs, served\n"
                        "import benchmark.loops.closed, benchmark.loops.open, "
                        "benchmark.loops.train\n"
                        "import benchmark.harness.registry as r\n"
                        "[r.metric_reader(m['name']) for m in "
                        "r.load_benchmark()['per_layer']]\n"
                        "import nlt_tpu_torch.serve, "
                        "nlt_tpu_torch.parallel.train")
    assert not top & {"jax", "jaxlib", "flax", "nlt_tpu"}


def test_reference_loads_nothing_of_the_program():
    top = _loaded_after("import benchmark.reference.steps, "
                        "benchmark.reference.precision")
    assert not top & {"jax", "jaxlib", "flax", "nlt_tpu", "nlt_tpu_torch"}


def test_reference_sources_import_no_program():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as h:
            tree = ast.parse(h.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "nlt_tpu", "nlt_tpu_torch",
                    "benchmark"), (f, name)
