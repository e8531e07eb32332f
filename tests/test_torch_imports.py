"""The port stands alone: nlt_tpu_torch and chip_smoke.py import neither
jax nor nlt_tpu, and the entry points refuse to run on a CUDA device
that is not there instead of falling back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from nlt_tpu_torch.utils.config import Config
from tests.test_torch_model import small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    pkg = os.path.join(ROOT, "nlt_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # kernel build outputs
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def _forbidden(name):
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "nlt_tpu")


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, "%s imports %s" % (os.path.relpath(path, ROOT), bad)


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nlt_tpu_torch\n"
        "for m in pkgutil.walk_packages(nlt_tpu_torch.__path__, "
        "'nlt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'nlt_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('nlt_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    from nlt_tpu_torch.models.nlt import Model
    from nlt_tpu_torch.serve import Server

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Server(str(tmp_path / "ckpt"), config=Config(small_cfg()))
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(Config(small_cfg()))
