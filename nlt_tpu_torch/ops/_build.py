"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``_build/lib<name>-<hash>.so`` (a plain C interface, loaded with
ctypes), at first use. The hash covers the source, every header under
``csrc/`` (``*.cuh``, ``*.h``) and the flags, so an edited source or
header builds anew and an unchanged one is reused. ``build``
starts one ``nvcc`` per source, all at once, and waits for them all.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS = {}
_LOCK = threading.Lock()
# name -> compiler output of the build that produced the loaded library
# (ptxas register / shared-memory / spill report), or "" if it was reused.
BUILD_LOGS = {}


def _nvcc():
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
        "kernels of nlt_tpu_torch are built from source at first use")


def _target(name):
    """(source, library path): the name carries a hash of the source, the
    headers of csrc/ (which any source may include) and the flags."""
    src = os.path.join(CSRC, name + ".cu")
    headers = sorted(f for f in os.listdir(CSRC)
                     if f.endswith((".cuh", ".h")))
    digest = hashlib.sha256()
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, "lib%s-%s.so" % (
        name, digest.hexdigest()[:16]))


def build(names):
    """Compile every source in `names` that has no current library, one
    nvcc process each, started together. Returns {name: library path}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs, paths = {}, {}
    for name in names:
        src, out = _target(name)
        paths[name] = out
        if os.path.exists(out):
            BUILD_LOGS.setdefault(name, "")
            continue
        tmp = "%s.%d.tmp" % (out, os.getpid())
        procs[name] = (subprocess.Popen(
            [_nvcc()] + NVCC_FLAGS + ["-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append("%s (exit %d):\n%s" % (name, proc.returncode, log))
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name):
    """ctypes handle of csrc/<name>.cu, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            _LIBS[name] = lib
        return lib
