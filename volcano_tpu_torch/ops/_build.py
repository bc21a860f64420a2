"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``. Nothing here includes PyTorch's
headers, so a build takes seconds. The library goes to ``_build/`` in the
package (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source or shared header (``csrc/*.cuh``) is rebuilt
and a built one is reused.

``nvcc`` is looked up on ``PATH``, then under ``$CUDA_HOME`` and
``/usr/local/cuda``. Nothing is built when a module is imported: the first
launch of a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

#: sm_90a (Hopper). No multiply-add contraction and no fast math: the
#: kernels match the reference's float32 results bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build with the "
                       "CUDA toolkit, on a machine with the card")


def _paths(name: str):
    src = os.path.join(CSRC, f"{name}.cu")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    # the source and every shared header it may include
    for path in [src] + sorted(os.path.join(CSRC, h) for h in os.listdir(CSRC)
                               if h.endswith(".cuh")):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = f"lib{name}-{digest.hexdigest()[:12]}"
    return (src, os.path.join(BUILD_DIR, stem + ".so"),
            os.path.join(BUILD_DIR, stem + ".log"))


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns each kernel's compiler log (with
    ptxas's register and shared-memory report)."""
    names = list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, lib, log = _paths(name)
        if not os.path.exists(lib):
            tmp = f"{lib}.{os.getpid()}.tmp"
            out = open(log, "w")
            procs[name] = (subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=out,
                stderr=subprocess.STDOUT), out, tmp, lib)
    failed = []
    for name, (proc, out, tmp, lib) in procs.items():
        rc = proc.wait()
        out.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            failed.append(name)
    logs = {}
    for name in names:
        with open(_paths(name)[2]) as f:
            logs[name] = f.read()
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(_paths(name)[1])
    return lib
