"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds. Libraries go to ``hivedscheduler_tpu_torch/_build/``
at first use, named with a hash of the source, of every header it includes
from ``csrc/`` and of the flags, so an edited source or header never loads
a stale library. Several sources build in parallel, one ``nvcc`` each. A
missing ``nvcc`` or a failed build raises with the compiler's output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from typing import Dict, List, Sequence

_OPS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_OPS, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_OPS), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# compiler output (ptxas register and shared-memory report) of each build
# this process ran, by kernel name
BUILD_LOGS: Dict[str, str] = {}
_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under the CUDA home PyTorch finds."""
    path = shutil.which("nvcc")
    if path:
        return path
    from torch.utils import cpp_extension

    home = cpp_extension.CUDA_HOME
    cand = os.path.join(home, "bin", "nvcc") if home else ""
    if cand and os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found (not on PATH, and no CUDA home with bin/nvcc): the "
        "port's CUDA kernels cannot be built"
    )


def sources(name: str) -> List[str]:
    """``csrc/<name>.cu`` and every ``csrc/`` file it includes with
    ``#include "..."``, directly or through another header."""
    todo, seen = [f"{name}.cu"], []
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.append(rel)
        with open(os.path.join(CSRC, rel), "rb") as f:
            todo += [m.decode() for m in _LOCAL_INCLUDE.findall(f.read())]
    return [os.path.join(CSRC, rel) for rel in seen]


def library_path(name: str) -> str:
    """Where the library of ``csrc/<name>.cu`` lives for the current source
    and headers."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(sources(name)):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_all(names: Sequence[str]) -> List[str]:
    """Compile every ``csrc/<name>.cu`` whose library is missing, all
    compilers started together; returns the libraries' paths in order."""
    paths = [library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths) if not os.path.exists(p)]
    if todo:
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        for name, path in todo:
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((name, path, tmp, proc))
        failed = []
        for name, path, tmp, proc in procs:
            BUILD_LOGS[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu (exit "
                              f"{proc.returncode}):\n{BUILD_LOGS[name]}")
            else:
                os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(build(name))
        _LOADED[name] = lib
    return lib
