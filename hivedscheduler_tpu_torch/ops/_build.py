"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``: no PyTorch headers, so a
build takes seconds. Libraries go to ``hivedscheduler_tpu_torch/_build/``
at first use, named with a hash of the source, of every header it includes
from ``csrc/`` and of the flags, so an edited source or header never loads
a stale library. The first use of any of :data:`LIBRARIES` builds every one
of them that is missing, one ``nvcc`` each, all started together. ptxas's
report (``-Xptxas -v``) of each build is kept beside its library, so a
library built by an earlier process still has it. A missing ``nvcc`` or a
failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

_OPS = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_OPS, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_OPS), "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# the kernels' libraries: K1, and K2 and K3, on wgmma for bf16 inputs and for
# fp16 inputs (the fp16 sources include the bf16 ones, instantiated for fp16:
# four compilers in parallel, not two of twice the work), the CUDA-core
# family of all three, the cluster K1, and K2 and K3, past D 256, the 3xTF32
# K1, and K2 and K3, at f32 inputs up to D 128, and the 3xTF32 cluster K1,
# and K2 and K3, past it: eleven compilers at once
LIBRARIES = ("flash_fwd", "flash_bwd", "flash_fwd_f16", "flash_bwd_f16", "flash_generic",
             "flash_fwd_wide", "flash_bwd_wide", "flash_fwd_tf32", "flash_bwd_tf32",
             "flash_fwd_tf32_wide", "flash_bwd_tf32_wide")

_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# compiler output (ptxas register and shared-memory report) of each build
# this process ran, by library name, and each build's wall seconds
BUILD_LOGS: Dict[str, str] = {}
BUILD_SECONDS: Dict[str, float] = {}
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


def log_path(library: str) -> str:
    """Where the compiler's output of the library at ``library`` is kept."""
    return os.path.splitext(library)[0] + ".log"


def build_log(name: str) -> str:
    """The compiler's output of the current library of ``csrc/<name>.cu``:
    this process's build, else the one kept beside the library, else ''."""
    if name in BUILD_LOGS:
        return BUILD_LOGS[name]
    path = log_path(library_path(name))
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def ptxas_report(log: str) -> Dict[str, list]:
    """{kernel: [registers, spill stores, spill loads, serialized]} from a
    ``-Xptxas -v`` log, by mangled kernel name; serialized: ptxas's C7512
    note that it serialized the kernel's wgmma for want of registers."""
    out: Dict[str, list] = {}
    name, serial = None, set()
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, None, None, False]
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            out[name][1:3] = int(m.group(1)), int(m.group(2))
        elif name and "Used" in line and "registers" in line:
            out[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
        m = re.search(r"C7512\).*function '(\w+)'", line)
        if m:
            serial.add(m.group(1))
    for n in serial & set(out):
        out[n][3] = True
    return out


def build_all(names: Sequence[str]) -> List[str]:
    """Compile every ``csrc/<name>.cu`` whose library, or the compiler's
    output kept beside it, is missing, all compilers started together;
    returns the libraries' paths in order."""
    paths = [library_path(n) for n in names]
    todo = [(n, p) for n, p in zip(names, paths)
            if not (os.path.exists(p) and os.path.exists(log_path(p)))]
    if todo:
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = []
        t0 = time.perf_counter()
        for name, path in todo:
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((name, path, tmp, proc))
        failed = []

        def reap(name, proc):
            # one reader a compiler: each one's output is drained as it comes,
            # and its seconds are its own
            BUILD_LOGS[name] = proc.communicate()[0]
            BUILD_SECONDS[name] = time.perf_counter() - t0

        readers = [threading.Thread(target=reap, args=(name, proc)) for name, _, _, proc in procs]
        for reader in readers:
            reader.start()
        for reader in readers:
            reader.join()
        for name, path, tmp, proc in procs:
            if proc.returncode != 0:
                failed.append(f"nvcc failed to build {name}.cu (exit "
                              f"{proc.returncode}):\n{BUILD_LOGS[name]}")
            else:
                with open(log_path(path), "w") as f:
                    f.write(BUILD_LOGS[name])
                os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path."""
    return build_all([name])[0]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed; for
    one of :data:`LIBRARIES`, with every other one of them that is missing,
    in one parallel build."""
    lib = _LOADED.get(name)
    if lib is None:
        if name in LIBRARIES:
            path = build_all(LIBRARIES)[LIBRARIES.index(name)]
        else:
            path = build(name)
        lib = ctypes.CDLL(path)
        _LOADED[name] = lib
    return lib
