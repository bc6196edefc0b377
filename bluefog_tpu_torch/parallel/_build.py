"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. The build happens
at first use, from the sources in the package, into
``bluefog_tpu_torch/_build/`` (listed in ``.gitignore``); a library is named
by a hash of its sources and flags, so an edited kernel is rebuilt and an
unchanged one is loaded as it is. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
KERNEL_SOURCES = ("flash_fwd", "flash_bwd", "adam")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(_CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (
                src.stem == name or src.suffix == ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return _BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    out = _lib_path(name)
    if out.exists():
        return out, None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (proc, tmp)


def _finish(name: str, out: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named kernel source not yet built, all nvcc processes
    started together. Returns each source's compiler log (``-Xptxas -v``:
    registers, shared memory, spills; empty when it was already built)."""
    with _lock:
        jobs = {n: _start(n) for n in names}
        return {n: _finish(n, *jobs[n]) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed,
    together with every other kernel source not yet built (one wait for
    the nvcc processes of a step's first use, not one after another)."""
    lib = _libs.get(name)
    if lib is None:
        build(KERNEL_SOURCES)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _libs[name] = lib
    return lib
