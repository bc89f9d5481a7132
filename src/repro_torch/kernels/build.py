"""Builds the port's CUDA kernels at first use.

Each ``csrc/*.cu`` source is compiled on its own by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds).  Builds
land in ``build/kernels/`` at the repository root, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
is reused.  ``build_all`` starts one ``nvcc`` per source together and
waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {"paged_attention": "paged_attention.cu",
           "sketch_update": "sketch_update.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None
              ) -> Dict[str, Tuple[float, str]]:
    """Compile every named kernel (default: all) that is not built yet,
    all ``nvcc`` processes at once.  Returns name -> (seconds, compiler
    log); a kernel already built reports (0.0, "cached")."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, Tuple[float, str]] = {}
    for name in names:
        dst = lib_path(name)
        if dst.exists():
            out[name] = (0.0, "cached")
            continue
        tmp = dst.with_name(f"{dst.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, dst, time.perf_counter())
    for name, (proc, tmp, dst, t0) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} "
                               f"(rc {proc.returncode}):\n{log}")
        os.replace(tmp, dst)         # atomic: concurrent builders agree
        out[name] = (time.perf_counter() - t0, log)
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        _LIBS[name] = lib
    return lib
