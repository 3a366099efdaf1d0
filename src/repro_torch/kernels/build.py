"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes`` (route
(b) of a hand-written kernel: no PyTorch headers, so a build takes
seconds). The build happens at first use, into ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``), under a name that
carries a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is loaded as it is. :func:`build` compiles several
libraries at once, one ``nvcc`` process per source, all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "BUILD_DIR", "build", "library", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
SOURCES = {"assign": "assign.cu", "gather_topk": "gather_topk.cu",
           "quant_coarse": "quant_coarse.cu", "dense_topk": "dense_topk.cu",
           "flash_attn": "flash_attn.cu",
           "flash_attn_bwd": "flash_attn_bwd.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (neither on PATH nor at /usr/local/cuda/bin); "
            "the port's CUDA kernels are built with it at first use")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named library (default: all) that is not built yet,
    one ``nvcc`` per source, all started together. Returns each built
    library's ``ptxas`` report (registers, shared memory, spills)."""
    names = list(SOURCES if names is None else names)
    todo = [(n, _lib_path(n)) for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs.append((name, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        reports = {}
        for name, tmp, out, proc in procs:
            stdout, stderr = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {SOURCES[name]} "
                    f"(exit {proc.returncode}):\n{stdout}{stderr}")
            os.replace(tmp, out)
            reports[name] = stdout + stderr
        return reports
    finally:
        for _, tmp, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()


def library_path(name: str) -> Path:
    """Where the built library of one kernel source lives (built or not)."""
    return _lib_path(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib

