"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``apollo_vision_net_tpu_torch/csrc/`` is compiled on first
use into ``apollo_vision_net_tpu_torch/build/`` as a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The library
name carries a hash of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU (PATH or /usr/local/cuda/bin)")


def library_path(source: str) -> Path:
    src = CSRC_DIR / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str) -> Path:
    """Compile csrc/<source> unless the library for its current text exists.
    Returns the library path."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>; one handle per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
