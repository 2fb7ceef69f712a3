"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each source under ``apollo_vision_net_tpu_torch/csrc/`` is compiled on first
use into ``apollo_vision_net_tpu_torch/build/`` as a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The library
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt and a stale library is never loaded. ``build_many`` compiles the
sources afresh, one nvcc per source, all at once, and returns each build's
seconds and the compiler's resource report (``-Xptxas -v``: registers,
shared memory, stack frame and spills per kernel).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    # the shared headers (*.cuh) are part of every source's text
    text = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _start(source: str, force: bool = False):
    out = library_path(source)
    if out.exists() and not force:
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    # the compiler's output goes to a file: a pipe nobody reads until the
    # end could fill and stall nvcc
    with open(tmp.with_suffix(".log"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return out, tmp, proc


def _finish(source: str, out: Path, tmp: Path, proc) -> str:
    proc.wait()
    log = tmp.with_suffix(".log")
    report = log.read_text()
    log.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{report}")
    os.replace(tmp, out)
    return report


def build(source: str) -> Path:
    """Compile csrc/<source> unless the library for its current text exists.
    Returns the library path."""
    out, tmp, proc = _start(source)
    if proc is not None:
        _finish(source, out, tmp, proc)
    return out


def build_many(sources: Sequence[str]) -> Dict[str, Tuple[float, str]]:
    """Compile the sources afresh and in parallel (one nvcc each, started
    together), even where a library for their text exists, so that every
    call has the compiler's report. Returns {source: (seconds from the
    common start, ptxas report)}."""
    t0 = time.perf_counter()
    started = {s: _start(s, force=True) for s in sources}
    done = {}
    while len(done) < len(started):
        for s, (_, _, proc) in started.items():
            if s not in done and proc.poll() is not None:
                done[s] = time.perf_counter() - t0
        time.sleep(0.05)
    return {s: (done[s], _finish(s, *started[s])) for s in sources}


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<source>; one handle per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
