"""ctypes bindings for the port's native host library (csrc/host_ops.cpp).

Counterpart of the JAX package's data/native.py, with no quiet fallback:
the library is built with g++ at first use (the JAX package's csrc/Makefile
flags, ``CXX_FLAGS``) into ``apollo_vision_net_tpu_torch/build/``, named by
a hash of the source, the flags and the host's CPU (``-march=native`` code
runs only on the CPU it was built for), and a failed build or load raises
with the compiler's or the loader's message. The numpy versions
(``data/pipeline.py``'s normalize, scale and pad; ``voxelize_numpy`` in
``tools/convert_lidar_to_occ.py``) are the plain versions the tests and
``chip_smoke.py`` hold these against; nothing takes them in the library's
place.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "host_ops.cpp"
BUILD_DIR = PKG_DIR / "build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-pthread", "-Wall")

_lock = threading.Lock()
_lib = None

_F32P = ctypes.POINTER(ctypes.c_float)
ARGTYPES = {
    "resize_normalize_pad": [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, _F32P, _F32P, _F32P,
        ctypes.c_int, ctypes.c_int,
    ],
    "voxelize_points": [
        _F32P, ctypes.c_int64, _F32P, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ],
}


def find_cxx() -> str:
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("the native host library needs a C++ compiler: "
                           f"{os.environ.get('CXX', 'g++')} not found on PATH")
    return cxx


def _cpu_identity() -> str:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as f:
            keep = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(keep)))
    except OSError:
        return platform.processor() or platform.machine()


def library_path() -> Path:
    text = (SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
            + _cpu_identity().encode())
    return BUILD_DIR / f"libhost_ops_{hashlib.sha256(text).hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/host_ops.cpp unless the library for its text, the flags
    and this CPU exists; raises with the compiler's output on failure."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([find_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: each concurrent build writes its own file
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library; one handle per process."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            for name, argtypes in ARGTYPES.items():
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = None
            _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_F32P)


def resized_size(n: int, scale: float) -> int:
    """The library's resized size, ``std::lround(n * scale)`` with the
    product in float32: half away from zero, where the numpy path's
    ``round`` takes half to even (45 rows at scale 0.5: 23 here, 22 there;
    the library then writes one more row than the numpy path)."""
    return int(math.floor(float(np.float32(n) * np.float32(scale)) + 0.5))


def resize_normalize_pad(
    imgs_u8: np.ndarray,  # (N, H, W, 3) uint8 RGB
    scale: float,
    mean: np.ndarray,
    std: np.ndarray,
    size_divisor: int = 32,
) -> np.ndarray:
    """Fused bilinear resize by ``scale``, (x - mean) / std and bottom/right
    zero-pad to ``size_divisor``: (N, H', W', 3) float32. The padded size
    holds the rows and columns the library writes (``resized_size``), so a
    half-way size whose even rounding lands on a multiple of
    ``size_divisor`` (65 rows at 0.5) pads to the next one instead of
    writing past the buffer, as the JAX package's binding would."""
    lib = load()
    imgs_u8 = np.ascontiguousarray(imgs_u8, np.uint8)
    n, h, w, _ = imgs_u8.shape
    nh, nw = resized_size(h, scale), resized_size(w, scale)
    oh = (nh + size_divisor - 1) // size_divisor * size_divisor
    ow = (nw + size_divisor - 1) // size_divisor * size_divisor
    out = np.empty((n, oh, ow, 3), np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.resize_normalize_pad(
        imgs_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n, h, w, ctypes.c_float(scale), _fptr(mean), _fptr(std),
        _fptr(out), oh, ow,
    )
    return out


def voxelize_points(
    points: np.ndarray,       # (n, 4) [x, y, z, label]
    pc_range,
    voxel_size,
    dims: Tuple[int, int, int],  # (xdim, ydim, zdim)
    num_classes: int,
    empty_label: int,
) -> np.ndarray:
    """Majority-vote semantic voxelization -> dense (z·y·x,) int32 labels
    (x minor, the reference's convert_lidar_pcd_to_occ.py:122 layout; ties
    to the smallest label, empty voxels ``empty_label``)."""
    lib = load()
    points = np.ascontiguousarray(points, np.float32)
    xdim, ydim, zdim = dims
    dense = np.full((zdim * xdim * ydim,), empty_label, np.int32)
    pcr = np.ascontiguousarray(pc_range, np.float32)
    lib.voxelize_points(
        _fptr(points), points.shape[0], _fptr(pcr),
        ctypes.c_float(voxel_size[0]), ctypes.c_float(voxel_size[1]),
        ctypes.c_float(voxel_size[2]),
        xdim, ydim, zdim, num_classes,
        dense.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return dense
