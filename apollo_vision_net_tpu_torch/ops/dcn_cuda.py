"""Wrapper of the hand-written CUDA modulated deformable conv (csrc/dcn_fwd.cu).

``dcn_fwd`` checks its inputs, allocates the output and launches the kernel
on the current CUDA stream. Its plain counterpart is
``ops.dcn.modulated_deform_conv_ref``; the kernel replaces the Pallas kernel
``_dcn_kernel`` of the JAX package (ops/dcn_pallas.py).

``launches`` grows by one per kernel launch, so a run can show that its main
path went through the kernel; ``launches_by_variant`` splits it by the
kernel variant that ran: ``vector`` (16-byte gathers and cp.async weight
rows, C and O whole 16-byte units, aligned tensors) or ``general`` (scalar
loads, any C and O).

``ARGTYPES`` is the C signature of the entry point as ctypes sees it.
"""
from __future__ import annotations

import ctypes

import torch

from apollo_vision_net_tpu_torch.ops.msda_cuda import VARIANTS, _check

SOURCE = "dcn_fwd.cu"

launches = 0
launches_by_variant = dict.fromkeys(VARIANTS.values(), 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    # x, dtype, offset, mask, weight, out, B, H, W, C, Ho, Wo, O, stride,
    # stream, variant
    "dcn_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                _P],
}


def reset_launch_counts() -> None:
    global launches
    launches = 0
    launches_by_variant.update(dict.fromkeys(VARIANTS.values(), 0))


def _lib() -> ctypes.CDLL:
    from apollo_vision_net_tpu_torch.ops import _build

    lib = _build.load(SOURCE)
    if lib.dcn_fwd.argtypes is None:
        lib.dcn_fwd.argtypes = ARGTYPES["dcn_fwd"]
        lib.dcn_fwd.restype = ctypes.c_int
    return lib


def dcn_fwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
            weight: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, H, W, C) f32|bf16; offset (B, Ho, Wo, 9, 2) f32 (x, y) pixel
    offsets per tap, taps row-major; mask (B, Ho, Wo, 9) f32; weight
    (9, C, O) in x's dtype -> (B, Ho, Wo, O) in x's dtype."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"dcn_fwd launches on CUDA tensors, got {x.device}")
    if x.dim() != 4 or offset.dim() != 5 or weight.dim() != 3:
        raise ValueError("x must be (B, H, W, C), offset (B, Ho, Wo, 9, 2), "
                         "weight (9, C, O)")
    B, H, W, C = x.shape
    _, Ho, Wo, K, _ = offset.shape
    O = weight.shape[-1]
    if K != 9 or stride < 1:
        raise ValueError(f"dcn_fwd takes 3x3 taps and stride >= 1, got "
                         f"{K} taps, stride {stride}")
    dev = x.device
    _check("x", x, (B, H, W, C), tuple(_DTYPES), dev)
    _check("offset", offset, (B, Ho, Wo, 9, 2), (torch.float32,), dev)
    _check("mask", mask, (B, Ho, Wo, 9), (torch.float32,), dev)
    _check("weight", weight, (9, C, O), (x.dtype,), dev)
    lib = _lib()
    out = torch.empty((B, Ho, Wo, O), dtype=x.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = (ctypes.c_int * 1)(-1)
    err = lib.dcn_fwd(x.data_ptr(), _DTYPES[x.dtype], offset.data_ptr(),
                      mask.data_ptr(), weight.data_ptr(), out.data_ptr(),
                      B, H, W, C, Ho, Wo, O, int(stride), stream, variant)
    if err != 0:
        raise RuntimeError(f"dcn_fwd kernel launch failed: CUDA error {err}")
    launches += 1
    if variant[0] in VARIANTS:  # an empty call launches nothing
        launches_by_variant[VARIANTS[variant[0]]] += 1
    return out
