"""Wrappers of the hand-written CUDA modulated deformable conv and its
backward (csrc/dcn_fwd.cu, which includes the backward's kernels from
csrc/dcn_bwd.cuh).

``dcn_fwd`` checks its inputs, allocates the output and launches the kernel
on the current CUDA stream. Its plain counterpart is
``ops.dcn.modulated_deform_conv_ref``; the kernel replaces the Pallas kernel
``_dcn_kernel`` of the JAX package (ops/dcn_pallas.py). ``dcn_bwd`` is its
gradient (the JAX package's is the XLA VJP of ``_dcn_xla_ref``, not a
Pallas kernel): the im2col kernel writes the modulated samples, two
``torch.matmul`` products give the weight's gradient and the samples'
(the JAX package leaves both to XLA einsums), and the d-input kernel turns
the latter into the gradients of x, the offsets and the mask. Its plain
counterpart is autograd through the plain version.

``launches`` grows by one per forward launch, ``launches_bwd`` by one per
backward (its two kernels), so a run can show that its main path went
through the kernels; ``launches_by_variant`` splits the forward's by the
kernel variant that ran: ``vector`` (16-byte gathers; C and O whole
16-byte units, aligned tensors) or ``general`` (scalar loads, any C and
O); ``launches_bwd_by_variant`` splits the backward's by ``BWD_VARIANTS``:
``quad`` (4 channels a lane: C a multiple of 4, x aligned to 4 channels)
or ``general``.

``ARGTYPES`` are the C signatures of the entry points as ctypes sees them.
"""
from __future__ import annotations

import ctypes

import torch

from apollo_vision_net_tpu_torch.ops.msda_cuda import VARIANTS, _check

SOURCE = "dcn_fwd.cu"

launches = 0
launches_by_variant = dict.fromkeys(VARIANTS.values(), 0)
launches_bwd = 0
# the backward's d-input kernel reports the variant it launched
BWD_VARIANTS = {1: "quad", 0: "general"}
launches_bwd_by_variant = dict.fromkeys(BWD_VARIANTS.values(), 0)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
ARGTYPES = {
    # x, dtype, offset, mask, weight, out, B, H, W, C, Ho, Wo, O, stride,
    # stream, variant
    "dcn_fwd": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
                _P],
    # x, dtype, offset, mask, col, B, H, W, C, Ho, Wo, stride, stream,
    # variant
    "dcn_bwd_im2col": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                       _P],
    # x, dtype, offset, mask, dcol, grad_x_f32, grad_x, grad_offset,
    # grad_mask, B, H, W, C, Ho, Wo, stride, stream, variant
    "dcn_bwd_col2im": [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                       _I, _I, _I, _P, _P],
}


def reset_launch_counts() -> None:
    global launches, launches_bwd
    launches = 0
    launches_bwd = 0
    launches_by_variant.update(dict.fromkeys(VARIANTS.values(), 0))
    launches_bwd_by_variant.update(dict.fromkeys(BWD_VARIANTS.values(), 0))


def _lib() -> ctypes.CDLL:
    from apollo_vision_net_tpu_torch.ops import _build

    lib = _build.load(SOURCE)
    if lib.dcn_fwd.argtypes is None:
        for name, argtypes in ARGTYPES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def _check_dcn(name, x, offset, mask, stride):
    """(B, H, W, C, Ho, Wo) of a call of entry ``name``, its inputs
    checked."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got {x.device}")
    if x.dim() != 4 or offset.dim() != 5:
        raise ValueError("x must be (B, H, W, C), offset (B, Ho, Wo, 9, 2)")
    B, H, W, C = x.shape
    _, Ho, Wo, K, _ = offset.shape
    if K != 9 or stride < 1:
        raise ValueError(f"{name} takes 3x3 taps and stride >= 1, got "
                         f"{K} taps, stride {stride}")
    dev = x.device
    _check("x", x, (B, H, W, C), tuple(_DTYPES), dev)
    _check("offset", offset, (B, Ho, Wo, 9, 2), (torch.float32,), dev)
    _check("mask", mask, (B, Ho, Wo, 9), (torch.float32,), dev)
    return B, H, W, C, Ho, Wo


def dcn_fwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
            weight: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, H, W, C) f32|bf16; offset (B, Ho, Wo, 9, 2) f32 (x, y) pixel
    offsets per tap, taps row-major; mask (B, Ho, Wo, 9) f32; weight
    (9, C, O) in x's dtype -> (B, Ho, Wo, O) in x's dtype."""
    global launches
    B, H, W, C, Ho, Wo = _check_dcn("dcn_fwd", x, offset, mask, stride)
    if weight.dim() != 3:
        raise ValueError("weight must be (9, C, O)")
    O = weight.shape[-1]
    dev = x.device
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


def dcn_bwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
            weight: torch.Tensor, grad_out: torch.Tensor, stride: int = 1):
    """The gradient of ``dcn_fwd`` at (x, offset, mask, weight) for
    ``grad_out`` (B, Ho, Wo, O) in x's dtype -> (grad_x in x's dtype,
    grad_offset (B, Ho, Wo, 9, 2) f32, grad_mask (B, Ho, Wo, 9) f32,
    grad_weight (9, C, O) in x's dtype). The samples are formed and rounded
    as the forward forms them; grad_x is accumulated in an f32 scratch and
    cast once."""
    global launches_bwd
    B, H, W, C, Ho, Wo = _check_dcn("dcn_bwd", x, offset, mask, stride)
    if weight.dim() != 3:
        raise ValueError("weight must be (9, C, O)")
    O = weight.shape[-1]
    dev = x.device
    _check("weight", weight, (9, C, O), (x.dtype,), dev)
    _check("grad_out", grad_out, (B, Ho, Wo, O), (x.dtype,), dev)
    lib = _lib()
    M = B * Ho * Wo
    stream = torch.cuda.current_stream(dev).cuda_stream
    variant = (ctypes.c_int * 1)(-1)
    col = torch.empty((M, 9 * C), dtype=x.dtype, device=dev)
    err = lib.dcn_bwd_im2col(x.data_ptr(), _DTYPES[x.dtype], offset.data_ptr(),
                             mask.data_ptr(), col.data_ptr(), B, H, W, C, Ho,
                             Wo, int(stride), stream, variant)
    if err != 0:
        raise RuntimeError(f"dcn_bwd_im2col kernel launch failed: CUDA error {err}")
    g = grad_out.reshape(M, O)
    # the two products in x's dtype with f32 accumulation, as the plain
    # version's f32 product rounded by its casts
    grad_weight = (col.t() @ g).reshape(9, C, O)
    dcol = g @ weight.reshape(9 * C, O).t()
    del col
    grad_x_f32 = torch.empty((B, H, W, C), dtype=torch.float32, device=dev)
    grad_x = grad_x_f32 if x.dtype == torch.float32 else torch.empty_like(x)
    grad_offset = torch.empty_like(offset)
    grad_mask = torch.empty_like(mask)
    err = lib.dcn_bwd_col2im(x.data_ptr(), _DTYPES[x.dtype], offset.data_ptr(),
                             mask.data_ptr(), dcol.data_ptr(),
                             grad_x_f32.data_ptr(), grad_x.data_ptr(),
                             grad_offset.data_ptr(), grad_mask.data_ptr(),
                             B, H, W, C, Ho, Wo, int(stride), stream, variant)
    if err != 0:
        raise RuntimeError(f"dcn_bwd_col2im kernel launch failed: CUDA error {err}")
    launches_bwd += 1
    if variant[0] in BWD_VARIANTS:  # an empty call launches nothing
        launches_bwd_by_variant[BWD_VARIANTS[variant[0]]] += 1
    return grad_x, grad_offset, grad_mask, grad_weight
