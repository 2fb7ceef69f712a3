"""Modulated deformable convolution v2 (3×3 taps): plain version and front end.

Counterpart of the DCNv2 part of the JAX package's ops/dcnv3.py
(``modulated_deform_conv``), which R101-DCN stages 3-4 run. Layouts are the
JAX package's: x (B, H, W, C), offset (B, Ho, Wo, 9, 2) as (x, y) pixel
offsets per tap with taps row-major (tap k = ky·3 + kx), mask (B, Ho, Wo, 9)
(sigmoid modulation), weight (9, C, O) -> (B, Ho, Wo, O).

Tap k of output pixel (i, j) samples x bilinearly, with zero padding, at
``(j·s + kx - 1, i·s + ky - 1) + offset[i, j, k]`` in input pixels. The
sample is scaled by the mask and rounded to x's dtype; the taps are then
contracted with the weight in f32 and the result rounded to x's dtype (the
JAX package's ``_dcn_xla_ref`` order: sample first, then project).

``modulated_deform_conv`` runs the plain version for CPU tensors and the
CUDA kernel (ops/dcn_cuda.py) for CUDA tensors, through ``DCNFunction``,
whose backward is the hand-written CUDA backward (``dcn_cuda.dcn_bwd``);
the plain version's backward is autograd through it.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from apollo_vision_net_tpu_torch.ops import cost, use_plain

# (dx, dy) of tap k = ky * 3 + kx
_TAPS = torch.tensor([[kx - 1.0, ky - 1.0] for ky in range(3) for kx in range(3)])


def modulated_deform_conv_ref(x: torch.Tensor, offset: torch.Tensor,
                              mask: torch.Tensor, weight: torch.Tensor,
                              stride: int = 1) -> torch.Tensor:
    """Plain PyTorch DCNv2: per bilinear corner, gather and weight; then
    one f32 product with the (9·C, O) weight."""
    B, H, W, C = x.shape
    _, Ho, Wo, K, _ = offset.shape
    O = weight.shape[-1]
    Q = Ho * Wo
    dev = x.device
    ys, xs = torch.meshgrid(torch.arange(Ho, device=dev) * stride,
                            torch.arange(Wo, device=dev) * stride, indexing="ij")
    base = torch.stack([xs, ys], -1).reshape(1, Q, 1, 2).float()
    pos = base + _TAPS.to(dev)[None, None] + offset.float().reshape(B, Q, K, 2)
    px, py = pos[..., 0], pos[..., 1]
    x0, y0 = torch.floor(px), torch.floor(py)
    fx, fy = px - x0, py - y0
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    xf = x.reshape(B, H * W, C).float()
    mk = mask.float().reshape(B, Q, K)
    sampled = x.new_zeros((B, Q * K, C), dtype=torch.float32)
    for cx, cy, cw in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)),
                       (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
        ix, iy = x0 + cx, y0 + cy
        valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
        idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, Q * K, 1)
        wgt = (cw * mk * valid).reshape(B, Q * K, 1)
        sampled = sampled + torch.gather(xf, 1, idx.expand(B, Q * K, C)) * wgt
    sampled = sampled.to(x.dtype).float().reshape(B, Q, K * C)
    out = sampled @ weight.float().reshape(K * C, O)
    return out.to(x.dtype).reshape(B, Ho, Wo, O)


class DCNFunction(torch.autograd.Function):
    """The CUDA DCN forward (``dcn_cuda.dcn_fwd``) with its CUDA backward
    (``dcn_cuda.dcn_bwd``): gradients of x, the offsets, the mask and the
    weight."""

    @staticmethod
    def forward(ctx, x, offset, mask, weight, stride):
        from apollo_vision_net_tpu_torch.ops import dcn_cuda

        ctx.stride = stride
        ctx.save_for_backward(x, offset, mask, weight)
        return dcn_cuda.dcn_fwd(x, offset, mask, weight, stride)

    @staticmethod
    def backward(ctx, grad_out):
        from apollo_vision_net_tpu_torch.ops import dcn_cuda

        x, offset, mask, weight = ctx.saved_tensors
        grads = dcn_cuda.dcn_bwd(x, offset, mask, weight,
                                 grad_out.to(x.dtype).contiguous(), ctx.stride)
        return (*grads, None)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor, weight: torch.Tensor,
                          stride: int = 1) -> torch.Tensor:
    """DCNv2 front end: the plain version for CPU tensors, the hand-written
    CUDA kernel for CUDA tensors (which raises on inputs it does not take),
    with the hand-written CUDA backward where a gradient is needed. On meta
    tensors: the output's shape, and the kernel's operations tallied
    (``ops.cost``)."""
    if offset.shape[-2:] != (9, 2) or weight.shape[0] != 9:
        raise ValueError(f"3x3 taps only: offset {tuple(offset.shape)}, "
                         f"weight {tuple(weight.shape)}")
    if x.device.type == "meta":
        B, Ho, Wo = offset.shape[:3]
        cost.record("dcn_fwd", cost.dcn_operations(B, Ho, Wo, *weight.shape[1:]))
        return x.new_empty((B, Ho, Wo, weight.shape[-1]))
    if use_plain(x):
        with record_function("modulated_deform_conv.plain"):
            return modulated_deform_conv_ref(x, offset, mask, weight, stride)
    return DCNFunction.apply(x, offset, mask, weight, stride)
