"""Multi-scale deformable attention (MSDA): plain version and dispatcher.

Semantics are those of ``F.grid_sample(mode='bilinear', padding_mode='zeros',
align_corners=False)`` on grids ``2 * loc - 1``, then an attention-weighted
sum over levels and points, accumulated in f32.

Shapes (batch-first, the JAX package's layout):
  value:               (B, V, H, D)   flattened multi-level features
  spatial_shapes:      ((h0, w0), (h1, w1), ...) with sum(h * w) == V
  sampling_locations:  (B, Q, H, L, P, 2) in [0, 1], last dim (x, y)
  attention_weights:   (B, Q, H, L, P)
  returns:             (B, Q, H * D) in value's dtype

``ms_deform_attn`` runs the plain version for CPU tensors and the CUDA
kernel (ops/msda_cuda.py) for CUDA tensors, through ``MSDAFunction``, whose
backward is the hand-written CUDA backward (``msda_cuda.msda_bwd``); the
plain version's backward is autograd through it, each (level, corner)
term under ``torch.utils.checkpoint``: the term's gathered rows (B, H, Q·P,
D) in f32 are formed again in the backward instead of kept, the same
values and gradients in a fraction of the memory (by count, a base SCA
layer's 16 copies are 31.5 GB and InternImage-S's 33 DCNv3 calls' ~19 GB
at six 480x800 images: the f32 step of ``bev_base_occ_intern_s`` under
plain versions did not fit in 80 GB). ``ms_deform_attn_factored``
does the same for multi-level SCA on factored operands (per-camera
reference points, offsets and weights shared by the cameras of a sample),
through ``FactoredMSDAFunction`` (``msda_cuda.msda_fwd_factored`` and
``msda_cuda.msda_bwd_factored``). ``ms_deform_attn_local`` takes the calls
whose queries are the cells of the value's own single level (DCNv3's):
the plain version for CPU tensors, and through ``LocalMSDAFunction`` the
tile-local CUDA entry and its backward (``msda_cuda.msda_fwd_local``,
``msda_cuda.msda_bwd_local``) for CUDA tensors. ``ms_deform_attn`` sends
the f32 single-level calls whose whole map a block holds in shared memory
(``msda_cuda.takes_resident``: SCA over the cameras' 15x25 map) through
``ResidentMSDAFunction`` to the map-resident CUDA entry and its backward
(``msda_cuda.msda_fwd_resident``, ``msda_cuda.msda_bwd_resident``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from apollo_vision_net_tpu_torch.ops import cost, use_plain

Shapes = Sequence[Tuple[int, int]]


def _corner_term(v_l: torch.Tensor, idx_t: torch.Tensor,
                 wgt: torch.Tensor) -> torch.Tensor:
    """One bilinear corner of one level: the rows ``idx_t`` (B, H, Q·P, 1)
    of ``v_l`` (B, H, hw, D) weighted by ``wgt`` (B, H, Q, P) and summed
    over the points: (B, H, Q, D)."""
    B, H, Q, P = wgt.shape
    D = v_l.shape[-1]
    g = torch.gather(v_l, 2, idx_t.expand(B, H, Q * P, D))
    return torch.einsum("bhqpd,bhqp->bhqd", g.reshape(B, H, Q, P, D), wgt)


def ms_deform_attn_ref(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 32,
) -> torch.Tensor:
    """Plain PyTorch MSDA: per level and bilinear corner, gather and
    weight. With ``tile_mask`` (B, ceil(Q / q_tile)), queries of a tile whose
    mask is 0 are zero, as the kernel writes them."""
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if len(spatial_shapes) != L or sum(h * w for h, w in spatial_shapes) != V:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match "
                         f"V={V}, L={L}")
    out = value.new_zeros((B, H, Q, D), dtype=torch.float32)
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        # (B, hw, H, D) -> (B, H, hw, D): gather axis contiguous per head
        v_l = value[:, start:start + h * w].permute(0, 2, 1, 3).float()
        start += h * w
        loc = sampling_locations[:, :, :, lvl].float()  # (B, Q, H, P, 2)
        attn = attention_weights[:, :, :, lvl].float()  # (B, Q, H, P)
        px = loc[..., 0] * w - 0.5
        py = loc[..., 1] * h - 0.5
        x0 = torch.floor(px)
        y0 = torch.floor(py)
        fx = px - x0
        fy = py - y0
        x0 = x0.to(torch.int64)
        y0 = y0.to(torch.int64)
        for cx, cy, cw in (
            (0, 0, (1 - fx) * (1 - fy)),
            (1, 0, fx * (1 - fy)),
            (0, 1, (1 - fx) * fy),
            (1, 1, fx * fy),
        ):
            ix = x0 + cx
            iy = y0 + cy
            valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            idx = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
            wgt = (cw * valid * attn).permute(0, 2, 1, 3)  # (B, H, Q, P)
            idx_t = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1)
            if torch.is_grad_enabled() and (v_l.requires_grad or wgt.requires_grad):
                term = checkpoint(_corner_term, v_l, idx_t, wgt, use_reentrant=False)
            else:
                term = _corner_term(v_l, idx_t, wgt)
            out = out + term
    out = out.permute(0, 2, 1, 3).reshape(B, Q, H * D)
    if tile_mask is not None:
        keep = tile_mask.to(torch.bool).repeat_interleave(q_tile, dim=1)[:, :Q]
        out = out * keep[:, :, None]
    return out.to(value.dtype)


def materialize_factored(
    ref_flat: torch.Tensor,   # (B, Q, P * 2) per value batch
    off_flat: torch.Tensor,   # (Bs, Q, H * L * P * 2) raw-cell offsets
    attn_flat: torch.Tensor,  # (Bs, Q, H * L * P) softmaxed
    spatial_shapes: Shapes,
    num_heads: int,
    num_points: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Factored SCA operands -> flat (B, Q, H·L·P·2) locations and
    (B, Q, H·L·P) weights. B = Bs · N with the camera axis fast: offsets and
    weights are shared by the N cameras of a sample, reference points are
    per camera. ``ref[p]`` is replicated over every (head, level) block and
    offsets are divided by each level's (w, h)."""
    B, Q, _ = ref_flat.shape
    Bs = attn_flat.shape[0]
    N = B // Bs
    H, P, L = num_heads, num_points, len(spatial_shapes)
    fi = np.arange(H * L * P * 2)
    l_of = (fi // (2 * P)) % L
    wh = np.array([[w, h] for h, w in spatial_shapes], np.float32)
    inv = torch.as_tensor((1.0 / wh[l_of, fi % 2]).astype(np.float32),
                          device=off_flat.device)
    off = (off_flat.float() * inv).reshape(Bs, 1, Q, -1)
    loc = (ref_flat.float().repeat(1, 1, H * L).reshape(Bs, N, Q, -1)
           + off).reshape(B, Q, H * L * P * 2)
    attn = attn_flat.reshape(Bs, 1, Q, -1).expand(Bs, N, Q, H * L * P)
    return loc, attn.reshape(B, Q, H * L * P)


class MSDAFunction(torch.autograd.Function):
    """The CUDA MSDA forward (``msda_cuda.msda_fwd``) with its CUDA backward
    (``msda_cuda.msda_bwd``): gradients of value, locations and weights,
    those of a masked tile's queries zero."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes, tile_mask, q_tile):
        from apollo_vision_net_tpu_torch.ops import msda_cuda

        ctx.spatial_shapes = tuple(tuple(int(s) for s in hw)
                                   for hw in spatial_shapes)
        ctx.q_tile = q_tile
        ctx.save_for_backward(value, sampling_locations, attention_weights,
                              tile_mask)
        return msda_cuda.msda_fwd(value, spatial_shapes, sampling_locations,
                                  attention_weights, tile_mask=tile_mask,
                                  q_tile=q_tile)

    @staticmethod
    def backward(ctx, grad_out):
        from apollo_vision_net_tpu_torch.ops import msda_cuda

        value, loc, attn, tile_mask = ctx.saved_tensors
        g_value, g_loc, g_attn = msda_cuda.msda_bwd(
            value, ctx.spatial_shapes, loc, attn,
            grad_out.to(value.dtype).contiguous(), tile_mask=tile_mask,
            q_tile=ctx.q_tile)
        return g_value, g_loc, g_attn, None, None, None


class FactoredMSDAFunction(torch.autograd.Function):
    """The factored CUDA MSDA forward (``msda_cuda.msda_fwd_factored``) with
    its CUDA backward (``msda_cuda.msda_bwd_factored``): gradients of value,
    reference points (only when autograd asks for them: the model's are
    camera geometry), offsets and weights, those of a masked (camera, tile)
    zero."""

    @staticmethod
    def forward(ctx, value, ref_flat, off_flat, attn_flat, spatial_shapes,
                tile_mask, q_tile):
        from apollo_vision_net_tpu_torch.ops import msda_cuda

        ctx.spatial_shapes = tuple(tuple(int(s) for s in hw)
                                   for hw in spatial_shapes)
        ctx.q_tile = q_tile
        ctx.save_for_backward(value, ref_flat, off_flat, attn_flat, tile_mask)
        return msda_cuda.msda_fwd_factored(
            value, spatial_shapes, ref_flat, off_flat, attn_flat,
            tile_mask=tile_mask, q_tile=q_tile)

    @staticmethod
    def backward(ctx, grad_out):
        from apollo_vision_net_tpu_torch.ops import msda_cuda

        value, ref_flat, off_flat, attn_flat, tile_mask = ctx.saved_tensors
        g_value, g_ref, g_off, g_attn = msda_cuda.msda_bwd_factored(
            value, ctx.spatial_shapes, ref_flat, off_flat, attn_flat,
            grad_out.to(value.dtype).contiguous(), tile_mask=tile_mask,
            q_tile=ctx.q_tile, need_ref=ctx.needs_input_grad[1])
        return g_value, g_ref, g_off, g_attn, None, None, None


class ResidentMSDAFunction(torch.autograd.Function):
    """The map-resident CUDA MSDA forward (``msda_cuda.msda_fwd_resident``)
    with its CUDA backward (``msda_cuda.msda_bwd_resident``): gradients of
    value, locations and weights, those of a masked tile's queries zero."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes, tile_mask, q_tile):
        from apollo_vision_net_tpu_torch.ops import msda_cuda

        ctx.spatial_shapes = tuple(tuple(int(s) for s in hw)
                                   for hw in spatial_shapes)
        ctx.q_tile = q_tile
        ctx.save_for_backward(value, sampling_locations, attention_weights,
                              tile_mask)
        return msda_cuda.msda_fwd_resident(
            value, spatial_shapes, sampling_locations, attention_weights,
            tile_mask=tile_mask, q_tile=q_tile)

    @staticmethod
    def backward(ctx, grad_out):
        from apollo_vision_net_tpu_torch.ops import msda_cuda

        value, loc, attn, tile_mask = ctx.saved_tensors
        g_value, g_loc, g_attn = msda_cuda.msda_bwd_resident(
            value, ctx.spatial_shapes, loc, attn,
            grad_out.to(value.dtype).contiguous(), tile_mask=tile_mask,
            q_tile=ctx.q_tile)
        return g_value, g_loc, g_attn, None, None, None


def ms_deform_attn(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 32,
) -> torch.Tensor:
    """MSDA front end: the plain version for CPU tensors, the hand-written
    CUDA kernels for CUDA tensors (which raise on inputs they do not take),
    with the hand-written CUDA backward where a gradient is needed: the
    map-resident entry where ``msda_cuda.takes_resident`` holds, else the
    plain and masked entry. On meta tensors: the output's shape, and the
    kernel's operations tallied (``ops.cost``)."""
    from apollo_vision_net_tpu_torch.ops import msda_cuda

    B, V, H, D = value.shape
    resident = msda_cuda.takes_resident(value, spatial_shapes,
                                        sampling_locations)
    if value.device.type == "meta":
        _, Q, _, L, P, _ = sampling_locations.shape
        # every query counted: a tile mask's values are not on the meta device
        entry = ("msda_fwd_resident" if resident else
                 "msda_fwd" if tile_mask is None else "msda_fwd_masked")
        cost.record(entry, cost.msda_operations(B * Q, H, L, P, D))
        return value.new_empty((B, Q, H * D))
    if use_plain(value):
        with record_function("ms_deform_attn.plain"):
            return ms_deform_attn_ref(
                value, spatial_shapes, sampling_locations, attention_weights,
                tile_mask=tile_mask, q_tile=q_tile)
    if resident:
        return ResidentMSDAFunction.apply(value, sampling_locations,
                                          attention_weights, spatial_shapes,
                                          tile_mask, q_tile)
    return MSDAFunction.apply(value, sampling_locations, attention_weights,
                              spatial_shapes, tile_mask, q_tile)


def ms_deform_attn_factored(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    ref_flat: torch.Tensor,
    off_flat: torch.Tensor,
    attn_flat: torch.Tensor,
    *,
    tile_mask: Optional[torch.Tensor] = None,
    q_tile: int = 128,
) -> torch.Tensor:
    """MSDA on factored operands (see ``materialize_factored``): value
    (B, V, H, D), ref_flat (B, Q, P·2), off_flat (Bs, Q, H·L·P·2) raw-cell
    offsets, attn_flat (Bs, Q, H·L·P) -> (B, Q, H·D). The plain version
    materializes the locations and runs ``ms_deform_attn_ref``; on CUDA
    tensors the kernel forms them in registers and never materializes, and
    the hand-written CUDA backward gives the gradients where one is
    needed. On meta tensors: the output's shape, and the kernel's
    operations tallied (``ops.cost``)."""
    B, V, H, D = value.shape
    Q, P, L = ref_flat.shape[1], ref_flat.shape[2] // 2, len(spatial_shapes)
    if value.device.type == "meta":
        cost.record("msda_fwd_factored", cost.msda_operations(B * Q, H, L, P, D))
        return value.new_empty((B, Q, H * D))
    if use_plain(value):
        with record_function("ms_deform_attn_factored.plain"):
            loc, attn = materialize_factored(ref_flat, off_flat, attn_flat,
                                             spatial_shapes, H, P)
            return ms_deform_attn_ref(
                value, spatial_shapes, loc.reshape(B, Q, H, L, P, 2),
                attn.reshape(B, Q, H, L, P), tile_mask=tile_mask, q_tile=q_tile)
    return FactoredMSDAFunction.apply(value, ref_flat, off_flat, attn_flat,
                                      spatial_shapes, tile_mask, q_tile)


class LocalMSDAFunction(torch.autograd.Function):
    """The tile-local CUDA MSDA forward (``msda_cuda.msda_fwd_local``) with
    its CUDA backward (``msda_cuda.msda_bwd_local``): gradients of value,
    locations and weights."""

    @staticmethod
    def forward(ctx, value, sampling_locations, attention_weights,
                spatial_shapes):
        from apollo_vision_net_tpu_torch.ops import msda_cuda

        ctx.spatial_shapes = tuple(tuple(int(s) for s in hw)
                                   for hw in spatial_shapes)
        if any(ctx.needs_input_grad[:3]):
            # the backward's blocks take fewer samples than the forward's:
            # refuse them before any work, not halfway through a step
            msda_cuda.check_local(value, spatial_shapes, sampling_locations,
                                  attention_weights, backward=True)
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return msda_cuda.msda_fwd_local(value, spatial_shapes,
                                        sampling_locations, attention_weights)

    @staticmethod
    def backward(ctx, grad_out):
        from apollo_vision_net_tpu_torch.ops import msda_cuda

        value, loc, attn = ctx.saved_tensors
        g_value, g_loc, g_attn = msda_cuda.msda_bwd_local(
            value, ctx.spatial_shapes, loc, attn,
            grad_out.to(value.dtype).contiguous())
        return g_value, g_loc, g_attn, None


def ms_deform_attn_local(
    value: torch.Tensor,
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,
    attention_weights: torch.Tensor,
) -> torch.Tensor:
    """MSDA whose queries are the cells of the value's one level: value
    (B, h·w, H, D), spatial_shapes ((h, w),), loc (B, h·w, H, 1, P, 2),
    attn (B, h·w, H, 1, P) -> (B, h·w, H·D), query q at cell (q // w,
    q % w). The plain version for CPU tensors (under the plain MSDA's
    profiler range); on CUDA tensors the tile-local kernel and its
    backward, which raise on inputs they do not take
    (``msda_cuda.check_local``: f32, D a multiple of 4 up to 32). On meta
    tensors: the output's shape, and the kernel's operations tallied
    (``ops.cost``)."""
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if L != 1 or len(spatial_shapes) != 1 or Q != V:
        raise ValueError(f"ms_deform_attn_local takes one level whose cells "
                         f"are the queries: L={L}, V={V}, Q={Q}")
    if value.device.type == "meta":
        cost.record("msda_fwd_local", cost.msda_operations(B * Q, H, 1, P, D))
        return value.new_empty((B, Q, H * D))
    if use_plain(value):
        with record_function("ms_deform_attn.plain"):
            return ms_deform_attn_ref(value, spatial_shapes, sampling_locations,
                                      attention_weights)
    return LocalMSDAFunction.apply(value, sampling_locations, attention_weights,
                                   spatial_shapes)
