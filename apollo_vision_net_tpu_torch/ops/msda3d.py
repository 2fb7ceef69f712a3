"""Trilinear multi-scale deformable attention over voxel grids (plain
PyTorch).

Counterpart of the JAX package's ops/msda3d.py (reference
voxel_multi_scale_deformable_attn_pytorch,
voxel_temporal_self_attention.py:270-330): per level a (d, h, w) value
grid, sampling locations (x, y, z) in [0, 1], ``F.grid_sample`` on a 5-D
input (trilinear, zero padding, ``align_corners=False``), the samples
weighted by the attention over levels and points.

The JAX op is XLA, not Pallas, so this is the port of an XLA op and runs
the same on the CPU and the GPU. The JAX package's 2x2x2 corner patch
(one gathered row of 8·D channels a sample) is a TPU layout; here the
sampler reads the grid directly and its backward recomputes the corners,
so autograd keeps the value grid and the locations only (the patch would
keep ~2.6 GB of gathered rows a layer at voxel_base_occ's shape).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Shapes3d = Sequence[Tuple[int, int, int]]


def ms_deform_attn_3d(value: torch.Tensor, spatial_shapes: Shapes3d,
                      sampling_locations: torch.Tensor,
                      attention_weights: torch.Tensor) -> torch.Tensor:
    """value (B, V, H, D) with V = sum d·h·w, (z, y, x) order, x minor;
    spatial_shapes ((d, h, w), ...); sampling_locations (B, Q, H, L, P, 3)
    as (x, y, z) in [0, 1]; attention_weights (B, Q, H, L, P) -> (B, Q, H·D)
    in value's dtype, accumulated in f32."""
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape
    if len(spatial_shapes) != L or sum(d * h * w for d, h, w in spatial_shapes) != V:
        raise ValueError(f"spatial_shapes {spatial_shapes} do not match "
                         f"V={V}, L={L}")
    out = value.new_zeros((B * H, D, Q), dtype=torch.float32)
    start = 0
    for lvl, (d, h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + d * h * w].float()
        start += d * h * w
        v = v.permute(0, 2, 3, 1).reshape(B * H, D, d, h, w)
        grid = 2.0 * sampling_locations[:, :, :, lvl].float() - 1.0  # (B, Q, H, P, 3)
        grid = grid.permute(0, 2, 1, 3, 4).reshape(B * H, 1, Q, P, 3)
        s = F.grid_sample(v, grid, mode="bilinear", padding_mode="zeros",
                          align_corners=False)[:, :, 0]  # (B·H, D, Q, P)
        attn = attention_weights[:, :, :, lvl].float().permute(0, 2, 1, 3)
        out = out + torch.einsum("ndqp,nqp->ndq", s, attn.reshape(B * H, Q, P))
    out = out.reshape(B, H, D, Q).permute(0, 3, 1, 2).reshape(B, Q, H * D)
    return out.to(value.dtype)
