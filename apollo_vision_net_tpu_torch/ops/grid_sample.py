"""Bilinear 2D and trilinear 3D grid sampling and BEV rotation (plain
PyTorch).

Counterpart of the JAX package's ops/grid_sample.py: ``mode='bilinear',
padding_mode='zeros', align_corners=False``, grid coords in [-1, 1] with the
last dim (x, y), or (x, y, z) over a volume's (W, H, D). Images and volumes
keep the JAX layout ((H, W, C), (D, H, W, C)) with a leading batch axis
where the JAX code vmapped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, C), grid (B, ..., 2) -> (B, ..., C)."""
    B, H, W, C = img.shape
    out_shape = grid.shape[1:-1]
    g = grid.reshape(B, 1, -1, 2).to(img.dtype)
    out = F.grid_sample(img.permute(0, 3, 1, 2), g, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(B, C, -1).permute(0, 2, 1).reshape(B, *out_shape, C)


def grid_sample_3d(vol: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """vol (B, D, H, W, C), grid (B, ..., 3) with x indexing W, y H and z
    D -> (B, ..., C), trilinear (the occupancy flow warping)."""
    B, D, H, W, C = vol.shape
    out_shape = grid.shape[1:-1]
    g = grid.reshape(B, 1, 1, -1, 3).to(vol.dtype)
    out = F.grid_sample(vol.permute(0, 4, 1, 2, 3), g, mode="bilinear",
                        padding_mode="zeros", align_corners=False)
    return out.reshape(B, C, -1).permute(0, 2, 1).reshape(B, *out_shape, C)


def rotate_2d(img: torch.Tensor, angle_deg: torch.Tensor) -> torch.Tensor:
    """Rotate each (H, W, C) image of the batch counter-clockwise about its
    centre by ``angle_deg`` (B,) degrees, bilinear, zeros outside — torchvision
    ``rotate`` as the reference applies it to ``prev_bev``."""
    B, H, W, _ = img.shape
    theta = torch.deg2rad(angle_deg.float())
    cos, sin = torch.cos(theta)[:, None, None], torch.sin(theta)[:, None, None]
    ys = (torch.arange(H, dtype=torch.float32, device=img.device) + 0.5) - H / 2.0
    xs = (torch.arange(W, dtype=torch.float32, device=img.device) + 0.5) - W / 2.0
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    # output pixel (gx, gy) samples the input at the inverse-rotated position
    sx = cos * gx - sin * gy
    sy = sin * gx + cos * gy
    # back to normalized [-1, 1]: pixel p -> (2p + 1)/S - 1
    nx = (2.0 * (sx + W / 2.0 - 0.5) + 1.0) / W - 1.0
    ny = (2.0 * (sy + H / 2.0 - 0.5) + 1.0) / H - 1.0
    return grid_sample_2d(img, torch.stack([nx, ny], dim=-1))
