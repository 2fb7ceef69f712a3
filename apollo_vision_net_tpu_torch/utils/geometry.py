"""BEV/camera geometry: reference points, projection, ego-motion shift.

Counterpart of the JAX package's utils/geometry.py (reference
bevformer/modules/encoder.py:47-241, transformer.py:156-178). The numpy
helpers are copies; the tensor functions take a leading batch axis where
the JAX code vmapped.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def bev_reference_points_3d(
    bev_h: int, bev_w: int, z_size: float, num_points_in_pillar: int
) -> np.ndarray:
    """Pillar reference points (num_points_in_pillar, bev_h*bev_w, 3),
    normalized (x, y, z) in [0, 1] (encoder.py:61-72)."""
    zs = np.linspace(0.5, z_size - 0.5, num_points_in_pillar) / z_size
    xs = (np.arange(bev_w) + 0.5) / bev_w
    ys = (np.arange(bev_h) + 0.5) / bev_h
    zz = zs[:, None, None] * np.ones((1, bev_h, bev_w))
    xx = np.broadcast_to(xs[None, None, :], (num_points_in_pillar, bev_h, bev_w))
    yy = np.broadcast_to(ys[None, :, None], (num_points_in_pillar, bev_h, bev_w))
    ref = np.stack([xx, yy, zz], axis=-1)  # (P, H, W, 3)
    return ref.reshape(num_points_in_pillar, bev_h * bev_w, 3).astype(np.float32)


def bev_reference_points_2d(bev_h: int, bev_w: int) -> np.ndarray:
    """Plane reference points (bev_h*bev_w, 2), normalized (x, y)
    (encoder.py:76-86)."""
    ys, xs = np.meshgrid(
        (np.arange(bev_h) + 0.5) / bev_h,
        (np.arange(bev_w) + 0.5) / bev_w,
        indexing="ij",
    )
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1).astype(np.float32)


def point_sampling(
    ref_3d: torch.Tensor,
    pc_range: Sequence[float],
    lidar2img: torch.Tensor,
    img_shape: Tuple[int, int],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project pillar reference points into every camera.

    ref_3d (P, N, 3) normalized; lidar2img (B, num_cam, 4, 4).
    Returns reference_points_cam (B, num_cam, N, P, 2) in [0, 1] image
    coords and bev_mask (B, num_cam, N, P) — depth > eps and strictly inside
    the image (encoder.py:185-233).
    """
    pc = torch.as_tensor(np.asarray(pc_range, np.float32), device=ref_3d.device)
    P, N, _ = ref_3d.shape
    xyz = ref_3d * (pc[3:6] - pc[0:3]) + pc[0:3]
    xyz1 = torch.cat([xyz, torch.ones((P, N, 1), dtype=xyz.dtype,
                                      device=xyz.device)], dim=-1)
    proj = torch.einsum("bcij,pnj->bcpni", lidar2img.float(), xyz1.float())
    eps = 1e-5
    depth = proj[..., 2:3]
    mask = depth[..., 0] > eps
    uv = proj[..., 0:2] / torch.clamp(depth, min=eps)
    h_img, w_img = img_shape
    u = uv[..., 0] / float(w_img)
    v = uv[..., 1] / float(h_img)
    mask = mask & (u > 0.0) & (u < 1.0) & (v > 0.0) & (v < 1.0)
    ref_cam = torch.stack([u, v], dim=-1)  # (B, cam, P, N, 2)
    return ref_cam.transpose(2, 3), mask.transpose(2, 3)


def spatial_block_order(h: int, w: int, bh: int = 8, bw: int = 16
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Permutation reordering a row-major (h, w) grid into (bh, bw) blocks
    scanned block-row-major, so consecutive query tiles are spatially
    compact. Returns (perm, inv_perm), each (h*w,) int32 with
    ``flat_blocked = flat_rowmajor[perm]``."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    key = (
        (ys // bh) * ((w + bw - 1) // bw) + (xs // bw)
    ) * (bh * bw) + (ys % bh) * bw + (xs % bw)
    perm = np.argsort(key.reshape(-1), kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm), dtype=np.int32)
    return perm, inv


def bev_shift_from_can_bus(
    can_bus: torch.Tensor,
    grid_length: Tuple[float, float],
    bev_h: int,
    bev_w: int,
    use_shift: bool = True,
) -> torch.Tensor:
    """Normalized BEV grid shift (B, 2) = (shift_x, shift_y) from ego motion.

    can_bus (B, 18): [0:2] translation delta, [-2] global yaw in radians
    (transformer.py:156-178, including its sin/cos axis convention)."""
    delta_x, delta_y = can_bus[:, 0], can_bus[:, 1]
    ego_angle = can_bus[:, -2] / np.pi * 180.0
    grid_length_y, grid_length_x = grid_length[0], grid_length[1]
    translation_length = torch.sqrt(delta_x ** 2 + delta_y ** 2)
    translation_angle = torch.atan2(delta_y, delta_x) / np.pi * 180.0
    bev_angle = ego_angle - translation_angle
    shift_y = (translation_length * torch.cos(bev_angle / 180.0 * np.pi)
               / grid_length_y / bev_h)
    shift_x = (translation_length * torch.sin(bev_angle / 180.0 * np.pi)
               / grid_length_x / bev_w)
    scale = 1.0 if use_shift else 0.0
    return torch.stack([shift_x * scale, shift_y * scale], dim=-1).float()
