"""GT masks for MapTRv2's auxiliary BEV and PV segmentation heads, numpy only.

Copy of the JAX package's data/rasterize.py (reference
bevformer_det_map_head_apollo_v2.py:234-414): the GT polylines are drawn
into a BEV mask (points normalized to the patch range and rounded to grid
cells, max(|dx|, |dy|) interpolation steps a segment, a (2r+1)^2 box
dilation) and, projected at z = 0 through each camera's lidar2img (depth
> 1e-5, inside the image), into per-camera PV masks at feature
resolution. The port keeps its own copy so that it imports nothing of the
JAX package; a test holds the copy equal to the original.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _dilate_box(mask: np.ndarray, radius: int) -> np.ndarray:
    """Binary dilation with a (2r+1)² square (the reference's per-point
    [lo:hi] box writes, expressed as a post-pass)."""
    if radius <= 0:
        return mask
    out = mask.copy()
    H, W = mask.shape
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx == 0 and dy == 0:
                continue
            src = mask[
                max(-dy, 0):H - max(dy, 0), max(-dx, 0):W - max(dx, 0)]
            out[max(dy, 0):H - max(-dy, 0),
                max(dx, 0):W - max(-dx, 0)] = np.maximum(
                out[max(dy, 0):H - max(-dy, 0),
                    max(dx, 0):W - max(-dx, 0)], src)
    return out


def _draw_cells(mask: np.ndarray, gx: np.ndarray, gy: np.ndarray) -> None:
    """Draw a polyline given integer grid coords (reference draw loop:
    steps = max(|Δx|, |Δy|, 1) interpolation points per segment)."""
    if len(gx) == 0:
        return
    if len(gx) == 1:
        mask[gy[0], gx[0]] = 1.0
        return
    for i in range(len(gx) - 1):
        x0, y0, x1, y1 = int(gx[i]), int(gy[i]), int(gx[i + 1]), int(gy[i + 1])
        steps = max(abs(x1 - x0), abs(y1 - y0), 1)
        t = np.arange(steps + 1, dtype=np.float64) / steps
        xx = np.rint(x0 + (x1 - x0) * t).astype(np.int64)
        yy = np.rint(y0 + (y1 - y0) * t).astype(np.int64)
        mask[yy, xx] = 1.0


def rasterize_lines_bev(
    vectors: Sequence[np.ndarray],       # ego-frame (P, 2) polylines, meters
    bev_h: int,
    bev_w: int,
    patch_size: Tuple[float, float],     # (h = y extent, w = x extent)
    radius: int = 1,
) -> np.ndarray:
    """(bev_h, bev_w) float32 {0,1} mask (reference _build_bev_seg_targets).

    x ∈ [-w/2, w/2] maps to columns, y ∈ [-h/2, h/2] to rows, endpoints on
    the (size-1) lattice exactly as the reference's normalize-then-round."""
    mask = np.zeros((bev_h, bev_w), np.float32)
    half_h, half_w = patch_size[0] / 2.0, patch_size[1] / 2.0
    for pts in vectors:
        pts = np.asarray(pts, np.float64)
        pts = pts[np.isfinite(pts).all(axis=-1)]
        if len(pts) == 0:
            continue
        gx = np.clip(np.rint(
            (pts[:, 0] + half_w) / (2 * half_w) * (bev_w - 1)),
            0, bev_w - 1).astype(np.int64)
        gy = np.clip(np.rint(
            (pts[:, 1] + half_h) / (2 * half_h) * (bev_h - 1)),
            0, bev_h - 1).astype(np.int64)
        _draw_cells(mask, gx, gy)
    return _dilate_box(mask, radius)


def rasterize_lines_pv(
    vectors: Sequence[np.ndarray],       # ego-frame (P, 2) polylines
    lidar2img: np.ndarray,               # (N_cam, 4, 4)
    img_hw: Tuple[int, int],             # padded image (H, W)
    feat_hw: Tuple[int, int],            # mask resolution (h, w)
    radius: int = 1,
) -> np.ndarray:
    """(N_cam, h, w) float32 masks (reference _build_pv_seg_targets):
    project z=0 polyline points per camera, keep depth>1e-5 + in-bounds,
    draw segments between consecutive visible points."""
    n_cam = lidar2img.shape[0]
    img_h, img_w = img_hw
    feat_h, feat_w = feat_hw
    out = np.zeros((n_cam, feat_h, feat_w), np.float32)
    for cam in range(n_cam):
        P = np.asarray(lidar2img[cam], np.float64)
        for pts in vectors:
            pts = np.asarray(pts, np.float64)
            pts = pts[np.isfinite(pts).all(axis=-1)]
            if len(pts) == 0:
                continue
            xyz1 = np.concatenate(
                [pts, np.zeros((len(pts), 1)), np.ones((len(pts), 1))],
                axis=-1)
            proj = xyz1 @ P.T
            depth = proj[:, 2]
            uv = proj[:, :2] / np.clip(depth[:, None], 1e-5, None)
            vis = (
                (depth > 1e-5)
                & (uv[:, 0] >= 0) & (uv[:, 0] <= img_w - 1)
                & (uv[:, 1] >= 0) & (uv[:, 1] <= img_h - 1)
            )
            uv = uv[vis]
            if len(uv) == 0:
                continue
            gx = np.clip(np.rint(
                uv[:, 0] / max(img_w - 1.0, 1.0) * (feat_w - 1)),
                0, feat_w - 1).astype(np.int64)
            gy = np.clip(np.rint(
                uv[:, 1] / max(img_h - 1.0, 1.0) * (feat_h - 1)),
                0, feat_h - 1).astype(np.int64)
            _draw_cells(out[cam], gx, gy)
        out[cam] = _dilate_box(out[cam], radius)
    return out
