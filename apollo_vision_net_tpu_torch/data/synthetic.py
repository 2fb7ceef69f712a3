"""Synthetic multi-camera inputs matching the real data contracts.

``camera_ring_lidar2img`` and ``make_batch`` are copies of the JAX package's
data/synthetic.py (a ring of forward-facing pinhole cameras, ego motion
along +x), limited to the fields inference, the detection GT, the
occupancy and flow GT, the map GT and its segmentation masks use.
``paint_gt`` paints class-coded cues of the GT into the images, and
voxelizes the GT boxes into the occupancy GT, so that a small set is
learnable for an overfit check. ``make_stream`` lays the same kind of data
out as a stream of frames for the streaming runner.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from apollo_vision_net_tpu_torch.configs import ExperimentConfig
from apollo_vision_net_tpu_torch.data.rasterize import (
    rasterize_lines_bev,
    rasterize_lines_pv,
)
from apollo_vision_net_tpu_torch.data.vector_map import pack_map_gt


def camera_ring_lidar2img(num_cams: int, img_h: int, img_w: int,
                          fov_deg: float = 70.0) -> np.ndarray:
    """(N, 4, 4) lidar→image matrices for a ring of forward-tilted cameras."""
    f = (img_w / 2.0) / np.tan(np.deg2rad(fov_deg) / 2.0)
    K = np.array(
        [[f, 0, img_w / 2.0, 0],
         [0, f, img_h / 2.0, 0],
         [0, 0, 1, 0],
         [0, 0, 0, 1]], np.float64,
    )
    mats = []
    for n in range(num_cams):
        yaw = 2.0 * np.pi * n / num_cams
        # lidar (x fwd, y left, z up) -> camera (x right, y down, z fwd)
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array(
            [[-s, c, 0, 0],
             [0, 0, -1, 0],
             [c, s, 0, 0],
             [0, 0, 0, 1]], np.float64,
        )
        mats.append(K @ R)
    return np.stack(mats).astype(np.float32)


def _paint_points(img, lidar2img, pts3d, labels, value=4.0, radius=2):
    """Paint class-coded square cues at the camera projections of 3D
    points, so that a synthetic set is learnable. img: (N, H, W, 3),
    modified in place."""
    N, H, W, _ = img.shape
    ones = np.ones((len(pts3d), 1), np.float32)
    hom = np.concatenate([pts3d, ones], axis=1)
    for n in range(N):
        cam = hom @ lidar2img[n].T
        d = cam[:, 2]
        front = d > 0.5
        u = cam[:, 0] / np.maximum(d, 0.5)
        v = cam[:, 1] / np.maximum(d, 0.5)
        for i in np.where(front)[0]:
            x, y = int(round(u[i])), int(round(v[i]))
            if 0 <= x < W and 0 <= y < H:
                c = int(labels[i]) % 3
                ys = slice(max(y - radius, 0), min(y + radius + 1, H))
                xs = slice(max(x - radius, 0), min(x + radius + 1, W))
                img[n, ys, xs, c] = value
    return img


def _boxes_to_occupancy(boxes, labels, m) -> np.ndarray:
    """(k, 9) GT boxes -> dense (occ_zdim*occ_ydim*occ_xdim,) class grid,
    voxel index (zi*ydim + yi)*xdim + xi, the occupancy head's (z, y, x)
    order. Voxels inside a box get min(label, occupancy_classes - 1);
    everything else free (occupancy_classes)."""
    pc = np.asarray(m.pc_range, np.float32)
    xd, yd, zd = m.occ_xdim, m.occ_ydim, m.occ_zdim
    dense = np.full(zd * xd * yd, m.occupancy_classes, np.int32)
    if len(boxes) == 0:
        return dense
    xs = pc[0] + (np.arange(xd) + 0.5) * (pc[3] - pc[0]) / xd
    ys = pc[1] + (np.arange(yd) + 0.5) * (pc[4] - pc[1]) / yd
    zs = pc[2] + (np.arange(zd) + 0.5) * (pc[5] - pc[2]) / zd
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)  # (z, y, x) order
    for b, lab in zip(np.asarray(boxes), np.asarray(labels)):
        cx, cy, cz, w, l, h, yaw = b[:7]
        c, s = np.cos(yaw), np.sin(yaw)
        dx = (pts[:, 0] - cx) * c + (pts[:, 1] - cy) * s   # along heading
        dy = -(pts[:, 0] - cx) * s + (pts[:, 1] - cy) * c
        dz = pts[:, 2] - cz
        # at least one voxel in each dim so thin boxes stay visible
        vs = np.array([(pc[3] - pc[0]) / xd, (pc[4] - pc[1]) / yd,
                       (pc[5] - pc[2]) / zd], np.float32)
        inside = ((np.abs(dx) <= max(l / 2, vs[0] / 2))
                  & (np.abs(dy) <= max(w / 2, vs[1] / 2))
                  & (np.abs(dz) <= max(h / 2, vs[2] / 2)))
        dense[inside] = min(int(lab), m.occupancy_classes - 1)
    return dense


def make_batch(cfg: ExperimentConfig, batch_size: int, seed: int = 0,
               dtype=np.float32, paint_gt: bool = False
               ) -> Dict[str, np.ndarray]:
    """A (B, T = queue_length) batch of images, can_bus deltas, camera
    matrices, has_prev flags, padded detection GT and, with an occupancy
    head, dense occupancy GT (B, voxels), or (B, T, voxels) for every queue
    frame with ``keep_bev_history`` or ``with_occupancy_flow``, and with
    ``predict_flow`` the flow GT (..., voxels, 2) of the object voxels;
    with a map head, padded map GT and, with ``with_aux_seg``, the
    rasterized BEV and PV segmentation masks; the same
    arrays as the JAX package's make_batch for these keys and seed.
    ``paint_gt`` paints the GT boxes' centres and the map vectors' points
    into every frame and makes the occupancy GT the voxelized GT boxes
    (random sparse voxels otherwise)."""
    m, d = cfg.model, cfg.data
    rng = np.random.default_rng(seed)
    B, T, N = batch_size, m.queue_length, m.num_cams
    H, W = m.img_shape
    G = d.max_gt_boxes

    img = rng.standard_normal((B, T, N, H, W, 3)).astype(dtype)
    can_bus = np.zeros((B, T, 18), np.float32)
    # ~0.5 m/frame forward motion, slight yaw drift; frame 0 deltas zeroed
    can_bus[:, 1:, 0] = rng.normal(0.5, 0.05, (B, T - 1)) if T > 1 else 0
    can_bus[:, :, -2] = rng.normal(0.0, 0.01, (B, T))  # global yaw (rad)
    can_bus[:, :, -1] = 0.0  # yaw delta (deg); 0 for frame 0
    if T > 1:
        can_bus[:, 1:, -1] = rng.normal(0.0, 0.2, (B, T - 1))

    l2i = camera_ring_lidar2img(N, H, W)
    lidar2img = np.broadcast_to(l2i, (B, T, N, 4, 4)).copy()
    has_prev = np.ones((B, T), np.float32)
    has_prev[:, 0] = 0.0

    n_real = rng.integers(1, max(G // 2, 2), B)
    gt_boxes = np.zeros((B, G, 9), np.float32)
    gt_boxes[..., 3:6] = 1.0
    gt_labels = np.zeros((B, G), np.int32)
    gt_mask = np.zeros((B, G), bool)
    pc = np.asarray(m.pc_range)
    for b in range(B):
        k = int(n_real[b])
        gt_boxes[b, :k, 0] = rng.uniform(pc[0] * 0.8, pc[3] * 0.8, k)
        gt_boxes[b, :k, 1] = rng.uniform(pc[1] * 0.8, pc[4] * 0.8, k)
        gt_boxes[b, :k, 2] = rng.uniform(-2.0, 0.5, k)
        gt_boxes[b, :k, 3:6] = rng.uniform(0.5, 5.0, (k, 3))
        gt_boxes[b, :k, 6] = rng.uniform(-np.pi, np.pi, k)
        gt_boxes[b, :k, 7:9] = rng.normal(0, 2, (k, 2))
        gt_labels[b, :k] = rng.integers(0, m.num_classes, k)
        gt_mask[b, :k] = True

    if paint_gt:
        for b in range(B):
            k = int(n_real[b])
            for t in range(T):
                _paint_points(img[b, t], lidar2img[b, t],
                              gt_boxes[b, :k, :3], gt_labels[b, :k])

    batch = dict(
        img=img,
        can_bus=can_bus,
        lidar2img=lidar2img,
        has_prev=has_prev,
        gt_boxes=gt_boxes,
        gt_labels=gt_labels,
        gt_mask=gt_mask,
    )
    if m.with_occupancy:
        vox = m.occ_zdim * m.occ_xdim * m.occ_ydim
        # multi-frame supervision: every queue frame gets occupancy GT
        multi_frame = m.keep_bev_history or m.with_occupancy_flow
        S = T if multi_frame else 1
        if paint_gt:
            occ1 = np.stack([
                _boxes_to_occupancy(gt_boxes[b, :int(n_real[b])],
                                    gt_labels[b, :int(n_real[b])], m)
                for b in range(B)])
            occ = np.repeat(occ1[:, None], S, axis=1)
        else:
            # mostly free (= occupancy_classes), sparse semantic voxels
            occ = np.full((B, S, vox), m.occupancy_classes, np.int32)
            n_occ = vox // 20
            for b in range(B):
                for s in range(S):
                    idx = rng.choice(vox, n_occ, replace=False)
                    occ[b, s, idx] = rng.integers(0, m.occupancy_classes, n_occ)
        batch["gt_occupancy"] = occ if multi_frame else occ[:, 0]
        if m.predict_flow:
            # foreground object classes carry a flow
            flow = np.zeros((B, S, vox, 2), np.float32)
            obj = occ < 10
            flow[obj] = rng.normal(0, 1.5, (int(obj.sum()), 2))
            batch["gt_flow"] = flow if multi_frame else flow[:, 0]
    if m.with_map:
        # Hungarian matching needs GT rows <= query columns
        max_vec = min(d.max_gt_boxes, m.num_map_vec)
        packed = []
        all_vecs = []
        vec_count = 0  # labels cycle across the batch: every class appears
        for b in range(B):
            n_vec = int(rng.integers(1, 5))
            vecs, labels = [], []
            for _ in range(n_vec):
                pts = np.cumsum(rng.uniform(-2, 2, (m.map_num_pts, 2)),
                                axis=0).astype(np.float32)
                pts -= pts.mean(0)
                vecs.append(pts)
                labels.append(vec_count % m.map_num_classes)
                vec_count += 1
            all_vecs.append(vecs)
            if paint_gt:
                pts2 = np.concatenate(vecs, axis=0)
                pts3 = np.concatenate(
                    [pts2, np.zeros((len(pts2), 1), np.float32)], axis=1)
                labs = np.repeat(labels, [len(v) for v in vecs])
                for t in range(T):
                    # negative value: map cues apart from box cues
                    _paint_points(img[b, t], lidar2img[b, t], pts3, labs,
                                  value=-4.0, radius=1)
            packed.append(pack_map_gt(
                vecs, labels, max_vec=max_vec, fixed_num=m.map_num_pts,
                pattern=m.map_shift_pattern,
                patch_size=m.map_patch_size, seed=seed + b))
        batch["map_shift_pts"] = np.stack([p["shift_pts"] for p in packed])
        batch["map_labels"] = np.stack([p["labels"] for p in packed])
        batch["map_mask"] = np.stack([p["mask"] for p in packed])
        batch["map_order_mask"] = np.stack([p["order_mask"] for p in packed])
        if m.with_aux_seg:
            # the same vectors rasterized for the aux segmentation heads: the
            # BEV grid, and each camera of the last queue frame at the finest
            # neck level (stride 16)
            fh, fw = H // 16, W // 16
            batch["gt_bev_seg"] = np.stack([
                rasterize_lines_bev(all_vecs[b], m.bev_h, m.bev_w,
                                    m.map_patch_size, radius=m.map_aux_seg_radius)
                for b in range(B)])
            batch["gt_pv_seg"] = np.stack([
                rasterize_lines_pv(all_vecs[b], lidar2img[b, -1], (H, W),
                                   (fh, fw), radius=m.map_aux_pv_radius)
                for b in range(B)])
    return batch


def make_stream(cfg: ExperimentConfig, num_frames: int, seed: int = 0,
                scene_change_at: tuple = ()) -> List[dict]:
    """Frames for the streaming runner: img (N, H, W, 3), ABSOLUTE can_bus
    (18,) (position in [0:3], global yaw in rad at [-2], yaw in degrees at
    [-1]), lidar2img (N, 4, 4) and a scene token that changes at every index
    in ``scene_change_at``."""
    m = cfg.model
    rng = np.random.default_rng(seed)
    N, (H, W) = m.num_cams, m.img_shape
    l2i = camera_ring_lidar2img(N, H, W)
    pos = np.zeros(3, np.float64)
    yaw_deg = 0.0
    scene = 0
    frames = []
    for t in range(num_frames):
        if t in scene_change_at:
            scene += 1
        pos[0] += rng.normal(0.5, 0.05)
        pos[1] += rng.normal(0.0, 0.05)
        yaw_deg += rng.normal(0.0, 0.5)
        can_bus = np.zeros(18, np.float32)
        can_bus[:3] = pos
        can_bus[-2] = np.deg2rad(yaw_deg)
        can_bus[-1] = yaw_deg
        frames.append(dict(
            img=rng.standard_normal((N, H, W, 3)).astype(np.float32),
            can_bus=can_bus,
            lidar2img=l2i.copy(),
            scene_token=f"scene-{scene}",
        ))
    return frames
