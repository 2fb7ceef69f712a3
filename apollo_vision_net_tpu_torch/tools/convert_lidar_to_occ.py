"""Occupancy GT generation: labeled lidar points -> dense/sparse voxel labels.

Counterpart of the JAX package's tools/convert_lidar_to_occ.py (parity:
the reference's tools/convert_lidar_pcd_to_occ.py, single frame, and
tools/convert_lidar_pcd_sequence_to_occ.py:347-460, sequence mode):
aggregates labeled points into 0.5 m voxel labels by majority vote and
writes sparse (n, 2) [voxel_index, class] npy files, the training
pipeline's occupancy GT. The vote runs in the port's native host library
(``data/native.py::voxelize_points``, csrc/host_ops.cpp), which raises
where it cannot be built; ``voxelize_numpy`` is its plain version.

Sequence mode (``sequence`` subcommand) chains poses: each sweep is moved
into the centre frame by ``inv(T_center) @ T_frame`` before the vote (the
reference stacks raw coordinates). Points of dynamic classes are kept from
the centre frame only, against ghosting, and an optional voxel-space
morphological closing fills interior holes (reference voxel_morph_fill:
295-327: original voxels keep their class, filled voxels get the fallback
class).

    python3 -m apollo_vision_net_tpu_torch.tools.convert_lidar_to_occ \\
        <points.npy> <out.npy> [--pc-range ...] [--voxel-size ...]
    python3 -m apollo_vision_net_tpu_torch.tools.convert_lidar_to_occ \\
        sequence <lidar_dir> <out.npy> --center-id <id> [--window 3]
        [--stride 1] [--poses <npy>] [--dynamic-classes ...]
        [--fill voxel_morph] [--morph-radius 1]
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

from apollo_vision_net_tpu_torch.data import native
from apollo_vision_net_tpu_torch.data.semantic_kitti import dense_to_sparse

INT16_MAX = 32767


def voxelize_numpy(points, pc_range, voxel_size, dims, num_classes,
                   empty_label):
    """The plain version of ``native.voxelize_points``, label for label:
    float32 arithmetic as the library's (bounds, then ``(p - lo) / size``
    truncated), labels truncated toward zero, counts saturating at int16's
    maximum, ties to the smallest label. (The JAX tool's numpy fallback
    bins in float64 and can put a point within ~1e-6 m of a voxel face into
    the neighbouring voxel.)"""
    xdim, ydim, zdim = dims
    p = np.asarray(points, np.float32)
    pc = np.asarray(pc_range, np.float32)
    vs = np.asarray(voxel_size, np.float32)
    m = ((p[:, 0] >= pc[0]) & (p[:, 0] < pc[3])
         & (p[:, 1] >= pc[1]) & (p[:, 1] < pc[4])
         & (p[:, 2] >= pc[2]) & (p[:, 2] < pc[5]))
    p = p[m]
    xi = ((p[:, 0] - pc[0]) / vs[0]).astype(np.int64)
    yi = ((p[:, 1] - pc[1]) / vs[1]).astype(np.int64)
    zi = ((p[:, 2] - pc[2]) / vs[2]).astype(np.int64)
    lab = np.trunc(p[:, 3]).astype(np.int64)
    keep = ((lab >= 0) & (lab < num_classes) & (xi >= 0) & (xi < xdim)
            & (yi >= 0) & (yi < ydim) & (zi >= 0) & (zi < zdim))
    # (z, y, x) flat order, x minor — reference-exact
    # (convert_lidar_pcd_to_occ.py:122: vox = x + y*xdim + z*xdim*ydim)
    vox = ((zi * ydim + yi) * xdim + xi)[keep]
    counts = np.zeros((zdim * ydim * xdim, num_classes), np.int32)
    np.add.at(counts, (vox, lab[keep]), 1)
    np.minimum(counts, INT16_MAX, out=counts)
    dense = np.full((zdim * ydim * xdim,), empty_label, np.int32)
    occupied = counts.max(1) > 0
    dense[occupied] = counts[occupied].argmax(1)
    return dense


def _voxelize(pts, pc, vs, dims, num_classes):
    return native.voxelize_points(pts, pc, vs, dims, num_classes, num_classes)


def _shift3d(mask, dz, dx, dy):
    out = np.zeros_like(mask)
    zs = slice(max(dz, 0), mask.shape[0] + min(dz, 0))
    xs = slice(max(dx, 0), mask.shape[1] + min(dx, 0))
    ys = slice(max(dy, 0), mask.shape[2] + min(dy, 0))
    zs2 = slice(max(-dz, 0), mask.shape[0] + min(-dz, 0))
    xs2 = slice(max(-dx, 0), mask.shape[1] + min(-dx, 0))
    ys2 = slice(max(-dy, 0), mask.shape[2] + min(-dy, 0))
    out[zs, xs, ys] = mask[zs2, xs2, ys2]
    return out


def _dilate3d(mask, radius):
    out = mask.copy()
    for dz in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            for dy in range(-radius, radius + 1):
                if dz or dx or dy:
                    out |= _shift3d(mask, dz, dx, dy)
    return out


def _erode3d(mask, radius):
    out = mask.copy()
    for dz in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            for dy in range(-radius, radius + 1):
                if dz or dx or dy:
                    out &= _shift3d(mask, dz, dx, dy)
    return out


def aggregate_sequence(
    frame_points, poses, center_idx, dynamic_classes=(),
):
    """Pose-chain sweeps into the center frame; dynamic-class points kept
    only from the center frame (reference :400-440 w/ pose compensation).

    frame_points: list of (n_i, 4) [x, y, z, label]; poses: list of (4, 4)
    frame→global (or None for the reference's naive stacking)."""
    dyn = set(int(c) for c in dynamic_classes)
    out = []
    T_cg_inv = (np.linalg.inv(np.asarray(poses[center_idx], np.float64))
                if poses is not None else None)
    for i, pts in enumerate(frame_points):
        pts = np.asarray(pts, np.float32)
        if pts.size == 0:
            continue
        lab = pts[:, 3].astype(np.int64)
        is_dyn = np.isin(lab, list(dyn)) if dyn else np.zeros(len(pts), bool)
        keep = ~is_dyn if i != center_idx else np.ones(len(pts), bool)
        p = pts[keep]
        if p.size == 0:
            continue
        if T_cg_inv is not None and i != center_idx:
            T = T_cg_inv @ np.asarray(poses[i], np.float64)
            xyz1 = np.concatenate(
                [p[:, :3], np.ones((len(p), 1), np.float32)], axis=1)
            p = np.concatenate(
                [(xyz1 @ T.T)[:, :3].astype(np.float32), p[:, 3:4]], axis=1)
        out.append(p)
    if not out:
        raise RuntimeError("no points in the requested window")
    return np.concatenate(out, axis=0)


def morph_close_dense(dense, dims, num_classes, radius=1, iters=1):
    """Voxel-space closing (reference voxel_morph_fill:295-327): original
    voxels keep their class, filled voxels get the fallback class
    (num_classes - 1 == 'general object' analog of occupied_class_id)."""
    xdim, ydim, zdim = dims
    grid = dense.reshape(zdim, ydim, xdim)
    mask = grid != num_classes
    filled = mask
    for _ in range(max(1, iters)):
        filled = _erode3d(_dilate3d(filled, radius), radius)
    filled |= mask  # closing never removes original voxels
    out = grid.copy()
    out[filled & ~mask] = num_classes - 1
    return out.reshape(-1)


def _add_grid_args(p):
    p.add_argument("--pc-range", nargs=6, type=float,
                   default=[-50.0, -50.0, -5.0, 50.0, 50.0, 3.0])
    p.add_argument("--voxel-size", nargs=3, type=float,
                   default=[0.5, 0.5, 0.5])
    p.add_argument("--num-classes", type=int, default=16)


def _dims(pc, vs):
    return (
        int((pc[3] - pc[0]) / vs[0]),
        int((pc[4] - pc[1]) / vs[1]),
        int((pc[5] - pc[2]) / vs[2]),
    )


def _write_sparse(dense, num_classes, out):
    sparse = dense_to_sparse(dense, num_classes)
    np.save(out, sparse)
    print(f"{sparse.shape[0]} occupied voxels -> {out}")


def main(argv: Optional[List[str]] = None) -> int:
    args_in = sys.argv[1:] if argv is None else list(argv)
    if args_in and args_in[0] == "sequence":
        p = argparse.ArgumentParser()
        p.add_argument("cmd")
        p.add_argument("lidar_dir",
                       help="dir of <id>.npy (n,4) labeled point frames")
        p.add_argument("out", help="output .npy sparse (n,2)")
        p.add_argument("--center-id", required=True)
        p.add_argument("--window", type=int, default=3)
        p.add_argument("--stride", type=int, default=1)
        p.add_argument("--poses", default=None,
                       help=".npy (n_frames, 4, 4) frame->global poses, "
                            "ordered like the sorted frame files")
        p.add_argument("--dynamic-classes", nargs="*", type=int, default=[],
                       help="semantic ids treated as dynamic (center-"
                            "frame-only, anti-ghosting)")
        p.add_argument("--fill", choices=["none", "voxel_morph"],
                       default="none")
        p.add_argument("--morph-radius", type=int, default=1)
        _add_grid_args(p)
        args = p.parse_args(args_in)

        center = int(args.center_id)
        half = args.window // 2
        ids = [center + t * args.stride for t in range(-half, half + 1)]
        ids = [i for i in ids if i >= 0]
        frames, kept_ids = [], []
        for fid in ids:
            path = os.path.join(args.lidar_dir, f"{fid:06d}.npy")
            if os.path.exists(path):
                frames.append(np.load(path).astype(np.float32))
                kept_ids.append(fid)
        poses = None
        if args.poses:
            all_poses = np.load(args.poses)
            poses = [all_poses[i] for i in kept_ids]
        pts = aggregate_sequence(
            frames, poses, kept_ids.index(center),
            dynamic_classes=args.dynamic_classes)
        pc, vs = args.pc_range, args.voxel_size
        dims = _dims(pc, vs)
        dense = _voxelize(pts, pc, vs, dims, args.num_classes)
        if args.fill == "voxel_morph":
            dense = morph_close_dense(dense, dims, args.num_classes,
                                      radius=args.morph_radius)
        _write_sparse(dense, args.num_classes, args.out)
        return 0

    p = argparse.ArgumentParser()
    p.add_argument("points", help=".npy (n,4) [x,y,z,label] labeled points")
    p.add_argument("out", help="output .npy sparse (n,2) [voxel_idx, class]")
    _add_grid_args(p)
    args = p.parse_args(args_in)

    pts = np.load(args.points).astype(np.float32)
    pc, vs = args.pc_range, args.voxel_size
    dims = _dims(pc, vs)
    dense = _voxelize(pts, pc, vs, dims, args.num_classes)
    _write_sparse(dense, args.num_classes, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
