"""SemanticKITTI raw-file reader: .bin/.label/voxels + calib/poses.

Parity: the raw on-disk format consumed by the reference's SemanticKITTI
path (semantic_kitti/kitti_dataset.py:25-324 reads infos whose
``occ_gt_path`` points at dense (256, 256, 32) grids with 0=empty,
1..19=classes, 255=invalid, and whose ``cams['image_2']`` carries
``cam_intrinsic``/``lidar2cam``). This module parses the dataset's native
files directly so those infos can be produced without any devkit:

- ``sequences/<s>/velodyne/<f>.bin``   — (N, 4) float32 points
- ``sequences/<s>/labels/<f>.label``   — uint32 per point; semantic id in
  the low 16 bits, instance id in the high 16
- ``sequences/<s>/voxels/<f>.bin``     — 256·256·32 occupancy bits, packed
  MSB-first (np.unpackbits order), (x, y, z)-major
- ``sequences/<s>/voxels/<f>.label``   — uint16 per voxel, raw semantic ids
- ``sequences/<s>/voxels/<f>.invalid`` — packed bits, unlabelable voxels
- ``sequences/<s>/calib.txt``          — ``P2`` (3×4 cam projection) and
  ``Tr`` (3×4 velodyne→cam0 extrinsic)
- ``sequences/<s>/poses.txt``          — per-frame 3×4 cam0 poses; lidar
  poses are Tr⁻¹ · pose · Tr

All functions are host-side numpy. Copy of the JAX package's
data/semantic_kitti_reader.py.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from apollo_vision_net_tpu_torch.data.semantic_kitti import (
    OCC_XDIM,
    OCC_YDIM,
    OCC_ZDIM,
    OCCUPANCY_CLASSES,
    VOXEL_NUM,
    build_learning_map_array,
)

VOXEL_SHAPE = (OCC_XDIM, OCC_YDIM, OCC_ZDIM)  # (256, 256, 32), (x, y, z)


def read_points(path: str) -> np.ndarray:
    """(N, 4) [x, y, z, remission] float32."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


def read_point_labels(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(semantic (N,), instance (N,)) from a .label file."""
    raw = np.fromfile(path, dtype=np.uint32)
    return (raw & 0xFFFF).astype(np.int32), (raw >> 16).astype(np.int32)


def read_voxel_bitmap(path: str) -> np.ndarray:
    """Packed-bit voxel mask → bool (256, 256, 32), (x, y, z) order.
    Used for voxels/*.bin (occupancy) and *.invalid / *.occluded."""
    bits = np.unpackbits(np.fromfile(path, dtype=np.uint8))
    if bits.size != VOXEL_NUM:
        raise ValueError(
            f"{path}: {bits.size} bits, expected {VOXEL_NUM}")
    return bits.astype(bool).reshape(VOXEL_SHAPE)


def read_voxel_label(path: str) -> np.ndarray:
    """uint16 raw semantic ids → (256, 256, 32), (x, y, z) order."""
    lab = np.fromfile(path, dtype=np.uint16)
    if lab.size != VOXEL_NUM:
        raise ValueError(f"{path}: {lab.size} voxels, expected {VOXEL_NUM}")
    return lab.reshape(VOXEL_SHAPE)


def read_calib(path: str) -> Dict[str, np.ndarray]:
    """calib.txt → {'P2': (3, 4), 'Tr': (4, 4) velodyne→cam0}."""
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, vals = line.split(":", 1)
            arr = np.asarray([float(v) for v in vals.split()], np.float64)
            if arr.size == 12:
                out[key.strip()] = arr.reshape(3, 4)
    calib = {"P2": out["P2"]}
    tr = np.eye(4)
    tr[:3] = out["Tr"]
    calib["Tr"] = tr
    return calib


def read_poses(path: str, tr: Optional[np.ndarray] = None) -> np.ndarray:
    """poses.txt → (T, 4, 4). cam0 poses by default; pass the calib ``Tr``
    to get lidar-frame poses (Tr⁻¹ · pose · Tr)."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 3, 4)
    poses = np.tile(np.eye(4), (len(rows), 1, 1))
    poses[:, :3] = rows
    if tr is not None:
        tr_inv = np.linalg.inv(tr)
        poses = tr_inv @ poses @ tr
    return poses


def build_ssc_gt(voxel_label: np.ndarray,
                 invalid: Optional[np.ndarray] = None) -> np.ndarray:
    """Dense SSC GT in the converter convention the reference evaluates
    against (kitti_dataset.py:239, loading.py:143-170): (256, 256, 32)
    uint8 with 0=empty, 1..19=classes (learning_map ids), 255=invalid."""
    lut = build_learning_map_array()
    gt = lut[np.clip(voxel_label.astype(np.int64), 0, len(lut) - 1)]
    gt = gt.astype(np.uint8)
    if invalid is not None:
        gt[invalid] = 255
    return gt


def frame_info(
    seq_dir: str,
    frame_idx: int,
    calib: Dict[str, np.ndarray],
    pose: np.ndarray,
    scene_name: str,
    occ_gt_path: str = "",
) -> dict:
    """One info record in the schema CustomSemanticKittiDataset consumes
    (kitti_dataset.py:135-200): cams.image_2 with cam_intrinsic (P2 viewpad)
    and lidar2cam (Tr), scene/frame identity, ego pose."""
    viewpad = np.eye(4)
    viewpad[:3] = calib["P2"]
    return dict(
        token=f"{scene_name}_{frame_idx:06d}",
        scene_token=scene_name,
        scene_name=scene_name,
        frame_idx=frame_idx,
        timestamp=frame_idx * 100_000,  # 10 Hz in µs
        can_bus=np.zeros(18, np.float32),
        ego2global=pose,
        occ_gt_path=occ_gt_path,
        cams={
            "image_2": dict(
                data_path=os.path.join(
                    seq_dir, "image_2", f"{frame_idx:06d}.png"),
                cam_intrinsic=viewpad[:3, :3],
                lidar2cam=calib["Tr"],
                lidar2img=viewpad @ calib["Tr"],
            )
        },
    )


def create_semantic_kitti_infos(
    root: str,
    sequences: List[str],
    out_dir: str,
    write_occ_gt: bool = True,
) -> List[dict]:
    """Scan ``<root>/sequences/<s>`` and build infos (+ dense occ-GT npys
    from voxels/*.label ∧ *.invalid when present). Devkit-free converter
    for the reference's SemanticKITTI path."""
    os.makedirs(out_dir, exist_ok=True)
    infos: List[dict] = []
    for seq in sequences:
        seq_dir = os.path.join(root, "sequences", seq)
        calib = read_calib(os.path.join(seq_dir, "calib.txt"))
        poses_path = os.path.join(seq_dir, "poses.txt")
        poses = (read_poses(poses_path, calib["Tr"])
                 if os.path.exists(poses_path) else None)
        vox_dir = os.path.join(seq_dir, "voxels")
        frames = sorted(
            int(f.split(".")[0]) for f in os.listdir(vox_dir)
            if f.endswith(".label"))
        for fi in frames:
            occ_path = ""
            if write_occ_gt:
                label = read_voxel_label(
                    os.path.join(vox_dir, f"{fi:06d}.label"))
                inv_file = os.path.join(vox_dir, f"{fi:06d}.invalid")
                invalid = (read_voxel_bitmap(inv_file)
                           if os.path.exists(inv_file) else None)
                occ_path = os.path.join(
                    out_dir, f"occ_gt_{seq}_{fi:06d}.npy")
                np.save(occ_path, build_ssc_gt(label, invalid))
            pose = poses[fi] if poses is not None and fi < len(poses) \
                else np.eye(4)
            infos.append(frame_info(
                seq_dir, fi, calib, pose, f"seq_{seq}", occ_path))
    return infos
