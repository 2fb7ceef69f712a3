"""SemanticKITTI semantic scene completion: label mapping, the dense and
sparse voxel GT codecs and the per-sample record.

Copy of the JAX package's data/semantic_kitti.py (parity:
semantic_kitti/kitti_dataset.py:25-324, CustomSemanticKittiDataset —
pc_range [0,-25.6,-2,51.2,25.6,4.4], 0.2 m voxels → 256×256×32 grid, 19
semantic classes + empty; kitti_metrics.py evaluates with empty as the
last bucket). The raw-file reader is ``data/semantic_kitti_reader.py``;
``sparse_to_dense`` and ``sparse_flow_to_dense`` also serve the nuScenes
dataset's occupancy GT.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

PC_RANGE = (0.0, -25.6, -2.0, 51.2, 25.6, 4.4)
OCCUPANCY_SIZE = (0.2, 0.2, 0.2)
OCC_XDIM = int((PC_RANGE[3] - PC_RANGE[0]) / OCCUPANCY_SIZE[0])  # 256
OCC_YDIM = int((PC_RANGE[4] - PC_RANGE[1]) / OCCUPANCY_SIZE[1])  # 256
OCC_ZDIM = int((PC_RANGE[5] - PC_RANGE[2]) / OCCUPANCY_SIZE[2])  # 32
OCCUPANCY_CLASSES = 19
VOXEL_NUM = OCC_XDIM * OCC_YDIM * OCC_ZDIM

CLASS_NAMES = (
    "car", "bicycle", "motorcycle", "truck", "other-vehicle", "person",
    "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
)

# semantic-kitti.yaml learning_map: raw label -> train id (0 = unlabeled,
# shifted so classes are 0..18 and empty/unlabeled = OCCUPANCY_CLASSES)
LEARNING_MAP: Dict[int, int] = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}


def build_learning_map_array() -> np.ndarray:
    lut = np.zeros(max(LEARNING_MAP) + 1, np.int32)
    for k, v in LEARNING_MAP.items():
        lut[k] = v
    return lut


def relabel(raw_labels: np.ndarray) -> np.ndarray:
    """Raw SemanticKITTI labels -> train ids 0..18, empty/unlabeled -> 19.

    Matches the relabel path of LoadOccupancyGT (datasets/pipelines/
    loading.py:143-170): yaml ids are 1-based after mapping (0=unlabeled),
    shifted down by one with unlabeled sent to the empty bucket.
    """
    lut = build_learning_map_array()
    mapped = lut[np.clip(raw_labels & 0xFFFF, 0, len(lut) - 1)]
    out = np.where(mapped == 0, OCCUPANCY_CLASSES, mapped - 1)
    return out.astype(np.int32)


def dense_gt_to_training_labels(dense_xyz: np.ndarray) -> np.ndarray:
    """Converter-format dense GT (x, y, z; 0=empty, 1..19, 255=invalid) →
    flat training labels in model voxel order (z, y, x; classes 0..18,
    empty=19, ignore=255). Reproduces LoadOccupancyGT's semantic-kitti
    branch (datasets/pipelines/loading.py:143-170: transpose(2,1,0), -1,
    -1→occupancy_classes, 254→255)."""
    occ = dense_xyz.transpose(2, 1, 0).astype(np.int32) - 1
    occ[occ == -1] = OCCUPANCY_CLASSES
    occ[occ == 254] = 255
    return occ.reshape(-1)


def sparse_to_dense(occ_gt: np.ndarray, voxel_num: int = VOXEL_NUM,
                    empty_label: int = OCCUPANCY_CLASSES) -> np.ndarray:
    """(n, 2) [voxel_index, class] -> dense (voxel_num,) labels."""
    dense = np.full((voxel_num,), empty_label, np.int32)
    if occ_gt.size:
        dense[occ_gt[:, 0].astype(np.int64)] = occ_gt[:, 1]
    return dense


def sparse_flow_to_dense(occ_gt: np.ndarray, flow_gt: np.ndarray,
                         voxel_num: int = VOXEL_NUM) -> np.ndarray:
    """Dense (voxel_num, 2) flow from per-occupied-voxel sparse rows.

    The reference's LoadFlowGT (datasets/pipelines/loading.py:172-184) loads
    an (n, 2) flow npy row-aligned with the sparse occ GT's (n, 2)
    [voxel_index, class] rows; the head densifies both together
    (bevformer_occupancy_head.py:795-801, 713-720)."""
    dense = np.zeros((voxel_num, 2), np.float32)
    if occ_gt.size and flow_gt.size:
        dense[occ_gt[:, 0].astype(np.int64)] = flow_gt[:, :2]
    return dense


def dense_to_sparse(dense: np.ndarray,
                    empty_label: int = OCCUPANCY_CLASSES) -> np.ndarray:
    """Dense labels -> (n, 2) [voxel_index, class] sparse rows (the
    reference's prediction dump format, kitti_dataset.py:320-324)."""
    idx = np.where(dense != empty_label)[0]
    return np.stack([idx, dense[idx]], axis=1).astype(np.int64)


def sample_record(
    img: np.ndarray, cam_intrinsic: np.ndarray, lidar2cam: np.ndarray,
    occ_gt_sparse: np.ndarray, sequence: str, frame_idx: int,
) -> dict:
    """Canonical per-frame record consumed by the training pipeline."""
    viewpad = np.eye(4, dtype=np.float64)
    viewpad[:3, :3] = cam_intrinsic[:3, :3]
    return dict(
        img=img,
        lidar2img=(viewpad @ lidar2cam)[None].astype(np.float32),
        occ_gt=occ_gt_sparse,
        scene_token=sequence,
        frame_idx=frame_idx,
        can_bus=np.zeros(18, np.float32),
    )
