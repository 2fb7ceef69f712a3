"""Sparse occupancy GT to dense voxel labels (and flows).

Copy of the part of the JAX package's data/semantic_kitti.py that the
nuScenes dataset uses (``sparse_to_dense``, ``sparse_flow_to_dense``) with
the SemanticKITTI grid's defaults (256x256x32 voxels, 19 classes + empty);
the SemanticKITTI reader and label mapping are not ported yet.
"""
from __future__ import annotations

import numpy as np

PC_RANGE = (0.0, -25.6, -2.0, 51.2, 25.6, 4.4)
OCCUPANCY_SIZE = (0.2, 0.2, 0.2)
OCC_XDIM = int((PC_RANGE[3] - PC_RANGE[0]) / OCCUPANCY_SIZE[0])  # 256
OCC_YDIM = int((PC_RANGE[4] - PC_RANGE[1]) / OCCUPANCY_SIZE[1])  # 256
OCC_ZDIM = int((PC_RANGE[5] - PC_RANGE[2]) / OCCUPANCY_SIZE[2])  # 32
OCCUPANCY_CLASSES = 19
VOXEL_NUM = OCC_XDIM * OCC_YDIM * OCC_ZDIM


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
