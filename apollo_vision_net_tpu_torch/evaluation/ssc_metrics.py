"""Semantic scene completion / occupancy IoU metrics.

A copy of the JAX package's evaluation/ssc_metrics.py (numpy only); a test
holds it equal to the original.

Parity: datasets/occupancy_metrics.py:3-101 (SSCMetrics — 17-way confusion
matrix with empty as the last class, completion IoU from the non-empty
block, per-distance-band masks) and semantic_kitti/kitti_metrics.py
(KittiSSCMetrics — 19/20-class variant with empty as class 0).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SSCMetrics:
    def __init__(
        self,
        n_classes: int = 17,
        point_cloud_range=(-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
        occupancy_size=(0.5, 0.5, 0.5),
        eval_far: bool = False,
        eval_near: bool = False,
        near_distance: float = 10.0,
        far_distance: float = 30.0,
        empty_label: Optional[int] = None,
    ):
        self.n_classes = n_classes
        # nuScenes convention: empty = last class; SemanticKITTI: empty = 0
        self.empty_label = n_classes - 1 if empty_label is None else empty_label
        self.pc_range = np.asarray(point_cloud_range, np.float64)
        self.occ_size = np.asarray(occupancy_size, np.float64)
        self.occ_xdim = int((self.pc_range[3] - self.pc_range[0]) / self.occ_size[0])
        self.occ_ydim = int((self.pc_range[4] - self.pc_range[1]) / self.occ_size[1])
        self.occ_zdim = int((self.pc_range[5] - self.pc_range[2]) / self.occ_size[2])
        self.hist = np.zeros((n_classes, n_classes), np.float64)
        self.eval_far, self.eval_near = eval_far, eval_near
        self.far_distance, self.near_distance = far_distance, near_distance
        self.hist_far = np.zeros_like(self.hist)
        self.hist_near = np.zeros_like(self.hist)
        if eval_far or eval_near:
            self._build_distance_masks()

    def _build_distance_masks(self):
        z, y, x = np.meshgrid(
            np.arange(self.occ_zdim), np.arange(self.occ_ydim),
            np.arange(self.occ_xdim), indexing="ij",
        )
        px = (x.reshape(-1) + 0.5) / self.occ_xdim * (
            self.pc_range[3] - self.pc_range[0]) + self.pc_range[0]
        py = (y.reshape(-1) + 0.5) / self.occ_ydim * (
            self.pc_range[4] - self.pc_range[1]) + self.pc_range[1]
        dist = np.hypot(px, py)
        self.far_voxel_mask = dist > self.far_distance
        self.near_voxel_mask = dist <= self.near_distance

    @staticmethod
    def _hist(n_cl: int, pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
        k = (gt >= 0) & (gt < n_cl)
        return np.bincount(
            n_cl * gt[k].astype(int) + pred[k].astype(int),
            minlength=n_cl**2,
        ).reshape(n_cl, n_cl)

    def add_batch(self, y_pred, y_true, visible_mask=None):
        y_pred = np.asarray(y_pred).reshape(-1)
        y_true = np.asarray(y_true).reshape(-1)
        if visible_mask is not None:
            vm = np.asarray(visible_mask).reshape(-1) == 1
            y_pred, y_true = y_pred[vm], y_true[vm]
        self.hist += self._hist(self.n_classes, y_pred, y_true)
        if self.eval_far and y_pred.size == self.far_voxel_mask.size:
            self.hist_far += self._hist(
                self.n_classes, y_pred[self.far_voxel_mask],
                y_true[self.far_voxel_mask])
        if self.eval_near and y_pred.size == self.near_voxel_mask.size:
            self.hist_near += self._hist(
                self.n_classes, y_pred[self.near_voxel_mask],
                y_true[self.near_voxel_mask])

    def _stats_from_hist(self, hist: np.ndarray) -> Dict[str, np.ndarray]:
        miou = np.diag(hist) / (
            hist.sum(1) + hist.sum(0) - np.diag(hist) + 1e-6) * 100.0
        e = self.empty_label
        sem = [i for i in range(self.n_classes) if i != e]
        completion_tp = hist[np.ix_(sem, sem)].sum()
        completion_fp = hist[e, sem].sum()
        completion_fn = hist[sem, e].sum()
        if completion_tp != 0:
            precision = completion_tp / (completion_tp + completion_fp)
            recall = completion_tp / (completion_tp + completion_fn)
            iou = completion_tp / (
                completion_tp + completion_fp + completion_fn) * 100.0
        else:
            precision = recall = iou = 0.0
        iou_ssc = miou[sem]
        return {
            "iou": iou,
            "precision": precision,
            "recall": recall,
            "iou_ssc": iou_ssc,
            "miou": float(np.mean(iou_ssc)),
        }

    def get_stats(self) -> Dict[str, np.ndarray]:
        out = self._stats_from_hist(self.hist)
        if self.eval_far:
            out["far"] = self._stats_from_hist(self.hist_far)
        if self.eval_near:
            out["near"] = self._stats_from_hist(self.hist_near)
        return out
