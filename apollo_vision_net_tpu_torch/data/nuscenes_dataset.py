"""nuScenes temporal dataset: infos + pipeline + queue + static GT packing.

Parity: datasets/nuscenes_dataset.py:22-547 (CustomNuScenesDataset) and
datasets/nuscenes_det_occ_map_dataset.py:573-1046 (det+occ+map variant) —
the mm-style pipeline/registry is replaced by plain composition:
`get_frame` builds one frame (images, lidar2img, can_bus, GT),
`get_queue_sample` assembles the training queue with union2one deltas, and
everything is padded to static shapes for the jitted train step.

Copy of the JAX package's data/nuscenes_dataset.py. Image loading uses
PIL; samples whose image files are absent raise, so CI uses the synthetic
generator instead (data/synthetic.py).
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from apollo_vision_net_tpu_torch.configs import ExperimentConfig
from apollo_vision_net_tpu_torch.data import infos as infos_lib
from apollo_vision_net_tpu_torch.data import pipeline as pipe
from apollo_vision_net_tpu_torch.data import temporal
from apollo_vision_net_tpu_torch.data.vector_map import pack_map_gt
from apollo_vision_net_tpu_torch.data.semantic_kitti import (
    sparse_flow_to_dense,
    sparse_to_dense,
)

DET_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)


class NuScenesTemporalDataset:
    def __init__(
        self,
        cfg: ExperimentConfig,
        ann_file: str,
        data_root: str = "",
        training: bool = True,
        img_scale: float = 0.5,
        load_occ_gt: bool = False,
        load_map_gt: bool = False,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.data_root = data_root
        self.training = training
        self.img_scale = img_scale
        self.load_occ_gt = load_occ_gt or cfg.model.with_occupancy
        self.load_map_gt = load_map_gt or cfg.model.with_map
        self.infos = infos_lib.load_infos(ann_file)
        self.rng = np.random.default_rng(seed)
        self.class_to_label = {n: i for i, n in enumerate(DET_CLASSES)}

    def __len__(self) -> int:
        return len(self.infos)

    def _load_images(self, info: dict) -> np.ndarray:
        from PIL import Image

        imgs = []
        for cam in infos_lib.CAM_ORDER[: self.cfg.model.num_cams]:
            path = info["cams"][cam]["data_path"]
            if self.data_root and not os.path.isabs(path):
                path = os.path.join(self.data_root, path)
            imgs.append(np.asarray(Image.open(path).convert("RGB")))
        return np.stack(imgs)

    def get_frame(self, index: int) -> Dict[str, np.ndarray]:
        info = self.infos[index]
        m = self.cfg.model
        imgs = self._load_images(info)
        l2i = infos_lib.lidar2img_from_info(
            info, infos_lib.CAM_ORDER[: m.num_cams])
        imgs, l2i = pipe.preprocess_frame(
            imgs, l2i, scale=self.img_scale, training=self.training,
            rng=self.rng)
        frame = dict(
            img=imgs.astype(np.float32),
            lidar2img=l2i.astype(np.float32),
            can_bus=infos_lib.patched_can_bus(info),
            scene_token=info.get("scene_token", ""),
        )
        # detection GT
        G = self.cfg.data.max_gt_boxes
        boxes = np.zeros((G, 9), np.float32)
        boxes[:, 3:6] = 1.0
        labels = np.zeros((G,), np.int32)
        mask = np.zeros((G,), bool)
        gt_boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 7))),
                              np.float32)
        gt_names = list(info.get("gt_names", []))
        gt_vel = np.asarray(
            info.get("gt_velocity", np.zeros((len(gt_names), 2))), np.float32)
        valid = np.asarray(
            info.get("valid_flag", np.ones(len(gt_names), bool)))
        k = 0
        pc = m.pc_range
        for i, name in enumerate(gt_names):
            if k >= G or name not in self.class_to_label or not valid[i]:
                continue
            b = gt_boxes[i]
            if not (pc[0] <= b[0] <= pc[3] and pc[1] <= b[1] <= pc[4]):
                continue
            boxes[k, :7] = b[:7]
            # infos store bottom-center z; the head regresses gravity center
            boxes[k, 2] += b[5] / 2.0
            boxes[k, 7:9] = np.nan_to_num(gt_vel[i])
            labels[k] = self.class_to_label[name]
            mask[k] = True
            k += 1
        frame.update(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)

        if self.load_occ_gt and "occ_gt_path" in info:
            occ_path = info["occ_gt_path"]
            if self.data_root and not os.path.isabs(occ_path):
                occ_path = os.path.join(self.data_root, occ_path)
            sparse = np.load(occ_path)
            vox = m.occ_zdim * m.occ_xdim * m.occ_ydim
            frame["gt_occupancy"] = sparse_to_dense(
                sparse, vox, m.occupancy_classes)
            if m.predict_flow and "flow_gt_path" in info:
                # (n, 2) flow rows aligned with the sparse occ rows
                # (reference LoadFlowGT, pipelines/loading.py:172-184)
                flow_path = info["flow_gt_path"]
                if self.data_root and not os.path.isabs(flow_path):
                    flow_path = os.path.join(self.data_root, flow_path)
                frame["gt_flow"] = sparse_flow_to_dense(
                    sparse, np.load(flow_path), vox)
        if self.load_map_gt:
            vectors = [np.asarray(v, np.float32)
                       for v in info.get("map_vectors", [])]
            labels_v = info.get("map_labels", [])
            packed = pack_map_gt(
                vectors,
                list(labels_v),
                max_vec=min(self.cfg.data.max_gt_boxes, m.num_map_vec),
                fixed_num=m.map_num_pts, pattern=m.map_shift_pattern,
                patch_size=m.map_patch_size, seed=index,
            )
            frame.update(
                map_shift_pts=packed["shift_pts"],
                map_labels=packed["labels"],
                map_mask=packed["mask"],
                map_order_mask=packed["order_mask"],
            )
            if m.with_aux_seg:
                # MapTRv2 aux BEV/PV seg masks from the same real geometry
                # (reference v2 head :234-414; host-side here)
                from apollo_vision_net_tpu_torch.data.rasterize import (
                    rasterize_lines_bev, rasterize_lines_pv)

                frame["gt_bev_seg"] = rasterize_lines_bev(
                    vectors, m.bev_h, m.bev_w, m.map_patch_size,
                    radius=m.map_aux_seg_radius)
                ih, iw = frame["img"].shape[1:3]
                frame["gt_pv_seg"] = rasterize_lines_pv(
                    vectors, frame["lidar2img"], (ih, iw),
                    (ih // 16, iw // 16), radius=m.map_aux_pv_radius)
        return frame

    def get_queue_sample(self, index: int) -> Dict[str, np.ndarray]:
        """One training sample: a queue of frames folded union2one-style."""
        idxs = temporal.sample_queue_indices(
            index, self.cfg.model.queue_length, self.rng)
        frames = [self.get_frame(i) for i in idxs]
        fold = temporal.union2one_can_bus(
            [f["can_bus"] for f in frames],
            [f["scene_token"] for f in frames],
        )
        sample = dict(
            img=np.stack([f["img"] for f in frames]),
            lidar2img=np.stack([f["lidar2img"] for f in frames]),
            can_bus=fold["can_bus"],
            has_prev=fold["has_prev"],
        )
        last = frames[-1]
        for key in ("gt_boxes", "gt_labels", "gt_mask", "gt_occupancy",
                    "gt_flow", "map_shift_pts", "map_labels", "map_mask",
                    "map_order_mask", "gt_bev_seg", "gt_pv_seg"):
            if key in last:
                sample[key] = last[key]
        m = self.cfg.model
        if (m.keep_bev_history or m.with_occupancy_flow) and \
                "gt_occupancy" in last:
            # multi-frame occ supervision: (S, voxel_num) per sample
            sample["gt_occupancy"] = np.stack(
                [f["gt_occupancy"] for f in frames])
            if "gt_flow" in last:
                sample["gt_flow"] = np.stack([f["gt_flow"] for f in frames])
        return sample


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def scene_contiguous_eval_indices(infos: List[dict], world: int, rank: int
                                  ) -> List[int]:
    """Contiguous per-rank chunks so the prev_bev recurrence stays local
    (reference samplers/distributed_sampler.py:35-37)."""
    n = len(infos)
    per = (n + world - 1) // world
    return list(range(rank * per, min((rank + 1) * per, n)))
