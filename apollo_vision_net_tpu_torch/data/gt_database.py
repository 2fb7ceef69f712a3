"""Ground-truth database creation for GT-sampling augmentation.

Copy of the JAX package's data/gt_database.py; numpy, importing nothing of that
package.

Parity: tools/data_converter/create_gt_database.py:109-250 — for every GT
box, crop the lidar points inside it, write one ``.bin`` per instance to
``<out>/<prefix>_gt_database/{idx}_{name}_{i}.bin`` and collect a
``db_infos`` pkl keyed by class name with per-instance records
(name/path/image_idx/gt_idx/box3d_lidar/num_points_in_gt/difficulty/
group_id/score).

The reference funnels this through an mmdet3d dataset + pipeline object
(LoadPointsFromFile/LoadAnnotations3D); here it reads the info pkls
produced by `data/kitti.py` / `data/infos.py` directly — same artifacts,
no registry indirection. nuScenes gt-database creation is disabled in the
reference's own create_data (tools/create_data.py:88-90, commented out);
the nuscenes-style branch here accepts infos that carry ``lidar_path`` +
``gt_boxes`` so the capability exists when a dataset provides them.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from apollo_vision_net_tpu_torch.data.kitti import (
    box_camera_to_lidar, points_in_rbbox, remove_outside_points)

__all__ = ["create_groundtruth_database"]


def _kitti_sample(info: Dict, data_path: str):
    """(points, names, boxes_lidar, difficulty, group_ids, image_idx)."""
    pc = info["point_cloud"]
    v_path = pc["velodyne_path"]
    if not os.path.isabs(v_path):
        v_path = os.path.join(data_path, v_path)
    points = np.fromfile(v_path, np.float32).reshape(
        -1, pc.get("num_features", 4))
    calib = info["calib"]
    if "image_shape" in info.get("image", {}):
        points = remove_outside_points(
            points, calib["R0_rect"], calib["Tr_velo_to_cam"],
            calib["P2"], info["image"]["image_shape"])
    annos = info["annos"]
    keep = annos["name"] != "DontCare"
    boxes_cam = np.concatenate(
        [annos["location"][keep], annos["dimensions"][keep],
         annos["rotation_y"][keep, None]], 1)
    boxes = box_camera_to_lidar(
        boxes_cam, calib["R0_rect"], calib["Tr_velo_to_cam"])
    return (points, annos["name"][keep], boxes,
            annos.get("difficulty", np.zeros(len(annos["name"]), np.int32))[keep],
            annos.get("group_ids", np.arange(len(annos["name"])))[keep],
            info["image"]["image_idx"])


def _nuscenes_sample(info: Dict, data_path: str):
    lp = info.get("lidar_path")
    if lp is None:
        raise KeyError(
            "nuscenes-style gt-database needs 'lidar_path' in each info")
    if not os.path.isabs(lp):
        lp = os.path.join(data_path, lp)
    points = np.fromfile(lp, np.float32).reshape(-1, 5)
    boxes7 = np.asarray(info["gt_boxes"], np.float64).reshape(-1, 7)
    # infos store [x, y, z_bottom, w, l, h, yaw] (data/infos.py schema);
    # reorder dims to the [l, w, h] the cropper expects
    boxes = boxes7[:, [0, 1, 2, 4, 3, 5, 6]]
    names = np.asarray(info["gt_names"])
    n = len(names)
    return (points, names, boxes, np.zeros(n, np.int32),
            np.arange(n, dtype=np.int32), info.get("token", ""))


def create_groundtruth_database(
    dataset: str,
    data_path: str,
    info_path: str,
    info_prefix: str = "kitti",
    used_classes: Optional[Sequence[str]] = None,
    database_save_path: Optional[str] = None,
    db_info_save_path: Optional[str] = None,
) -> Dict[str, List[Dict]]:
    """Build the per-instance point database. Returns db_infos.

    dataset: 'kitti' | 'nuscenes' (reference dataset_class_name switch,
    create_gt_database.py:147-207).
    """
    with open(info_path, "rb") as f:
        payload = pickle.load(f)
    infos = payload["infos"] if isinstance(payload, dict) else payload

    db_dir = database_save_path or os.path.join(
        data_path, f"{info_prefix}_gt_database")
    db_info_path = db_info_save_path or os.path.join(
        data_path, f"{info_prefix}_dbinfos_train.pkl")
    os.makedirs(db_dir, exist_ok=True)

    sample_fn = _kitti_sample if dataset == "kitti" else _nuscenes_sample
    db_infos: Dict[str, List[Dict]] = {}
    n_inst = 0
    for info in infos:
        points, names, boxes, difficulty, group_ids, image_idx = sample_fn(
            info, data_path)
        if len(boxes) == 0:
            continue
        inside = points_in_rbbox(points[:, :3], boxes)  # (P, N)
        for i, name in enumerate(names):
            name = str(name)
            if used_classes is not None and name not in used_classes:
                continue
            gt_points = points[inside[:, i]].astype(np.float32)
            # store points relative to the box center so the sampler can
            # paste instances at new poses (create_gt_database.py:244-246)
            gt_points = gt_points.copy()
            gt_points[:, :3] -= boxes[i, :3].astype(np.float32)
            fname = f"{image_idx}_{name}_{i}.bin"
            abs_path = os.path.join(db_dir, fname)
            gt_points.tofile(abs_path)
            db_infos.setdefault(name, []).append({
                "name": name,
                "path": os.path.join(os.path.basename(db_dir), fname),
                "image_idx": image_idx,
                "gt_idx": int(i),
                "box3d_lidar": boxes[i].astype(np.float32),
                "num_points_in_gt": int(inside[:, i].sum()),
                "difficulty": int(difficulty[i]),
                "group_id": int(group_ids[i]),
                "score": 0.0,
            })
            n_inst += 1

    with open(db_info_path, "wb") as f:
        pickle.dump(db_infos, f)
    for k, v in db_infos.items():
        print(f"load {len(v)} {k} database infos")
    print(f"gt database: {n_inst} instances -> {db_dir}")
    return db_infos
