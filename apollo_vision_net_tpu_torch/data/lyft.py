"""Lyft Level-5 offline converter.

Copy of the JAX package's data/lyft.py (``quat_to_rot`` from the port's
evaluation/formatting.py); numpy, importing nothing of that package.

Parity: tools/data_converter/lyft_converter.py:18-209 — same info schema as
the nuScenes converter (lidar_path/cams/sweeps/poses/gt_boxes in SECOND
yaw convention) with the Lyft category set and train/val scene-name splits.

The devkit (`lyft_dataset_sdk`) is import-gated exactly like the nuScenes
path in tools/create_data.py; `fill_trainval_infos` itself is duck-typed
over the devkit's table API (`.sample`, `.get`, `.get_sample_data`) so the
conversion logic is unit-tested in-env against a fake dataset object.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from apollo_vision_net_tpu_torch.evaluation.formatting import quat_to_rot

LYFT_CLASSES = (
    "car", "truck", "bus", "emergency_vehicle", "other_vehicle",
    "motorcycle", "bicycle", "pedestrian", "animal",
)

CAMERA_TYPES = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)


def _rt(rotation, translation) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = quat_to_rot(rotation)
    m[:3, 3] = np.asarray(translation, np.float64)
    return m


def _sensor2top(lyft, sensor_token: str, lidar2ego: np.ndarray,
                ego2global: np.ndarray, sensor_type: str) -> Dict:
    """sensor→top-lidar extrinsics at the keyframe's pose (the quantity the
    reference computes via obtain_sensor2top's unrolled rotation algebra —
    here as one homogeneous chain: inv(l2e)·inv(e2g)·s_e2g·s2e)."""
    sd = lyft.get("sample_data", sensor_token)
    cs = lyft.get("calibrated_sensor", sd["calibrated_sensor_token"])
    pose = lyft.get("ego_pose", sd["ego_pose_token"])
    data_path = str(lyft.get_sample_data_path(sensor_token))
    s2l = (np.linalg.inv(lidar2ego) @ np.linalg.inv(ego2global)
           @ _rt(pose["rotation"], pose["translation"])
           @ _rt(cs["rotation"], cs["translation"]))
    return {
        "data_path": data_path,
        "type": sensor_type,
        "sample_data_token": sensor_token,
        "sensor2ego_translation": cs["translation"],
        "sensor2ego_rotation": cs["rotation"],
        "ego2global_translation": pose["translation"],
        "ego2global_rotation": pose["rotation"],
        "timestamp": sd["timestamp"],
        "sensor2lidar_rotation": s2l[:3, :3],
        "sensor2lidar_translation": s2l[:3, 3],
    }


def fill_trainval_infos(
    lyft,
    train_scenes: set,
    val_scenes: set,
    test: bool = False,
    max_sweeps: int = 10,
    name_mapping: Optional[Dict[str, str]] = None,
) -> Tuple[List[Dict], List[Dict]]:
    """Per-sample info dicts split by scene membership
    (lyft_converter.py:93-209)."""
    train_infos: List[Dict] = []
    val_infos: List[Dict] = []
    for sample in lyft.sample:
        lidar_token = sample["data"]["LIDAR_TOP"]
        sd = lyft.get("sample_data", lidar_token)
        cs = lyft.get("calibrated_sensor", sd["calibrated_sensor_token"])
        pose = lyft.get("ego_pose", sd["ego_pose_token"])
        lidar_path, boxes, _ = lyft.get_sample_data(lidar_token)

        info = {
            "lidar_path": str(lidar_path),
            "token": sample["token"],
            "sweeps": [],
            "cams": {},
            "lidar2ego_translation": cs["translation"],
            "lidar2ego_rotation": cs["rotation"],
            "ego2global_translation": pose["translation"],
            "ego2global_rotation": pose["rotation"],
            "timestamp": sample["timestamp"],
        }
        lidar2ego = _rt(cs["rotation"], cs["translation"])
        ego2global = _rt(pose["rotation"], pose["translation"])

        for cam in CAMERA_TYPES:
            if cam not in sample["data"]:
                continue
            cam_token = sample["data"][cam]
            _, _, cam_intrinsic = lyft.get_sample_data(cam_token)
            cam_info = _sensor2top(lyft, cam_token, lidar2ego, ego2global, cam)
            cam_info["cam_intrinsic"] = np.asarray(cam_intrinsic)
            info["cams"][cam] = cam_info

        sweep_rec = sd
        while len(info["sweeps"]) < max_sweeps and sweep_rec["prev"]:
            info["sweeps"].append(_sensor2top(
                lyft, sweep_rec["prev"], lidar2ego, ego2global, "lidar"))
            sweep_rec = lyft.get("sample_data", sweep_rec["prev"])

        if not test:
            annotations = [
                lyft.get("sample_annotation", t) for t in sample["anns"]]
            locs = np.array([b.center for b in boxes]).reshape(-1, 3)
            dims = np.array([b.wlh for b in boxes]).reshape(-1, 3)
            rots = np.array(
                [b.orientation.yaw_pitch_roll[0] for b in boxes]
            ).reshape(-1, 1)
            names = [
                (name_mapping or {}).get(b.name, b.name) for b in boxes]
            # SECOND yaw convention: -yaw - pi/2 (lyft_converter.py:196)
            info["gt_boxes"] = np.concatenate(
                [locs, dims, -rots - np.pi / 2], axis=1)
            info["gt_names"] = np.array(names)
            info["num_lidar_pts"] = np.array(
                [a["num_lidar_pts"] for a in annotations])
            info["num_radar_pts"] = np.array(
                [a["num_radar_pts"] for a in annotations])

        (train_infos if sample["scene_token"] in train_scenes
         else val_infos).append(info)
    return train_infos, val_infos


def create_lyft_infos(root_path: str, info_prefix: str = "lyft",
                      version: str = "v1.01-train", max_sweeps: int = 10,
                      out_dir: Optional[str] = None,
                      split_files: Optional[Dict[str, Sequence[str]]] = None):
    """The full conversion (lyft_converter.py:18-91): loads the devkit, resolves the
    scene-name splits (train/val txt files under ``<root>/<version>``), and
    writes ``{prefix}_infos_{train,val|test}.pkl``."""
    try:
        from lyft_dataset_sdk.lyftdataset import LyftDataset as Lyft
    except ImportError as e:  # pragma: no cover - devkit absent in CI
        raise SystemExit(
            "lyft_dataset_sdk is required for Lyft conversion "
            "(not available in this environment)") from e

    lyft = Lyft(
        data_path=os.path.join(root_path, version),
        json_path=os.path.join(root_path, version, version),
        verbose=True)
    test = "test" in version
    if split_files is None:
        split_files = {
            s: os.path.join(root_path, f"{s}.txt") for s in ("train", "val")}

    def read_split(p):
        if isinstance(p, (list, tuple)):
            return list(p)
        if os.path.exists(p):
            with open(p) as f:
                return [ln.strip() for ln in f if ln.strip()]
        return []

    name_by_token = {s["token"]: lyft.get("scene", s["token"])["name"]
                     for s in lyft.scene}
    train_names = set(read_split(split_files["train"]))
    val_names = set(read_split(split_files.get("val", [])))
    train_scenes = {t for t, n in name_by_token.items() if n in train_names}
    val_scenes = {t for t, n in name_by_token.items() if n in val_names}

    train_infos, val_infos = fill_trainval_infos(
        lyft, train_scenes, val_scenes, test=test, max_sweeps=max_sweeps)
    out_dir = out_dir or root_path
    os.makedirs(out_dir, exist_ok=True)
    meta = {"version": version}
    if test:
        paths = {"test": train_infos}
    else:
        paths = {"train": train_infos, "val": val_infos}
    written = {}
    for split, infos in paths.items():
        p = os.path.join(out_dir, f"{info_prefix}_infos_{split}.pkl")
        with open(p, "wb") as f:
            pickle.dump({"infos": infos, "metadata": meta}, f)
        written[split] = p
        print(f"lyft info {split}: {len(infos)} samples -> {p}")
    return written
