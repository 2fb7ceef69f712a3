"""nuScenes temporal infos: schema, loading, per-camera lidar2img.

Copy of the JAX package's data/infos.py. Parity (reference file:line):
- infos pkl contract (dict(infos=[...], metadata=...), sorted by timestamp):
  datasets/nuscenes_dataset.py:67-81; each info carries token, scene_token,
  can_bus (18,), lidar2ego_{rotation (wxyz quaternion), translation},
  ego2global_{rotation, translation}, cams{name: {data_path, cam_intrinsic,
  sensor2lidar_rotation, sensor2lidar_translation}}, timestamp, gt_boxes
  (N, 7|9), gt_names, gt_velocity, valid_flag, map_location
  (tools/data_converter/nuscenes_converter.py:178-225)
- lidar2img = viewpad(intrinsic) @ inv(sensor2lidar): nuscenes_dataset.py:
  180-266 (lidar2cam_rt construction)
- can_bus global-yaw patch: can_bus[-2] = yaw (rad), can_bus[-1] = yaw (deg)
  (nuscenes_dataset.py:249-266)

Quaternions are (w, x, y, z); ``quat_to_rot`` is the one of the port's
evaluation/formatting.py (the results' global frame uses the same).
"""
from __future__ import annotations

import pickle
from typing import List, Sequence

import numpy as np

from apollo_vision_net_tpu_torch.evaluation.formatting import quat_to_rot

CAM_ORDER = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)

DETECTION_NAME_MAP = {
    # nuScenes category -> detection class (converter parity)
    "vehicle.car": "car", "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle", "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus", "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier", "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle", "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
}


def quat_yaw(q: Sequence[float]) -> float:
    """Yaw of a (w,x,y,z) quaternion (pyquaternion yaw_pitch_roll parity)."""
    r = quat_to_rot(q)
    return float(np.arctan2(r[1, 0], r[0, 0]))


def load_infos(path: str) -> List[dict]:
    with open(path, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data
    return sorted(infos, key=lambda e: e["timestamp"])


def lidar2img_from_info(info: dict, cam_order: Sequence[str] = CAM_ORDER
                        ) -> np.ndarray:
    """(num_cam, 4, 4) projection matrices (nuscenes_dataset.py:205-231)."""
    mats = []
    for cam in cam_order:
        c = info["cams"][cam]
        l2c_r = np.asarray(c["sensor2lidar_rotation"]).T
        l2c_t = np.asarray(c["sensor2lidar_translation"]) @ l2c_r.T
        rt = np.eye(4)
        rt[:3, :3] = l2c_r
        rt[:3, 3] = -l2c_t
        viewpad = np.eye(4)
        intr = np.asarray(c["cam_intrinsic"])
        viewpad[: intr.shape[0], : intr.shape[1]] = intr
        mats.append(viewpad @ rt)
    return np.stack(mats).astype(np.float32)


def patched_can_bus(info: dict) -> np.ndarray:
    """can_bus with global-position/yaw patch (nuscenes_dataset.py:249-266):
    can_bus[:3] = global translation, can_bus[3:7] = global rotation quat,
    can_bus[-2] = global yaw (rad), can_bus[-1] = yaw (deg)."""
    cb = np.array(info["can_bus"], np.float64).copy()
    translation = np.asarray(info["ego2global_translation"])
    rotation = np.asarray(info["ego2global_rotation"])
    cb[:3] = translation
    cb[3:7] = rotation
    yaw = quat_yaw(rotation)
    if yaw < 0:
        yaw += 2 * np.pi
    cb[-2] = yaw
    cb[-1] = yaw / np.pi * 180.0
    return cb.astype(np.float32)


def lidar2global(info: dict) -> np.ndarray:
    """4x4 lidar→global (det_occ_map_dataset.py:936-950)."""
    l2e = np.eye(4)
    l2e[:3, :3] = quat_to_rot(info["lidar2ego_rotation"])
    l2e[:3, 3] = np.asarray(info["lidar2ego_translation"])
    e2g = np.eye(4)
    e2g[:3, :3] = quat_to_rot(info["ego2global_rotation"])
    e2g[:3, 3] = np.asarray(info["ego2global_translation"])
    return e2g @ l2e
