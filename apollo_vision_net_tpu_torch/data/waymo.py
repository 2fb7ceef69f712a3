"""Waymo Open Dataset → KITTI-format converter.

Copy of the JAX package's data/waymo.py; numpy, importing nothing of that
package.

Parity: tools/data_converter/waymo_converter.py:23-519 (Waymo2KITTI) —
per-frame extraction of images / calib / lidar / pose / labels into the
KITTI directory layout (`image_0..4/`, `velodyne/`, `calib/`, `pose/`,
`label_0..4/`, `label_all/`), with the Waymo→KITTI coordinate conversion
(front-left-up vehicle frame → right-down-front camera frame, volumetric
box center → bottom center, z-yaw → −y-yaw − π/2).

The reference entangles proto parsing (tensorflow + waymo_open_dataset)
with the conversion math. Here the math lives in ``convert_frame``, which
takes a plain dict of numpy arrays — unit-testable in-env — while the
import-gated ``WaymoToKitti`` runner handles tfrecord reading when the
devkit is available.

Frame-dict schema consumed by ``convert_frame``:

    {
      'timestamp_micros': int,
      'pose': (4, 4) vehicle→global,
      'images': {cam_idx(0-4): png_bytes},
      'camera_calibs': {cam_idx: {'extrinsic': (4,4) cam→vehicle,
                                  'intrinsic': (f_u, f_v, c_u, c_v, ...)}},
      'points': (N, 6) x,y,z,intensity,elongation,timestamp (vehicle frame),
      'laser_labels': [{'id', 'type': int, 'center': (3,), 'size': (l,w,h),
                        'heading': float, 'num_lidar_points_in_box': int,
                        'camera_name': int|None, 'bbox': (4,)|None,
                        'detection_difficulty_level': int,
                        'tracking_difficulty_level': int}],
    }
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["convert_frame", "WaymoToKitti", "T_FRONT_CAM_TO_REF"]

TYPE_LIST = ("UNKNOWN", "VEHICLE", "PEDESTRIAN", "SIGN", "CYCLIST")
CLASS_MAP = {
    "UNKNOWN": "DontCare",
    "PEDESTRIAN": "Pedestrian",
    "VEHICLE": "Car",
    "CYCLIST": "Cyclist",
    "SIGN": "Sign",
}
SELECTED_CLASSES = ("VEHICLE", "PEDESTRIAN", "CYCLIST")

# waymo front camera (x forward) → kitti reference camera (z forward)
T_FRONT_CAM_TO_REF = np.array([
    [0.0, -1.0, 0.0],
    [0.0, 0.0, -1.0],
    [1.0, 0.0, 0.0],
])


def _homo(r3: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = r3
    return m


def _frame_stem(prefix: int, file_idx: int, frame_idx: int) -> str:
    return f"{prefix}{file_idx:03d}{frame_idx:03d}"


def _kitti_label_line(name: str, bbox, loc, dims_lhw, ry,
                      truncated: float = 0.0, occluded: int = 0,
                      track_id: Optional[str] = None) -> str:
    l, h, w = dims_lhw
    alpha = -10.0  # reference writes -10 (unknown observation angle)
    fields = [
        name, f"{truncated:.2f}", str(occluded), f"{alpha:.2f}",
        *(f"{v:.2f}" for v in bbox),
        f"{h:.2f}", f"{w:.2f}", f"{l:.2f}",
        *(f"{v:.2f}" for v in loc), f"{ry:.2f}",
    ]
    if track_id is not None:
        fields.append(track_id)
    return " ".join(fields)


def convert_frame(
    frame: Dict,
    save_dir: str,
    prefix: int,
    file_idx: int,
    frame_idx: int,
    test_mode: bool = False,
    filter_empty_3dboxes: bool = True,
    save_track_id: bool = False,
) -> Dict[str, str]:
    """Write one frame's KITTI-format artifacts; returns {kind: path}.

    Mirrors Waymo2KITTI.save_{image,calib,lidar,pose,label}
    (waymo_converter.py:132-370) with the proto already flattened to numpy.
    """
    stem = _frame_stem(prefix, file_idx, frame_idx)
    out: Dict[str, str] = {}

    # images -------------------------------------------------------- png
    for cam_idx, png in frame.get("images", {}).items():
        d = os.path.join(save_dir, f"image_{cam_idx}")
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, stem + ".png")
        with open(p, "wb") as f:
            f.write(png)
        out[f"image_{cam_idx}"] = p

    # calib ---------------------------------------------------------- txt
    calibs = frame["camera_calibs"]
    t_ref = _homo(T_FRONT_CAM_TO_REF)
    velo2cam: Dict[int, np.ndarray] = {}
    lines: List[str] = []
    for cam_idx in sorted(calibs):
        cal = calibs[cam_idx]
        t_vehicle_to_cam = np.linalg.inv(np.asarray(cal["extrinsic"]))
        velo2cam[cam_idx] = t_ref @ t_vehicle_to_cam
        intr = np.asarray(cal["intrinsic"], np.float64)
        P = np.zeros((3, 4))
        P[0, 0], P[1, 1] = intr[0], intr[1]
        P[0, 2], P[1, 2] = intr[2], intr[3]
        P[2, 2] = 1.0
        lines.append(
            f"P{cam_idx}: " + " ".join(f"{v:e}" for v in P.reshape(12)))
    lines.append(
        "R0_rect: " + " ".join(f"{v:e}" for v in np.eye(3).reshape(9)))
    for cam_idx in sorted(velo2cam):
        lines.append(
            f"Tr_velo_to_cam_{cam_idx}: "
            + " ".join(f"{v:e}" for v in velo2cam[cam_idx][:3].reshape(12)))
    d = os.path.join(save_dir, "calib")
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, stem + ".txt")
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    out["calib"] = p

    # lidar ---------------------------------------------------------- bin
    pts = np.asarray(frame["points"], np.float32)
    d = os.path.join(save_dir, "velodyne")
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, stem + ".bin")
    pts.tofile(p)
    out["velodyne"] = p

    # pose ----------------------------------------------------------- txt
    d = os.path.join(save_dir, "pose")
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, stem + ".txt")
    np.savetxt(p, np.asarray(frame["pose"]).reshape(4, 4))
    out["pose"] = p

    # labels --------------------------------------------------------- txt
    if not test_mode:
        t_velo_front = velo2cam.get(0)
        per_cam: Dict[int, List[str]] = {i: [] for i in velo2cam}
        all_lines: List[str] = []
        for obj in frame.get("laser_labels", ()):
            wtype = TYPE_LIST[int(obj["type"])]
            if wtype not in SELECTED_CLASSES:
                continue
            if filter_empty_3dboxes and obj.get(
                    "num_lidar_points_in_box", 1) < 1:
                continue
            name = CLASS_MAP[wtype]
            l, w, h = np.asarray(obj["size"], np.float64)
            cx, cy, cz = np.asarray(obj["center"], np.float64)
            # volumetric center -> bottom center, vehicle frame -> ref cam
            pt = t_velo_front @ np.array([cx, cy, cz - h / 2, 1.0])
            loc = pt[:3]
            # +x-around-z (waymo) -> +x-around-y (kitti camera)
            ry = -float(obj["heading"]) - np.pi / 2
            ry = (ry + np.pi) % (2 * np.pi) - np.pi
            bbox = obj.get("bbox")
            cam_name = obj.get("camera_name")
            if bbox is None:
                bbox, cam_name = (0.0, 0.0, 0.0, 0.0), None
            track = str(obj["id"]) if save_track_id else None
            line = _kitti_label_line(name, bbox, loc, (l, h, w), ry,
                                     track_id=track)
            if cam_name is not None and int(cam_name) in per_cam:
                per_cam[int(cam_name)].append(line)
            all_lines.append(line)
        for cam_idx, cam_lines in per_cam.items():
            d = os.path.join(save_dir, f"label_{cam_idx}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, stem + ".txt"), "w") as f:
                f.write("\n".join(cam_lines) + ("\n" if cam_lines else ""))
        d = os.path.join(save_dir, "label_all")
        os.makedirs(d, exist_ok=True)
        p = os.path.join(d, stem + ".txt")
        with open(p, "w") as f:
            f.write("\n".join(all_lines) + ("\n" if all_lines else ""))
        out["label_all"] = p
    return out


class WaymoToKitti:
    """tfrecord runner (import-gated on tensorflow + waymo_open_dataset).

    Reads ``<load_dir>/*.tfrecord``, keeps every 5th frame (the reference's
    subsampling, waymo_converter.py:108), flattens each Frame proto to the
    numpy frame-dict and hands it to ``convert_frame``.
    """

    def __init__(self, load_dir: str, save_dir: str, prefix: int,
                 workers: int = 8, test_mode: bool = False):
        self.load_dir = load_dir
        self.save_dir = save_dir
        self.prefix = prefix
        self.workers = workers
        self.test_mode = test_mode
        import glob

        self.tfrecords = sorted(
            glob.glob(os.path.join(load_dir, "*.tfrecord")))

    def __len__(self) -> int:
        return len(self.tfrecords)

    @staticmethod
    def _flatten_frame(frame) -> Dict:  # pragma: no cover - devkit-gated
        from waymo_open_dataset.utils.frame_utils import (
            convert_range_image_to_point_cloud,
            parse_range_image_and_camera_projection)

        ri, cp, _, top_pose = parse_range_image_and_camera_projection(frame)
        pts_ret = []
        for ri_index in (0, 1):
            points, _ = convert_range_image_to_point_cloud(
                frame, ri, cp, top_pose, ri_index=ri_index,
                keep_polar_features=True)
            # keep_polar_features rows: (range, intensity, elongation, x,y,z)
            p = np.concatenate(points, axis=0)
            pts_ret.append(np.column_stack([
                p[:, 3:6], p[:, 1], p[:, 2],
                np.full(len(p), frame.timestamp_micros, np.float64)]))
        pts = np.concatenate(pts_ret, 0)

        id_to_bbox, id_to_cam = {}, {}
        for labels in frame.projected_lidar_labels:
            for lab in labels.labels:
                id_to_bbox[lab.id] = (
                    lab.box.center_x - lab.box.length / 2,
                    lab.box.center_y - lab.box.width / 2,
                    lab.box.center_x + lab.box.length / 2,
                    lab.box.center_y + lab.box.width / 2)
                id_to_cam[lab.id] = labels.name - 1
        lidar_suffixes = ("_FRONT", "_FRONT_RIGHT", "_FRONT_LEFT",
                          "_SIDE_RIGHT", "_SIDE_LEFT")
        laser_labels = []
        for obj in frame.laser_labels:
            bbox = cam = None
            for sfx in lidar_suffixes:
                if obj.id + sfx in id_to_bbox:
                    bbox = id_to_bbox[obj.id + sfx]
                    cam = id_to_cam[obj.id + sfx]
                    break
            laser_labels.append({
                "id": obj.id, "type": obj.type,
                "center": (obj.box.center_x, obj.box.center_y,
                           obj.box.center_z),
                "size": (obj.box.length, obj.box.width, obj.box.height),
                "heading": obj.box.heading,
                "num_lidar_points_in_box": obj.num_lidar_points_in_box,
                "camera_name": cam, "bbox": bbox,
            })
        return {
            "timestamp_micros": frame.timestamp_micros,
            "pose": np.array(frame.pose.transform).reshape(4, 4),
            "images": {img.name - 1: img.image for img in frame.images},
            "camera_calibs": {
                c.name - 1: {
                    "extrinsic": np.array(
                        c.extrinsic.transform).reshape(4, 4),
                    "intrinsic": np.array(c.intrinsic),
                } for c in frame.context.camera_calibrations},
            "points": pts,
            "laser_labels": laser_labels,
        }

    def convert_one(self, file_idx: int) -> int:  # pragma: no cover
        try:
            import tensorflow as tf
            from waymo_open_dataset import dataset_pb2
        except ImportError as e:
            raise SystemExit(
                "waymo conversion needs tensorflow + waymo_open_dataset "
                "(not available in this environment)") from e

        n = 0
        ds = tf.data.TFRecordDataset(
            self.tfrecords[file_idx], compression_type="")
        for frame_idx, data in enumerate(ds):
            if frame_idx % 5 != 0:
                continue
            frame = dataset_pb2.Frame()
            frame.ParseFromString(bytearray(data.numpy()))
            convert_frame(self._flatten_frame(frame), self.save_dir,
                          self.prefix, file_idx, frame_idx,
                          test_mode=self.test_mode)
            n += 1
        return n

    def convert(self) -> int:  # pragma: no cover - devkit-gated
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.workers) as ex:
            return sum(ex.map(self.convert_one, range(len(self))))
