"""KITTI-format predictions → Waymo evaluation format.

Copy of the JAX package's evaluation/kitti2waymo.py; numpy, importing nothing of that
package.

Parity: core/evaluation/kitti2waymo.py (KITTI2Waymo) — per instance:
bottom-center → true-center (y -= h/2 in the y-down camera frame), KITTI
reference-camera → Waymo vehicle frame via
``T_k2w = T_front_cam_to_vehicle @ T_ref_to_front_cam`` (:71-74, :185),
heading = −(rotation_y + π/2) wrapped to (−π, π] (:132-136), class map
Car/Pedestrian/Sign/Cyclist → Waymo types 1/2/3/4 (:64-69).

Split: the conversion math is pure numpy here (testable without
any Waymo dependency); serialization to ``metrics_pb2.Objects`` .bin files
needs the waymo-open-dataset wheel and is import-gated in
``write_waymo_bin`` — exactly like the reference's module-level gate, but
without taking tensorflow down with it.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# waymo_open_dataset label_pb2.Label enum values
K2W_CLASS_MAP = {"Car": 1, "Pedestrian": 2, "Sign": 3, "Cyclist": 4}

# KITTI reference cam (x right, y down, z fwd) -> Waymo front cam
# (x fwd, y left, z up), reference :71-74
T_REF_TO_FRONT_CAM = np.array([
    [0.0, 0.0, 1.0, 0.0],
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def wrap_heading(h: float) -> float:
    """Wrap to (-π, π] with the reference's while-loop semantics."""
    while h < -np.pi:
        h += 2 * np.pi
    while h > np.pi:
        h -= 2 * np.pi
    return h


def kitti_instance_to_waymo(
    location: np.ndarray,      # (3,) bottom center, KITTI cam frame
    dimensions: np.ndarray,    # (3,) (l, h, w) — KITTI result convention
    rotation_y: float,
    score: float,
    name: str,
    T_front_cam_to_vehicle: np.ndarray,  # (4, 4)
) -> Dict:
    """One KITTI box → Waymo object dict (:105-155)."""
    length, height, width = (float(v) for v in dimensions)
    x, y, z = (float(v) for v in location)
    y -= height / 2.0  # bottom center -> true center (y points down)
    T_k2w = np.asarray(T_front_cam_to_vehicle) @ T_REF_TO_FRONT_CAM
    pt = T_k2w @ np.array([x, y, z, 1.0])
    heading = wrap_heading(-(float(rotation_y) + np.pi / 2.0))
    return dict(
        center_x=round(float(pt[0]), 4),
        center_y=round(float(pt[1]), 4),
        center_z=round(float(pt[2]), 4),
        length=round(length, 4),
        width=round(width, 4),
        height=round(height, 4),
        heading=round(heading, 4),
        type=K2W_CLASS_MAP.get(str(name), 0),
        score=round(float(score), 4),
    )


def convert_frame(
    kitti_result: Dict,               # name/dimensions/location/rotation_y/score
    T_front_cam_to_vehicle: np.ndarray,
    context_name: str = "",
    frame_timestamp_micros: int = 0,
) -> List[Dict]:
    """All instances of one frame (reference parse_objects :89-163)."""
    out = []
    names = np.asarray(kitti_result["name"])
    for i in range(len(names)):
        obj = kitti_instance_to_waymo(
            np.asarray(kitti_result["location"])[i],
            np.asarray(kitti_result["dimensions"])[i],
            float(np.asarray(kitti_result["rotation_y"])[i]),
            float(np.asarray(kitti_result["score"])[i]),
            str(names[i]),
            T_front_cam_to_vehicle,
        )
        obj["context_name"] = context_name
        obj["frame_timestamp_micros"] = int(frame_timestamp_micros)
        out.append(obj)
    return out


def frames_from_tfrecords(tfrecords_dir: str, prefix: str):
    """Iterate Waymo tfrecords into plain frame-metadata dicts
    (reference convert_one :170-186). Import-gated on tensorflow +
    waymo-open-dataset; everything downstream is dependency-free."""
    from glob import glob
    from os.path import join

    try:
        import tensorflow as tf
        from waymo_open_dataset import dataset_pb2 as open_dataset
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "tensorflow + waymo-open-dataset are required to read "
            "tfrecords; use frames_from_metadata for the gated path") from e

    paths = sorted(glob(join(tfrecords_dir, "*.tfrecord")))
    for file_idx, path in enumerate(paths):
        for frame_num, frame_data in enumerate(
                tf.data.TFRecordDataset(path, compression_type="")):
            frame = open_dataset.Frame()
            frame.ParseFromString(bytearray(frame_data.numpy()))
            T = None
            for camera in frame.context.camera_calibrations:
                if camera.name == 1:  # FRONT
                    T = np.array(camera.extrinsic.transform).reshape(4, 4)
            yield dict(
                filename=f"{prefix}{file_idx:03d}{frame_num:03d}",
                context_name=frame.context.name,
                frame_timestamp_micros=frame.timestamp_micros,
                T_front_cam_to_vehicle=T,
            )


class KittiToWaymoConverter:
    """End-to-end conversion (reference KITTI2Waymo :40-250): pairs KITTI
    result dicts with Waymo frames by the ``prefix+file+frame`` filename
    key, converts every paired frame's instances, and combines them into
    one objects list — with the reference's behaviors: frames with no
    matching prediction produce an EMPTY entry (a miss is not an error,
    :188-190), and per-frame outputs are written then combined (:203-215).

    ``frames`` is any iterable of frame-metadata dicts (filename,
    context_name, frame_timestamp_micros, T_front_cam_to_vehicle) — from
    ``frames_from_tfrecords`` on a real Waymo tree, or plain dicts/npz in
    tests. Parallel conversion uses a thread pool (numpy releases the
    GIL; the reference used 64 mmcv worker processes)."""

    def __init__(self, kitti_result_files: Sequence[Dict], workers: int = 8):
        self.kitti_result_files = list(kitti_result_files)
        self.workers = int(workers)
        # reference :55-57 — first sample_idx of each result file keys it
        self.name2idx: Dict[str, int] = {}
        for idx, result in enumerate(self.kitti_result_files):
            if len(result.get("sample_idx", [])) > 0:
                self.name2idx[str(result["sample_idx"][0])] = idx

    def convert_frame_meta(self, meta: Dict) -> List[Dict]:
        key = str(meta["filename"])
        idx = self.name2idx.get(key)
        if idx is None:
            return []  # reference prints '<name> not found' and emits empty
        return convert_frame(
            self.kitti_result_files[idx],
            np.asarray(meta["T_front_cam_to_vehicle"]),
            context_name=str(meta.get("context_name", "")),
            frame_timestamp_micros=int(
                meta.get("frame_timestamp_micros", 0)),
        )

    def convert(self, frames: Sequence[Dict],
                save_dir: str | None = None) -> List[Dict]:
        """Convert all frames (parallel) -> combined objects list, in
        frame order. With ``save_dir``, also writes one json per frame
        plus the combined file (the reference's per-file .bin layout,
        minus the proto dependency)."""
        import json
        import os
        from concurrent.futures import ThreadPoolExecutor

        frames = list(frames)
        with ThreadPoolExecutor(max_workers=max(self.workers, 1)) as ex:
            per_frame = list(ex.map(self.convert_frame_meta, frames))
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            for meta, objs in zip(frames, per_frame):
                with open(os.path.join(
                        save_dir, f"{meta['filename']}.json"), "w") as f:
                    json.dump(objs, f)
        combined = [o for objs in per_frame for o in objs]
        if save_dir is not None:
            with open(os.path.join(save_dir, "combined.json"), "w") as f:
                json.dump(combined, f)
        return combined

    def convert_to_bin(self, frames: Sequence[Dict], final_path: str,
                       save_dir: str | None = None) -> None:
        """Full reference pipeline ending in a metrics_pb2 ``.bin``
        (import-gated on the waymo wheel)."""
        write_waymo_bin(self.convert(frames, save_dir=save_dir), final_path)


def write_waymo_bin(objects: Sequence[Dict], path: str) -> None:
    """Serialize converted objects to a Waymo metrics_pb2 .bin file.

    Import-gated: needs the waymo-open-dataset wheel (not in the baked
    image); everything upstream of this call is dependency-free."""
    try:
        from waymo_open_dataset import label_pb2
        from waymo_open_dataset.protos import metrics_pb2
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "waymo-open-dataset is required to write .bin files; the "
            "dict-level conversion (convert_frame) works without it") from e

    combined = metrics_pb2.Objects()
    for od in objects:
        o = metrics_pb2.Object()
        box = label_pb2.Label.Box()
        box.center_x = od["center_x"]
        box.center_y = od["center_y"]
        box.center_z = od["center_z"]
        box.length = od["length"]
        box.width = od["width"]
        box.height = od["height"]
        box.heading = od["heading"]
        o.object.box.CopyFrom(box)
        o.object.type = od["type"]
        o.score = od["score"]
        o.context_name = od.get("context_name", "")
        o.frame_timestamp_micros = od.get("frame_timestamp_micros", 0)
        combined.objects.append(o)
    with open(path, "wb") as f:
        f.write(combined.SerializeToString())
