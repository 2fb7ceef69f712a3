"""Result formatting: model outputs → evaluator/JSON records.

A copy of the JAX package's evaluation/formatting.py (numpy only), with
``quat_to_rot`` copied from its data/infos.py; a test holds both equal to
the originals.

Parity: the reference's `format_results`/`_format_bbox` path (upstream
BEVFormer convention wrapped by datasets/nuscenes_dataset.py:283-340):
boxes to global frame via ego pose, velocity-based default attributes, and
the MapTR `nuscmap_results.json` layout
(nuscenes_det_occ_map_dataset.py:733-807).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def quat_to_rot(q: Sequence[float]) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix."""
    w, x, y, z = [float(v) for v in q]
    n = np.sqrt(w * w + x * x + y * y + z * z)
    if n < 1e-12:
        return np.eye(3)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


DETECTION_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)

DEFAULT_ATTR = {
    "car": "vehicle.parked", "pedestrian": "pedestrian.standing",
    "trailer": "vehicle.parked", "truck": "vehicle.parked",
    "bus": "vehicle.stopped", "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked", "bicycle": "cycle.without_rider",
    "barrier": "", "traffic_cone": "",
}


def default_attribute(name: str, velocity_xy: np.ndarray) -> str:
    """Velocity-thresholded default attribute (upstream _format_bbox)."""
    if np.linalg.norm(velocity_xy) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        if name == "pedestrian":
            return "pedestrian.moving"
    return DEFAULT_ATTR.get(name, "")


def detections_to_sample_record(
    boxes: np.ndarray,    # (N, 9) lidar frame (cx,cy,cz,w,l,h,yaw,vx,vy)
    scores: np.ndarray,
    labels: np.ndarray,
    valid: np.ndarray,
    lidar2global: Optional[np.ndarray] = None,  # 4x4; None keeps lidar frame
    class_names: Sequence[str] = DETECTION_CLASSES,
) -> Dict[str, np.ndarray]:
    """One sample's detections in the evaluator's record format."""
    keep = np.asarray(valid, bool)
    b = np.asarray(boxes)[keep]
    s = np.asarray(scores)[keep]
    l = np.asarray(labels)[keep]
    centers = b[:, :3]
    yaw = b[:, 6]
    vel = b[:, 7:9] if b.shape[1] > 7 else np.zeros((len(b), 2))
    if lidar2global is not None:
        r = lidar2global[:3, :3]
        centers = centers @ r.T + lidar2global[:3, 3]
        yaw = yaw + np.arctan2(r[1, 0], r[0, 0])
        vel = vel @ r[:2, :2].T
    names = np.array([class_names[i] for i in l])
    return dict(
        names=names,
        translation=centers,
        size=b[:, 3:6],
        yaw=yaw,
        velocity=vel,
        scores=s,
        attrs=np.array([default_attribute(n, v)
                        for n, v in zip(names, vel)]),
        ego_translation=(
            lidar2global[:3, 3] if lidar2global is not None else np.zeros(3)),
    )


def gt_to_sample_record(
    gt_boxes: np.ndarray, gt_labels: np.ndarray, gt_mask: np.ndarray,
    lidar2global: Optional[np.ndarray] = None,
    class_names: Sequence[str] = DETECTION_CLASSES,
    gt_attrs: Optional[Sequence[str]] = None,
) -> Dict[str, np.ndarray]:
    rec = detections_to_sample_record(
        gt_boxes, np.ones(len(gt_boxes)), gt_labels, gt_mask, lidar2global,
        class_names)
    rec.pop("scores")
    if gt_attrs is not None:
        rec["attrs"] = np.asarray(gt_attrs)[np.asarray(gt_mask, bool)]
    return rec


def map_results_record(vectors, scores, labels,
                       score_threshold: float = 0.0) -> dict:
    """MapTR nuscmap_results entry: vectors in meters + scores + labels
    (det_map head get_map_results :970-1005)."""
    return dict(
        vectors=np.asarray(vectors),
        scores=np.asarray(scores),
        labels=np.asarray(labels),
        valid=np.asarray(scores) > score_threshold,
    )


def dump_results_json(results: Dict[str, list], path: str,
                      sample_tokens: Optional[Sequence[str]] = None) -> None:
    """Write det+map results in the MapTR ``nuscmap_results.json`` layout
    (reference format_map_results, nuscenes_det_occ_map_dataset.py:733-765:
    ``{"meta": ..., "results": {token: [{"pts", "cls_name"->type int,
    "confidence_level"}]}}``), sample order = dataset order. Round-trips via
    ``load_results_json`` for offline re-evaluation
    (tools/eval_map_offline.py, reference §6.2)."""
    import json

    n = max(len(results.get("map", [])), len(results.get("det", [])))
    tokens = list(sample_tokens) if sample_tokens else [
        f"sample_{i:06d}" for i in range(n)]
    out = {"meta": {"use_camera": True, "use_lidar": False},
           "results": {}, "det_results": {}}
    for i, tok in enumerate(tokens):
        if i < len(results.get("map", [])):
            r = results["map"][i]
            out["results"][tok] = [
                dict(pts=np.asarray(v, np.float64).tolist(),
                     pts_num=int(len(v)),
                     type=int(l),
                     confidence_level=float(s))
                for v, s, l, ok in zip(r["vectors"], r["scores"],
                                       r["labels"], r["valid"]) if ok
            ]
        if i < len(results.get("det", [])):
            d = results["det"][i]
            out["det_results"][tok] = [
                dict(translation=np.asarray(t, np.float64).tolist(),
                     size=np.asarray(sz, np.float64).tolist(),
                     yaw=float(y), velocity=np.asarray(v, np.float64).tolist(),
                     detection_name=str(nm), detection_score=float(sc),
                     attribute_name=str(at))
                for t, sz, y, v, nm, sc, at in zip(
                    d["translation"], d["size"], d["yaw"], d["velocity"],
                    d["names"], d["scores"], d["attrs"])
            ]
    with open(path, "w") as f:
        json.dump(out, f)


def load_results_json(path: str) -> Dict[str, list]:
    """Inverse of dump_results_json → evaluator-ready record lists."""
    import json

    with open(path) as f:
        data = json.load(f)
    map_records = []
    for tok in data.get("results", {}):
        entries = data["results"][tok]
        map_records.append(dict(
            vectors=[np.asarray(e["pts"], np.float32) for e in entries],
            scores=np.asarray([e["confidence_level"] for e in entries],
                              np.float32),
            labels=np.asarray([e["type"] for e in entries], np.int32),
            valid=np.ones(len(entries), bool),
        ))
    det_records = []
    for tok in data.get("det_results", {}):
        entries = data["det_results"][tok]
        det_records.append(dict(
            names=np.asarray([e["detection_name"] for e in entries]),
            translation=np.asarray(
                [e["translation"] for e in entries], np.float64).reshape(-1, 3),
            size=np.asarray([e["size"] for e in entries],
                            np.float64).reshape(-1, 3),
            yaw=np.asarray([e["yaw"] for e in entries], np.float64),
            velocity=np.asarray([e["velocity"] for e in entries],
                                np.float64).reshape(-1, 2),
            scores=np.asarray([e["detection_score"] for e in entries],
                              np.float64),
            attrs=np.asarray([e["attribute_name"] for e in entries]),
            ego_translation=np.zeros(3),
        ))
    return {"det": det_records, "map": map_records, "occ": []}


def dump_map_gt_json(gt_map: Sequence[dict], path: str,
                     sample_tokens: Optional[Sequence[str]] = None) -> None:
    """GT-side analog (reference _format_map_gt auto-generating
    ``nuscenes_map_anns_val.json``, :808-863)."""
    import json

    tokens = list(sample_tokens) if sample_tokens else [
        f"sample_{i:06d}" for i in range(len(gt_map))]
    out = {"GTs": [
        dict(sample_token=tok,
             vectors=[dict(pts=np.asarray(v, np.float64).tolist(),
                           pts_num=int(len(v)), type=int(l))
                      for v, l in zip(g["vectors"], g["labels"])])
        for tok, g in zip(tokens, gt_map)
    ]}
    with open(path, "w") as f:
        json.dump(out, f)


def load_map_gt_json(path: str) -> List[dict]:
    import json

    with open(path) as f:
        data = json.load(f)
    return [
        dict(vectors=[np.asarray(v["pts"], np.float32)
                      for v in g["vectors"]],
             labels=np.asarray([v["type"] for v in g["vectors"]], np.int32))
        for g in data["GTs"]
    ]
