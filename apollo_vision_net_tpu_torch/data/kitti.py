"""KITTI 3D-detection offline converter — devkit-free numpy.

Copy of the JAX package's data/kitti.py; numpy, importing nothing of that
package.

Parity: tools/data_converter/kitti_converter.py (create_kitti_info_file:87,
_calculate_num_points_in_gt:46, create_reduced_point_cloud:291,
export_2d_annotation:334) + kitti_data_utils.py (get_label_anno:92,
get_kitti_image_info:141, add_difficulty_to_annos:467). The reference goes
through mmcv/skimage/mmdet3d box ops; everything here is plain file parsing
and vectorized numpy geometry, so the converter runs (and is tested) with no
third-party dataset toolkit.

Info schema (KITTI annotation format version 2, the same dict layout the
reference documents at kitti_data_utils.py:142-175):

    {
      'image':       {'image_idx', 'image_path', 'image_shape'},
      'point_cloud': {'num_features': 4, 'velodyne_path'},
      'calib':       {'P0'..'P3' (4,4), 'R0_rect' (4,4),
                      'Tr_velo_to_cam' (4,4), 'Tr_imu_to_velo' (4,4)},
      'annos':       {'name', 'truncated', 'occluded', 'alpha', 'bbox',
                      'dimensions' (lhw), 'location', 'rotation_y', 'score',
                      'index', 'group_ids', 'difficulty',
                      'num_points_in_gt'},
    }
"""
from __future__ import annotations

import os
import pickle
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "parse_label_file", "parse_calib_file", "box_camera_to_lidar",
    "points_in_rbbox", "remove_outside_points", "add_difficulty_to_annos",
    "create_kitti_infos", "create_reduced_point_cloud",
    "export_2d_annotation",
]

# evaluation-protocol constants (kitti_data_utils.py:468-476)
_MIN_HEIGHT = (40.0, 25.0, 25.0)
_MAX_OCCLUSION = (0, 1, 2)
_MAX_TRUNCATION = (0.15, 0.3, 0.5)


# ---------------------------------------------------------------- parsing

def parse_label_file(path: str) -> Dict[str, np.ndarray]:
    """KITTI label_2 txt → annos dict (kitti_data_utils.py:92-133).

    `dimensions` are converted from the file's h,w,l order to l,h,w (the
    "standard lhw(camera)" layout the reference uses); DontCare rows sort
    last in `index` with -1.
    """
    with open(path) as f:
        content = [ln.strip().split(" ") for ln in f if ln.strip()]
    num_objects = sum(1 for x in content if x[0] != "DontCare")
    num_gt = len(content)
    annos = {
        "name": np.array([x[0] for x in content]),
        "truncated": np.array([float(x[1]) for x in content]),
        "occluded": np.array([int(float(x[2])) for x in content]),
        "alpha": np.array([float(x[3]) for x in content]),
        "bbox": np.array(
            [[float(v) for v in x[4:8]] for x in content]).reshape(-1, 4),
        "dimensions": np.array(
            [[float(v) for v in x[8:11]] for x in content]
        ).reshape(-1, 3)[:, [2, 0, 1]],  # hwl -> lhw
        "location": np.array(
            [[float(v) for v in x[11:14]] for x in content]).reshape(-1, 3),
        "rotation_y": np.array(
            [float(x[14]) for x in content]).reshape(-1),
    }
    if content and len(content[0]) == 16:
        annos["score"] = np.array([float(x[15]) for x in content])
    else:
        annos["score"] = np.zeros((num_gt,))
    annos["index"] = np.array(
        list(range(num_objects)) + [-1] * (num_gt - num_objects), np.int32)
    annos["group_ids"] = np.arange(num_gt, dtype=np.int32)
    return annos


def parse_calib_file(path: str, extend: bool = True) -> Dict[str, np.ndarray]:
    """calib txt → {'P0'..'P3', 'R0_rect', 'Tr_velo_to_cam',
    'Tr_imu_to_velo'} 4×4 matrices (kitti_data_utils.py:208-250)."""
    vals = {}
    with open(path) as f:
        for ln in f:
            if ":" in ln:
                k, v = ln.split(":", 1)
            elif ln.strip():
                k, v = ln.split(" ", 1)
            else:
                continue
            vals[k.strip()] = np.array(
                [float(x) for x in v.split()], np.float64)

    def ext34(a):
        m = a.reshape(3, 4)
        return np.vstack([m, [0.0, 0.0, 0.0, 1.0]]) if extend else m

    calib = {k: ext34(vals[k]) for k in ("P0", "P1", "P2", "P3") if k in vals}
    r0 = vals.get("R0_rect", vals.get("R_rect", np.eye(3).ravel()))
    if extend:
        rect = np.eye(4)
        rect[:3, :3] = r0.reshape(3, 3)
    else:
        rect = r0.reshape(3, 3)
    calib["R0_rect"] = rect
    # Any extrinsic chain: KITTI's Tr_velo_to_cam / Tr_imu_to_velo plus the
    # waymo-export per-camera Tr_velo_to_cam_{0..4} keys.
    for k in vals:
        if k.startswith("Tr_"):
            calib[k] = ext34(vals[k])
    return calib


def _read_png_shape(path: str) -> Optional[np.ndarray]:
    """(h, w) from a PNG header without an image library — replaces the
    reference's skimage.io.imread(...).shape (kitti_data_utils.py:196)."""
    try:
        with open(path, "rb") as f:
            head = f.read(26)
        if head[:8] != b"\x89PNG\r\n\x1a\n":
            return None
        w, h = struct.unpack(">II", head[16:24])
        return np.array([h, w], np.int32)
    except OSError:
        return None


# ----------------------------------------------------------- box geometry

def box_camera_to_lidar(boxes: np.ndarray, rect: np.ndarray,
                        velo2cam: np.ndarray) -> np.ndarray:
    """(N,7) camera boxes [x,y,z,l,h,w,ry] (bottom-center location) →
    lidar boxes [x,y,z,l,w,h,yaw] with yaw = -ry - π/2 (the mmdet3d
    convention the reference converter relies on,
    kitti_converter.py:77-78)."""
    boxes = np.asarray(boxes, np.float64).reshape(-1, 7)
    xyz = boxes[:, :3]
    l, h, w = boxes[:, 3], boxes[:, 4], boxes[:, 5]
    ry = boxes[:, 6]
    cam2velo = np.linalg.inv(rect @ velo2cam)
    xyz1 = np.concatenate([xyz, np.ones((len(xyz), 1))], 1)
    xyz_l = (xyz1 @ cam2velo.T)[:, :3]
    yaw = -ry - np.pi / 2
    return np.stack(
        [xyz_l[:, 0], xyz_l[:, 1], xyz_l[:, 2], l, w, h, yaw], 1)


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """(P,3+), (N,7) lidar boxes [x,y,z,l,w,h,yaw] bottom-centered →
    (P, N) bool membership (reference box_np_ops.points_in_rbbox)."""
    pts = np.asarray(points)[:, :3]
    boxes = np.asarray(boxes).reshape(-1, 7)
    if len(boxes) == 0:
        return np.zeros((len(pts), 0), bool)
    d = pts[:, None, :] - boxes[None, :, :3]          # (P, N, 3)
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    # rotate into box frame (inverse of the box yaw)
    lx = d[..., 0] * c[None] + d[..., 1] * s[None]
    ly = -d[..., 0] * s[None] + d[..., 1] * c[None]
    lz = d[..., 2]
    return (
        (np.abs(lx) <= boxes[None, :, 3] / 2)
        & (np.abs(ly) <= boxes[None, :, 4] / 2)
        & (lz >= 0) & (lz <= boxes[None, :, 5])
    )


def remove_outside_points(points: np.ndarray, rect: np.ndarray,
                          velo2cam: np.ndarray, P2: np.ndarray,
                          image_shape: Sequence[int]) -> np.ndarray:
    """Keep points that project inside the image with positive depth —
    same predicate as the reference's camera-frustum surface test
    (kitti_converter.py:65-66, box_np_ops.remove_outside_points)."""
    pts = np.asarray(points)
    xyz1 = np.concatenate(
        [pts[:, :3], np.ones((len(pts), 1), pts.dtype)], 1)
    cam = xyz1 @ (rect @ velo2cam).T
    img = cam @ P2.T
    z = img[:, 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = img[:, 0] / z
        v = img[:, 1] / z
    h, w = int(image_shape[0]), int(image_shape[1])
    keep = (z > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return pts[keep]


def add_difficulty_to_annos(info: Dict) -> np.ndarray:
    """Easy/moderate/hard/-1 per the KITTI eval protocol
    (kitti_data_utils.py:467-510): thresholds on 2D-box height, occlusion
    and truncation; moderate/hard are the xor shells of the masks."""
    annos = info["annos"]
    height = annos["bbox"][:, 3] - annos["bbox"][:, 1]
    occ = annos["occluded"]
    trunc = annos["truncated"]
    masks = [
        (occ <= _MAX_OCCLUSION[i]) & (height > _MIN_HEIGHT[i])
        & (trunc <= _MAX_TRUNCATION[i])
        for i in range(3)
    ]
    diff = np.full(len(height), -1, np.int32)
    is_easy = masks[0]
    is_moderate = np.logical_xor(masks[0], masks[1])
    is_hard = np.logical_xor(masks[2], masks[1])
    diff[is_hard] = 2
    diff[is_moderate] = 1
    diff[is_easy] = 0
    annos["difficulty"] = diff
    return diff


# ------------------------------------------------------------- converters

def _idx_str(idx: int) -> str:
    return f"{idx:06d}"


def _read_imageset(path: str) -> List[int]:
    with open(path) as f:
        return [int(ln) for ln in f if ln.strip()]


def _load_velodyne(path: str, num_features: int = 4) -> np.ndarray:
    return np.fromfile(path, np.float32).reshape(-1, num_features)


def get_kitti_image_info(
    data_path: str,
    training: bool = True,
    label_info: bool = True,
    velodyne: bool = True,
    calib: bool = True,
    image_ids: Sequence[int] = (),
    relative_path: bool = True,
    num_worker: int = 8,
) -> List[Dict]:
    """Per-frame info dicts (kitti_data_utils.py:141-263)."""
    split = "training" if training else "testing"

    def one(idx):
        s = _idx_str(idx)
        info = {
            "image": {
                "image_idx": idx,
                "image_path": os.path.join(split, "image_2", s + ".png"),
            },
            "point_cloud": {"num_features": 4},
        }
        if velodyne:
            info["point_cloud"]["velodyne_path"] = os.path.join(
                split, "velodyne", s + ".bin")
        shape = _read_png_shape(
            os.path.join(data_path, info["image"]["image_path"]))
        if shape is not None:
            info["image"]["image_shape"] = shape
        if calib:
            info["calib"] = parse_calib_file(
                os.path.join(data_path, split, "calib", s + ".txt"))
        if label_info:
            info["annos"] = parse_label_file(
                os.path.join(data_path, split, "label_2", s + ".txt"))
            add_difficulty_to_annos(info)
        if not relative_path:
            for key, sub in (("image", "image_path"),
                             ("point_cloud", "velodyne_path")):
                if sub in info[key]:
                    info[key][sub] = os.path.join(data_path, info[key][sub])
        return info

    with ThreadPoolExecutor(num_worker) as ex:
        return list(ex.map(one, image_ids))


def _calculate_num_points_in_gt(data_path: str, infos: List[Dict],
                                relative_path: bool,
                                remove_outside: bool = True) -> None:
    """annos['num_points_in_gt'] per box; DontCare rows get -1
    (kitti_converter.py:46-84)."""
    for info in infos:
        v_path = info["point_cloud"]["velodyne_path"]
        if relative_path:
            v_path = os.path.join(data_path, v_path)
        points = _load_velodyne(
            v_path, info["point_cloud"]["num_features"])
        calib = info["calib"]
        if remove_outside and "image_shape" in info["image"]:
            points = remove_outside_points(
                points, calib["R0_rect"], calib["Tr_velo_to_cam"],
                calib["P2"], info["image"]["image_shape"])
        annos = info["annos"]
        num_obj = int(np.sum(annos["name"] != "DontCare"))
        boxes_cam = np.concatenate(
            [annos["location"][:num_obj],
             annos["dimensions"][:num_obj],
             annos["rotation_y"][:num_obj, None]], 1)
        boxes_lidar = box_camera_to_lidar(
            boxes_cam, calib["R0_rect"], calib["Tr_velo_to_cam"])
        inside = points_in_rbbox(points[:, :3], boxes_lidar)
        n_in = inside.sum(0)
        n_ignored = len(annos["name"]) - num_obj
        annos["num_points_in_gt"] = np.concatenate(
            [n_in, -np.ones(n_ignored)]).astype(np.int32)


def create_kitti_infos(data_path: str, pkl_prefix: str = "kitti",
                       save_path: Optional[str] = None,
                       relative_path: bool = True) -> Dict[str, str]:
    """train/val/trainval/test info pkls from ImageSets splits
    (kitti_converter.py:87-148). Returns {split: pkl_path}."""
    save_path = save_path or data_path
    os.makedirs(save_path, exist_ok=True)
    imageset = os.path.join(data_path, "ImageSets")
    ids = {}
    for split in ("train", "val", "test"):
        p = os.path.join(imageset, split + ".txt")
        ids[split] = _read_imageset(p) if os.path.exists(p) else []

    out = {}
    per_split: Dict[str, List[Dict]] = {}
    for split in ("train", "val"):
        infos = get_kitti_image_info(
            data_path, training=True, image_ids=ids[split],
            relative_path=relative_path)
        _calculate_num_points_in_gt(data_path, infos, relative_path)
        per_split[split] = infos
    per_split["trainval"] = per_split["train"] + per_split["val"]
    per_split["test"] = get_kitti_image_info(
        data_path, training=False, label_info=False,
        image_ids=ids["test"], relative_path=relative_path)

    for split, infos in per_split.items():
        path = os.path.join(save_path, f"{pkl_prefix}_infos_{split}.pkl")
        with open(path, "wb") as f:
            pickle.dump(infos, f)
        out[split] = path
        print(f"kitti info {split}: {len(infos)} frames -> {path}")
    return out


def create_reduced_point_cloud(data_path: str, pkl_prefix: str = "kitti",
                               save_path: Optional[str] = None) -> None:
    """Write `velodyne_reduced/` bins with only front-camera-visible points
    (kitti_converter.py:232-331)."""
    for split in ("train", "val", "test"):
        info_path = os.path.join(data_path, f"{pkl_prefix}_infos_{split}.pkl")
        if not os.path.exists(info_path):
            continue
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            v_rel = info["point_cloud"]["velodyne_path"]
            v_path = os.path.join(data_path, v_rel)
            points = _load_velodyne(
                v_path, info["point_cloud"]["num_features"])
            calib = info["calib"]
            if "image_shape" in info["image"]:
                points = remove_outside_points(
                    points, calib["R0_rect"], calib["Tr_velo_to_cam"],
                    calib["P2"], info["image"]["image_shape"])
            if save_path is None:
                out_dir = os.path.join(
                    os.path.dirname(v_path) + "_reduced")
            else:
                out_dir = save_path
            os.makedirs(out_dir, exist_ok=True)
            points.astype(np.float32).tofile(
                os.path.join(out_dir, os.path.basename(v_path)))


def export_2d_annotation(root_path: str, info_path: str) -> str:
    """COCO-style 2D annotation json next to the info pkl
    (kitti_converter.py:334-379). Returns the json path."""
    import json

    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    images, annotations = [], []
    ann_id = 0
    cats = sorted({
        str(n) for info in infos
        for n in info.get("annos", {}).get("name", ())
        if n != "DontCare"})
    cat_id = {n: i for i, n in enumerate(cats)}
    for info in infos:
        img = info["image"]
        shape = img.get("image_shape", np.array([0, 0]))
        images.append({
            "id": img["image_idx"],
            "file_name": img["image_path"],
            "height": int(shape[0]), "width": int(shape[1]),
        })
        annos = info.get("annos")
        if annos is None:
            continue
        for i, name in enumerate(annos["name"]):
            if name == "DontCare":
                continue
            x1, y1, x2, y2 = annos["bbox"][i]
            annotations.append({
                "id": ann_id,
                "image_id": img["image_idx"],
                "category_id": cat_id[str(name)],
                "bbox": [float(x1), float(y1),
                         float(x2 - x1), float(y2 - y1)],
                "area": float((x2 - x1) * (y2 - y1)),
                "iscrowd": 0,
                "bbox_cam3d": (
                    annos["location"][i].tolist()
                    + annos["dimensions"][i].tolist()
                    + [float(annos["rotation_y"][i])]),
            })
            ann_id += 1
    out = info_path.replace(".pkl", ".coco.json")
    with open(out, "w") as f:
        json.dump({
            "images": images,
            "annotations": annotations,
            "categories": [
                {"id": i, "name": n} for n, i in cat_id.items()],
        }, f)
    print(f"2d annotation -> {out} ({ann_id} boxes)")
    return out
