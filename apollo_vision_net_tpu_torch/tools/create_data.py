"""Offline data converter: raw nuScenes tables -> temporal infos pkl, and
the vector-map GT that the map head trains on.

Counterpart of the JAX package's tools/create_data.py, its ``nuscenes``
and ``nuscenes-map-gt`` subcommands (reference tools/create_data.py +
tools/data_converter/nuscenes_converter.py:29-675): per-sample records
with the 18-dim can_bus from the CAN pose messages, per-camera
sensor2lidar extrinsics and intrinsics, annotations, map_location and
scene metadata, sorted by timestamp, split into train and val; then, from
the map-expansion JSONs under ``<root>/maps/expansion``, each sample's
ego-frame map polylines and labels. Devkit-free: ``data/nusc_tables.py``
reads the v1.0 JSON tables and can_bus blobs, ``data/map_extract.py`` the
map. Numpy only: nothing here runs on a device.

    python3 -m apollo_vision_net_tpu_torch.tools.create_data nuscenes \\
        --root-path <nuscenes> --version v1.0-trainval --out-dir <dir> \\
        [--splits <json>]
    python3 -m apollo_vision_net_tpu_torch.tools.create_data nuscenes-map-gt \\
        --root-path <nuscenes> --infos <pkl> [--out <pkl>] [--map-version 2]
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Optional

import numpy as np

CAMS = (
    "CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
)


def create_nuscenes_infos(root_path: str, version: str, out_dir: str,
                          splits_json: str = ""):
    """Devkit-free: drives data/nusc_tables.py over the raw v1.0 JSON
    tables + can_bus blobs (reference nuscenes_converter.py:29-225 drives
    the devkit over the same files — identical schema out)."""
    from apollo_vision_net_tpu_torch.data.infos import (
        DETECTION_NAME_MAP,
        quat_to_rot,
    )
    from apollo_vision_net_tpu_torch.data.nusc_tables import (
        NuScenesTables,
        resolve_splits,
    )

    nusc = NuScenesTables(dataroot=root_path, version=version, verbose=True)

    def rt(rot, tr):
        m = np.eye(4)
        m[:3, :3] = quat_to_rot(rot)
        m[:3, 3] = tr
        return m

    def get_can_bus(sample):
        # reference nuscenes_converter.py:153-175: last pose message at or
        # before the sample timestamp; zeros for scenes without CAN data.
        # (The reference extends the trailing accel/rotation_rate/vel from
        # the loop-escaped `pose` variable — an off-by-one it never hits in
        # practice since messages are ~10 ms apart; we read `last`
        # consistently.)
        scene_name = nusc.get("scene", sample["scene_token"])["name"]
        ts = sample["timestamp"]
        try:
            pose_list = nusc.get_can_bus_pose(scene_name)
        except (FileNotFoundError, OSError):
            return np.zeros(18, np.float32)
        if not pose_list:
            return np.zeros(18, np.float32)
        last = pose_list[0]
        for pose in pose_list:
            if pose["utime"] > ts:
                break
            last = pose
        rec = []
        rec.extend(last["pos"])
        rec.extend(last["orientation"])
        rec.extend(last["accel"])
        rec.extend(last["rotation_rate"])
        rec.extend(last["vel"])
        rec.extend([0.0, 0.0])
        return np.asarray(rec, np.float32)

    infos = []
    for sample in nusc.sample:
        lidar = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        cs = nusc.get("calibrated_sensor", lidar["calibrated_sensor_token"])
        pose = nusc.get("ego_pose", lidar["ego_pose_token"])
        scene = nusc.get("scene", sample["scene_token"])
        log = nusc.get("log", scene["log_token"])
        info = dict(
            token=sample["token"],
            scene_token=sample["scene_token"],
            scene_name=scene["name"],
            map_location=log["location"],
            timestamp=sample["timestamp"],
            can_bus=get_can_bus(sample),
            lidar2ego_translation=cs["translation"],
            lidar2ego_rotation=cs["rotation"],
            ego2global_translation=pose["translation"],
            ego2global_rotation=pose["rotation"],
            cams={},
        )
        l2e = rt(cs["rotation"], cs["translation"])
        e2g = rt(pose["rotation"], pose["translation"])
        for cam in CAMS:
            sd = nusc.get("sample_data", sample["data"][cam])
            ccs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
            cpose = nusc.get("ego_pose", sd["ego_pose_token"])
            # sensor->lidar at the lidar timestamp (converter
            # obtain_sensor2top): cam->cam_ego->global->lidar_ego->lidar
            c2e = rt(ccs["rotation"], ccs["translation"])
            ce2g = rt(cpose["rotation"], cpose["translation"])
            cam2lidar = np.linalg.inv(l2e) @ np.linalg.inv(e2g) @ ce2g @ c2e
            info["cams"][cam] = dict(
                data_path=sd["filename"],
                cam_intrinsic=np.asarray(ccs["camera_intrinsic"]),
                sensor2lidar_rotation=cam2lidar[:3, :3],
                sensor2lidar_translation=cam2lidar[:3, 3],
            )
        # keyframe boxes ARE the annotations (devkit get_boxes on a
        # keyframe sample_data returns one Box per annotation, global
        # frame); transform to the lidar frame exactly as the reference
        g2l = np.linalg.inv(e2g @ l2e)
        ego_yaw = np.arctan2(e2g[1, 0], e2g[0, 0])
        gt, names, vels, valid, vis, ann_tokens = [], [], [], [], [], []
        for t in sample["anns"]:
            ann = nusc.get("sample_annotation", t)
            if ann.get("category_name", "") not in DETECTION_NAME_MAP:
                continue
            center = np.asarray(ann["translation"], np.float64)
            w, l, h = ann["size"]
            rot = quat_to_rot(ann["rotation"])
            yaw_g = np.arctan2(rot[1, 0], rot[0, 0])
            c = g2l[:3, :3] @ center + g2l[:3, 3]
            yaw = yaw_g - ego_yaw
            gt.append([c[0], c[1], c[2] - h / 2, w, l, h, yaw])
            names.append(DETECTION_NAME_MAP[ann["category_name"]])
            v = nusc.box_velocity(t)[:2]
            vels.append(np.nan_to_num(v))
            valid.append(ann["num_lidar_pts"] + ann["num_radar_pts"] > 0)
            vis.append(ann.get("visibility_token", ""))
            ann_tokens.append(t)
        info["gt_boxes"] = np.asarray(gt, np.float32).reshape(-1, 7)
        info["gt_names"] = np.asarray(names)
        info["gt_velocity"] = np.asarray(vels, np.float32).reshape(-1, 2)
        info["valid_flag"] = np.asarray(valid, bool)
        # eval GT-filter variants need these (nuscnes_eval.py:423-566)
        info["gt_visibility"] = np.asarray(vis)
        info["gt_ann_tokens"] = np.asarray(ann_tokens)
        infos.append(info)

    infos.sort(key=lambda i: i["timestamp"])
    split_sets = resolve_splits(version, splits_json)
    train = [i for i in infos if i["scene_name"] in split_sets["train"]]
    val = [i for i in infos if i["scene_name"] in split_sets["val"]]
    leftover = len(infos) - len(train) - len(val)
    if leftover:
        print(f"warning: {leftover} samples in scenes outside both splits")
    os.makedirs(out_dir, exist_ok=True)
    for split, data in (("train", train), ("val", val)):
        out = os.path.join(out_dir, f"nuscenes_infos_temporal_{split}.pkl")
        with open(out, "wb") as f:
            pickle.dump({"infos": data, "metadata": {"version": version}}, f)
        print(f"wrote {len(data)} infos to {out}")


def add_map_gt_to_infos(
    infos_path: str,
    dataroot: str,
    out_path: str = "",
    map_version: int = 1,
    patch_size=(60.0, 30.0),
    locations=None,
) -> str:
    """Annotate an existing infos pkl with online vector-map GT
    (`map_vectors` ego-frame polylines + `map_labels` per sample).

    Devkit-free: needs only the map-expansion JSONs under
    ``<dataroot>/maps/expansion`` and the poses already in the infos
    (reference extracts the same GT online per batch at dataloading time,
    nuscenes_det_occ_map_dataset.py:885-966; precomputing into infos keeps
    the input pipeline free of per-step polygon work — the extraction is
    deterministic so offline == online).
    """
    from apollo_vision_net_tpu_torch.data.infos import lidar2global
    from apollo_vision_net_tpu_torch.data.map_extract import (
        VectorizedLocalMap, VectorizedLocalMapV2)
    from apollo_vision_net_tpu_torch.data.nusc_map import (
        MAP_LOCATIONS, load_city_maps)

    with open(infos_path, "rb") as f:
        payload = pickle.load(f)
    infos = payload["infos"] if isinstance(payload, dict) else payload

    needed = sorted({i.get("map_location", "") for i in infos} - {""})
    locations = locations if locations is not None else (
        needed or list(MAP_LOCATIONS))
    maps = load_city_maps(dataroot, locations)
    cls = VectorizedLocalMapV2 if map_version == 2 else VectorizedLocalMap
    vmap = cls(maps, patch_size=tuple(patch_size))

    n_vec = 0
    for info in infos:
        loc = info.get("map_location", "")
        if loc not in maps:
            info["map_vectors"], info["map_labels"] = [], []
            continue
        m = lidar2global(info)
        yaw = float(np.arctan2(m[1, 0], m[0, 0]))
        vectors, labels = vmap.gen_vectorized_samples_pose(loc, m[:2, 3], yaw)
        info["map_vectors"] = vectors
        info["map_labels"] = labels
        n_vec += len(vectors)

    out_path = out_path or infos_path
    with open(out_path, "wb") as f:
        pickle.dump(payload, f)
    print(f"annotated {len(infos)} infos with {n_vec} map vectors -> {out_path}")
    return out_path


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="nuScenes tables -> temporal infos pkl (nuscenes), or "
                    "map GT added to an infos pkl (nuscenes-map-gt)")
    p.add_argument("dataset", choices=["nuscenes", "nuscenes-map-gt"])
    p.add_argument("--root-path", required=True)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--out-dir", default="")
    p.add_argument("--infos", default="", help="infos pkl for nuscenes-map-gt")
    p.add_argument("--out", default="", help="output pkl (default: in place)")
    p.add_argument("--map-version", type=int, default=1, choices=[1, 2])
    p.add_argument("--patch-size", type=float, nargs=2, default=[60.0, 30.0])
    p.add_argument("--splits", default="",
                   help="JSON with {'train': [...], 'val': [...]} scene "
                        "names (trainval split lists; mini is built in)")
    a = p.parse_args(argv)
    if a.dataset == "nuscenes":
        if not a.out_dir:
            raise SystemExit("--out-dir required for nuscenes conversion")
        create_nuscenes_infos(a.root_path, a.version, a.out_dir,
                              splits_json=a.splits)
        for split in ("train", "val"):
            pkl = os.path.join(
                a.out_dir, f"nuscenes_infos_temporal_{split}.pkl")
            if os.path.isdir(os.path.join(a.root_path, "maps", "expansion")):
                add_map_gt_to_infos(
                    pkl, a.root_path, map_version=a.map_version,
                    patch_size=a.patch_size)
    else:
        if not a.infos:
            raise SystemExit("--infos required for nuscenes-map-gt")
        add_map_gt_to_infos(
            a.infos, a.root_path, out_path=a.out,
            map_version=a.map_version, patch_size=a.patch_size)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
