"""Devkit-free nuScenes v1.0 table reader.

The reference converter (tools/data_converter/nuscenes_converter.py:29-225)
drives the nuscenes devkit; the devkit itself is a thin layer over the
per-version JSON tables (``<dataroot>/<version>/*.json``) and the CAN-bus
blobs (``<dataroot>/can_bus/<scene>_pose.json``). This module reads those
files directly — the same treatment ``data/nusc_map.py`` gives the map
expansion JSONs — so ``tools/create_data.py nuscenes`` runs (and is
testable against a fake table dump) without any pip dependency.

Copy of the JAX package's data/nusc_tables.py (the port imports nothing
of the JAX package; a CPU test holds the copy equal to the original).

Implements exactly the devkit surface the converter consumes:
- ``get(table, token)`` with the devkit's derived fields
  (``sample['data'][channel]``, ``sample['anns']``,
  ``sample_annotation['category_name']``)
- ``box_velocity(ann_token)``: central difference over the instance's
  neighbouring annotations (devkit nuscenes.py ``box_velocity``: prev/next
  global positions over dt, NaN when both neighbours are absent or the
  time gap exceeds ``max_time_diff``)
- ``get_can_bus_pose(scene_name)``: the pose message list, sorted by utime
- official splits: the mini split is vendored (2 scenes of v1.0-mini);
  trainval consumes the devkit's ``splits.py`` lists when the devkit is
  installed, else an explicit ``--splits`` JSON
  (``{"train": [...], "val": [...]}``).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

TABLE_NAMES = (
    "category", "attribute", "visibility", "instance", "sensor",
    "calibrated_sensor", "ego_pose", "log", "scene", "sample",
    "sample_data", "sample_annotation", "map",
)

# devkit nuscenes/utils/splits.py (v1.0-mini)
MINI_TRAIN = (
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
)
MINI_VAL = ("scene-0103", "scene-0916")


class NuScenesTables:
    """Raw-JSON nuScenes database with devkit-compatible accessors."""

    def __init__(self, dataroot: str, version: str = "v1.0-mini",
                 verbose: bool = False):
        self.dataroot = dataroot
        self.version = version
        tdir = os.path.join(dataroot, version)
        self._tables: Dict[str, List[dict]] = {}
        self._index: Dict[str, Dict[str, dict]] = {}
        for name in TABLE_NAMES:
            path = os.path.join(tdir, f"{name}.json")
            if not os.path.exists(path):
                # map.json is absent from some fakes; category/attribute may
                # be trimmed — only the tables the converter touches are hard
                # requirements and fail later with a readable KeyError
                self._tables[name] = []
                self._index[name] = {}
                continue
            with open(path) as f:
                rows = json.load(f)
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}
            if verbose:
                print(f"{len(rows):7d} {name}")

        # ---- devkit-style derived fields -------------------------------
        # sample['data'][channel] = keyframe sample_data token;
        # sample['anns'] = annotation tokens
        for s in self._tables["sample"]:
            s.setdefault("data", {})
            s.setdefault("anns", [])
        for sd in self._tables["sample_data"]:
            if not sd.get("is_key_frame"):
                continue
            cs = self._index["calibrated_sensor"][
                sd["calibrated_sensor_token"]]
            sensor = self._index["sensor"][cs["sensor_token"]]
            sample = self._index["sample"].get(sd["sample_token"])
            if sample is not None:
                sample["data"][sensor["channel"]] = sd["token"]
        for ann in self._tables["sample_annotation"]:
            sample = self._index["sample"].get(ann["sample_token"])
            if sample is not None:
                sample["anns"].append(ann["token"])
            inst = self._index["instance"].get(ann["instance_token"])
            if inst is not None:
                cat = self._index["category"].get(inst["category_token"])
                ann["category_name"] = cat["name"] if cat else ""

    # ---- devkit surface -------------------------------------------------
    @property
    def sample(self) -> List[dict]:
        return self._tables["sample"]

    @property
    def scene(self) -> List[dict]:
        return self._tables["scene"]

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    def box_velocity(self, ann_token: str,
                     max_time_diff: float = 1.5) -> np.ndarray:
        """Devkit nuscenes.py box_velocity: finite difference of the
        instance's neighbouring annotation positions (global frame)."""
        ann = self.get("sample_annotation", ann_token)
        has_prev = bool(ann["prev"])
        has_next = bool(ann["next"])
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.get("sample_annotation",
                         ann["prev"]) if has_prev else ann
        last = self.get("sample_annotation",
                        ann["next"]) if has_next else ann
        pos_first = np.asarray(first["translation"], np.float64)
        pos_last = np.asarray(last["translation"], np.float64)
        t_first = 1e-6 * self.get("sample", first["sample_token"])[
            "timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        dt = t_last - t_first
        if dt > max_time_diff or dt <= 0:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / dt

    def get_can_bus_pose(self, scene_name: str) -> List[dict]:
        """Pose message list (devkit NuScenesCanBus.get_messages(scene,
        'pose')); raises FileNotFoundError for server scenes without CAN."""
        path = os.path.join(self.dataroot, "can_bus",
                            f"{scene_name}_pose.json")
        with open(path) as f:
            msgs = json.load(f)
        return sorted(msgs, key=lambda m: m["utime"])


def resolve_splits(version: str,
                   splits_json: Optional[str] = None) -> Dict[str, set]:
    """Train/val scene-name sets: vendored mini split, devkit lists when
    importable, or an explicit {"train": [...], "val": [...]} JSON."""
    if splits_json:
        with open(splits_json) as f:
            d = json.load(f)
        return {"train": set(d["train"]), "val": set(d["val"])}
    if "mini" in version:
        return {"train": set(MINI_TRAIN), "val": set(MINI_VAL)}
    try:
        from nuscenes.utils import splits  # pragma: no cover

        return {"train": set(splits.train), "val": set(splits.val)}
    except ImportError:
        raise SystemExit(
            "trainval split lists need either the nuscenes devkit or "
            "--splits <json> with {'train': [...], 'val': [...]} scene "
            "names (the official 700/150 split is a fixed list, not a "
            "rule)")
