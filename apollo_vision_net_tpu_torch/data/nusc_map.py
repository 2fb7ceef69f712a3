"""Devkit-free nuScenes map-expansion reader.

The reference extracts online map GT through the nuScenes devkit's
``NuScenesMap`` (datasets/nuscenes_det_occ_map_dataset.py:308-323 loads the
four city maps; extract_line/extract_polygon at :425,:449; the v2 dataset
additionally uses ``discretize_lanes`` + lane connectivity,
nuscenes_det_mapv2_dataset.py:152-166). The devkit is not in the baked TPU
image and is a heavyweight dependency for what is simple JSON: this module
parses the map-expansion JSON schema directly (``maps/expansion/<city>.json``
with ``node``/``line``/``polygon`` geometry tables, per-layer record lists,
``arcline_path_3`` lane paths and ``connectivity``), and reimplements the
constant-curvature arcline discretization from the geometry (pose advanced
in closed form per L/S/R segment).

Copy of the JAX package's data/nusc_map.py (the port imports nothing of
the JAX package; a CPU test holds the copy equal to the original).

Everything returns plain numpy arrays so the extraction layer
(data/map_extract.py) and tests stay dependency-free.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAP_LOCATIONS = (
    "boston-seaport",
    "singapore-hollandvillage",
    "singapore-onenorth",
    "singapore-queenstown",
)

LINE_LAYERS = ("road_divider", "lane_divider")
POLYGON_LAYERS = ("road_segment", "lane", "ped_crossing",
                  "road_block", "walkway", "carpark_area", "lane_connector")
CENTERLINE_LAYERS = ("lane", "lane_connector")


class NuScenesMapJSON:
    """One city map parsed from the expansion JSON (no devkit)."""

    def __init__(self, data: dict, location: str = "") -> None:
        self.location = location
        self.nodes: Dict[str, Tuple[float, float]] = {
            r["token"]: (float(r["x"]), float(r["y"]))
            for r in data.get("node", [])
        }
        self.lines: Dict[str, dict] = {
            r["token"]: r for r in data.get("line", [])
        }
        self.polygons: Dict[str, dict] = {
            r["token"]: r for r in data.get("polygon", [])
        }
        self.layers: Dict[str, List[dict]] = {
            name: list(data.get(name, []))
            for name in LINE_LAYERS + POLYGON_LAYERS
        }
        # arcline_path_3: JSON is a list of {token, arcline_paths=[...]}
        # (the devkit re-keys it by token); accept a pre-keyed dict too.
        raw_arc = data.get("arcline_path_3", [])
        if isinstance(raw_arc, dict):
            self.arcline_path_3 = dict(raw_arc)
        else:
            self.arcline_path_3 = {
                r["token"]: r.get("arcline_paths", r.get("arcline_path", []))
                for r in raw_arc
            }
        raw_conn = data.get("connectivity", [])
        if isinstance(raw_conn, dict):
            self.connectivity = dict(raw_conn)
        else:
            self.connectivity = {
                r["token"]: r.get("connectivity", r) for r in raw_conn
            }

    @classmethod
    def from_file(cls, path: str, location: str = "") -> "NuScenesMapJSON":
        with open(path) as f:
            return cls(json.load(f), location=location)

    # -- geometry extraction (devkit extract_line / extract_polygon) --------

    def _node_coords(self, tokens: Sequence[str]) -> np.ndarray:
        return np.asarray([self.nodes[t] for t in tokens], np.float64)

    def extract_line(self, line_token: str) -> np.ndarray:
        """(P, 2) polyline in global map coords."""
        return self._node_coords(self.lines[line_token]["node_tokens"])

    def extract_polygon(
        self, polygon_token: str
    ) -> Tuple[np.ndarray, List[np.ndarray]]:
        """(exterior (P, 2) OPEN ring, [hole rings])."""
        rec = self.polygons[polygon_token]
        ext = self._node_coords(rec["exterior_node_tokens"])
        holes = [
            self._node_coords(h["node_tokens"])
            for h in rec.get("holes", [])
            if h.get("node_tokens")
        ]
        return ext, holes

    # -- layer accessors -----------------------------------------------------

    def layer_records(self, layer: str) -> List[dict]:
        return self.layers.get(layer, [])

    def record_polygons(
        self, layer: str
    ) -> List[Tuple[np.ndarray, List[np.ndarray]]]:
        """All polygons of a polygon layer (road_segment records may carry
        multiple polygon_tokens, reference :447-455)."""
        out = []
        for rec in self.layer_records(layer):
            if "polygon_tokens" in rec:
                for tok in rec["polygon_tokens"]:
                    out.append(self.extract_polygon(tok))
            elif rec.get("polygon_token"):
                out.append(self.extract_polygon(rec["polygon_token"]))
        return out

    # -- lane connectivity / centerlines (v2) --------------------------------

    def incoming_lane_ids(self, lane_token: str) -> List[str]:
        return list(self.connectivity.get(lane_token, {}).get("incoming", []))

    def outgoing_lane_ids(self, lane_token: str) -> List[str]:
        return list(self.connectivity.get(lane_token, {}).get("outgoing", []))

    def discretize_lane(
        self, lane_token: str, resolution: float = 0.5
    ) -> Optional[np.ndarray]:
        """(P, 2) centerline points for a lane/lane_connector, from its
        arcline paths (devkit ``discretize_lanes``, used by the v2 dataset at
        nuscenes_det_mapv2_dataset.py:152)."""
        paths = self.arcline_path_3.get(lane_token)
        if not paths:
            return None
        pts = [discretize_arcline_path(p, resolution) for p in paths]
        return np.concatenate(pts, axis=0)[:, :2]


def discretize_arcline_path(path: dict, resolution: float) -> np.ndarray:
    """Discretize one arcline path record to (P, 3) [x, y, yaw].

    Record schema: start_pose [x, y, yaw], shape (3 letters of L/S/R),
    radius, segment_length [3 floats]. Poses advance in closed form:
    straight → translate along yaw; arc of curvature κ=±1/radius →
    x += (sin(yaw+κs) − sin(yaw))/κ, y −= (cos(yaw+κs) − cos(yaw))/κ.
    """
    seg_len = [float(v) for v in path["segment_length"]]
    total = sum(seg_len)
    radius = float(path["radius"])
    shape = path["shape"]
    kappa = {"L": 1.0 / radius if radius else 0.0, "S": 0.0,
             "R": -1.0 / radius if radius else 0.0}
    n_points = int(max(math.ceil(total / resolution) + 1.5, 2))
    step = total / (n_points - 1)

    # per-segment start poses
    seg_start = [tuple(float(v) for v in path["start_pose"])]
    for j in range(2):
        seg_start.append(
            _advance_pose(seg_start[j], kappa[shape[j]], seg_len[j]))
    cum = np.concatenate([[0.0], np.cumsum(seg_len)])

    out = np.empty((n_points, 3), np.float64)
    for i in range(n_points):
        s = min(i * step, total)
        j = int(np.clip(np.searchsorted(cum[1:3], s, side="right"), 0, 2))
        out[i] = _advance_pose(seg_start[j], kappa[shape[j]], s - cum[j])
    return out


def _advance_pose(pose: Tuple[float, float, float], kappa: float,
                  s: float) -> Tuple[float, float, float]:
    x, y, yaw = pose
    if abs(kappa) < 1e-12:
        return (x + s * math.cos(yaw), y + s * math.sin(yaw), yaw)
    return (
        x + (math.sin(yaw + kappa * s) - math.sin(yaw)) / kappa,
        y - (math.cos(yaw + kappa * s) - math.cos(yaw)) / kappa,
        yaw + kappa * s,
    )


def load_city_maps(
    dataroot: str, locations: Sequence[str] = MAP_LOCATIONS
) -> Dict[str, NuScenesMapJSON]:
    """Load ``<dataroot>/maps/expansion/<loc>.json`` for each location —
    mirror of the reference's four-city NuScenesMap dict (:308-323)."""
    import os

    out = {}
    for loc in locations:
        path = os.path.join(dataroot, "maps", "expansion", f"{loc}.json")
        out[loc] = NuScenesMapJSON.from_file(path, location=loc)
    return out
