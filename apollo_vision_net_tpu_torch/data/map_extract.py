"""Online vector-map GT extraction (VectorizedLocalMap, TPU-native rebuild).

Parity targets (reference file:line):
- datasets/nuscenes_det_occ_map_dataset.py:283-569 ``VectorizedLocalMap``:
  per sample, crop+rotate an ego-centered patch out of the city map and
  emit labeled polyline instances — divider (road_divider+lane_divider
  lines, label 0), ped_crossing (polygon exteriors, label 1), boundary
  (exterior contours of unary_union(road_segment, lane) re-clipped to the
  patch shrunk by 0.2 m, segments deliberately NOT merged, label 2).
- datasets/nuscenes_det_mapv2_dataset.py:13-263 ``VectorizedLocalMapV2``:
  adds centerline (label 3) — lane/lane_connector centerlines discretized
  at 0.5 m, joined through the lane-connectivity graph, every simple
  root→leaf path emitted after Douglas-Peucker simplify(0.2).

Copy of the JAX package's data/map_extract.py (the port imports nothing
of the JAX package; a CPU test holds the copy equal to the original).

Design differences from the reference (documented, deliberate):
- No shapely/devkit/networkx: geometry is data/geometry2d.py (numpy), map
  IO is data/nusc_map.py (plain JSON), the connectivity graph is a dict.
- The reference clips dividers/peds/boundaries against an AXIS-ALIGNED
  global box (:414-421) before rotating into ego frame — a quirk of its
  reimplementation (upstream MapTR and its own v2 centerline path use the
  rotated patch). We clip in the ego frame (equivalent to the rotated
  patch), which keeps all classes consistent and the GT inside the ego
  patch rectangle that the BEV grid actually covers.
- Invalid-polygon repair (shapely buffer(0), :457-468) is unnecessary: the
  even-odd classifier tolerates self-intersecting rings directly.

Everything is host-side numpy, deterministic given (map, pose).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from apollo_vision_net_tpu_torch.data import geometry2d as g2
from apollo_vision_net_tpu_torch.data.nusc_map import (
    CENTERLINE_LAYERS,
    NuScenesMapJSON,
)
from apollo_vision_net_tpu_torch.data.vector_map import (
    MAP_CLASS2LABEL,
    clip_polyline_to_box,
    global_to_patch,
)


def quaternion_yaw(q: Sequence[float]) -> float:
    """Yaw of a [w, x, y, z] quaternion (heading of the rotated x-axis
    projected on the ground plane — the devkit convention the reference
    relies on at :336)."""
    w, x, y, z = (float(v) for v in q)
    return math.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def _bbox(pts: np.ndarray) -> Tuple[float, float, float, float]:
    return (float(pts[:, 0].min()), float(pts[:, 1].min()),
            float(pts[:, 0].max()), float(pts[:, 1].max()))


class VectorizedLocalMap:
    """v1 extraction: divider / ped_crossing / boundary (labels 0/1/2)."""

    vec_classes: Tuple[str, ...] = ("divider", "ped_crossing", "boundary")
    line_layers: Tuple[str, ...] = ("road_divider", "lane_divider")
    ped_layers: Tuple[str, ...] = ("ped_crossing",)
    contour_layers: Tuple[str, ...] = ("road_segment", "lane")

    def __init__(
        self,
        maps: Dict[str, NuScenesMapJSON],
        patch_size: Tuple[float, float] = (60.0, 30.0),  # (h=y, w=x) meters
        contour_shrink: float = 0.2,
    ) -> None:
        self.maps = maps
        self.patch_size = patch_size
        self.half_h = patch_size[0] / 2.0
        self.half_w = patch_size[1] / 2.0
        self.contour_shrink = contour_shrink
        # static per-city geometry caches: (geometry, bbox) per record
        self._lines: Dict[str, List[Tuple[np.ndarray, tuple]]] = {}
        self._peds: Dict[str, list] = {}
        self._contours: Dict[str, list] = {}

    # -- caches ---------------------------------------------------------------

    def _line_cache(self, loc: str):
        if loc not in self._lines:
            m = self.maps[loc]
            items = []
            for layer in self.line_layers:
                for rec in m.layer_records(layer):
                    line = m.extract_line(rec["line_token"])
                    if len(line) >= 2:
                        items.append((line, _bbox(line)))
            self._lines[loc] = items
        return self._lines[loc]

    def _poly_cache(self, loc: str, layers: Sequence[str], store: Dict):
        if loc not in store:
            m = self.maps[loc]
            items = []
            for layer in layers:
                for ext, holes in m.record_polygons(layer):
                    if len(ext) >= 3:
                        items.append(((ext, holes), _bbox(ext)))
            store[loc] = items
        return store[loc]

    # -- patch machinery ------------------------------------------------------

    def _patch_reach(self) -> float:
        return math.hypot(self.half_w, self.half_h)

    def _in_reach(self, bbox: tuple, center: np.ndarray) -> bool:
        r = self._patch_reach()
        return not (
            bbox[2] < center[0] - r or bbox[0] > center[0] + r
            or bbox[3] < center[1] - r or bbox[1] > center[1] + r
        )

    # -- per-class extraction --------------------------------------------------

    def _divider_instances(self, loc, center, yaw):
        out = []
        for line, bbox in self._line_cache(loc):
            if not self._in_reach(bbox, center):
                continue
            ego = global_to_patch(line, center, yaw)
            out.extend(clip_polyline_to_box(ego, self.half_w, self.half_h))
        return out

    def _ped_instances(self, loc, center, yaw):
        """Polygon exteriors after the patch clip (reference :512-524)."""
        out = []
        for (ext, _holes), bbox in self._poly_cache(
                loc, self.ped_layers, self._peds):
            if not self._in_reach(bbox, center):
                continue
            ego = global_to_patch(ext, center, yaw)
            ring = g2.clip_ring_to_box(ego, self.half_w, self.half_h)
            if ring is not None:
                out.append(ring)
        return out

    def _boundary_instances(self, loc, center, yaw):
        """Union(road_segment, lane) exterior contours ∩ shrunk patch,
        segments kept split (reference :526-569 incl. the no-linemerge
        note)."""
        polys = []
        for (ext, holes), bbox in self._poly_cache(
                loc, self.contour_layers, self._contours):
            if not self._in_reach(bbox, center):
                continue
            ego_ext = global_to_patch(ext, center, yaw)
            clipped = g2.clip_ring_to_box(ego_ext, self.half_w, self.half_h)
            if clipped is None:
                continue
            ego_holes = []
            for h in holes:
                hc = g2.clip_ring_to_box(
                    global_to_patch(h, center, yaw), self.half_w, self.half_h)
                if hc is not None:
                    ego_holes.append(hc)
            polys.append((clipped, ego_holes))
        if not polys:
            return []
        contours = g2.union_exterior_contours(polys)
        out = []
        hw = self.half_w - self.contour_shrink
        hh = self.half_h - self.contour_shrink
        for ring in contours:
            out.extend(clip_polyline_to_box(ring, hw, hh))
        return out

    # -- public API ------------------------------------------------------------

    def gen_vectorized_samples(
        self,
        location: str,
        lidar2global_translation: Sequence[float],
        lidar2global_rotation: Sequence[float],  # [w, x, y, z]
    ) -> Tuple[List[np.ndarray], List[int]]:
        """(instances in ego frame float32, labels) — the payload the
        dataset packs via vector_map.pack_map_gt (reference returns
        gt_vecs_pts_loc/gt_vecs_label, :371-390)."""
        return self.gen_vectorized_samples_pose(
            location,
            np.asarray(lidar2global_translation[:2], np.float64),
            quaternion_yaw(lidar2global_rotation),
        )

    def gen_vectorized_samples_pose(
        self, location: str, center: np.ndarray, yaw: float
    ) -> Tuple[List[np.ndarray], List[int]]:
        """Same extraction, pose given as (xy center, yaw) — the form the
        offline converter has after composing info poses (infos.lidar2global)."""
        center = np.asarray(center, np.float64)[:2]
        vectors: List[np.ndarray] = []
        labels: List[int] = []

        def add(instances, label):
            for inst in instances:
                if len(inst) < 2:
                    continue
                if np.linalg.norm(np.diff(inst, axis=0), axis=1).sum() < 1e-3:
                    continue
                vectors.append(np.asarray(inst, np.float32))
                labels.append(label)

        for vc in self.vec_classes:
            if vc == "divider":
                add(self._divider_instances(location, center, yaw),
                    MAP_CLASS2LABEL["divider"])
            elif vc == "ped_crossing":
                add(self._ped_instances(location, center, yaw),
                    MAP_CLASS2LABEL["ped_crossing"])
            elif vc == "boundary":
                add(self._boundary_instances(location, center, yaw),
                    MAP_CLASS2LABEL["boundary"])
            elif vc == "centerline":
                add(self._centerline_instances(location, center, yaw),
                    MAP_CLASS2LABEL["centerline"])
            else:
                raise ValueError(f"unsupported vec_class {vc}")
        return vectors, labels

    def _centerline_instances(self, loc, center, yaw):
        raise ValueError("centerline requires VectorizedLocalMapV2")


class VectorizedLocalMapV2(VectorizedLocalMap):
    """v2: + centerline (label 3) via the lane-connectivity graph
    (reference nuscenes_det_mapv2_dataset.py:126-263)."""

    vec_classes = ("divider", "ped_crossing", "boundary", "centerline")
    centerline_layers: Tuple[str, ...] = CENTERLINE_LAYERS
    centerline_resolution: float = 0.5
    simplify_tol: float = 0.2

    def _centerline_instances(self, loc, center, yaw):
        m = self.maps[loc]
        # per-record clipped centerline pieces, ego frame, rounded to 3
        # decimals (the reference rounds for graph-node identity, :204)
        recs: Dict[str, dict] = {}
        for layer in self.centerline_layers:
            for rec in m.layer_records(layer):
                tok = rec["token"]
                pts = m.discretize_lane(tok, self.centerline_resolution)
                if pts is None or len(pts) < 2:
                    continue
                ego = global_to_patch(np.round(pts, 3), center, yaw)
                pieces = [
                    np.round(p, 3) for p in
                    clip_polyline_to_box(ego, self.half_w, self.half_h)
                ]
                pieces = [p for p in pieces if len(p) >= 2]
                if not pieces:
                    continue
                recs[tok] = dict(
                    pieces=pieces,
                    start=tuple(pieces[0][0]),
                    end=tuple(pieces[-1][-1]),
                    incoming=m.incoming_lane_ids(tok),
                    outgoing=m.outgoing_lane_ids(tok),
                )
        if not recs:
            return []

        # directed point graph (reference union_centerline :190-263)
        succ: Dict[tuple, list] = {}
        indeg: Dict[tuple, int] = {}

        def add_edge(a: tuple, b: tuple) -> None:
            if a == b:
                return
            lst = succ.setdefault(a, [])
            if b not in lst:
                lst.append(b)
                indeg[b] = indeg.get(b, 0) + 1
                indeg.setdefault(a, indeg.get(a, 0))

        for rec in recs.values():
            for piece in rec["pieces"]:
                for a, b in zip(piece[:-1], piece[1:]):
                    add_edge(tuple(a), tuple(b))
            for pred in rec["incoming"]:
                if pred in recs:
                    add_edge(recs[pred]["end"], rec["start"])
            for nxt in rec["outgoing"]:
                if nxt in recs:
                    add_edge(rec["end"], recs[nxt]["start"])

        roots = [n for n, d in indeg.items() if d == 0]
        leaves = [n for n in indeg if not succ.get(n)]
        if not roots or not leaves:
            # cyclic patch graph: fall back to per-record pieces (:245-252)
            return [p for rec in recs.values() for p in rec["pieces"]]

        out = []
        for root in roots:
            # all simple root→leaf paths, DFS (networkx all_simple_paths)
            stack = [(root, [root])]
            while stack:
                node, path = stack.pop()
                nxts = succ.get(node, [])
                if not nxts:
                    if len(path) >= 2:
                        out.append(g2.simplify_line(
                            np.asarray(path, np.float64), self.simplify_tol))
                    continue
                for nxt in nxts:
                    if nxt in path:  # simple paths only (no revisits)
                        continue
                    stack.append((nxt, path + [nxt]))
        return out
