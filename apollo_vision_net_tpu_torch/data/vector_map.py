"""Vector-map GT packing for the map loss, pure numpy.

Copy of the part of the JAX package's data/vector_map.py that the training
slice and the map-GT extraction use (``InstanceLines`` with its shift
protocols, ``order_mask_from_shifts``, ``pack_map_gt``, ``MAP_CLASS2LABEL``,
``global_to_patch``, ``clip_polyline_to_box``), with ``resample_line`` from
the port's copy of evaluation/map_eval.py as in the JAX package; the port
keeps its own copy so that it imports nothing of the JAX package, and a
test holds the copy equal to the original.

Parity (reference datasets/nuscenes_det_occ_map_dataset.py): fixed-N
arc-length resampling (:95-125), shift protocols v0 (:127-166), v1
(:168-215) and v2 (:217-280; the polygon subsample is seeded). Padding
value -10000 for invalid shift rows.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from apollo_vision_net_tpu_torch.evaluation.map_eval import resample_line

PADDING_VALUE = -10000.0
MAP_CLASS2LABEL = {"divider": 0, "ped_crossing": 1, "boundary": 2,
                   "centerline": 3}


def _is_closed(pts: np.ndarray) -> bool:
    return bool(np.all(pts[0] == pts[-1]))


@dataclasses.dataclass
class InstanceLines:
    """A set of map instance polylines in ego(lidar) frame, meters."""

    instance_list: List[np.ndarray]  # each (P_i, 2), closed if first==last
    fixed_num: int = 20
    patch_size: Tuple[float, float] = (60.0, 30.0)  # (h=y extent, w=x extent)

    @property
    def max_x(self) -> float:
        return self.patch_size[1] / 2.0

    @property
    def max_y(self) -> float:
        return self.patch_size[0] / 2.0

    def _clamp(self, pts: np.ndarray) -> np.ndarray:
        out = pts.copy()
        out[..., 0] = np.clip(out[..., 0], -self.max_x, self.max_x)
        out[..., 1] = np.clip(out[..., 1], -self.max_y, self.max_y)
        return out

    @property
    def fixed_num_sampled_points(self) -> np.ndarray:
        """(N, fixed_num, 2), clamped to the patch."""
        out = [resample_line(inst, self.fixed_num) for inst in self.instance_list]
        return self._clamp(np.stack(out).astype(np.float32))

    def shift_points(self, pattern: str = "v2",
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """(N, num_shifts, fixed_num, 2) admissible orderings per protocol."""
        if pattern == "v0":
            return self._shift_v0()
        if pattern == "v1":
            return self._shift_v1()
        if pattern == "v2":
            return self._shift_v2(rng or np.random.default_rng(0))
        raise ValueError(pattern)

    def _shift_v0(self) -> np.ndarray:
        fixed = self.fixed_num_sampled_points
        out = []
        for pts in fixed:
            if _is_closed(pts):
                shifts = np.stack(
                    [np.roll(pts, i, axis=0) for i in range(self.fixed_num)])
            else:
                shifts = np.stack([pts, pts[::-1]])
                pad = np.full(
                    (self.fixed_num - 2, self.fixed_num, 2), PADDING_VALUE,
                    np.float32)
                shifts = np.concatenate(
                    [self._clamp(shifts), pad]).astype(np.float32)
                out.append(shifts)
                continue
            out.append(self._clamp(shifts).astype(np.float32))
        return np.stack(out)

    def _shift_v1(self) -> np.ndarray:
        fixed = self.fixed_num_sampled_points
        shift_num = self.fixed_num - 1
        out = []
        for pts in fixed:
            if _is_closed(pts):
                core = pts[:-1]
                rolls = np.stack(
                    [np.roll(core, i, axis=0) for i in range(shift_num)])
                shifts = np.concatenate([rolls, rolls[:, :1]], axis=1)
                shifts = self._clamp(shifts)
            else:
                shifts = self._clamp(np.stack([pts, pts[::-1]]))
                pad = np.full((shift_num - 2, self.fixed_num, 2),
                              PADDING_VALUE, np.float32)
                shifts = np.concatenate([shifts, pad])
            out.append(shifts.astype(np.float32))
        return np.stack(out)

    def _shift_v2(self, rng: np.random.Generator) -> np.ndarray:
        final_shift_num = self.fixed_num - 1
        out = []
        for inst in self.instance_list:
            pts = np.asarray(inst, np.float64)
            if _is_closed(pts) and pts.shape[0] > 2:
                core = pts[:-1]
                shift_list = []
                for i in range(core.shape[0]):
                    rolled = np.roll(core, i, axis=0)
                    closed = np.concatenate([rolled, rolled[:1]], axis=0)
                    shift_list.append(resample_line(closed, self.fixed_num))
                shifts = np.stack(shift_list)
                if shifts.shape[0] > final_shift_num:
                    idx = rng.choice(shifts.shape[0], final_shift_num,
                                     replace=False)
                    shifts = shifts[idx]
            else:
                s = resample_line(pts, self.fixed_num)
                shifts = np.stack([s, s[::-1]])
            shifts = self._clamp(shifts).astype(np.float32)
            if shifts.shape[0] < final_shift_num:
                pad = np.full(
                    (final_shift_num - shifts.shape[0], self.fixed_num, 2),
                    PADDING_VALUE, np.float32)
                shifts = np.concatenate([shifts, pad])
            out.append(shifts)
        return np.stack(out)


def order_mask_from_shifts(shifts: np.ndarray) -> np.ndarray:
    """(N, O, P, 2) -> (N, O) validity from the padding sentinel."""
    return ~(shifts <= PADDING_VALUE + 1).all(axis=(-1, -2))


# ---------------------------------------------------------------------------
# local patch geometry (VectorizedLocalMap core)
# ---------------------------------------------------------------------------

def global_to_patch(pts: np.ndarray, patch_center: Sequence[float],
                    patch_yaw: float) -> np.ndarray:
    """Rotate/translate global-frame points into the ego patch frame
    (reference :412-432 rotate -patch_angle then translate)."""
    c, s = np.cos(-patch_yaw), np.sin(-patch_yaw)
    rel = pts - np.asarray(patch_center, np.float64)[None, :2]
    return rel @ np.array([[c, -s], [s, c]], np.float64).T


def clip_polyline_to_box(pts: np.ndarray, half_w: float, half_h: float
                         ) -> List[np.ndarray]:
    """Clip an ego-frame polyline to the patch box, splitting into pieces —
    the reference intersects shapely geometries with the patch and keeps
    split segments separate (:547-552). Pure-numpy segment clipping
    (Liang-Barsky per segment, pieces stitched while contiguous)."""
    lo = np.array([-half_w, -half_h])
    hi = np.array([half_w, half_h])
    pieces: List[List[np.ndarray]] = []
    cur: List[np.ndarray] = []

    def emit():
        nonlocal cur
        if len(cur) >= 2:
            pieces.append(cur)
        cur = []

    for a, b in zip(pts[:-1], pts[1:]):
        d = b - a
        t0, t1 = 0.0, 1.0
        ok = True
        for dim in range(2):
            if abs(d[dim]) < 1e-12:
                if a[dim] < lo[dim] or a[dim] > hi[dim]:
                    ok = False
                    break
            else:
                ta = (lo[dim] - a[dim]) / d[dim]
                tb = (hi[dim] - a[dim]) / d[dim]
                ta, tb = min(ta, tb), max(ta, tb)
                t0, t1 = max(t0, ta), min(t1, tb)
                if t0 > t1:
                    ok = False
                    break
        if not ok:
            emit()
            continue
        pa, pb = a + t0 * d, a + t1 * d
        if not cur:
            cur = [pa]
        elif np.linalg.norm(cur[-1] - pa) > 1e-9:
            emit()
            cur = [pa]
        cur.append(pb)
    emit()
    return [np.stack(p) for p in pieces]


def pack_map_gt(
    vectors: List[np.ndarray],
    labels: List[int],
    max_vec: int,
    fixed_num: int = 20,
    pattern: str = "v2",
    patch_size: Tuple[float, float] = (60.0, 30.0),
    seed: int = 0,
):
    """Pad one sample's map GT to static shapes: dict(shift_pts
    (V, O, P, 2), labels (V,), mask (V,), order_mask (V, O))."""
    n_orders = fixed_num if pattern == "v0" else fixed_num - 1
    n_orders = max(n_orders, 2)
    out_pts = np.zeros((max_vec, n_orders, fixed_num, 2), np.float32)
    out_lab = np.zeros((max_vec,), np.int32)
    out_mask = np.zeros((max_vec,), bool)
    out_order = np.zeros((max_vec, n_orders), bool)
    if vectors:
        il = InstanceLines(vectors[:max_vec], fixed_num, patch_size)
        shifts = il.shift_points(pattern, np.random.default_rng(seed))
        n = shifts.shape[0]
        o = min(shifts.shape[1], n_orders)
        out_pts[:n, :o] = shifts[:, :o]
        out_lab[:n] = np.asarray(labels[:n], np.int32)
        out_mask[:n] = True
        out_order[:n, :o] = order_mask_from_shifts(shifts)[:, :o]
    return dict(shift_pts=out_pts, labels=out_lab, mask=out_mask,
                order_mask=out_order)
