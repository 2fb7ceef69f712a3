"""Pure-numpy 2D polygon/polyline geometry — the shapely replacement for
online vector-map GT extraction.

Copy of the JAX package's data/geometry2d.py (the port imports nothing
of the JAX package; a CPU test holds the copy equal to the original).

The reference leans on shapely for four operations (datasets/
nuscenes_det_occ_map_dataset.py:283-569): line ∩ patch, polygon ∩ patch,
unary_union of road/lane polygons followed by taking component exteriors,
and Douglas-Peucker `simplify` for v2 centerlines. shapely is not in the
baked TPU image, and the host data path should not hard-depend on it, so
this module implements exactly those four primitives:

- ``clip_ring_to_box``   — Sutherland–Hodgman polygon clip vs an axis box
- ``point_in_polygon``   — even-odd ray cast (exterior + holes)
- ``union_exterior_contours`` — boundary-of-union via edge classification:
  split every ring edge at crossings with other polygons, keep the
  sub-segments that have union-interior on exactly one side, chain them
  back into rings, keep rings that enclose union interior (drop holes).
  This is the classic "arrangement" construction specialised to what the
  reference consumes (it never uses union *areas*, only exterior contours).
- ``simplify_line``      — Douglas–Peucker

All functions are host-side numpy (the data pipeline runs on CPU while the
TPU computes; SURVEY.md §7 stage 1).
"""
from __future__ import annotations

from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np

Ring = np.ndarray  # (P, 2); closed rings repeat the first point last
PolygonWithHoles = Tuple[np.ndarray, List[np.ndarray]]


def ring_is_closed(pts: np.ndarray) -> bool:
    return len(pts) >= 2 and bool(np.all(pts[0] == pts[-1]))


def open_ring(pts: np.ndarray) -> np.ndarray:
    """Drop the duplicated closing vertex if present."""
    return pts[:-1] if ring_is_closed(pts) else pts


def close_ring(pts: np.ndarray) -> np.ndarray:
    return pts if ring_is_closed(pts) else np.concatenate([pts, pts[:1]])


def ring_area(pts: np.ndarray) -> float:
    """Signed area (positive = CCW)."""
    r = open_ring(np.asarray(pts, np.float64))
    x, y = r[:, 0], r[:, 1]
    x2, y2 = np.roll(x, -1), np.roll(y, -1)
    return float(0.5 * np.sum(x * y2 - x2 * y))


def point_in_ring(p: Sequence[float], ring: np.ndarray) -> bool:
    """Even-odd ray cast; boundary points are implementation-defined (the
    union classifier only ever queries points offset off boundaries)."""
    r = open_ring(np.asarray(ring, np.float64))
    if len(r) < 3:
        return False
    x, y = float(p[0]), float(p[1])
    x1, y1 = r[:, 0], r[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    cond = (y1 > y) != (y2 > y)
    dy = np.where(y2 - y1 == 0.0, 1.0, y2 - y1)
    xint = x1 + (y - y1) * (x2 - x1) / dy
    return bool(np.count_nonzero(cond & (x < xint)) % 2)


def point_in_polygon(p: Sequence[float], poly: PolygonWithHoles) -> bool:
    ext, holes = poly
    if not point_in_ring(p, ext):
        return False
    return not any(point_in_ring(p, h) for h in holes)


def clip_ring_to_box(ring: np.ndarray, half_w: float, half_h: float
                     ) -> Optional[np.ndarray]:
    """Sutherland–Hodgman clip of a simple ring against the axis-aligned box
    [-half_w, half_w]×[-half_h, half_h]. Returns a CLOSED ring or None.

    Matches the reference's per-polygon `poly.intersection(patch)`
    (:463-464) for simple polygons; a polygon that the box splits into
    multiple parts comes back as one ring with degenerate bridges along the
    box edge — acceptable for GT purposes (the reference's −0.2 m inner
    re-clip removes box-edge artifacts downstream, :536-538)."""
    pts = open_ring(np.asarray(ring, np.float64))
    if len(pts) < 3:
        return None
    for axis, bound in ((0, half_w), (0, -half_w), (1, half_h), (1, -half_h)):
        if len(pts) < 3:
            return None
        sgn = 1.0 if bound >= 0 else -1.0
        lim = abs(bound)
        out: List[np.ndarray] = []
        prev = pts[-1]
        prev_in = sgn * prev[axis] <= lim
        for cur in pts:
            cur_in = sgn * cur[axis] <= lim
            if cur_in != prev_in:
                # in the sign-transformed coordinate u = sgn·x the boundary
                # is u = lim, so t = (lim - u_prev) / (u_cur - u_prev)
                t = (lim - sgn * prev[axis]) / (
                    sgn * cur[axis] - sgn * prev[axis])
                out.append(prev + t * (cur - prev))
            if cur_in:
                out.append(cur)
            prev, prev_in = cur, cur_in
        pts = np.asarray(out, np.float64) if out else np.zeros((0, 2))
    if len(pts) < 3 or abs(ring_area(pts)) < 1e-9:
        return None
    return close_ring(pts)


def _split_params(a0: np.ndarray, a1: np.ndarray,
                  b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """t∈(0,1) along segment (a0,a1) where it properly crosses any (b0,b1)."""
    r = a1 - a0
    d = b1 - b0
    q = b0 - a0[None, :]
    cross_rd = r[0] * d[:, 1] - r[1] * d[:, 0]
    cross_qd = q[:, 0] * d[:, 1] - q[:, 1] * d[:, 0]
    cross_qr = q[:, 0] * r[1] - q[:, 1] * r[0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = cross_qd / cross_rd
        u = cross_qr / cross_rd
    ok = (
        (np.abs(cross_rd) > 1e-12)
        & (t > 1e-9) & (t < 1 - 1e-9)
        & (u > -1e-9) & (u < 1 + 1e-9)
    )
    return np.sort(t[ok])


class _SnapIndex:
    """Endpoint → segment lookup with tolerance (neighbor-bin search)."""

    def __init__(self, tol: float) -> None:
        self.tol = tol
        self.bins: defaultdict = defaultdict(list)

    def _key(self, p: np.ndarray) -> Tuple[int, int]:
        return (int(np.floor(p[0] / self.tol)), int(np.floor(p[1] / self.tol)))

    def add(self, p: np.ndarray, item) -> None:
        self.bins[self._key(p)].append((np.asarray(p), item))

    def find(self, p: np.ndarray, accept=None):
        kx, ky = self._key(p)
        best = None
        best_d = self.tol
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for q, item in self.bins.get((kx + dx, ky + dy), ()):
                    if accept is not None and not accept(item):
                        continue
                    d = float(np.hypot(q[0] - p[0], q[1] - p[1]))
                    if d < best_d:
                        best, best_d = item, d
        return best


def _chain_segments(segments: List[np.ndarray], tol: float
                    ) -> List[np.ndarray]:
    """Chain (2,2) segments into polylines/rings by endpoint proximity."""
    index = _SnapIndex(tol)
    for i, s in enumerate(segments):
        index.add(s[0], (i, 0))
        index.add(s[1], (i, 1))
    used = [False] * len(segments)

    def take(p: np.ndarray) -> Optional[Tuple[int, int]]:
        return index.find(p, accept=lambda item: not used[item[0]])

    chains = []
    for i in range(len(segments)):
        if used[i]:
            continue
        used[i] = True
        chain = [segments[i][0], segments[i][1]]
        while True:  # extend forward
            hit = take(chain[-1])
            if hit is None:
                break
            j, e = hit
            used[j] = True
            chain.append(segments[j][1 - e])
            if np.hypot(*(chain[-1] - chain[0])) < tol:
                break
        if np.hypot(*(chain[-1] - chain[0])) >= tol:
            while True:  # extend backward
                hit = take(chain[0])
                if hit is None:
                    break
                j, e = hit
                used[j] = True
                chain.insert(0, segments[j][1 - e])
                if np.hypot(*(chain[-1] - chain[0])) < tol:
                    break
        arr = np.asarray(chain)
        if np.hypot(*(arr[-1] - arr[0])) < tol and len(arr) >= 4:
            arr = np.concatenate([arr[:-1], arr[:1]])  # snap-close
        chains.append(arr)
    return chains


def union_exterior_contours(
    polygons: Sequence[PolygonWithHoles], tol: float = 1e-6
) -> List[np.ndarray]:
    """Exterior rings of unary_union(polygons) — reference :530-534
    (`unary_union` then `poly.exterior` per union component, holes dropped).

    Edge-classification construction: a boundary point of the union is a
    boundary point of some input polygon with union-interior on exactly one
    side. Shared edges between adjacent polygons (lane/road_segment tile
    edges) have interior on both sides and vanish, exactly as in the
    boolean union.
    """
    polys = [
        (open_ring(np.asarray(e, np.float64)),
         [open_ring(np.asarray(h, np.float64)) for h in hs])
        for e, hs in polygons
    ]
    polys = [(e, hs) for e, hs in polys if len(e) >= 3]
    if not polys:
        return []

    # ring inventory: (poly_idx, ring_pts)
    rings: List[Tuple[int, np.ndarray]] = []
    for pi, (ext, holes) in enumerate(polys):
        rings.append((pi, ext))
        for h in holes:
            if len(h) >= 3:
                rings.append((pi, h))

    # flat edge arrays per polygon (for crossing queries)
    edges_by_poly: List[Tuple[np.ndarray, np.ndarray]] = []
    for pi, (ext, holes) in enumerate(polys):
        e0s, e1s = [], []
        for r in [ext] + holes:
            if len(r) >= 3:
                e0s.append(r)
                e1s.append(np.roll(r, -1, axis=0))
        edges_by_poly.append((np.concatenate(e0s), np.concatenate(e1s)))

    def inside_union(p: np.ndarray, skip: int = -1) -> bool:
        return any(
            point_in_polygon(p, poly)
            for i, poly in enumerate(polys) if i != skip
        )

    # scale-aware epsilons
    span = max(
        float(np.ptp(np.concatenate([r for _, r in rings]), axis=0).max()),
        1.0,
    )
    off = max(span * 1e-7, 1e-7)
    snap = max(span * 1e-9, tol)

    kept: List[np.ndarray] = []
    seen = set()
    for pi, ring in rings:
        e0 = ring
        e1 = np.roll(ring, -1, axis=0)
        for a0, a1 in zip(e0, e1):
            seg_len = float(np.hypot(*(a1 - a0)))
            if seg_len < snap:
                continue
            ts = [0.0]
            for pj, (b0, b1) in enumerate(edges_by_poly):
                if pj == pi:
                    continue
                ts.extend(_split_params(a0, a1, b0, b1).tolist())
            ts.append(1.0)
            ts = np.unique(np.asarray(ts))
            for t0, t1 in zip(ts[:-1], ts[1:]):
                if (t1 - t0) * seg_len < snap:
                    continue
                p0 = a0 + t0 * (a1 - a0)
                p1 = a0 + t1 * (a1 - a0)
                m = 0.5 * (p0 + p1)
                d = (p1 - p0) / np.hypot(*(p1 - p0))
                n = np.array([-d[1], d[0]])
                # union-boundary test: interior on exactly one side. The
                # owning polygon counts too (its own interior is one side).
                side_a = inside_union(m + off * n)
                side_b = inside_union(m - off * n)
                if side_a == side_b:
                    continue
                key = tuple(
                    sorted((
                        (round(p0[0] / snap), round(p0[1] / snap)),
                        (round(p1[0] / snap), round(p1[1] / snap)),
                    ))
                )
                if key in seen:  # duplicate shared edge
                    continue
                seen.add(key)
                kept.append(np.stack([p0, p1]))

    out: List[np.ndarray] = []
    for chain in _chain_segments(kept, max(snap * 10, 1e-5)):
        if len(chain) < 3:
            continue
        if not ring_is_closed(chain):
            # fp leftovers: keep open contour pieces (still valid boundary
            # polylines for GT) rather than dropping geometry
            out.append(chain)
            continue
        # drop hole rings: a union-exterior ring encloses union interior
        r = open_ring(chain)
        seg = np.argmax(np.hypot(*(np.roll(r, -1, axis=0) - r).T))
        a, b = r[seg], np.roll(r, -1, axis=0)[seg]
        m = 0.5 * (a + b)
        d = (b - a) / max(np.hypot(*(b - a)), 1e-12)
        n = np.array([-d[1], d[0]])
        probe = m + off * n if point_in_ring(m + off * n, chain) else m - off * n
        if inside_union(probe):
            out.append(chain)
    return out


def simplify_line(pts: np.ndarray, tol: float) -> np.ndarray:
    """Douglas–Peucker (reference v2 centerline `simplify(0.2)`,
    nuscenes_det_mapv2_dataset.py:260)."""
    pts = np.asarray(pts, np.float64)
    if len(pts) <= 2:
        return pts
    keep = np.zeros(len(pts), bool)
    keep[[0, -1]] = True
    stack = [(0, len(pts) - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 <= i0 + 1:
            continue
        a, b = pts[i0], pts[i1]
        ab = b - a
        denom = max(float(np.hypot(*ab)), 1e-12)
        rel = pts[i0 + 1:i1] - a
        dist = np.abs(rel[:, 0] * ab[1] - rel[:, 1] * ab[0]) / denom
        k = int(np.argmax(dist))
        if dist[k] > tol:
            mid = i0 + 1 + k
            keep[mid] = True
            stack.append((i0, mid))
            stack.append((mid, i1))
    return pts[keep]
