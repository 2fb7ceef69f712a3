"""Vectorized-map mAP evaluator (MapTR protocol), pure numpy.

A copy of the JAX package's evaluation/map_eval.py; a test holds it equal
to the original.

Parity: datasets/map_utils/ (reference file:line):
- resample to 100 pts along arc length: mean_ap.py:92-110 (_resample_line)
- pairwise polyline score: tpfp_chamfer.py:19-97 (chamfer = −mean symmetric
  min point distance; iou = buffered-polyline IoU)
- one-GT-matched-once greedy TP/FP by descending score: tpfp.py:8-73
- AP = area under max-interpolated PR: mean_ap.py:52-89
- thresholds: chamfer {0.5, 1.0, 1.5}, iou 0.5:0.05:0.95, final metric =
  mean over thresholds (nuscenes_det_occ_map_dataset.py:662-731)

Deviations from the shapely implementation (shapely is unavailable here):
- The STRtree buffered-intersection prefilter is dropped for chamfer — it is
  provably lossless for thresholds ≤ 2·linewidth (if the radius-2 buffers
  don't intersect, every point distance > 4 ⇒ chamfer > 4 > 1.5).
- Buffered-polyline IoU is computed by rasterizing the flat-cap/mitre-join
  buffer as a distance field on a 0.05 m grid (exact chamfer path is
  untouched). Documented in DEVIATIONS.md.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

MAP_CLASSES = ("divider", "ped_crossing", "boundary")
CHAMFER_THRESHOLDS = (0.5, 1.0, 1.5)
IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 0.96, 0.05), 2).tolist())


def resample_line(pts: np.ndarray, num: int) -> np.ndarray:
    """Arc-length uniform resampling (shapely interpolate parity)."""
    pts = np.asarray(pts, np.float64)
    if pts.shape[0] == num:
        return pts.astype(np.float32)
    if pts.shape[0] < 2:
        p = pts[0] if pts.shape[0] == 1 else np.zeros((2,))
        return np.repeat(p[None], num, axis=0).astype(np.float32)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    total = cum[-1]
    if total <= 1e-6:
        return np.repeat(pts[:1], num, axis=0).astype(np.float32)
    targets = np.linspace(0.0, total, num)
    idx = np.clip(np.searchsorted(cum, targets, side="right") - 1, 0,
                  len(seg) - 1)
    t = (targets - cum[idx]) / np.maximum(seg[idx], 1e-12)
    out = pts[idx] + (pts[idx + 1] - pts[idx]) * t[:, None]
    return out.astype(np.float32)


def chamfer_score_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(N, P, 2) × (M, P, 2) -> (N, M) negative symmetric chamfer."""
    if pred.shape[0] == 0 or gt.shape[0] == 0:
        return np.full((pred.shape[0], gt.shape[0]), -100.0)
    d = np.linalg.norm(
        pred[:, None, :, None, :] - gt[None, :, None, :, :], axis=-1
    )  # (N, M, P_pred, P_gt)
    ab = d.min(axis=3).mean(axis=2)
    ba = d.min(axis=2).mean(axis=2)
    return -(ab + ba) / 2.0


def _segment_distance_field(line: np.ndarray, xs, ys) -> np.ndarray:
    """Min distance from each grid point to the polyline segments."""
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([gx.reshape(-1), gy.reshape(-1)], axis=1)  # (G, 2)
    a = line[:-1]  # (S, 2)
    b = line[1:]
    ab = b - a
    denom = np.maximum((ab**2).sum(1), 1e-12)  # (S,)
    ap = pts[:, None, :] - a[None, :, :]       # (G, S, 2)
    t = np.clip((ap * ab[None]).sum(-1) / denom[None], 0.0, 1.0)
    proj = a[None] + t[..., None] * ab[None]
    d = np.linalg.norm(pts[:, None, :] - proj, axis=-1).min(axis=1)
    return d.reshape(len(xs), len(ys))


def buffered_iou(pred: np.ndarray, gt: np.ndarray, linewidth: float = 1.0,
                 resolution: float = 0.05) -> float:
    """Rasterized IoU of the two buffered polylines (round-cap approx of the
    flat-cap shapely buffer; error is O(resolution))."""
    lo = np.minimum(pred.min(0), gt.min(0)) - linewidth - resolution
    hi = np.maximum(pred.max(0), gt.max(0)) + linewidth + resolution
    nx = min(int(np.ceil((hi[0] - lo[0]) / resolution)) + 1, 2000)
    ny = min(int(np.ceil((hi[1] - lo[1]) / resolution)) + 1, 2000)
    xs = lo[0] + np.arange(nx) * resolution
    ys = lo[1] + np.arange(ny) * resolution
    in_pred = _segment_distance_field(pred, xs, ys) <= linewidth
    in_gt = _segment_distance_field(gt, xs, ys) <= linewidth
    union = np.logical_or(in_pred, in_gt).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(in_pred, in_gt).sum() / union)


def polyline_score(pred_lines: np.ndarray, gt_lines: np.ndarray,
                   linewidth: float = 1.0, metric: str = "chamfer"
                   ) -> np.ndarray:
    """(N, P, 2) × (M, P, 2) -> (N, M) score, higher better."""
    N, M = pred_lines.shape[0], gt_lines.shape[0]
    if metric == "chamfer":
        return chamfer_score_matrix(pred_lines, gt_lines)
    score = np.zeros((N, M))
    for i in range(N):
        for j in range(M):
            # bbox prefilter (replaces STRtree)
            if (pred_lines[i].min(0) > gt_lines[j].max(0) + 2 * linewidth).any():
                continue
            if (pred_lines[i].max(0) < gt_lines[j].min(0) - 2 * linewidth).any():
                continue
            score[i, j] = buffered_iou(pred_lines[i], gt_lines[j], linewidth)
    return score


def tpfp_gen(gen_lines: np.ndarray, gt_lines: np.ndarray,
             threshold: float = 0.5, metric: str = "chamfer"
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-sample TP/FP flags (tpfp.py:8-73). gen_lines (N, P*2+1) with
    trailing score; gt_lines (M, P*2)."""
    num_gens, num_gts = gen_lines.shape[0], gt_lines.shape[0]
    tp = np.zeros((num_gens,), np.float32)
    fp = np.zeros((num_gens,), np.float32)
    if num_gens == 0:
        return tp, fp
    if num_gts == 0:
        fp[:] = 1.0
        return tp, fp
    scores = gen_lines[:, -1]
    pred_pts = gen_lines[:, :-1].reshape(num_gens, -1, 2)
    gt_pts = gt_lines.reshape(num_gts, -1, 2)
    mat = polyline_score(pred_pts, gt_pts, linewidth=2.0, metric=metric)
    thr = -threshold if metric == "chamfer" else threshold
    matched = mat.max(axis=1) >= thr
    best_gt = mat.argmax(axis=1)
    gt_covered = np.zeros((num_gts,), bool)
    for i in np.argsort(-scores).tolist():
        if not matched[i]:
            fp[i] = 1.0
            continue
        g = int(best_gt[i])
        if not gt_covered[g]:
            gt_covered[g] = True
            tp[i] = 1.0
        else:
            fp[i] = 1.0
    return tp, fp


def average_precision(recalls: np.ndarray, precisions: np.ndarray) -> float:
    """'area' mode AP (mean_ap.py:52-89)."""
    mrec = np.concatenate([[0.0], recalls, [1.0]])
    mpre = np.concatenate([[0.0], precisions, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def format_by_class(
    results: Sequence[dict],
    annotations: Sequence[dict],
    num_classes: int = 3,
    num_sample_pts: int = 100,
    score_threshold: float = 0.0,
) -> Tuple[List[List[np.ndarray]], List[List[np.ndarray]]]:
    """Per class: per-sample (N, 100*2+1) prediction arrays (score appended)
    and (M, 100*2) GT arrays. `results[i]` = {vectors (N,P,2), scores (N,),
    labels (N,), [valid (N,)]}; `annotations[i]` = {vectors: list[(P_i, 2)],
    labels (M,)}."""
    cls_gens: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    cls_gts: List[List[np.ndarray]] = [[] for _ in range(num_classes)]
    for res, ann in zip(results, annotations):
        vectors = np.asarray(res["vectors"], np.float64)
        scores = np.asarray(res["scores"], np.float64)
        labels = np.asarray(res["labels"])
        valid = np.asarray(res.get("valid", np.ones(len(scores), bool)))
        valid = valid & (scores > score_threshold)
        gt_vec = ann["vectors"]
        gt_lab = np.asarray(ann["labels"])
        for c in range(num_classes):
            sel = valid & (labels == c)
            gens = []
            for v, s in zip(vectors[sel], scores[sel]):
                line = resample_line(v, num_sample_pts).reshape(-1)
                gens.append(np.concatenate([line, [s]]))
            cls_gens[c].append(
                np.stack(gens) if gens else
                np.zeros((0, num_sample_pts * 2 + 1), np.float32))
            gts = [
                resample_line(np.asarray(g), num_sample_pts).reshape(-1)
                for g, l in zip(gt_vec, gt_lab) if l == c
            ]
            cls_gts[c].append(
                np.stack(gts) if gts else
                np.zeros((0, num_sample_pts * 2), np.float32))
    return cls_gens, cls_gts


def eval_map_threshold(cls_gens, cls_gts, threshold: float,
                       metric: str = "chamfer") -> Tuple[float, List[dict]]:
    """mAP at one threshold (mean_ap.py:252-328)."""
    out = []
    for gens_per_sample, gts_per_sample in zip(cls_gens, cls_gts):
        tpfp = [tpfp_gen(g, t, threshold, metric)
                for g, t in zip(gens_per_sample, gts_per_sample)]
        num_gts = sum(t.shape[0] for t in gts_per_sample)
        dets = (np.vstack(gens_per_sample) if gens_per_sample
                else np.zeros((0, 1)))
        if dets.shape[0] == 0:
            out.append({"num_gts": num_gts, "num_dets": 0, "ap": 0.0})
            continue
        order = np.argsort(-dets[:, -1])
        tp = np.concatenate([t for t, _ in tpfp])[order]
        fp = np.concatenate([f for _, f in tpfp])[order]
        tp_cum, fp_cum = np.cumsum(tp), np.cumsum(fp)
        eps = np.finfo(np.float32).eps
        recalls = tp_cum / max(num_gts, eps)
        precisions = tp_cum / np.maximum(tp_cum + fp_cum, eps)
        out.append({
            "num_gts": num_gts, "num_dets": int(dets.shape[0]),
            "ap": average_precision(recalls, precisions),
        })
    aps = [r["ap"] for r in out if r["num_gts"] > 0]
    return (float(np.mean(aps)) if aps else 0.0), out


def evaluate_map(
    results: Sequence[dict],
    annotations: Sequence[dict],
    class_names: Sequence[str] = MAP_CLASSES,
    metrics: Sequence[str] = ("chamfer",),
) -> Dict[str, float]:
    """Full protocol: mean over thresholds per metric
    (nuscenes_det_occ_map_dataset.py:696-729)."""
    cls_gens, cls_gts = format_by_class(results, annotations,
                                        num_classes=len(class_names))
    summary: Dict[str, float] = {}
    for metric in metrics:
        thresholds = CHAMFER_THRESHOLDS if metric == "chamfer" else IOU_THRESHOLDS
        per_thr_aps = []
        per_cls = np.zeros((len(thresholds), len(class_names)))
        for ti, thr in enumerate(thresholds):
            mean_ap, out = eval_map_threshold(cls_gens, cls_gts, thr, metric)
            per_thr_aps.append(mean_ap)
            per_cls[ti] = [r["ap"] for r in out]
        summary[f"NuscMap_{metric}/mAP"] = float(np.mean(per_thr_aps))
        for ci, name in enumerate(class_names):
            summary[f"NuscMap_{metric}/{name}_AP"] = float(per_cls[:, ci].mean())
    return summary
