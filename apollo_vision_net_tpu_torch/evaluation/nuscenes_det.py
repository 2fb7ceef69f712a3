"""nuScenes detection metrics: mAP over center-distance thresholds + TP
errors (ATE/ASE/AOE/AVE/AAE) + NDS, pure numpy.

A copy of the JAX package's evaluation/nuscenes_det.py; a test holds it
equal to the original.

Reimplements the official nuScenes detection protocol (the reference wraps
the devkit via NuScenesEval_custom, datasets/nuscnes_eval.py:75-812; the
devkit itself is not installed here):
- match by BEV center distance, thresholds {0.5, 1, 2, 4} m
- greedy matching in descending score; one GT matched once
- AP = mean interpolated precision over 101 recall points, clipped at
  min_recall=0.1 / min_precision=0.1, normalized by (1-0.1)
- TP errors computed on matches at the 2.0 m threshold, averaged over the
  recall range [0.1, max_recall]
- NDS = (5·mAP + Σ₅ (1 − min(1, tp_err))) / 10
- per-class GT/pred range filtering (class_range from the official config)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

DETECTION_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)
DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_DIST_THRESHOLD = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
# AOE is undefined for cones; AVE/AAE undefined for cones+barriers
ATTR_IRRELEVANT = {"traffic_cone", "barrier"}
ORIENT_IRRELEVANT = {"traffic_cone"}
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")


def _yaw_diff(a: float, b: float, period: float = 2 * np.pi) -> float:
    d = (a - b) % period
    if d > period / 2:
        d = period - d
    return abs(d)


def _scale_iou(wlh_a: np.ndarray, wlh_b: np.ndarray) -> float:
    """Aligned-box IoU (devkit scale_iou)."""
    mins = np.minimum(wlh_a, wlh_b)
    inter = np.prod(mins)
    union = np.prod(wlh_a) + np.prod(wlh_b) - inter
    return float(inter / union) if union > 0 else 0.0


def accumulate_class(
    gts: Sequence[dict], preds: Sequence[dict], class_name: str,
    dist_th: float,
) -> dict:
    """Per-class, per-threshold accumulation (devkit `accumulate`).

    gts/preds: per-sample dicts with keys 'translation' (N,3), 'size' (N,3
    wlh), 'yaw' (N,), 'velocity' (N,2), 'label' (N,) str-index, 'score'
    (preds), 'attr' (optional str list), 'ego_translation_xy' distance
    already applied by the caller's range filter.
    """
    npos = sum(int((np.asarray(g["names"]) == class_name).sum()) for g in gts)
    # flatten predictions of this class
    rows = []
    for si, p in enumerate(preds):
        names = np.asarray(p["names"])
        for i in np.where(names == class_name)[0]:
            rows.append((float(p["scores"][i]), si, int(i)))
    rows.sort(key=lambda r: -r[0])

    if npos == 0 or len(rows) == 0:
        return dict(npos=npos, ndet=len(rows), tp=np.zeros(len(rows)),
                    fp=np.ones(len(rows)), conf=np.array([r[0] for r in rows]),
                    match_errs=[])

    taken = [np.zeros(len(np.asarray(g["names"])), bool) for g in gts]
    tp = np.zeros(len(rows))
    fp = np.zeros(len(rows))
    conf = np.zeros(len(rows))
    match_errs: List[dict] = []
    for k, (score, si, pi) in enumerate(rows):
        conf[k] = score
        g = gts[si]
        names = np.asarray(g["names"])
        cand = np.where((names == class_name) & (~taken[si]))[0]
        if cand.size:
            d = np.linalg.norm(
                np.asarray(g["translation"])[cand, :2]
                - np.asarray(preds[si]["translation"])[pi, :2], axis=1)
            j = int(np.argmin(d))
            if d[j] < dist_th:
                gi = int(cand[j])
                taken[si][gi] = True
                tp[k] = 1.0
                err = dict(
                    trans_err=float(d[j]),
                    scale_err=1.0 - _scale_iou(
                        np.asarray(g["size"])[gi],
                        np.asarray(preds[si]["size"])[pi]),
                    orient_err=(
                        0.0 if class_name in ORIENT_IRRELEVANT else _yaw_diff(
                            float(np.asarray(g["yaw"])[gi]),
                            float(np.asarray(preds[si]["yaw"])[pi]),
                            period=np.pi if class_name == "barrier"
                            else 2 * np.pi)),
                    vel_err=(
                        0.0 if class_name in ATTR_IRRELEVANT else float(
                            np.linalg.norm(
                                np.asarray(g["velocity"])[gi, :2]
                                - np.asarray(preds[si]["velocity"])[pi, :2]))),
                    attr_err=(
                        0.0 if class_name in ATTR_IRRELEVANT else float(
                            np.asarray(g.get("attrs", names))[gi]
                            != np.asarray(
                                preds[si].get("attrs", names))[pi])),
                )
                match_errs.append(err)
                continue
        fp[k] = 1.0
    return dict(npos=npos, ndet=len(rows), tp=tp, fp=fp, conf=conf,
                match_errs=match_errs)


def _metric_curves(acc: dict) -> dict:
    """101-point interpolated precision + cummean TP error curves."""
    npos = acc["npos"]
    out = {"precision": np.zeros(101), "max_recall": 0.0}
    for m in TP_METRICS:
        out[m] = np.ones(101)
    if npos == 0 or acc["ndet"] == 0:
        return out
    tp_cum = np.cumsum(acc["tp"])
    fp_cum = np.cumsum(acc["fp"])
    rec = tp_cum / npos
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    rec_interp = np.linspace(0, 1, 101)
    out["precision"] = np.interp(rec_interp, rec, prec, right=0)
    out["max_recall"] = float(rec[-1]) if len(rec) else 0.0
    if acc["match_errs"]:
        match_rec = rec[acc["tp"] > 0]
        for m in TP_METRICS:
            errs = np.array([e[m] for e in acc["match_errs"]])
            cummean = np.cumsum(errs) / (np.arange(len(errs)) + 1)
            out[m] = np.interp(rec_interp, match_rec, cummean, right=1.0)
    return out


def _calc_ap(curves: dict) -> float:
    prec = np.copy(curves["precision"])[round(100 * MIN_RECALL) + 1:]
    prec -= MIN_PRECISION
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - MIN_PRECISION)


def _calc_tp(curves: dict, metric: str) -> float:
    first = round(100 * MIN_RECALL) + 1
    last = int(round(100 * curves["max_recall"]))
    if last < first:
        return 1.0
    return float(np.mean(curves[metric][first:last + 1]))


def filter_by_range(sample: dict, is_gt: bool) -> dict:
    """Per-class ego-distance range filter (devkit filter_eval_boxes)."""
    names = np.asarray(sample["names"])
    t = np.asarray(sample["translation"])
    ego = np.asarray(sample.get("ego_translation", np.zeros(3)))
    dist = np.linalg.norm(t[:, :2] - ego[None, :2], axis=1)
    keep = np.array([
        d <= CLASS_RANGE.get(str(n), 50.0) for n, d in zip(names, dist)
    ], bool) if len(names) else np.zeros(0, bool)
    out = {}
    for k, v in sample.items():
        arr = np.asarray(v)
        out[k] = arr[keep] if arr.ndim >= 1 and len(arr) == len(keep) else v
    return out


def _mask_sample(sample: dict, keep: np.ndarray) -> dict:
    """Slice every per-box array field of a sample record by `keep`."""
    out = {}
    for k, v in sample.items():
        arr = np.asarray(v)
        out[k] = arr[keep] if arr.ndim >= 1 and len(arr) == len(keep) else v
    return out


def filter_by_visibility(gts: Sequence[dict], visibility) -> List[dict]:
    """Keep GT boxes whose visibility token matches (reference
    filter_eval_boxes_by_visibility, nuscnes_eval.py:455-484). Records
    without a 'visibility' field pass through unchanged."""
    vis_set = {str(v) for v in (
        visibility if isinstance(visibility, (list, tuple, set))
        else [visibility])}
    out = []
    for g in gts:
        if "visibility" not in g:
            out.append(g)
            continue
        vis = np.asarray([str(v) for v in g["visibility"]])
        out.append(_mask_sample(g, np.isin(vis, list(vis_set))))
    return out


def filter_by_tokens(gts: Sequence[dict], keep_tokens) -> List[dict]:
    """Keep GT boxes by annotation token (reference
    filter_eval_boxes_by_id, nuscnes_eval.py:423-452)."""
    keep_tokens = set(keep_tokens)
    out = []
    for g in gts:
        if "tokens" not in g:
            out.append(g)
            continue
        keep = np.asarray([t in keep_tokens for t in g["tokens"]], bool)
        out.append(_mask_sample(g, keep))
    return out


def filter_by_sample_token(
    gts: Sequence[dict], preds: Sequence[dict],
    sample_tokens: Sequence[str], valid_sample_tokens,
):
    """Drop whole samples outside the valid set (reference
    filter_by_sample_token, nuscnes_eval.py:487-492)."""
    valid = set(valid_sample_tokens)
    kept = [i for i, t in enumerate(sample_tokens) if t in valid]
    return ([gts[i] for i in kept], [preds[i] for i in kept],
            [sample_tokens[i] for i in kept])


def filter_by_overlap(
    gts: Sequence[dict],
    lidar2img: Sequence[np.ndarray],     # per sample (N_cam, 4, 4)
    img_hw,                              # (H, W) or per-sample list
    min_cams: int = 2,
) -> List[dict]:
    """Keep GT boxes whose center is visible in >= min_cams cameras
    (reference filter_eval_boxes_by_overlap, nuscnes_eval.py:495-566:
    center_in_image per camera, kept when count > 1). Expects records
    carrying lidar-frame centers as 'translation_lidar' (N, 3); records
    without it pass through."""
    out = []
    for si, g in enumerate(gts):
        if "translation_lidar" not in g:
            out.append(g)
            continue
        centers = np.asarray(g["translation_lidar"], np.float64)
        mats = np.asarray(lidar2img[si], np.float64)
        hw = img_hw[si] if isinstance(img_hw, (list, tuple)) and \
            not np.isscalar(img_hw[0]) else img_hw
        h, w = float(hw[0]), float(hw[1])
        xyz1 = np.concatenate(
            [centers, np.ones((len(centers), 1))], axis=-1)
        proj = np.einsum("cij,nj->cni", mats, xyz1)  # (N_cam, N, 4)
        depth = proj[..., 2]
        uv = proj[..., :2] / np.clip(depth[..., None], 1e-5, None)
        vis = (
            (depth > 1e-5)
            & (uv[..., 0] >= 0) & (uv[..., 0] <= w - 1)
            & (uv[..., 1] >= 0) & (uv[..., 1] <= h - 1)
        )
        count = vis.sum(axis=0)  # cameras seeing each center
        out.append(_mask_sample(g, count >= min_cams))
    return out


def evaluate_detection(
    gts: Sequence[dict], preds: Sequence[dict],
    class_names: Sequence[str] = DETECTION_CLASSES,
    *,
    gt_visibility=None,
    valid_sample_tokens=None,
    sample_tokens: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """Full NDS/mAP evaluation over per-sample GT/pred dicts.

    Optional GT-filter variants from the custom protocol
    (nuscnes_eval.py:423-566): `gt_visibility` keeps only GT at the given
    visibility level(s); `valid_sample_tokens` (+`sample_tokens`)
    restricts evaluation to a sample subset."""
    if valid_sample_tokens is not None:
        toks = list(sample_tokens if sample_tokens is not None
                    else range(len(gts)))
        gts, preds, _ = filter_by_sample_token(
            gts, preds, toks, valid_sample_tokens)
    if gt_visibility is not None:
        gts = filter_by_visibility(gts, gt_visibility)
    gts = [filter_by_range(g, True) for g in gts]
    preds = [filter_by_range(p, False) for p in preds]

    aps = np.zeros((len(class_names), len(DIST_THRESHOLDS)))
    tp_errs = {m: np.zeros(len(class_names)) for m in TP_METRICS}
    for ci, cname in enumerate(class_names):
        for ti, th in enumerate(DIST_THRESHOLDS):
            acc = accumulate_class(gts, preds, cname, th)
            curves = _metric_curves(acc)
            aps[ci, ti] = _calc_ap(curves)
            if th == TP_DIST_THRESHOLD:
                for m in TP_METRICS:
                    tp_errs[m][ci] = _calc_tp(curves, m)

    mean_ap = float(aps.mean())
    out = {"mean_ap": mean_ap}
    for ci, cname in enumerate(class_names):
        out[f"{cname}_AP"] = float(aps[ci].mean())
    tp_scores = []
    for m in TP_METRICS:
        # devkit averages over classes where the metric is defined
        defined = [
            ci for ci, c in enumerate(class_names)
            if not (m == "orient_err" and c in ORIENT_IRRELEVANT)
            and not (m in ("vel_err", "attr_err") and c in ATTR_IRRELEVANT)
        ]
        val = float(np.mean([tp_errs[m][ci] for ci in defined]))
        out[m] = val
        tp_scores.append(max(0.0, 1.0 - min(1.0, val)))
    out["NDS"] = float((5 * mean_ap + sum(tp_scores)) / 10.0)
    return out
