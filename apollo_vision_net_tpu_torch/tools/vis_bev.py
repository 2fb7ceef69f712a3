"""BEV detection and map visualization: boxes and vector-map polylines in
the ego frame, drawn to a PNG with PIL.

Counterpart of the JAX package's tools/vis_bev.py (reference
analysis_tools/vis_det_bev_single.py + vis_map_pred_single.py), which
draws with matplotlib; the geometry (``box_corners``) is the same. x runs
right and y up, over ``pc_range``; the ego is the black triangle at the
centre, detections red, GT boxes gray, map vectors coloured by class
(``MAP_COLORS``). It reads the pickle that ``tools/test.py --dump-pickle``
writes and runs no model.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.vis_bev RESULTS.pkl
      [--index 0] [--out bev.png] [--score-thr 0.3]
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

# matplotlib's tab10 orange, blue, green and purple
MAP_COLORS = {0: (255, 127, 14), 1: (31, 119, 180), 2: (44, 160, 44),
              3: (148, 103, 189)}
DET_COLOR = (214, 39, 40)
GT_COLOR = (128, 128, 128)
TITLE = "BEV det (red) / GT (gray) / map vectors"
TITLE_ROWS = 16
PC_RANGE = (-50, -50, -5, 50, 50, 3)


def box_corners(b: np.ndarray) -> np.ndarray:
    """(>= 7,) box (cx, cy, cz, w, l, h, yaw, ...) -> (4, 2) BEV corners."""
    cx, cy, w, l, yaw = b[0], b[1], b[3], b[4], b[6]
    dx, dy = l / 2, w / 2
    pts = np.array([[-dx, -dy], [-dx, dy], [dx, dy], [dx, -dy]])
    c, s = np.cos(yaw), np.sin(yaw)
    rot = pts @ np.array([[c, s], [-s, c]])
    return rot + [cx, cy]


def to_pixels(xy: np.ndarray, pc_range, size: int) -> list:
    """(n, 2) ego-frame metres -> [(col, row)] on a ``size`` square canvas
    below the title band: x right, y up."""
    xy = np.asarray(xy, np.float64)
    col = (xy[:, 0] - pc_range[0]) / (pc_range[3] - pc_range[0]) * size
    row = (pc_range[4] - xy[:, 1]) / (pc_range[4] - pc_range[1]) * size + TITLE_ROWS
    return list(zip(col.tolist(), row.tolist()))


def det_boxes(det: dict) -> np.ndarray:
    """A detection record's 9-dim boxes: ``boxes``, or the evaluator
    record's translation / size / yaw columns."""
    if "boxes" in det:
        return np.asarray(det["boxes"])
    return np.concatenate([np.asarray(det["translation"]), np.asarray(det["size"]),
                           np.asarray(det["yaw"])[:, None]], axis=1)


def kept(det: dict, score_thr: float) -> np.ndarray:
    keep = np.asarray(det["scores"]) > score_thr
    if "valid" in det:
        keep &= np.asarray(det["valid"], bool)
    return keep


def render_bev(det=None, map_res=None, gt_boxes=None, pc_range=PC_RANGE,
               out_path="bev.png", score_thr=0.3, size: int = 800):
    """Draw and save the BEV picture (``size`` x ``size`` below a
    ``TITLE_ROWS`` title band); returns the PIL image."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (size, size + TITLE_ROWS), "white")
    draw = ImageDraw.Draw(img)
    draw.text((4, 2), TITLE, fill="black")
    (ex, ey), = to_pixels([[0.0, 0.0]], pc_range, size)
    draw.polygon([(ex, ey - 8), (ex - 6, ey + 6), (ex + 6, ey + 6)], fill="black")
    if gt_boxes is not None:
        for b in np.asarray(gt_boxes):
            draw.polygon(to_pixels(box_corners(b), pc_range, size), outline=GT_COLOR)
    if det is not None:
        keep = kept(det, score_thr)
        for b in det_boxes(det)[keep]:
            draw.polygon(to_pixels(box_corners(b), pc_range, size),
                         outline=DET_COLOR, width=2)
    if map_res is not None:
        for v, s, lab in zip(np.asarray(map_res["vectors"]),
                             np.asarray(map_res["scores"]),
                             np.asarray(map_res["labels"])):
            if s < score_thr:
                continue
            draw.line(to_pixels(v, pc_range, size),
                      fill=MAP_COLORS.get(int(lab), (0, 0, 0)), width=2)
    img.save(out_path)
    print(f"wrote {out_path}")
    return img


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results", help="tools/test.py --dump-pickle file")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", default="bev.png")
    p.add_argument("--score-thr", type=float, default=0.3)
    args = p.parse_args(argv)
    with open(args.results, "rb") as f:
        res = pickle.load(f)
    det = res.get("det", [None] * (args.index + 1))[args.index]
    map_res = res.get("map", [None] * (args.index + 1))
    map_res = map_res[args.index] if map_res else None
    render_bev(det=det, map_res=map_res, out_path=args.out,
               score_thr=args.score_thr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
