"""Detections and map vectors projected into the camera images
(perspective view), a grid of the cameras drawn to a PNG with PIL: the eye
for camera geometry.

Counterpart of the JAX package's tools/project_det_map_to_pv.py (reference
tools/analysis_tools/project_det_map_to_pv_single.py:40-200: box corners
and polyline points through lidar2img, the points behind a camera
dropped, a drawing a camera); the geometry (``box_corners_3d``,
``project``, ``EDGES``) is the same. Boxes and vectors come from a
``tools/test.py --dump-pickle`` file, or, without one, from a served frame
of the port's model (random weights from seed 0) on the config's
synthetic batch: the batch's last frame through
``BEVFormer.forward_test_frame`` with no history, decoded by
``nms_free_decode`` and ``get_map_results``, all scores shown (an
untrained model's are tiny). The model runs on the card unless
``--device cpu``.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.project_det_map_to_pv
      [--config bev_smoke_det_map] [--results res.pkl --index 0]
      [--out pv.png] [--device cpu]
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np
import torch

from apollo_vision_net_tpu_torch import configs
from apollo_vision_net_tpu_torch.tools.vis_bev import (
    DET_COLOR,
    MAP_COLORS,
    det_boxes,
    kept,
)

EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
GAP = 4


def box_corners_3d(b: np.ndarray) -> np.ndarray:
    """(9,) box -> (8, 3) corners; gravity-centre box, yaw about z."""
    cx, cy, cz, w, l, h, yaw = b[0], b[1], b[2], b[3], b[4], b[5], b[6]
    xs = np.array([-1, -1, 1, 1, -1, -1, 1, 1]) * (l / 2)
    ys = np.array([-1, 1, 1, -1, -1, 1, 1, -1]) * (w / 2)
    zs = np.array([-1, -1, -1, -1, 1, 1, 1, 1]) * (h / 2)
    c, s = np.cos(yaw), np.sin(yaw)
    x = xs * c - ys * s + cx
    y = xs * s + ys * c + cy
    return np.stack([x, y, zs + cz], axis=1)


def project(pts3d: np.ndarray, l2i: np.ndarray, eps: float = 1e-3):
    """(N, 3) lidar points -> (N, 2) pixels and the (N,) in-front mask."""
    hom = np.concatenate([pts3d, np.ones((len(pts3d), 1))], axis=1)
    cam = hom @ l2i.T
    depth = cam[:, 2]
    front = depth > eps
    px = cam[:, :2] / np.maximum(depth[:, None], eps)
    return px, front


def draw_frame(imgs, lidar2img, det=None, map_res=None, gt_boxes=None,
               out_path="pv.png", score_thr=0.3, scale: float = 0.5):
    """A grid of the N camera images (3 a row, each min-max normalized and
    scaled by ``scale``) with the GT boxes white, the kept detections red
    and the map vectors (on z = 0) coloured by class; saved to
    ``out_path``; returns the PIL image."""
    from PIL import Image, ImageDraw

    imgs = np.asarray(imgs, np.float32)
    N, H, W = imgs.shape[:3]
    cols = min(N, 3)
    rows = (N + cols - 1) // cols
    tw, th = round(W * scale), round(H * scale)
    out = Image.new("RGB", (cols * tw + (cols - 1) * GAP, rows * th + (rows - 1) * GAP),
                    "white")
    boxes = []
    if gt_boxes is not None:
        boxes.append((np.asarray(gt_boxes), (255, 255, 255), 1))
    if det is not None:
        boxes.append((det_boxes(det)[kept(det, score_thr)], DET_COLOR, 2))
    for n in range(N):
        im = imgs[n]
        im = (im - im.min()) / max(float(im.max() - im.min()), 1e-6)
        tile = Image.fromarray((im * 255).astype(np.uint8)).resize((tw, th))
        draw = ImageDraw.Draw(tile)
        for bs, color, width in boxes:
            for b in bs:
                px, front = project(box_corners_3d(np.asarray(b)), lidar2img[n])
                if front.sum() < 2:
                    continue
                for i, j in EDGES:
                    if front[i] and front[j]:
                        draw.line([tuple(px[i] * scale), tuple(px[j] * scale)],
                                  fill=color, width=width)
        if map_res is not None:
            for v, s, lab in zip(np.asarray(map_res["vectors"]),
                                 np.asarray(map_res["scores"]),
                                 np.asarray(map_res["labels"])):
                if s < score_thr:
                    continue
                px, front = project(np.concatenate([v, np.zeros((len(v), 1))], axis=1),
                                    lidar2img[n])
                if front.sum() >= 2:
                    draw.line([tuple(p) for p in px[front] * scale],
                              fill=MAP_COLORS.get(int(lab), (0, 0, 0)), width=2)
        draw.text((4, 2), f"cam {n}", fill="white")
        out.paste(tile, ((n % cols) * (tw + GAP), (n // cols) * (th + GAP)))
    out.save(out_path)
    print(f"wrote {out_path}")
    return out


@torch.inference_mode()
def run_model_frame(cfg, batch: dict, device=None, seed: int = 0):
    """The port's model (random weights from ``seed``) on the batch's last
    frame with no history -> (det record, map record or None), numpy."""
    from apollo_vision_net_tpu_torch.models.detector import build_model
    from apollo_vision_net_tpu_torch.models.heads.map_head import get_map_results
    from apollo_vision_net_tpu_torch.runtime.inference import POST_CENTER_RANGE
    from apollo_vision_net_tpu_torch.utils.box_coder import nms_free_decode

    model = build_model(cfg, device, seed=seed)
    dev = next(model.parameters()).device

    def last(k):
        return torch.as_tensor(batch[k][:, -1]).to(dev, torch.float32)

    outs, _ = model.forward_test_frame(
        last("img"), last("can_bus"), last("lidar2img"), model.zero_carry(1, dev),
        torch.zeros((1,), device=dev))
    d = nms_free_decode(outs["all_cls_scores"][-1, 0], outs["all_bbox_preds"][-1, 0],
                        POST_CENTER_RANGE, max_num=50,
                        num_classes=cfg.model.num_classes)
    det = dict(boxes=d.boxes.cpu().numpy(), scores=d.scores.cpu().numpy(),
               valid=d.valid.cpu().numpy())
    map_res = None
    if "map_all_cls_scores" in outs:
        mr = get_map_results(outs["map_all_cls_scores"][-1],
                             outs["map_all_pts_preds"][-1], cfg.model.pc_range)
        map_res = {k: mr[k][0].cpu().numpy() for k in ("vectors", "scores", "labels")}
    return det, map_res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="bev_smoke_det_map")
    p.add_argument("--results", default=None,
                   help="pickle with det/map records (else run the model)")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--out", default="pv.png")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    from apollo_vision_net_tpu_torch.data.synthetic import make_batch

    cfg = getattr(configs, args.config)()
    batch = make_batch(cfg, batch_size=1, seed=0)
    gt = batch["gt_boxes"][0][batch["gt_mask"][0]]
    if args.results:
        with open(args.results, "rb") as f:
            res = pickle.load(f)
        det = res.get("det", [None] * (args.index + 1))[args.index]
        mr = res.get("map") or []
        map_res = mr[args.index] if args.index < len(mr) else None
        thr = args.score_thr
    else:
        from apollo_vision_net_tpu_torch import resolve_device

        det, map_res = run_model_frame(cfg, batch, resolve_device(args.device))
        thr = -1.0  # untrained scores are tiny: show everything
    draw_frame(batch["img"][0, -1], batch["lidar2img"][0, -1], det=det,
               map_res=map_res, gt_boxes=gt, out_path=args.out, score_thr=thr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
