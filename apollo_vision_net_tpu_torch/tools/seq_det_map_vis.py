"""Sequence BEV detection and map visualization: every frame of a
``tools/test.py --dump-pickle`` result stream drawn as a BEV PNG (boxes,
map polylines and GT, ``vis_bev.render_bev``), and optionally an animated
GIF of them: queue replays and scene resets of the streaming inference
show as jumps from frame to frame.

Counterpart of the JAX package's tools/seq_det_map_vis.py (reference
tools/analysis_tools/seq_det_map_vis.py); it draws with PIL and runs no
model.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.seq_det_map_vis RESULTS.pkl
      --out-dir DIR [--score-thr 0.3] [--max-frames N] [--gif]
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from apollo_vision_net_tpu_torch.tools.vis_bev import render_bev


def render_sequence(res: dict, out_dir: str, score_thr: float = 0.3,
                    max_frames: int = 0, gif: bool = False) -> list:
    """The frames' PNGs (and ``seq.gif`` with ``gif``) under ``out_dir``;
    returns the PNG paths."""
    dets = res.get("det", [])
    maps = res.get("map", [])
    gt = res.get("gt") or {}
    n = len(dets) or len(maps)
    if max_frames:
        n = min(n, max_frames)
    os.makedirs(out_dir, exist_ok=True)
    paths, images = [], []
    gt_det = gt.get("det") or []
    for i in range(n):
        gt_boxes = None
        if i < len(gt_det) and gt_det[i] is not None and "translation" in gt_det[i]:
            r = gt_det[i]
            gt_boxes = np.concatenate([np.asarray(r["translation"]),
                                       np.asarray(r["size"]),
                                       np.asarray(r["yaw"])[:, None]], axis=1)
        out = os.path.join(out_dir, f"{i:04d}.png")
        images.append(render_bev(det=dets[i] if i < len(dets) else None,
                                 map_res=maps[i] if i < len(maps) else None,
                                 gt_boxes=gt_boxes, out_path=out,
                                 score_thr=score_thr))
        paths.append(out)
    if gif and images:
        out = os.path.join(out_dir, "seq.gif")
        images[0].save(out, save_all=True, append_images=images[1:],
                       duration=500, loop=0)
        print(f"wrote {out} ({len(images)} frames)")
    return paths


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results", help="tools/test.py --dump-pickle file")
    p.add_argument("--out-dir", default="seq_vis")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--gif", action="store_true",
                   help="also write <out-dir>/seq.gif")
    args = p.parse_args(argv)
    with open(args.results, "rb") as f:
        res = pickle.load(f)
    render_sequence(res, args.out_dir, args.score_thr, args.max_frames, args.gif)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
