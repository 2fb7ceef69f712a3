"""Occupancy GT against prediction, drawn with PIL: per frame

  [ GT BEV top class | Pred BEV top class | agreement map ]

where the agreement map colours each BEV cell green (both occupied, same
class), yellow (both occupied, class differs), red (false occupied) and
blue (missed); ``--gif`` writes every frame into an animated GIF.

Counterpart of the JAX package's tools/vis_occ_pair.py (reference
tools/occ_visualization/vis_occ_pair_single.py + visualize_occ_gt.py),
which draws with matplotlib; ``_bev_top_class`` is the same reduction. It
reads the pickle that ``tools/test.py --eval iou --dump-pickle`` writes
(``{"occ": [dense class grid a frame], "gt": {"occ": [...]}}``) or two
.npy grids, and runs no model.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.vis_occ_pair RESULTS.pkl
      [--index 0] [--dims X Y Z] [--empty-label L] [--out occ_pair.png]
      [--gif]
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from apollo_vision_net_tpu_torch.tools.vis_occ import _bev_top_class, colorize, panels

# white, tab:green, gold, tab:red, tab:blue
AGREE_COLORS = np.array([(255, 255, 255), (44, 160, 44), (255, 215, 0),
                         (214, 39, 40), (31, 119, 180)], np.uint8)


def agreement(gt_bev: np.ndarray, pred_bev: np.ndarray) -> np.ndarray:
    """0 empty in both, 1 same class, 2 class differs, 3 false occupied,
    4 missed."""
    agree = np.zeros(gt_bev.shape, np.int32)
    g, p = gt_bev >= 0, pred_bev >= 0
    agree[g & p & (gt_bev == pred_bev)] = 1
    agree[g & p & (gt_bev != pred_bev)] = 2
    agree[~g & p] = 3
    agree[g & ~p] = 4
    return agree


def render_pair(gt_bev, pred_bev, out_path=None, title="", scale: int = 2):
    """The three panels (the title on the first); saved to ``out_path``
    if given; returns the PIL image."""
    img = panels([colorize(gt_bev, scale), colorize(pred_bev, scale),
                  colorize(agreement(gt_bev, pred_bev), scale, AGREE_COLORS)],
                 [f"GT {title}".strip(), "Pred", "G=match Y=class R=FP B=miss"])
    if out_path:
        img.save(out_path)
        print(f"wrote {out_path}")
    return img


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results",
                   help="tools/test.py --dump-pickle file, or a pred .npy "
                        "dense grid (then --gt is required)")
    p.add_argument("--gt", default=None, help=".npy GT grid (npy mode)")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--dims", nargs=3, type=int, default=None,
                   help="xdim ydim zdim (default: inferred square x=y)")
    p.add_argument("--empty-label", type=int, default=None,
                   help="default: max label in the GT grid")
    p.add_argument("--out", default="occ_pair.png")
    p.add_argument("--gif", action="store_true",
                   help="render every frame into an animated GIF at --out")
    args = p.parse_args(argv)

    if args.results.endswith(".npy"):
        if not args.gt:
            raise SystemExit(".npy mode requires --gt")
        preds = [np.load(args.results)]
        gts = [np.load(args.gt)]
    else:
        with open(args.results, "rb") as f:
            res = pickle.load(f)
        preds = [np.asarray(o).reshape(-1) for o in res.get("occ", [])]
        gts = [np.asarray(o).reshape(-1)
               for o in (res.get("gt") or {}).get("occ", [])]
        if not preds or not gts:
            raise SystemExit("results pickle has no occ preds + GT "
                             "(run tools/test.py --eval iou --dump-pickle)")

    empty = (args.empty_label if args.empty_label is not None
             else int(max(g.max() for g in gts)))
    if args.dims:
        dims = tuple(args.dims)
    else:  # a square BEV, z what is left
        n = preds[0].size
        xy = int(np.sqrt(n))
        while n % (xy * xy) and xy > 1:
            xy -= 1
        dims = (xy, xy, n // (xy * xy))

    def frame(i, out_path=None):
        return render_pair(_bev_top_class(gts[i], dims, empty),
                           _bev_top_class(preds[i], dims, empty),
                           out_path=out_path, title=f"frame {i}")

    if not args.gif:
        frame(args.index, args.out)
        return 0
    n = min(len(preds), len(gts))
    images = [frame(i) for i in range(n)]
    out = args.out if args.out.endswith(".gif") else args.out + ".gif"
    images[0].save(out, save_all=True, append_images=images[1:], duration=500, loop=0)
    print(f"wrote {out} ({n} frames)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
