"""Loss and metric curves of a ``metrics.jsonl`` stream, drawn to a PNG
with PIL.

Counterpart of the JAX package's tools/plot_loss_from_log.py (reference
tools/analysis_tools/plot_loss_from_log.py), which draws with matplotlib,
over the port's ``runtime.metrics_log.read_metrics``: one line a series
against the step, ``loss_total`` (or ``NDS``, ``mean_ap``) thicker, a
legend below the plot. A bare jsonl without kind tags (the overfit tool's
curve file) is read whole. It runs no model.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.plot_loss_from_log
      <work_dir|metrics.jsonl> [--keys loss_total loss_cls ...]
      [--kind train|eval] [--out curves.png] [--logy]
"""
from __future__ import annotations

import argparse
import json
import math
import os

# matplotlib's tab10
COLORS = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
          (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
          (188, 189, 34), (23, 190, 207))
WIDTH, HEIGHT = 1080, 660
# plot box: left, top, right, bottom margins
MARGINS = (70, 30, 20, 170)
THICK = ("loss_total", "NDS", "mean_ap")


def load_records(path: str, kind: str = "train") -> list:
    from apollo_vision_net_tpu_torch.runtime.metrics_log import read_metrics

    if os.path.isfile(path) and not path.endswith("metrics.jsonl"):
        with open(path) as f:
            return [json.loads(ln) for ln in f if ln.strip()]
    return read_metrics(path, kind=kind)


def series_keys(recs: list, kind: str = "train") -> list:
    """Every numeric key but the bookkeeping ones; in training only the
    ``loss*`` ones."""
    skip = {"step", "wall_time", "kind", "sec_per_it"}
    return sorted({k for r in recs for k, v in r.items()
                   if k not in skip and isinstance(v, (int, float))
                   and (kind == "eval" or k.startswith("loss"))})


def plot_box():
    left, top, right, bottom = MARGINS
    return left, top, WIDTH - right, HEIGHT - bottom


def render_curves(recs: list, keys: list, out_path: str, title: str = "",
                  logy: bool = False):
    """Draw and save the curves (``WIDTH`` x ``HEIGHT``); returns the
    image."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (WIDTH, HEIGHT), "white")
    draw = ImageDraw.Draw(img)
    x0, y0, x1, y1 = plot_box()
    steps = [r["step"] for r in recs]
    smin, smax = min(steps), max(steps)

    def fy(v):
        return math.log10(v) if logy else v

    vals = [fy(r[k]) for r in recs for k in keys
            if isinstance(r.get(k), (int, float)) and math.isfinite(r[k])
            and (r[k] > 0 or not logy)]
    vmin, vmax = (min(vals), max(vals)) if vals else (0.0, 1.0)
    if vmax == vmin:
        vmin, vmax = vmin - 0.5, vmax + 0.5

    def px(step, v):
        sx = (step - smin) / (smax - smin) if smax > smin else 0.5
        return x0 + sx * (x1 - x0), y1 - (fy(v) - vmin) / (vmax - vmin) * (y1 - y0)

    draw.rectangle((x0, y0, x1, y1), outline="black")
    for i in range(5):
        v = vmin + (vmax - vmin) * i / 4
        yy = y1 - (y1 - y0) * i / 4
        draw.line((x0, yy, x1, yy), fill=(230, 230, 230))
        draw.text((4, yy - 6), f"{10 ** v:.3g}" if logy else f"{v:.3g}", fill="black")
    draw.text((x0, y1 + 4), str(smin), fill="black")
    draw.text((x1 - 40, y1 + 4), str(smax), fill="black")
    draw.text(((x0 + x1) / 2 - 12, y1 + 4), "step", fill="black")
    draw.text((x0, 8), title, fill="black")
    for i, k in enumerate(keys):
        color = COLORS[i % len(COLORS)]
        pts = [px(r["step"], r[k]) for r in recs
               if isinstance(r.get(k), (int, float)) and math.isfinite(r[k])
               and (r[k] > 0 or not logy)]
        width = 3 if k in THICK else 1
        if len(pts) > 1:
            draw.line(pts, fill=color, width=width)
        elif pts:
            draw.ellipse((pts[0][0] - 2, pts[0][1] - 2, pts[0][0] + 2, pts[0][1] + 2), fill=color)
        lx = x0 + (i % 3) * 330
        ly = y1 + 24 + (i // 3) * 14
        draw.line((lx, ly + 6, lx + 20, ly + 6), fill=color, width=width)
        draw.text((lx + 24, ly), k, fill="black")
    img.save(out_path)
    return img


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log", help="work dir or metrics.jsonl path")
    p.add_argument("--keys", nargs="*", default=None,
                   help="scalar keys to plot (default: every loss_* key)")
    p.add_argument("--kind", default="train", choices=["train", "eval"])
    p.add_argument("--out", default="curves.png")
    p.add_argument("--logy", action="store_true")
    args = p.parse_args(argv)
    recs = load_records(args.log, args.kind)
    if not recs:
        raise SystemExit(f"no '{args.kind}' records in {args.log}")
    keys = args.keys or series_keys(recs, args.kind)
    render_curves(recs, keys, args.out,
                  title=os.path.basename(os.path.abspath(args.log)), logy=args.logy)
    print(f"wrote {args.out} ({len(recs)} records, {len(keys)} series)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
