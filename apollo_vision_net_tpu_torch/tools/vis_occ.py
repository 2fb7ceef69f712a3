"""Occupancy visualization: a dense or sparse semantic voxel grid drawn as
a BEV class map (the top occupied voxel's class a column) beside up to 8
z-slices, to a PNG with PIL.

Counterpart of the JAX package's tools/vis_occ.py (reference
tools/occ_visualization), which draws with matplotlib; the reduction to
the BEV (``_bev_top_class``) is the same. Voxels are in (z, y, x) order,
x minor; row y of the grid is row y of each panel. Classes take
matplotlib's tab20 colours (``CLASS_COLORS``), empty cells white. It runs
no model.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.vis_occ GRID.npy
      [--dims 200 200 16] [--empty-label 16] [--out occ.png]
GRID: a dense (voxels,) label array or a sparse (n, 2) [index, label] one.
"""
from __future__ import annotations

import argparse

import numpy as np

# matplotlib's tab20
CLASS_COLORS = np.array([
    (31, 119, 180), (174, 199, 232), (255, 127, 14), (255, 187, 120),
    (44, 160, 44), (152, 223, 138), (214, 39, 40), (255, 152, 150),
    (148, 103, 189), (197, 176, 213), (140, 86, 75), (196, 156, 148),
    (227, 119, 194), (247, 182, 210), (127, 127, 127), (199, 199, 199),
    (188, 189, 34), (219, 219, 141), (23, 190, 207), (158, 218, 229)], np.uint8)
GAP = 4
TITLE_ROWS = 14


def _occupied(dense: np.ndarray, dims, empty_label: int) -> np.ndarray:
    xdim, ydim, zdim = dims
    grid = dense.reshape(zdim, ydim, xdim).astype(np.int32)
    return np.where(grid == empty_label, -1, grid)


def _bev_top_class(dense: np.ndarray, dims, empty_label: int) -> np.ndarray:
    """(voxel_num,) labels in (z, y, x) order (x minor) -> (y, x) class of
    the highest occupied voxel, -1 where the column is empty."""
    xdim, ydim, zdim = dims
    occ = _occupied(dense, dims, empty_label)
    occupied = occ >= 0
    top_z = np.where(occupied.any(0), occupied[::-1].argmax(0), -1)
    bev = np.full((ydim, xdim), -1, np.int32)
    has = top_z >= 0
    zsel = (zdim - 1 - top_z)[has]
    ys, xs = np.where(has)
    bev[ys, xs] = occ[zsel, ys, xs]
    return bev


def colorize(classes: np.ndarray, scale: int = 1, palette=CLASS_COLORS):
    """(y, x) class map (-1 empty) -> PIL image, ``scale`` pixels a cell."""
    from PIL import Image

    rgb = np.full(classes.shape + (3,), 255, np.uint8)
    has = classes >= 0
    rgb[has] = palette[classes[has] % len(palette)]
    img = Image.fromarray(rgb)
    if scale != 1:
        img = img.resize((img.width * scale, img.height * scale), Image.NEAREST)
    return img


def panels(images, titles):
    """Images side by side, ``GAP`` pixels apart, each under its title."""
    from PIL import Image, ImageDraw

    w = sum(im.width for im in images) + GAP * (len(images) - 1)
    h = max(im.height for im in images) + TITLE_ROWS
    out = Image.new("RGB", (w, h), "white")
    draw = ImageDraw.Draw(out)
    x = 0
    for im, title in zip(images, titles):
        out.paste(im, (x, TITLE_ROWS))
        draw.text((x + 2, 1), title, fill="black")
        x += im.width + GAP
    return out


def render_occ(dense: np.ndarray, dims, empty_label: int, out_path: str,
               scale: int = 2):
    """The BEV top-class panel and min(z, 8) z-slices; returns the image."""
    xdim, ydim, zdim = dims
    occ = _occupied(dense, dims, empty_label)
    n_slices = min(zdim, 8)
    step = max(zdim // n_slices, 1)
    zs = [i * step for i in range(n_slices)]
    img = panels([colorize(_bev_top_class(dense, dims, empty_label), scale)]
                 + [colorize(occ[z], scale) for z in zs],
                 ["BEV (top voxel class)"] + [f"z={z}" for z in zs])
    img.save(out_path)
    print(f"wrote {out_path}")
    return img


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("occ", help=".npy dense (voxels,) or sparse (n,2) labels")
    p.add_argument("--dims", nargs=3, type=int, default=[200, 200, 16],
                   help="xdim ydim zdim")
    p.add_argument("--empty-label", type=int, default=16)
    p.add_argument("--out", default="occ.png")
    args = p.parse_args(argv)
    arr = np.load(args.occ)
    if arr.ndim == 2 and arr.shape[1] == 2:
        from apollo_vision_net_tpu_torch.data.semantic_kitti import sparse_to_dense

        arr = sparse_to_dense(arr, int(np.prod(args.dims)), args.empty_label)
    render_occ(arr, tuple(args.dims), args.empty_label, args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
