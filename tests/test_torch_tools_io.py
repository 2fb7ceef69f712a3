"""The port's tools that run no model, or one served frame, against the
JAX package's root ``tools/``, on the CPU.

- ``import_torch_weights``: on synthetic R50 (+ FPN) and DLA-34
  checkpoints built from a seed (tests/test_import_weights.py's torch
  modules), the imported tensors equal, through the bridge, what JAX's tool
  writes, and the summary lines are equal.
- ``eval_map_offline``: the chamfer metrics equal JAX's tool's on the same
  results and GT JSON written from a seed, within 1e-6.
- ``analyze_logs``: the port prints JAX's text byte for byte on a
  ``metrics.jsonl`` written by the port's ``MetricsLogger``.
- ``plot_loss_from_log`` and the visualizers: each writes its PNG or GIF at
  the expected size; a box, a voxel, a map line and a loss point at a known
  position colour the expected pixel; ``box_corners``, ``_bev_top_class``,
  ``project`` and ``box_corners_3d`` equal JAX's on the same inputs;
  ``project_det_map_to_pv --device cpu`` writes its image at a smoke
  config.
"""
import contextlib
import io
import json
import pickle
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))  # root tools/

from apollo_vision_net_tpu_torch import configs as port_configs  # noqa: E402
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from apollo_vision_net_tpu_torch.data.synthetic import make_stream  # noqa: E402
from apollo_vision_net_tpu_torch.evaluation import formatting  # noqa: E402
from apollo_vision_net_tpu_torch.runtime.metrics_log import MetricsLogger  # noqa: E402
from apollo_vision_net_tpu_torch.tools import (  # noqa: E402
    analyze_logs,
    eval_map_offline,
    import_torch_weights,
    plot_loss_from_log,
    project_det_map_to_pv,
    seq_det_map_vis,
    vis_bev,
    vis_occ,
    vis_occ_pair,
)
from test_import_weights import TFPN, TDla34, TResNet, _randomize_bn  # noqa: E402
from test_torch_occ import one_torch_thread  # noqa: E402,F401
from test_torch_tools import port_tool_output  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAP_METRIC_TOL = 1e-6


def jax_tool_output(monkeypatch, module, argv):
    """A root tools/ script's ``main`` run with ``argv``: its stdout."""
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        module.main()
    return out.getvalue()


# ---------------------------------------------------- import_torch_weights

@pytest.mark.parametrize("name", ["bev_smoke_det_map", "bev_tiny_det_map_apollo"])
def test_import_torch_weights_equals_jax_tool(name, tmp_path, monkeypatch):
    import flax.linen
    import flax.serialization

    from tools import import_torch_weights as jtool

    cfg = getattr(port_configs, name)()
    torch.manual_seed(len(name))
    if cfg.model.backbone_type == "resnet":  # R50 + an mmdet FPN, nested
        trunk, neck = TResNet(), TFPN([2048], cfg.model.embed_dims, 1)
        _randomize_bn(trunk)
        sd = {f"img_backbone.{k}": v for k, v in trunk.state_dict().items()}
        sd.update({f"img_neck.{k}": v for k, v in neck.state_dict().items()})
        sd["pts_bbox_head.query.weight"] = torch.zeros(4, 4)
    else:  # a bare DLA-34 dump with a classifier
        trunk = TDla34()
        _randomize_bn(trunk)
        sd = dict(trunk.state_dict(), **{"fc.weight": torch.zeros(2, 2)})
    torch.save({"state_dict": sd}, tmp_path / "ckpt.pth")

    # the JAX tool's one init under jit: the same draws as its eager call,
    # in one compile instead of one a primitive (~10 s, not ~25 s, on a CPU)
    eager_init = flax.linen.Module.init

    def jitted_init(self, rngs, *args, method=None, **kw):
        return jax.jit(lambda r, *a: eager_init(self, r, *a, method=method, **kw))(rngs, *args)

    monkeypatch.setattr(flax.linen.Module, "init", jitted_init)
    jout = jax_tool_output(monkeypatch, jtool, [
        str(tmp_path / "ckpt.pth"), "--config", name, "--out", str(tmp_path / "jax.msgpack")])
    out = port_tool_output(import_torch_weights, [
        str(tmp_path / "ckpt.pth"), "--config", name, "--out", str(tmp_path / "port.pt")])
    assert out.replace("port.pt", "OUT") == jout.replace("jax.msgpack", "OUT")

    with open(tmp_path / "jax.msgpack", "rb") as f:
        want = state_dict_from_flax(flax.serialization.msgpack_restore(f.read()))
    got = torch.load(tmp_path / "port.pt")
    assert set(got) == set(want)
    imported = ("img_backbone.", "img_neck.") if "img_neck.lateral_convs.0.conv.weight" in sd \
        else ("img_backbone.",)
    checked = [k for k in want if k.startswith(imported)]
    assert len(checked) > 100
    for k in checked:
        assert torch.equal(got[k], want[k]), k


# -------------------------------------------------------- eval_map_offline

def test_eval_map_offline_equals_jax_tool(tmp_path, monkeypatch):
    from tools import eval_map_offline as jtool

    rng = np.random.default_rng(7)
    gt, res = [], []
    for _ in range(4):
        n = int(rng.integers(2, 6))
        vecs = [np.cumsum(rng.normal(0, 3, (int(rng.integers(3, 8)), 2)), 0) for _ in range(n)]
        labels = rng.integers(0, 3, n)
        gt.append({"vectors": vecs, "labels": labels})
        pred = [v + rng.normal(0, 0.4, v.shape) for v in vecs]
        pred += [np.cumsum(rng.normal(0, 3, (5, 2)), 0) for _ in range(2)]
        res.append(formatting.map_results_record(
            [formatting_resample(v) for v in pred], rng.uniform(0.1, 1.0, n + 2),
            np.concatenate([labels, rng.integers(0, 3, 2)])))
    formatting.dump_results_json({"map": res}, str(tmp_path / "res.json"))
    formatting.dump_map_gt_json(gt, str(tmp_path / "gt.json"))
    argv = [str(tmp_path / "res.json"), str(tmp_path / "gt.json"), "--metrics", "chamfer"]
    want = json.loads(jax_tool_output(monkeypatch, jtool, argv))
    got = json.loads(port_tool_output(eval_map_offline, argv))
    assert set(got) == set(want) and len(got) == 4
    assert 0.0 < got["NuscMap_chamfer/mAP"] < 1.0
    for k, v in want.items():
        assert abs(got[k] - v) <= MAP_METRIC_TOL, k


def formatting_resample(v, n=20):
    """A polyline resampled to n points, as the map head emits them."""
    from apollo_vision_net_tpu_torch.evaluation.map_eval import resample_line

    return resample_line(np.asarray(v, np.float64), n)


# ------------------------------------------------------------ analyze_logs

def test_analyze_logs_prints_jax_text(tmp_path, monkeypatch):
    from tools import analyze_logs as jtool

    log = MetricsLogger(str(tmp_path))
    rng = np.random.default_rng(3)
    for step in range(1, 7):
        log.log("train", step, {"loss_total": 10.0 / step + rng.random(),
                                "loss_cls": 2.0 / step, "lr": 1e-4,
                                "sec_per_it": 0.5 + 0.1 * rng.random()})
        if step % 3 == 0:
            log.log("eval", step, {"NDS": 0.1 * step, "mAP": 0.05 * step,
                                   "mATE_err": 1.0 / step})
    log.close()
    out = port_tool_output(analyze_logs, [str(tmp_path)])
    assert out == jax_tool_output(monkeypatch, jtool, [str(tmp_path)])
    assert "loss_total" in out and "NDS" in out


def test_plot_loss_from_log_writes_its_png(tmp_path):
    log = MetricsLogger(str(tmp_path))
    for step in range(1, 11):
        log.log("train", step, {"loss_total": 5.0 / step, "loss_cls": 1.0 / step})
    log.close()
    out = port_tool_output(plot_loss_from_log, [str(tmp_path), "--out", str(tmp_path / "c.png"), "--logy"])
    assert "10 records, 2 series" in out
    img = Image.open(tmp_path / "c.png")
    assert img.size == (plot_loss_from_log.WIDTH, plot_loss_from_log.HEIGHT)
    # the first loss_total point (step 1, the largest value) in its colour,
    # at the plot box's top-left corner
    x0, y0, _, _ = plot_loss_from_log.plot_box()
    rgb = np.asarray(img.convert("RGB"))
    patch = rgb[y0 - 2:y0 + 3, x0:x0 + 4].reshape(-1, 3)
    assert (patch == plot_loss_from_log.COLORS[1]).all(1).any()  # loss_total: 2nd key


# ------------------------------------------------------------- visualizers

def _nested_function(fn, name):
    """A function defined inside ``fn`` (no closure), rebuilt from its code."""
    code = next(c for c in fn.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    return types.FunctionType(code, fn.__globals__)


def test_numeric_helpers_equal_jax():
    from tools import project_det_map_to_pv as jpv
    from tools import vis_bev as jbev
    from tools import vis_occ_pair as jpair

    rng = np.random.default_rng(11)
    jbox_corners = _nested_function(jbev.render_bev, "box_corners")
    for b in rng.normal(0, 5, (5, 9)):
        np.testing.assert_array_equal(vis_bev.box_corners(b), jbox_corners(b))
        np.testing.assert_array_equal(project_det_map_to_pv.box_corners_3d(b), jpv.box_corners_3d(b))
    pts = rng.normal(0, 10, (20, 3))
    l2i = rng.normal(0, 1, (4, 4))
    for a, b in zip(project_det_map_to_pv.project(pts, l2i), jpv.project(pts, l2i)):
        np.testing.assert_array_equal(a, b)
    assert project_det_map_to_pv.EDGES == jpv._EDGES
    dims = (6, 5, 4)
    dense = rng.integers(0, 4, int(np.prod(dims)))
    dense[rng.random(dense.shape) < 0.6] = 3
    np.testing.assert_array_equal(vis_occ_pair._bev_top_class(dense, dims, 3),
                                  jpair._bev_top_class(dense, dims, 3))


def test_vis_bev_draws_a_box_at_its_position(tmp_path):
    size, pc = 200, vis_bev.PC_RANGE
    # a 10 m x 10 m box centred 25 m ahead (x) and 25 m left (y)
    det = {"boxes": np.array([[25.0, 25.0, 0, 10.0, 10.0, 2.0, 0.0, 0, 0]]),
           "scores": np.array([0.9]), "valid": np.array([True])}
    img = vis_bev.render_bev(det=det, out_path=str(tmp_path / "bev.png"), size=size)
    assert Image.open(tmp_path / "bev.png").size == (size, size + vis_bev.TITLE_ROWS)
    rgb = np.asarray(img)
    # its left edge x = 20 m -> column 140; rows of y in [20, 30] -> 40-60
    col = round((20.0 - pc[0]) / (pc[3] - pc[0]) * size)
    row = round((pc[4] - 25.0) / (pc[4] - pc[1]) * size) + vis_bev.TITLE_ROWS
    assert tuple(rgb[row, col]) == vis_bev.DET_COLOR
    assert tuple(rgb[row, col + 5]) == (255, 255, 255)  # inside: not filled


def test_vis_occ_and_pair_write_their_images(tmp_path):
    dims, empty = (10, 8, 4), 16
    dense = np.full(int(np.prod(dims)), empty)
    dense[2 * 80 + 3 * 10 + 4] = 5  # z = 2, y = 3, x = 4: class 5
    img = vis_occ.render_occ(dense, dims, empty, str(tmp_path / "occ.png"), scale=2)
    panel = 10 * 2
    assert img.size == (5 * panel + 4 * vis_occ.GAP, 8 * 2 + vis_occ.TITLE_ROWS)
    rgb = np.asarray(img)
    assert tuple(rgb[vis_occ.TITLE_ROWS + 3 * 2, 4 * 2]) == tuple(vis_occ.CLASS_COLORS[5])
    assert tuple(rgb[vis_occ.TITLE_ROWS, 0]) == (255, 255, 255)

    pred = dense.copy()
    pred[0] = 7  # a false occupied column at y = 0, x = 0
    with open(tmp_path / "res.pkl", "wb") as f:
        pickle.dump({"occ": [pred, pred], "gt": {"occ": [dense, dense]}}, f)
    port_tool_output(vis_occ_pair, [str(tmp_path / "res.pkl"), "--dims", "10", "8", "4",
                                    "--empty-label", "16", "--out", str(tmp_path / "pair.png")])
    pair = np.asarray(Image.open(tmp_path / "pair.png"))
    assert pair.shape[:2] == (8 * 2 + vis_occ.TITLE_ROWS, 3 * panel + 2 * vis_occ.GAP)
    x_agree = 2 * (panel + vis_occ.GAP)
    assert tuple(pair[vis_occ.TITLE_ROWS, x_agree]) == tuple(vis_occ_pair.AGREE_COLORS[3])
    assert tuple(pair[vis_occ.TITLE_ROWS + 3 * 2, x_agree + 4 * 2]) == tuple(
        vis_occ_pair.AGREE_COLORS[1])
    port_tool_output(vis_occ_pair, [str(tmp_path / "res.pkl"), "--dims", "10", "8", "4",
                                    "--empty-label", "16", "--gif", "--out", str(tmp_path / "pair")])
    gif = Image.open(tmp_path / "pair.gif")
    assert gif.n_frames == 2 and gif.size == (3 * panel + 2 * vis_occ.GAP,
                                              8 * 2 + vis_occ.TITLE_ROWS)


def test_seq_det_map_vis_writes_frames_and_gif(tmp_path):
    det = {"boxes": np.array([[0.0, 10.0, 0, 2.0, 4.0, 1.5, 0.3, 0, 0]]),
           "scores": np.array([0.8]), "valid": np.array([True])}
    mp = {"vectors": np.array([[[-10.0, -5.0], [10.0, -5.0]]]),
          "scores": np.array([0.9]), "labels": np.array([1])}
    gt = {"det": [{"translation": np.array([[0.0, 10.0, 0.0]]), "size": np.array([[2.0, 4.0, 1.5]]),
                   "yaw": np.array([0.3])}] * 3}
    # the box moves 5 m a frame (a GIF keeps equal frames as one)
    dets = [dict(det, boxes=det["boxes"] + [5.0 * i, 0, 0, 0, 0, 0, 0, 0, 0]) for i in range(3)]
    paths = seq_det_map_vis.render_sequence({"det": dets, "map": [mp] * 3, "gt": gt},
                                            str(tmp_path / "seq"), gif=True)
    assert len(paths) == 3
    assert Image.open(paths[0]).size == (800, 800 + vis_bev.TITLE_ROWS)
    gif = Image.open(tmp_path / "seq" / "seq.gif")
    assert gif.n_frames == 3
    # the map line at y = -5 m in its class colour
    row = round((50 - (-5.0)) / 100 * 800) + vis_bev.TITLE_ROWS
    assert tuple(np.asarray(Image.open(paths[0]))[row, 400]) == vis_bev.MAP_COLORS[1]


def test_project_det_map_to_pv_on_the_cpu(tmp_path):
    cfg = port_configs.bev_smoke_det_map()
    m = cfg.model
    out = port_tool_output(project_det_map_to_pv, [
        "--config", cfg.name, "--device", "cpu", "--out", str(tmp_path / "pv.png")])
    assert "wrote" in out
    H, W = m.img_shape
    assert Image.open(tmp_path / "pv.png").size == (
        m.num_cams * W // 2 + (m.num_cams - 1) * project_det_map_to_pv.GAP, H // 2)
    # a box straight ahead of the first camera lands inside its image
    l2i = make_stream(cfg, 1)[0]["lidar2img"]
    px, front = project_det_map_to_pv.project(
        project_det_map_to_pv.box_corners_3d(np.array([10.0, 0, 0, 2, 2, 2, 0])), l2i[0])
    assert front.all()
    img = project_det_map_to_pv.draw_frame(
        np.zeros((m.num_cams, H, W, 3), np.float32), l2i,
        det={"boxes": np.array([[10.0, 0, 0, 2, 2, 2, 0, 0, 0]]), "scores": np.array([1.0])},
        out_path=str(tmp_path / "one.png"), scale=1.0)
    rgb = np.asarray(img)
    i, j = project_det_map_to_pv.EDGES[0]
    mid = np.round((px[i] + px[j]) / 2).astype(int)
    if 0 <= mid[0] < W and 0 <= mid[1] < H:
        assert tuple(rgb[mid[1], mid[0]]) == vis_bev.DET_COLOR
    assert (rgb[:, :W] == vis_bev.DET_COLOR).all(-1).sum() > 10
