"""The port's evaluators (numpy copies under evaluation/) against the JAX
package's originals on the same seeded records, and the port's overfit
check on the CPU.

The copies are numpy only, so the results must be equal: exact for counts
and dict keys, and bit for bit for the floats, since both sides run the same
numpy code on the same arrays.
"""
import json

import numpy as np
import pytest

from apollo_vision_net_tpu.configs import base as jax_configs
from apollo_vision_net_tpu.data.infos import quat_to_rot as jax_quat_to_rot
from apollo_vision_net_tpu.evaluation import formatting as jfmt
from apollo_vision_net_tpu.evaluation import map_eval as jmap
from apollo_vision_net_tpu.evaluation import nuscenes_det as jdet
from apollo_vision_net_tpu.evaluation.ssc_metrics import SSCMetrics as JSSC
from apollo_vision_net_tpu.runtime.inference import (
    evaluate_results as jax_evaluate_results,
)
from apollo_vision_net_tpu_torch import configs as port_configs
from apollo_vision_net_tpu_torch.evaluation import formatting as tfmt
from apollo_vision_net_tpu_torch.evaluation import map_eval as tmap
from apollo_vision_net_tpu_torch.evaluation import nuscenes_det as tdet
from apollo_vision_net_tpu_torch.evaluation.ssc_metrics import SSCMetrics
from apollo_vision_net_tpu_torch.runtime.inference import evaluate_results
from apollo_vision_net_tpu_torch.runtime.train_loop import format_losses
from apollo_vision_net_tpu_torch.tools import overfit_check
from test_torch_occ import one_torch_thread  # noqa: F401

# torch on one thread (see test_torch_occ.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _records(seed, n_samples=4, lidar2global=True):
    """Detections and GT of a few samples in both record formats: GT boxes
    in the port's synthetic layout and detections that are noisy copies of
    them plus false positives, so every AP and TP error is exercised."""
    rng = np.random.default_rng(seed)
    gts, dets, out = [], [], []
    for _ in range(n_samples):
        k = int(rng.integers(3, 9))
        boxes = np.zeros((12, 9), np.float32)
        boxes[:, 3:6] = 1.0
        boxes[:k, :2] = rng.uniform(-35, 35, (k, 2))
        boxes[:k, 2] = rng.uniform(-2, 0.5, k)
        boxes[:k, 3:6] = rng.uniform(0.5, 5, (k, 3))
        boxes[:k, 6] = rng.uniform(-np.pi, np.pi, k)
        boxes[:k, 7:9] = rng.normal(0, 2, (k, 2))
        labels = rng.integers(0, 10, 12)
        mask = np.arange(12) < k
        l2g = None
        if lidar2global:
            q = rng.normal(size=4)
            l2g = np.eye(4)
            l2g[:3, :3] = jax_quat_to_rot(q)
            l2g[:3, 3] = rng.uniform(-100, 100, 3)
        pred = boxes.copy()
        pred[:, :3] += rng.normal(0, 0.6, (12, 3))
        pred[:, 6] += rng.normal(0, 0.3, 12)
        pred[k:, :2] = rng.uniform(-35, 35, (12 - k, 2))
        scores = rng.uniform(0, 1, 12)
        plabels = np.where(rng.uniform(size=12) < 0.8, labels,
                           rng.integers(0, 10, 12))
        valid = rng.uniform(size=12) < 0.95
        out.append((boxes, labels, mask, pred, scores, plabels, valid, l2g))
    return out


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


def test_quat_to_rot_equals_the_jax_one():
    rng = np.random.default_rng(0)
    for q in list(rng.normal(size=(20, 4))) + [np.zeros(4), np.array([1.0, 0, 0, 0])]:
        np.testing.assert_array_equal(tfmt.quat_to_rot(q), jax_quat_to_rot(q))


def test_formatting_copy_equals_the_jax_one(tmp_path):
    """Sample records (with and without an ego pose), GT records, map
    records and the results JSON round trip."""
    recs = _records(1)
    for boxes, labels, mask, pred, scores, plabels, valid, l2g in recs:
        for pose in (None, l2g):
            _assert_same(
                tfmt.detections_to_sample_record(pred, scores, plabels, valid, pose),
                jfmt.detections_to_sample_record(pred, scores, plabels, valid, pose))
            _assert_same(tfmt.gt_to_sample_record(boxes, labels, mask, pose),
                         jfmt.gt_to_sample_record(boxes, labels, mask, pose))
    rng = np.random.default_rng(2)
    vecs, sc, lb = rng.normal(size=(6, 5, 2)), rng.uniform(size=6), rng.integers(0, 3, 6)
    _assert_same(tfmt.map_results_record(vecs, sc, lb, 0.3),
                 jfmt.map_results_record(vecs, sc, lb, 0.3))
    results = {"det": [jfmt.detections_to_sample_record(r[3], r[4], r[5], r[6], r[7])
                       for r in recs],
               "map": [jfmt.map_results_record(vecs, sc, lb, 0.3)] * len(recs)}
    tfmt.dump_results_json(results, str(tmp_path / "t.json"))
    jfmt.dump_results_json(results, str(tmp_path / "j.json"))
    assert (json.loads((tmp_path / "t.json").read_text())
            == json.loads((tmp_path / "j.json").read_text()))
    _assert_same(tfmt.load_results_json(str(tmp_path / "t.json")),
                 jfmt.load_results_json(str(tmp_path / "j.json")))


@pytest.mark.parametrize("seed", [3, 4])
def test_detection_evaluator_copy_equals_the_jax_one(seed):
    recs = _records(seed)
    gts = [jfmt.gt_to_sample_record(r[0], r[1], r[2], r[7]) for r in recs]
    dets = [jfmt.detections_to_sample_record(r[3], r[4], r[5], r[6], r[7])
            for r in recs]
    want = jdet.evaluate_detection(gts, dets)
    got = tdet.evaluate_detection(gts, dets)
    assert got == want
    assert 0.0 < want["mean_ap"] < 1.0 and 0.0 < want["NDS"] < 1.0


def _map_records(seed, n_samples, n_gt, step):
    rng = np.random.default_rng(seed)
    results, anns = [], []
    for _ in range(n_samples):
        gt_vecs = [np.cumsum(rng.uniform(-step, step, (int(rng.integers(2, 9)), 2)), 0)
                   for _ in range(n_gt)]
        pred = [tmap.resample_line(v, 20) + rng.normal(0, 0.3, (20, 2))
                for v in gt_vecs] + [rng.uniform(-4 * step, 4 * step, (20, 2))]
        results.append(jfmt.map_results_record(
            np.stack(pred), rng.uniform(size=n_gt + 1), np.arange(n_gt + 1) % 3))
        anns.append(dict(vectors=gt_vecs, labels=np.arange(n_gt) % 3))
    return results, anns


@pytest.mark.parametrize("metric", ["chamfer", "iou"])
def test_map_evaluator_copy_equals_the_jax_one(metric):
    """Both protocols on GT polylines and noisy predictions (the rasterized
    IoU on fewer and shorter lines: it takes ~50 ms a pair and threshold)."""
    results, anns = (_map_records(5, 3, 4, 2.0) if metric == "chamfer"
                     else _map_records(9, 1, 2, 0.5))
    want = jmap.evaluate_map(results, anns, metrics=(metric,))
    assert tmap.evaluate_map(results, anns, metrics=(metric,)) == want
    assert 0.0 < want[f"NuscMap_{metric}/mAP"] <= 1.0


@pytest.mark.parametrize("far_near", [False, True])
def test_ssc_metrics_copy_equals_the_jax_one(far_near):
    """SSCMetrics on 200x200x16 grids with free (16) and ignored (255)
    voxels, with and without the distance bands."""
    rng = np.random.default_rng(6)
    kw = dict(n_classes=17, eval_far=far_near, eval_near=far_near)
    t, j = SSCMetrics(**kw), JSSC(**kw)
    vox = 16 * 200 * 200
    for _ in range(2):
        true = np.where(rng.uniform(size=vox) < 0.9, 16, rng.integers(0, 16, vox))
        true[rng.uniform(size=vox) < 0.05] = 255
        pred = np.where(rng.uniform(size=vox) < 0.3, rng.integers(0, 17, vox), true)
        pred[pred == 255] = 16
        t.add_batch(pred, true)
        j.add_batch(pred, true)
    _assert_same(t.get_stats(), j.get_stats())
    assert 0.0 < t.get_stats()["iou"] < 100.0


def test_evaluate_results_equals_the_jax_one():
    """runtime.inference.evaluate_results over det, map and occ results of
    a det+occ config against the JAX package's, on the same records."""
    jcfg = jax_configs.bev_smoke_det_occ()
    tcfg = port_configs.bev_smoke_det_occ()
    recs = _records(7)
    rng = np.random.default_rng(8)
    vox = 4 * 32 * 32
    occ_true = [np.where(rng.uniform(size=vox) < 0.8, 16, rng.integers(0, 16, vox))
                for _ in recs]
    occ_pred = [np.where(rng.uniform(size=vox) < 0.2, rng.integers(0, 17, vox), t)
                for t in occ_true]
    results = {"det": [jfmt.detections_to_sample_record(*r[3:8]) for r in recs],
               "map": [], "occ": occ_pred}
    gt = {"det": [jfmt.gt_to_sample_record(r[0], r[1], r[2], r[7]) for r in recs],
          "occ": occ_true}
    want = jax_evaluate_results(jcfg, results, gt)
    assert evaluate_results(tcfg, results, gt) == want
    assert {"mean_ap", "NDS", "occ_iou", "occ_miou"} <= set(want)


def test_format_losses_puts_occupancy_terms_on_the_occ_line():
    losses = {"loss_cls": 1.0, "loss_bbox": 2.0, "loss_occupancy": 3.0,
              "lovasz_softmax": 0.5, "loss_sem_scal": 4.0, "loss_geo_scal": 5.0,
              "loss_total": 15.5, "grad_norm": 7.0}
    lines = format_losses(losses).split("\n  ")
    assert lines == ["loss_bbox=2.0000 loss_cls=1.0000 loss_total=15.5000",
                     "loss_geo_scal=5.0000 loss_occupancy=3.0000 "
                     "loss_sem_scal=4.0000 lovasz_softmax=0.5000",
                     "grad_norm=7.0000"]


def test_overfit_check_trains_and_evaluates_on_the_cpu(tmp_path, monkeypatch):
    """The port's overfit check end to end at a few steps: the loss curve
    falls, every metric of the det+occ config is reported, the bars fail
    (as they must after 8 steps) and --assert exits non-zero."""
    cfg = overfit_check.overfit_config(port_configs.bev_smoke_det_occ(), 8)
    assert cfg.optim.warmup_iters == 10 and cfg.optim.total_steps == 8
    model, batch, curve = overfit_check.overfit(cfg, steps=8, batch_size=1,
                                                device="cpu")
    assert [c["step"] for c in curve] == [0, 7]
    assert curve[-1]["loss_total"] < curve[0]["loss_total"]
    metrics = overfit_check.evaluate_overfit(cfg, model, batch)
    assert model.training
    assert {"mean_ap", "NDS", "occ_iou", "occ_miou"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    assert set(overfit_check.failed_bars(metrics)) == {"mean_ap", "occ_iou",
                                                       "occ_miou"}
    monkeypatch.setattr("sys.argv", [
        "overfit_check", "bev_smoke_det_occ", "--steps", "2", "--batch-size",
        "1", "--eval-every", "0", "--device", "cpu", "--out", str(tmp_path),
        "--assert"])
    assert overfit_check.main() == 1
    saved = json.loads((tmp_path / "bev_smoke_det_occ_metrics.json").read_text())
    assert saved["device"] == "cpu" and "occ_iou" in saved
    assert len((tmp_path / "bev_smoke_det_occ_overfit.jsonl").read_text()
               .splitlines()) == 2
