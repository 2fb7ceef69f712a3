"""The port's entry points on the CPU: the converter, train and test CLIs
over the nuScenes data layer, the metrics stream, checkpoint retention,
and the streaming eval's records against the JAX package's.

- ``tools.create_data`` (``nuscenes``, then ``nuscenes-map-gt``) on
  ``tests/test_nusc_tables.py::_fake_tables`` with a city map for its
  location; ``tools.train`` two steps of ``bev_smoke_det_map`` from an
  mmdet ResNet-50 checkpoint built here (``--pretrained``, ``--device
  cpu``) with a synthetic-frame eval at step 2, then ``--resume`` to step
  3; ``tools.test --eval bbox chamfer --dump-results`` over the val scene
  from the train CLI's work dir. Checked: the infos carry map GT, the
  metrics.jsonl records (three ``train`` records with ``sec_per_it``,
  ``step_s`` and ``data_wait_s``, one ``eval``), the checkpoints with their
  meta (config dict, NDS), the imported frozen BN statistics in the
  checkpoint, finite NDS and chamfer mAP, and the results JSON reloading.
- ``CheckpointManager``'s retention by NDS keeps the steps that the JAX
  package's orbax manager keeps; without a metric, the newest.
- ``MetricsLogger`` records read back by the JAX package's reader.
- ``run_streaming_eval`` on a small flagship copy (one layer a stack,
  bridged weights drawn from a seed) gives JAX's det and map records over three frames with a
  scene reset, within 1e-3 on boxes, scores and vectors, labels equal.
"""
import dataclasses
import functools
import json
import pickle
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apollo_vision_net_tpu.configs import base as jax_configs  # noqa: E402
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer  # noqa: E402
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model  # noqa: E402
from apollo_vision_net_tpu.runtime import inference as jinference  # noqa: E402
from apollo_vision_net_tpu.runtime import metrics_log as jmetrics_log  # noqa: E402
from apollo_vision_net_tpu_torch import configs as port_configs  # noqa: E402
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from apollo_vision_net_tpu_torch.data.synthetic import make_stream  # noqa: E402
from apollo_vision_net_tpu_torch.evaluation import formatting  # noqa: E402
from apollo_vision_net_tpu_torch.models.detector import build_model  # noqa: E402
from apollo_vision_net_tpu_torch.runtime import inference as tinference  # noqa: E402
from apollo_vision_net_tpu_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from apollo_vision_net_tpu_torch.runtime.metrics_log import (  # noqa: E402
    MetricsLogger,
    read_metrics,
)
from apollo_vision_net_tpu_torch.tools import create_data, test, train  # noqa: E402
from test_import_weights import TResNet, _randomize_bn  # noqa: E402
from test_map_extract import _build_city  # noqa: E402
from test_nusc_tables import _fake_tables  # noqa: E402
from test_torch_occ import one_torch_thread  # noqa: E402,F401
from test_torch_slice import SMALL, small  # noqa: E402
from test_torch_vovnet import drawn_params  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RECORD_TOL = 1e-3
# the small flagship of test_torch_slice at one layer a stack: the records'
# decode and formatting are under test, not the depth
EVAL_SIZES = dict(SMALL, encoder_layers=1, decoder_layers=1, map_decoder_layers=1)


def test_create_data_train_resume_and_test_clis(tmp_path):
    root = _fake_tables(tmp_path)
    (root / "maps" / "expansion").mkdir(parents=True)
    (root / "maps" / "expansion" / "singapore-onenorth.json").write_text(
        json.dumps(_build_city()))
    out = tmp_path / "infos"
    train_pkl = str(out / "nuscenes_infos_temporal_train.pkl")
    val_pkl = str(out / "nuscenes_infos_temporal_val.pkl")
    assert create_data.main(["nuscenes", "--root-path", str(root), "--version",
                             "v1.0-mini", "--out-dir", str(out)]) == 0
    assert create_data.main(["nuscenes-map-gt", "--root-path", str(root),
                             "--infos", train_pkl, "--map-version", "1"]) == 0
    with open(train_pkl, "rb") as f:
        infos = pickle.load(f)["infos"]
    assert len(infos) == 3 and all(i["map_vectors"] for i in infos)

    trunk = TResNet()
    _randomize_bn(trunk)
    ckpt = {f"img_backbone.{k}": v for k, v in trunk.state_dict().items()}
    ckpt["pts_bbox_head.query.weight"] = torch.zeros(4, 4)
    torch.save({"state_dict": ckpt}, tmp_path / "r50.pth")
    work = tmp_path / "work"
    argv = ["bev_smoke_det_map", "--data", "nuscenes", "--infos", train_pkl,
            "--data-root", str(root), "--img-scale", "1.0", "--num-workers", "0",
            "--work-dir", str(work), "--device", "cpu", "--log-interval", "1",
            "--pretrained", str(tmp_path / "r50.pth"), "--eval-interval", "2",
            "--eval-frames", "2"]
    assert train.main(argv + ["--steps", "2"]) == 0
    assert train.main(argv + ["--steps", "3", "--resume"]) == 0

    recs = read_metrics(str(work))
    assert [(r["kind"], r["step"]) for r in recs] == [
        ("train", 1), ("train", 2), ("eval", 2), ("train", 3)]
    for r in recs:
        if r["kind"] == "train":
            assert np.isfinite(r["loss_total"]) and r["sec_per_it"] > 0
            assert 0 <= r["data_wait_s"] <= r["step_s"]
    assert "NDS" in recs[2]
    mgr = CheckpointManager(str(work))
    assert mgr.steps() == [2, 3]
    meta = mgr.meta(2)
    cfg = dataclasses.replace(port_configs.bev_smoke_det_map(),
                              pretrained_path=str(tmp_path / "r50.pth"))
    assert meta["config"] == json.loads(json.dumps(dataclasses.asdict(cfg)))
    assert meta["metrics"]["NDS"] == recs[2]["NDS"] and mgr.meta(3)["metrics"] == {}
    saved = torch.load(mgr.path(3), weights_only=True)["model"]
    # frozen: the imported statistics, untouched by three updates
    assert torch.equal(saved["img_backbone.stem_bn.running_var"],
                       trunk.bn1.running_var)
    assert torch.equal(saved["img_backbone.layer4_2.bn3.weight"],
                       trunk.layer4[2].bn3.weight)

    metrics_path, results_path = tmp_path / "m.json", tmp_path / "res.json"
    assert test.main(["bev_smoke_det_map", "--data", "nuscenes", "--infos", val_pkl,
                      "--data-root", str(root), "--img-scale", "1.0",
                      "--checkpoint", str(work), "--eval", "bbox", "chamfer",
                      "--num-frames", "0", "--dump-results", str(results_path),
                      "--out", str(metrics_path), "--device", "cpu"]) == 0
    metrics = json.loads(metrics_path.read_text())
    assert np.isfinite(metrics["NDS"]) and np.isfinite(metrics["NuscMap_chamfer/mAP"])
    loaded = formatting.load_results_json(str(results_path))
    assert len(loaded["det"]) == len(loaded["map"]) == 3


def test_checkpoint_retention_equals_the_jax_managers(tmp_path, monkeypatch):
    """Saves with and without NDS, two kept: the port keeps what orbax
    keeps (the two best, a save without the metric counting as -1, ties to
    the newer step); without best_metric the two newest."""
    from apollo_vision_net_tpu.runtime.checkpoint import (
        CheckpointManager as JaxManager,
    )
    from apollo_vision_net_tpu_torch.runtime import checkpoint

    monkeypatch.setattr(checkpoint, "MAX_TO_KEEP", 2)

    cfg = port_configs.bev_smoke_det_map()
    jcfg = jax_configs.bev_smoke_det_map()
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    saves = [(1, {"NDS": 0.3}), (2, None), (3, {"NDS": 0.5}), (4, None),
             (5, {"NDS": 0.1}), (6, {"NDS": 0.3})]
    for best in ("NDS", None):
        jm = JaxManager(str(tmp_path / f"j{best}"), max_to_keep=2, best_metric=best)
        tm = CheckpointManager(str(tmp_path / f"t{best}"), best_metric=best)
        for step, metrics in saves:
            state = types.SimpleNamespace(params={"w": np.zeros(2, np.float32)},
                                          opt_state={"m": np.zeros(1, np.float32)},
                                          step=np.int32(step))
            jm.save(step, state, jcfg, metrics)
            tm.save(step, model, opt, cfg, metrics)
        assert tm.steps() == sorted(jm._mgr.all_steps())
        assert tm.steps() == ([3, 6] if best else [5, 6])
        jm.close()


def test_metrics_stream_reads_back_through_the_jax_reader(tmp_path):
    log = MetricsLogger(str(tmp_path))
    log.log("train", 1, {"loss_total": np.float32(2.5)}, sec_per_it=0.25)
    log.log("eval", 1, {"NDS": 0.125})
    log.close()
    for kind in (None, "train", "eval"):
        got = read_metrics(str(tmp_path), kind)
        want = jmetrics_log.read_metrics(str(tmp_path), kind)
        assert got == want and got
    assert read_metrics(str(tmp_path / "metrics.jsonl"))[0]["loss_total"] == 2.5


def test_streaming_eval_records_match_jax():
    jcfg = small(jax_configs.bev_tiny_det_map_apollo(), EVAL_SIZES)
    tcfg = small(port_configs.bev_tiny_det_map_apollo(), EVAL_SIZES)
    m = tcfg.model
    frames = make_stream(tcfg, 3, seed=5, scene_change_at=(2,))
    rng = np.random.default_rng(6)
    for f in frames:  # a lidar frame moved and turned in the global one
        c, s = np.cos(rng.uniform(-3, 3)), np.sin(rng.uniform(-3, 3))
        f["lidar2global"] = np.array([[c, -s, 0, rng.uniform(-50, 50)],
                                      [s, c, 0, rng.uniform(-50, 50)],
                                      [0, 0, 1, 1.8], [0, 0, 0, 1.0]])
    jmodel = jax_build_model(jcfg)
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        (1, m.num_cams, *m.img_shape, 3), (1, 18), (1, m.num_cams, 4, 4),
        (1, m.bev_h * m.bev_w, m.embed_dims), (1,))]
    params = drawn_params(jax.eval_shape(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame),
        {"params": jax.random.PRNGKey(0)}, *args)["params"], seed=7)
    want = jinference.run_streaming_eval(jcfg, jmodel, params, frames)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    got = tinference.run_streaming_eval(tcfg, tmodel, frames)
    assert len(got["det"]) == len(want["det"]) == 3 and got["occ"] == want["occ"] == []
    for g, w in zip(got["det"] + got["map"], want["det"] + want["map"]):
        assert set(g) == set(w)
        for k, v in w.items():
            if np.asarray(v).dtype.kind in "fc":
                np.testing.assert_allclose(np.asarray(g[k], np.float64), v,
                                           atol=RECORD_TOL, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], v, err_msg=k)
