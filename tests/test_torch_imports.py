"""The port stands alone: no JAX, no JAX package, its own config copy, and
entry points that refuse to fall back to the CPU without being asked."""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from apollo_vision_net_tpu.configs import base as jax_configs
from apollo_vision_net_tpu_torch import configs as port_configs

REPO = Path(__file__).resolve().parent.parent
PORT_MODULES = [
    "apollo_vision_net_tpu_torch",
    "apollo_vision_net_tpu_torch.bridge",
    "apollo_vision_net_tpu_torch.configs",
    "apollo_vision_net_tpu_torch.data.rasterize",
    "apollo_vision_net_tpu_torch.data.synthetic",
    "apollo_vision_net_tpu_torch.data.temporal",
    "apollo_vision_net_tpu_torch.data.vector_map",
    "apollo_vision_net_tpu_torch.evaluation.formatting",
    "apollo_vision_net_tpu_torch.evaluation.map_eval",
    "apollo_vision_net_tpu_torch.evaluation.nuscenes_det",
    "apollo_vision_net_tpu_torch.evaluation.ssc_metrics",
    "apollo_vision_net_tpu_torch.losses.det_loss",
    "apollo_vision_net_tpu_torch.losses.map_loss",
    "apollo_vision_net_tpu_torch.losses.multitask",
    "apollo_vision_net_tpu_torch.losses.occ_loss",
    "apollo_vision_net_tpu_torch.models.heads.map_head_v2",
    "apollo_vision_net_tpu_torch.models.heads.occ_head",
    "apollo_vision_net_tpu_torch.tools.overfit_check",
    "apollo_vision_net_tpu_torch.parallel.optim",
    "apollo_vision_net_tpu_torch.parallel.train",
    "apollo_vision_net_tpu_torch.runtime.checkpoint",
    "apollo_vision_net_tpu_torch.runtime.train_loop",
    "apollo_vision_net_tpu_torch.utils.grid_mask",
    "apollo_vision_net_tpu_torch.ops",
    "apollo_vision_net_tpu_torch.ops._build",
    "apollo_vision_net_tpu_torch.ops.dcn",
    "apollo_vision_net_tpu_torch.ops.dcn_cuda",
    "apollo_vision_net_tpu_torch.ops.dcnv3",
    "apollo_vision_net_tpu_torch.ops.grid_sample",
    "apollo_vision_net_tpu_torch.ops.msda",
    "apollo_vision_net_tpu_torch.ops.msda_cuda",
    "apollo_vision_net_tpu_torch.utils.box_coder",
    "apollo_vision_net_tpu_torch.utils.geometry",
    "apollo_vision_net_tpu_torch.models.detector",
    "apollo_vision_net_tpu_torch.models.fpn",
    "apollo_vision_net_tpu_torch.models.internimage",
    "apollo_vision_net_tpu_torch.models.voxel",
    "apollo_vision_net_tpu_torch.models.hybrid",
    "apollo_vision_net_tpu_torch.ops.msda3d",
    "apollo_vision_net_tpu_torch.models.resnet",
    "apollo_vision_net_tpu_torch.runtime.inference",
    "apollo_vision_net_tpu_torch.runtime.metrics_log",
    "apollo_vision_net_tpu_torch.data.geometry2d",
    "apollo_vision_net_tpu_torch.data.infos",
    "apollo_vision_net_tpu_torch.data.loader",
    "apollo_vision_net_tpu_torch.data.map_extract",
    "apollo_vision_net_tpu_torch.data.nusc_map",
    "apollo_vision_net_tpu_torch.data.nusc_tables",
    "apollo_vision_net_tpu_torch.data.nuscenes_dataset",
    "apollo_vision_net_tpu_torch.data.pipeline",
    "apollo_vision_net_tpu_torch.data.semantic_kitti",
    "apollo_vision_net_tpu_torch.models.vovnet",
    "apollo_vision_net_tpu_torch.utils.torch_import",
    "apollo_vision_net_tpu_torch.tools.create_data",
    "apollo_vision_net_tpu_torch.tools.test",
    "apollo_vision_net_tpu_torch.tools.train",
    "apollo_vision_net_tpu_torch.ops.cost",
    "apollo_vision_net_tpu_torch.utils.debug",
    "apollo_vision_net_tpu_torch.tools.analyze_logs",
    "apollo_vision_net_tpu_torch.tools.debug_shapes",
    "apollo_vision_net_tpu_torch.tools.eval_map_offline",
    "apollo_vision_net_tpu_torch.tools.get_params",
    "apollo_vision_net_tpu_torch.tools.import_torch_weights",
    "apollo_vision_net_tpu_torch.tools.plot_loss_from_log",
    "apollo_vision_net_tpu_torch.tools.profile_step",
    "apollo_vision_net_tpu_torch.tools.project_det_map_to_pv",
    "apollo_vision_net_tpu_torch.tools.seq_det_map_vis",
    "apollo_vision_net_tpu_torch.tools.vis_bev",
    "apollo_vision_net_tpu_torch.tools.vis_occ",
    "apollo_vision_net_tpu_torch.tools.vis_occ_pair",
    "apollo_vision_net_tpu_torch.parallel.mesh",
    "apollo_vision_net_tpu_torch.parallel.collectives",
    "apollo_vision_net_tpu_torch.tools.dryrun_multichip",
    "apollo_vision_net_tpu_torch.data.kitti",
    "apollo_vision_net_tpu_torch.data.gt_database",
    "apollo_vision_net_tpu_torch.data.lyft",
    "apollo_vision_net_tpu_torch.data.waymo",
    "apollo_vision_net_tpu_torch.data.indoor",
    "apollo_vision_net_tpu_torch.evaluation.kitti2waymo",
]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO)
    env["CUDA_VISIBLE_DEVICES"] = ""  # no GPU, whatever the machine has
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module listed, and every other module of the package (walked,
    tools/ included), imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import apollo_vision_net_tpu_torch as p\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "walked = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        f"assert set({PORT_MODULES!r}) - {{p.__name__}} <= set(walked)\n"
        "for m in walked: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'apollo_vision_net_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["ModelConfig", "OptimConfig", "DataConfig",
                                  "ExperimentConfig"])
def test_config_classes_equal_the_jax_ones(name):
    def fields(cls):
        return [(f.name, f.type, dataclasses.asdict(f.default)
                 if dataclasses.is_dataclass(f.default) else f.default)
                for f in dataclasses.fields(cls)]

    assert fields(getattr(port_configs, name)) == fields(getattr(jax_configs, name))


def test_flagship_config_equals_the_jax_one():
    j = jax_configs.bev_tiny_det_map_apollo()
    t = port_configs.bev_tiny_det_map_apollo()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.map_patch_size == j.model.map_patch_size


def test_base_config_equals_the_jax_one():
    j = jax_configs.bev_base_det_map()
    t = port_configs.bev_base_det_map()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.map_patch_size == j.model.map_patch_size


@pytest.mark.parametrize("name", ["bev_tiny_det", "bev_smoke_det",
                                  "bev_tiny_det_occ", "bev_tiny_occ",
                                  "semantic_kitti_occ", "bev_tiny_occ_intern_s",
                                  "bev_base_occ_intern_s"])
def test_r50_and_internimage_configs_equal_the_jax_ones(name):
    """The R50 BEVFormer configs and the InternImage-S ones (the base one
    built with ``dataclasses.replace`` on ``bev_base_occ``, as JAX builds
    it), field for field."""
    j = getattr(jax_configs, name)()
    t = getattr(port_configs, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.map_patch_size == j.model.map_patch_size
    assert t.model.backbone_type == (
        "internimage" if name.endswith("intern_s") else "resnet")


@pytest.mark.parametrize("name", ["voxel_tiny_occ", "voxel_base_occ",
                                  "smoke_voxel_occ", "hybrid_tiny_occ",
                                  "hybrid_base_occ", "smoke_hybrid_occ",
                                  "hybrid_tiny_occ_intern_s"])
def test_voxel_and_hybrid_configs_equal_the_jax_ones(name):
    """The VoxelFormer and HybridFormer configs (the InternImage-S one
    built with ``dataclasses.replace`` on ``hybrid_tiny_occ``, as JAX
    builds it), field for field."""
    j = getattr(jax_configs, name)()
    t = getattr(port_configs, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.head_family == name.split("_")[name.startswith("smoke")]
    assert t.model.with_occupancy


def test_data_copies_equal_the_jax_ones():
    """camera_ring_lidar2img, make_batch (inference and det-GT keys) and
    StreamingState behave as the JAX package's originals, and the tables of
    the real-data copies (camera order, class maps, normalization, table
    and layer names, splits, map classes) equal theirs
    (tests/test_torch_data.py holds their functions)."""
    import numpy as np

    from apollo_vision_net_tpu.data import infos as jinfos
    from apollo_vision_net_tpu.data import map_extract as jme
    from apollo_vision_net_tpu.data import nusc_map as jnm
    from apollo_vision_net_tpu.data import nusc_tables as jnt
    from apollo_vision_net_tpu.data import nuscenes_dataset as jds
    from apollo_vision_net_tpu.data import pipeline as jpipe
    from apollo_vision_net_tpu.data import vector_map as jvm
    from apollo_vision_net_tpu_torch.data import infos as tinfos
    from apollo_vision_net_tpu_torch.data import map_extract as tme
    from apollo_vision_net_tpu_torch.data import nusc_map as tnm
    from apollo_vision_net_tpu_torch.data import nusc_tables as tnt
    from apollo_vision_net_tpu_torch.data import nuscenes_dataset as tds
    from apollo_vision_net_tpu_torch.data import pipeline as tpipe
    from apollo_vision_net_tpu_torch.data import vector_map as tvm

    for (jmod, tmod), names in (
            ((jinfos, tinfos), ("CAM_ORDER", "DETECTION_NAME_MAP")),
            ((jpipe, tpipe), ("IMG_MEAN", "IMG_STD")),
            ((jnt, tnt), ("TABLE_NAMES", "MINI_TRAIN", "MINI_VAL")),
            ((jnm, tnm), ("MAP_LOCATIONS", "LINE_LAYERS", "POLYGON_LAYERS",
                          "CENTERLINE_LAYERS")),
            ((jds, tds), ("DET_CLASSES",)),
            ((jvm, tvm), ("MAP_CLASS2LABEL", "PADDING_VALUE"))):
        for name in names:
            np.testing.assert_array_equal(getattr(tmod, name), getattr(jmod, name),
                                          err_msg=name)
    for cls in ("VectorizedLocalMap", "VectorizedLocalMapV2"):
        for attr in ("vec_classes", "line_layers", "ped_layers", "contour_layers"):
            assert getattr(getattr(tme, cls), attr) == getattr(getattr(jme, cls), attr)

    from apollo_vision_net_tpu.data import synthetic as jsyn
    from apollo_vision_net_tpu.data.temporal import StreamingState as JState
    from apollo_vision_net_tpu_torch.data import synthetic as tsyn
    from apollo_vision_net_tpu_torch.data.temporal import StreamingState

    np.testing.assert_array_equal(tsyn.camera_ring_lidar2img(6, 480, 800),
                                  jsyn.camera_ring_lidar2img(6, 480, 800))
    for cfg in (jax_configs.bev_smoke_det_map(), jax_configs.bev_smoke_det_occ()):
        want = jsyn.make_batch(cfg, batch_size=2, seed=5)
        got = tsyn.make_batch(port_configs.ExperimentConfig(
            **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}),
            batch_size=2, seed=5)
        assert set(got) == set(want)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    # random sparse occupancy GT: free voxels and every class
    assert (got["gt_occupancy"] == 16).mean() > 0.9
    cfg = jax_configs.bev_smoke_det_map()

    frames = tsyn.make_stream(cfg, 5, seed=1, scene_change_at=(3,))
    js, ts = JState(), StreamingState()
    for f in frames:
        a = js.prepare_frame(f["can_bus"], f["scene_token"])
        b = ts.prepare_frame(f["can_bus"], f["scene_token"])
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1] == b[1]
        js.update(object())
        ts.update(object())


def test_entry_points_raise_without_a_gpu(monkeypatch):
    from apollo_vision_net_tpu_torch import resolve_device
    from apollo_vision_net_tpu_torch.models.detector import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    for cfg in (port_configs.bev_tiny_det_map_apollo(),
                port_configs.bev_base_det_map(),
                port_configs.bev_tiny_det_occ_apollo()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    from apollo_vision_net_tpu_torch.tools.overfit_check import overfit

    with pytest.raises(RuntimeError, match="no CUDA device"):
        overfit(port_configs.bev_smoke_det_occ(), steps=1)
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("tool", ["train", "test"])
def test_clis_raise_without_a_gpu_unless_asked_for_the_cpu(tool, monkeypatch, tmp_path):
    """The train and test CLIs run on the card unless ``--device cpu``;
    without a card and without the flag they raise before any work, and
    with it they run (one synthetic step, one synthetic frame).
    ``tools.create_data`` runs no model: it reads tables and maps with
    numpy on any machine."""
    import importlib

    main = importlib.import_module(f"apollo_vision_net_tpu_torch.tools.{tool}").main
    argv = {"train": ["bev_smoke_det", "--steps", "1", "--work-dir", str(tmp_path)],
            "test": ["bev_smoke_det", "--num-frames", "1"]}[tool]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not list(tmp_path.iterdir())
    assert main(argv + ["--device", "cpu"]) == 0


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    """No result line without a GPU, and none from a directory that holds
    chip_smoke.py and nothing else of the repo."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env()
    env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_smoke_config_equals_the_jax_one():
    j = jax_configs.bev_smoke_det_map()
    t = port_configs.bev_smoke_det_map()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("name", ["bev_tiny_det_occ_apollo", "bev_smoke_det_occ"])
def test_occupancy_configs_equal_the_jax_ones(name):
    j = getattr(jax_configs, name)()
    t = getattr(port_configs, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.with_occupancy and t.model.group_detr > 1


@pytest.mark.parametrize("name", ["bev_tiny_det_occ_tsa_apollo",
                                  "bev_tiny_det_occ_flow",
                                  "bev_smoke_det_occ_flow"])
def test_occupancy_option_configs_equal_the_jax_ones(name):
    j = getattr(jax_configs, name)()
    t = getattr(port_configs, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    m = t.model
    assert m.with_occupancy and (m.occ_tsa or m.predict_flow)


@pytest.mark.parametrize("name", ["bev_tiny_det_mapv2", "smoke_det_mapv2"])
def test_mapv2_configs_equal_the_jax_ones(name):
    j = getattr(jax_configs, name)()
    t = getattr(port_configs, name)()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model.map_patch_size == j.model.map_patch_size
    assert t.model.with_map and t.model.map_version == 2 and t.model.with_aux_seg
    from apollo_vision_net_tpu_torch.models.detector import build_model

    head = build_model(t, device="cpu").head
    assert len(head.map_layers) == t.model.map_decoder_layers
    assert head.map_instance_embedding.shape[0] == (
        t.model.num_map_vec + t.model.num_vec_one2many)


def test_make_batch_multi_frame_and_flow_gt_equal_the_jax_ones():
    """make_batch's occupancy GT of every queue frame (with_occupancy_flow)
    and its flow GT, random and painted, and the single-frame flow GT of
    predict_flow alone, equal the JAX package's array for array."""
    import numpy as np

    from apollo_vision_net_tpu.data import synthetic as jsyn
    from apollo_vision_net_tpu_torch.data import synthetic as tsyn

    flow_alone = dataclasses.replace(
        jax_configs.bev_smoke_det_occ(), model=dataclasses.replace(
            jax_configs.bev_smoke_det_occ().model, predict_flow=True))
    cases = ((jax_configs.bev_smoke_det_occ_flow(), False, True),
             (jax_configs.bev_smoke_det_occ_flow(), True, True),
             (flow_alone, False, False))
    for cfg, paint, multi in cases:
        want = jsyn.make_batch(cfg, batch_size=2, seed=3, paint_gt=paint)
        got = tsyn.make_batch(port_configs.ExperimentConfig(
            **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}),
            batch_size=2, seed=3, paint_gt=paint)
        assert set(got) == set(want) and "gt_flow" in got
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
            assert v.dtype == want[k].dtype, k
        m = cfg.model
        vox = m.occ_zdim * m.occ_ydim * m.occ_xdim
        lead = (2, m.queue_length) if multi else (2,)
        assert got["gt_occupancy"].shape == lead + (vox,)
        assert got["gt_flow"].shape == lead + (vox, 2)
        obj = got["gt_occupancy"] < 10
        assert obj.any() and (got["gt_flow"][~obj] == 0).all()
        assert (got["gt_flow"][obj] != 0).all()


def test_make_batch_map_gt_and_painted_cues_equal_the_jax_ones():
    """make_batch with paint_gt (box and map cues painted into every frame)
    and its map GT keys, for the smoke and flagship-sized configs, equal the
    JAX package's make_batch array for array."""
    import numpy as np

    from apollo_vision_net_tpu.data import synthetic as jsyn
    from apollo_vision_net_tpu_torch.data import synthetic as tsyn

    def smaller(cfg):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, img_shape=(96, 160)))

    occ_keys = {"gt_occupancy"}
    map_keys = {"map_shift_pts", "map_labels", "map_mask", "map_order_mask"}
    for cfg, keys in ((jax_configs.bev_smoke_det_map(), map_keys),
                      (smaller(jax_configs.bev_tiny_det_map_apollo()), map_keys),
                      (jax_configs.bev_smoke_det_occ(), occ_keys),
                      (smaller(jax_configs.bev_tiny_det_occ_apollo()), occ_keys)):
        want = jsyn.make_batch(cfg, batch_size=3, seed=7, paint_gt=True)
        got = tsyn.make_batch(port_configs.ExperimentConfig(
            **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}),
            batch_size=3, seed=7, paint_gt=True)
        assert set(got) == set(want)
        assert keys <= set(got)
        for k, v in got.items():
            np.testing.assert_array_equal(v, want[k], err_msg=k)
        assert (got["img"] == 4.0).any()
        assert (got["img"] == -4.0).any() == (keys == map_keys)
        if keys == occ_keys:  # the voxelized boxes: some voxels of a class
            assert (got["gt_occupancy"] < cfg.model.occupancy_classes).any()


@pytest.mark.parametrize("pattern", ["v0", "v1", "v2"])
def test_vector_map_copy_equals_the_jax_one(pattern):
    """pack_map_gt (with its shift protocols and order mask) and
    resample_line equal the JAX package's, polylines and a closed polygon."""
    import numpy as np

    from apollo_vision_net_tpu.data import vector_map as jvm
    from apollo_vision_net_tpu.evaluation import map_eval as jme
    from apollo_vision_net_tpu_torch.data import vector_map as tvm

    rng = np.random.default_rng(3)
    line = np.cumsum(rng.uniform(-2, 2, (7, 2)), 0).astype(np.float32)
    ring = rng.uniform(-5, 5, (5, 2)).astype(np.float32)
    ring = np.concatenate([ring, ring[:1]])
    far = (line * 8).astype(np.float32)  # clamped to the patch
    vecs, labels = [line, ring, far], [0, 1, 2]
    for max_vec in (2, 5):
        want = jvm.pack_map_gt(vecs, labels, max_vec, fixed_num=10,
                               pattern=pattern, seed=4)
        got = tvm.pack_map_gt(vecs, labels, max_vec, fixed_num=10,
                              pattern=pattern, seed=4)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for pts, num in ((line, 20), (line, 7), (ring[:1], 4), (ring, 13)):
        np.testing.assert_array_equal(tvm.resample_line(pts, num),
                                      jme.resample_line(pts, num))


def test_trainer_raises_without_a_gpu(monkeypatch, tmp_path):
    from apollo_vision_net_tpu_torch.runtime.train_loop import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(port_configs.bev_tiny_det_map_apollo(), iter([]), num_steps=1,
              work_dir=str(tmp_path))
