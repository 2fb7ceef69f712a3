"""The port's real-data layer against the JAX package's, byte for byte.

The port keeps its own numpy copies of the nuScenes data path
(``data/{temporal,infos,pipeline,semantic_kitti,nuscenes_dataset,loader,
nusc_tables,geometry2d,nusc_map,map_extract}.py`` and
``tools/create_data.py``'s converters); on the same seeded inputs each
gives what the JAX original gives (``np.array_equal`` on arrays, ``==`` on
records, dtypes included):

- the image pipeline (photometric distortion at one seed, normalize,
  bilinear scale with the patched lidar2img, pad to 32; the eval path with
  both packages' native libraries switched off, so that both take the
  numpy path: tests/test_torch_native.py holds the native paths), the
  infos helpers, queue sampling and
  union2one, sparse occupancy GT;
- the devkit-free table reader, the 2-D geometry, the map-expansion reader
  and the vector-map extraction (v1 and v2) on the JAX tests' fake city;
- ``create_nuscenes_infos`` on ``tests/test_nusc_tables.py::_fake_tables``
  and ``add_map_gt_to_infos`` on it and on
  ``tests/test_real_data_path.py::_fake_nuscenes``;
- ``NuScenesTemporalDataset.get_queue_sample`` (training mode, one seed)
  for a det+map config and a det+occ+flow config (multi-frame occupancy
  and flow GT from npy files), and the loader's batches at
  ``num_workers=0`` (the dataset's one rng makes threaded draws depend on
  their order, in JAX as well).
"""
import dataclasses
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apollo_vision_net_tpu.configs import base as jax_configs  # noqa: E402
from apollo_vision_net_tpu.data import geometry2d as jg2  # noqa: E402
from apollo_vision_net_tpu.data import infos as jinfos  # noqa: E402
from apollo_vision_net_tpu.data import loader as jloader  # noqa: E402
from apollo_vision_net_tpu.data import map_extract as jme  # noqa: E402
from apollo_vision_net_tpu.data import nusc_map as jnm  # noqa: E402
from apollo_vision_net_tpu.data import nusc_tables as jnt  # noqa: E402
from apollo_vision_net_tpu.data import nuscenes_dataset as jds  # noqa: E402
from apollo_vision_net_tpu.data import pipeline as jpipe  # noqa: E402
from apollo_vision_net_tpu.data import semantic_kitti as jsk  # noqa: E402
from apollo_vision_net_tpu.data import temporal as jtemporal  # noqa: E402
from apollo_vision_net_tpu_torch import configs as port_configs  # noqa: E402
from apollo_vision_net_tpu_torch.data import geometry2d as tg2  # noqa: E402
from apollo_vision_net_tpu_torch.data import infos as tinfos  # noqa: E402
from apollo_vision_net_tpu_torch.data import loader as tloader  # noqa: E402
from apollo_vision_net_tpu_torch.data import map_extract as tme  # noqa: E402
from apollo_vision_net_tpu_torch.data import nusc_map as tnm  # noqa: E402
from apollo_vision_net_tpu_torch.data import nusc_tables as tnt  # noqa: E402
from apollo_vision_net_tpu_torch.data import nuscenes_dataset as tds  # noqa: E402
from apollo_vision_net_tpu_torch.data import pipeline as tpipe  # noqa: E402
from apollo_vision_net_tpu_torch.data import semantic_kitti as tsk  # noqa: E402
from apollo_vision_net_tpu_torch.data import temporal as ttemporal  # noqa: E402
from apollo_vision_net_tpu_torch.evaluation import formatting as tformatting  # noqa: E402
from apollo_vision_net_tpu_torch.tools import create_data as tcreate  # noqa: E402
from test_map_extract import _build_city  # noqa: E402
from test_nusc_tables import _fake_tables  # noqa: E402
from test_real_data_path import _fake_nuscenes  # noqa: E402
from tools import create_data as jcreate  # noqa: E402


def assert_same(got, want, where="."):
    """Equal nested dicts / lists / tuples of arrays and scalars, arrays
    with their dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_same(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, (where, got, want)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def port_cfg(jcfg):
    return port_configs.ExperimentConfig(
        **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})


# ------------------------------------------------------------ pipeline

def test_image_pipeline_equals_the_jax_one(monkeypatch):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (3, 45, 70, 3), np.uint8)
    l2i = rng.standard_normal((3, 4, 4)).astype(np.float32)
    for seed in range(6):  # every branch of the distortion's draws
        a = jpipe.photometric_distortion(imgs.astype(np.float32),
                                         np.random.default_rng(seed))
        b = tpipe.photometric_distortion(imgs.astype(np.float32),
                                         np.random.default_rng(seed))
        assert_same(b, a)
    x = jpipe.normalize_images(imgs)
    assert_same(tpipe.normalize_images(imgs), x)
    for scale in (0.5, 0.37, 1.0):
        assert_same(tpipe.scale_images(x, l2i, scale), jpipe.scale_images(x, l2i, scale))
    assert_same(tpipe.pad_images(x), jpipe.pad_images(x))
    from apollo_vision_net_tpu.data import native

    monkeypatch.setattr(native, "resize_normalize_pad", lambda *a: None)
    monkeypatch.setattr(tpipe.native, "resize_normalize_pad", tpipe.plain_resize_normalize_pad)
    for training in (True, False):
        want = jpipe.preprocess_frame(imgs, l2i, scale=0.5, training=training,
                                      rng=np.random.default_rng(3))
        got = tpipe.preprocess_frame(imgs, l2i, scale=0.5, training=training,
                                     rng=np.random.default_rng(3))
        assert got[0].shape == (3, 32, 64, 3)
        assert_same(got, want)


def test_infos_temporal_and_occupancy_helpers_equal_the_jax_ones(tmp_path):
    rng = np.random.default_rng(1)
    for _ in range(4):
        q = rng.standard_normal(4)
        assert_same(tinfos.quat_to_rot(q), jinfos.quat_to_rot(q))
        assert_same(tformatting.quat_to_rot(q), jinfos.quat_to_rot(q))
        assert tinfos.quat_yaw(q) == jinfos.quat_yaw(q)
    assert_same(tinfos.quat_to_rot([0, 0, 0, 0]), jinfos.quat_to_rot([0, 0, 0, 0]))
    root, infos_path = _fake_nuscenes(tmp_path)
    infos = jinfos.load_infos(str(infos_path))
    assert_same(tinfos.load_infos(str(infos_path)), infos)
    info = dict(infos[1], ego2global_rotation=list(rng.standard_normal(4)),
                lidar2ego_rotation=list(rng.standard_normal(4)))
    for cams in (jinfos.CAM_ORDER, jinfos.CAM_ORDER[:2]):
        assert_same(tinfos.lidar2img_from_info(info, cams),
                    jinfos.lidar2img_from_info(info, cams))
    assert_same(tinfos.patched_can_bus(info), jinfos.patched_can_bus(info))
    assert_same(tinfos.lidar2global(info), jinfos.lidar2global(info))

    for index in (0, 1, 2, 5, 9):
        for qlen in (1, 2, 3, 4):
            a = jtemporal.sample_queue_indices(index, qlen, np.random.default_rng(index))
            b = ttemporal.sample_queue_indices(index, qlen, np.random.default_rng(index))
            assert_same(b, a)
    cbs = [rng.standard_normal(18).astype(np.float32) for _ in range(5)]
    scenes = ["a", "a", "b", "b", "b"]
    assert_same(ttemporal.union2one_can_bus(cbs, scenes),
                jtemporal.union2one_can_bus(cbs, scenes))

    occ = np.stack([rng.choice(1000, 50, replace=False),
                    rng.integers(0, 16, 50)], 1)
    flow = rng.standard_normal((50, 2)).astype(np.float32)
    assert_same(tsk.sparse_to_dense(occ, 1000, 16), jsk.sparse_to_dense(occ, 1000, 16))
    assert_same(tsk.sparse_flow_to_dense(occ, flow, 1000),
                jsk.sparse_flow_to_dense(occ, flow, 1000))
    assert (tsk.OCCUPANCY_CLASSES, tsk.VOXEL_NUM) == (jsk.OCCUPANCY_CLASSES, jsk.VOXEL_NUM)


# ------------------------------------------- tables, geometry, map GT

def test_table_reader_and_geometry_equal_the_jax_ones(tmp_path):
    root = _fake_tables(tmp_path)
    j = jnt.NuScenesTables(str(root), "v1.0-mini")
    t = tnt.NuScenesTables(str(root), "v1.0-mini")
    assert_same(t.sample, j.sample)
    assert_same(t.scene, j.scene)
    for ann in j._tables["sample_annotation"]:
        assert_same(t.box_velocity(ann["token"]), j.box_velocity(ann["token"]))
    assert_same(t.get_can_bus_pose("scene-0061"), j.get_can_bus_pose("scene-0061"))
    assert_same(tnt.resolve_splits("v1.0-mini"), jnt.resolve_splits("v1.0-mini"))

    rng = np.random.default_rng(2)
    rings = [rng.uniform(-12, 12, (n, 2)) for n in (3, 5, 8)]
    rings += [np.array([[0, 0], [4, 0], [4, 4], [0, 4.0]]),
              np.array([[2, 2], [6, 2], [6, 6], [2, 6.0]])]
    for r in rings:
        assert_same(tg2.clip_ring_to_box(r, 5.0, 3.0), jg2.clip_ring_to_box(r, 5.0, 3.0))
        assert tg2.ring_area(r) == jg2.ring_area(r)
        for p in rng.uniform(-12, 12, (6, 2)):
            assert tg2.point_in_polygon(p, (r, [])) == jg2.point_in_polygon(p, (r, []))
    polys = [(r, []) for r in rings[3:]] + [(rings[1], [])]
    assert_same(tg2.union_exterior_contours(polys), jg2.union_exterior_contours(polys))
    line = np.cumsum(rng.standard_normal((40, 2)), 0)
    assert_same(tg2.simplify_line(line, 0.2), jg2.simplify_line(line, 0.2))


@pytest.mark.parametrize("version", [1, 2])
def test_map_reader_and_extraction_equal_the_jax_ones(version):
    city = _build_city()
    jm, tm = jnm.NuScenesMapJSON(city, "testville"), tnm.NuScenesMapJSON(city, "testville")
    for tok in ("ln_d1", "ln_d2"):
        assert_same(tm.extract_line(tok), jm.extract_line(tok))
    for layer in ("road_segment", "lane", "ped_crossing"):
        assert_same(tm.record_polygons(layer), jm.record_polygons(layer))
    for lane in ("laneA", "laneB"):
        assert_same(tm.discretize_lane(lane), jm.discretize_lane(lane))
        assert tm.outgoing_lane_ids(lane) == jm.outgoing_lane_ids(lane)
    jcls = jme.VectorizedLocalMapV2 if version == 2 else jme.VectorizedLocalMap
    tcls = tme.VectorizedLocalMapV2 if version == 2 else tme.VectorizedLocalMap
    jv = jcls({"testville": jm}, patch_size=(60.0, 30.0))
    tv = tcls({"testville": tm}, patch_size=(60.0, 30.0))
    for center, yaw in (((20.0, 0.0), 0.0), ((12.0, 3.0), 0.7), ((5.0, -4.0), -2.1)):
        want = jv.gen_vectorized_samples_pose("testville", np.asarray(center), yaw)
        assert_same(tv.gen_vectorized_samples_pose("testville", np.asarray(center), yaw), want)
        assert want[0]
    q = [float(np.cos(0.35)), 0.0, 0.0, float(np.sin(0.35))]
    assert_same(tv.gen_vectorized_samples("testville", [18.0, 1.0, 0.0], q),
                jv.gen_vectorized_samples("testville", [18.0, 1.0, 0.0], q))


def _read(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_converters_equal_the_jax_ones(tmp_path):
    """create_nuscenes_infos on the fake table dump, then
    add_map_gt_to_infos (v1 and v2) on its output (a city map written for
    its location) and on the fake on-disk nuScenes."""
    root = _fake_tables(tmp_path)
    (root / "maps" / "expansion").mkdir(parents=True)
    (root / "maps" / "expansion" / "singapore-onenorth.json").write_text(
        json.dumps(_build_city()))
    jcreate.create_nuscenes_infos(str(root), "v1.0-mini", str(tmp_path / "j"))
    tcreate.create_nuscenes_infos(str(root), "v1.0-mini", str(tmp_path / "t"))
    for split in ("train", "val"):
        name = f"nuscenes_infos_temporal_{split}.pkl"
        assert_same(_read(tmp_path / "t" / name), _read(tmp_path / "j" / name))
        for version in (1, 2):
            outs = []
            for side, mod in (("j", jcreate), ("t", tcreate)):
                out = str(tmp_path / f"{side}{version}_{name}")
                mod.add_map_gt_to_infos(str(tmp_path / side / name), str(root),
                                        out_path=out, map_version=version)
                outs.append(_read(out))
            assert_same(outs[1], outs[0])
            assert all(i["map_vectors"] for i in outs[0]["infos"])
    froot, infos_path = _fake_nuscenes(tmp_path / "fake")
    outs = []
    for side, mod in (("j", jcreate), ("t", tcreate)):
        out = str(tmp_path / f"fake_{side}.pkl")
        mod.add_map_gt_to_infos(str(infos_path), str(froot), out_path=out,
                                map_version=2)
        outs.append(_read(out))
    assert_same(outs[1], outs[0])


# ------------------------------------------------------- dataset, loader

def _occ_tree(tmp_path, cfg):
    """The fake on-disk nuScenes with map GT, and per sample a sparse
    occupancy GT and its flow rows as npy files."""
    root, infos_path = _fake_nuscenes(tmp_path)
    jcreate.add_map_gt_to_infos(str(infos_path), str(root), map_version=1)
    payload = _read(infos_path)
    m = cfg.model
    vox = m.occ_zdim * m.occ_ydim * m.occ_xdim
    rng = np.random.default_rng(4)
    for t, info in enumerate(payload["infos"]):
        occ = np.stack([rng.choice(vox, 40, replace=False),
                        rng.integers(0, m.occupancy_classes, 40)], 1)
        np.save(root / f"occ{t}.npy", occ)
        np.save(root / f"flow{t}.npy", rng.standard_normal((40, 2)).astype(np.float32))
        info.update(occ_gt_path=f"occ{t}.npy", flow_gt_path=f"flow{t}.npy")
    with open(infos_path, "wb") as f:
        pickle.dump(payload, f)
    return root, infos_path


@pytest.mark.parametrize("name", ["bev_smoke_det_map", "bev_smoke_det_occ_flow"])
def test_dataset_queue_samples_and_loader_equal_the_jax_ones(tmp_path, monkeypatch,
                                                            name):
    jcfg = getattr(jax_configs, name)()
    root, infos_path = _occ_tree(tmp_path, jcfg)
    kw = dict(data_root=str(root), img_scale=1.0, seed=7)
    jset = jds.NuScenesTemporalDataset(jcfg, str(infos_path), training=True, **kw)
    tset = tds.NuScenesTemporalDataset(port_cfg(jcfg), str(infos_path), training=True, **kw)
    for i in (3, 1, 0, 2):
        want = jset.get_queue_sample(i)
        assert_same(tset.get_queue_sample(i), want)
    keys = {"map_shift_pts", "map_mask"} if name.endswith("map") else {"gt_occupancy", "gt_flow"}
    assert keys <= set(want)
    if name.endswith("flow"):  # every queue frame's occupancy and flow
        assert want["gt_flow"].shape[0] == jcfg.model.queue_length
    idx = jloader.shuffled_epoch_indices(len(jset), 3, drop_last_to=2)
    assert_same(tloader.shuffled_epoch_indices(len(tset), 3, drop_last_to=2), idx)
    want = list(jloader.PrefetchLoader(jset.get_queue_sample, idx, 2, num_workers=0))
    got = list(tloader.PrefetchLoader(tset.get_queue_sample, idx, 2, num_workers=0))
    assert_same(got, want)
    # eval mode (both packages' fused native resize switched off: both
    # take the numpy path)
    jeval = jds.NuScenesTemporalDataset(jcfg, str(infos_path), training=False, **kw)
    teval = tds.NuScenesTemporalDataset(port_cfg(jcfg), str(infos_path), training=False, **kw)
    from apollo_vision_net_tpu.data import native

    monkeypatch.setattr(native, "resize_normalize_pad", lambda *a: None)
    monkeypatch.setattr(tpipe.native, "resize_normalize_pad", tpipe.plain_resize_normalize_pad)
    assert_same(teval.get_frame(1), jeval.get_frame(1))
    assert tds.scene_contiguous_eval_indices(teval.infos, 2, 1) == \
        jds.scene_contiguous_eval_indices(jeval.infos, 2, 1)
    assert_same(tds.collate(want[:1]), jds.collate(want[:1]))
