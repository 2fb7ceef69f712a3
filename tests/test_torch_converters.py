"""The port's dataset converters against the JAX package's, byte for byte.

Each tree is written from a seed as tests/test_converters.py and
tests/test_kitti2waymo.py write theirs; the JAX converter runs on it, the
tree is written again in the same place, and the port's runs (through its
``create_data`` CLI where one of the eight choices drives it): every file
either writes must have the same bytes. The devkit-gated conversions (Lyft's
``lyft_dataset_sdk``, Waymo's tensorflow) are held by their conversion
functions on the duck-typed inputs of tests/test_converters.py; the lyft
choice by its gate's message, the waymo choice on a directory without
tfrecords.
"""
import importlib.util
import os
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest

from apollo_vision_net_tpu.data import gt_database as jgtdb
from apollo_vision_net_tpu.data import indoor as jindoor
from apollo_vision_net_tpu.data import kitti as jkitti
from apollo_vision_net_tpu.data import lyft as jlyft
from apollo_vision_net_tpu.data import waymo as jwaymo
from apollo_vision_net_tpu.evaluation import kitti2waymo as jk2w
from apollo_vision_net_tpu_torch.data import indoor as tindoor
from apollo_vision_net_tpu_torch.data import kitti as tkitti
from apollo_vision_net_tpu_torch.data import lyft as tlyft
from apollo_vision_net_tpu_torch.data import waymo as twaymo
from apollo_vision_net_tpu_torch.evaluation import kitti2waymo as tk2w
from apollo_vision_net_tpu_torch.tools import create_data as tcreate
from test_converters import _FakeLyft, _make_kitti, _png_bytes

REPO = Path(__file__).resolve().parent.parent


def jax_create_data():
    """The JAX package's tools/create_data.py as a module (a script there)."""
    spec = importlib.util.spec_from_file_location(
        "jax_create_data", REPO / "tools" / "create_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def snapshot(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def written_by(root: str, build, run) -> dict:
    """{path: bytes} of the files that ``run()`` adds to or changes in the
    tree that ``build(root)`` writes (from nothing)."""
    shutil.rmtree(root, ignore_errors=True)
    build(root)
    before = snapshot(root)
    run()
    return {k: v for k, v in snapshot(root).items() if before.get(k) != v}


def assert_same_files(root, build, run_jax, run_port):
    want = written_by(root, build, run_jax)
    got = written_by(root, build, run_port)
    assert want, "the JAX converter wrote nothing"
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k


def make_scannet(root, seed=0):
    """tests/test_converters.py's ScanNet tree: two scans of 500 points."""
    inst = os.path.join(root, "scannet_instance_data")
    meta = os.path.join(root, "meta_data")
    os.makedirs(inst)
    os.makedirs(meta)
    rng = np.random.default_rng(seed)
    scans = ["scene0000_00", "scene0001_00"]
    for scan in scans:
        n = 500
        np.save(os.path.join(inst, f"{scan}_vert.npy"),
                rng.normal(size=(n, 6)).astype(np.float32))
        np.save(os.path.join(inst, f"{scan}_ins_label.npy"), rng.integers(0, 5, n))
        np.save(os.path.join(inst, f"{scan}_sem_label.npy"),
                rng.choice([1, 3, 4, 39], n))
        boxes = np.array([[0, 0, 0.5, 2.0, 1.5, 0.6, 4],
                          [1, 1, 0.2, 0.4, 0.4, 0.5, 39]], np.float64)
        np.save(os.path.join(inst, f"{scan}_aligned_bbox.npy"), boxes)
        np.save(os.path.join(inst, f"{scan}_unaligned_bbox.npy"), boxes)
        np.save(os.path.join(inst, f"{scan}_axis_align_matrix.npy"), np.eye(4))
    with open(os.path.join(meta, "scannetv2_train.txt"), "w") as f:
        f.write(scans[0] + "\n")
    with open(os.path.join(meta, "scannetv2_val.txt"), "w") as f:
        f.write(scans[1] + "\n")


def waymo_frame(seed=0):
    """tests/test_converters.py's Waymo frame: a vehicle, a sign and an
    empty pedestrian, one camera."""
    ext = np.eye(4)
    ext[:3, 3] = [1.5, 0.0, 2.0]
    return {
        "timestamp_micros": 123456, "pose": np.eye(4),
        "images": {0: _png_bytes(8, 8)},
        "camera_calibs": {0: {"extrinsic": ext,
                              "intrinsic": [2000.0, 2000.0, 960.0, 640.0]}},
        "points": np.random.default_rng(seed).normal(size=(100, 6)).astype(np.float32),
        "laser_labels": [
            {"id": "obj1", "type": 1, "center": (10.0, 2.0, 1.0),
             "size": (4.5, 2.0, 1.8), "heading": 0.5,
             "num_lidar_points_in_box": 50, "camera_name": 0,
             "bbox": (100.0, 200.0, 300.0, 400.0)},
            {"id": "obj2", "type": 3, "center": (5.0, 0.0, 2.0),
             "size": (0.5, 0.5, 1.0), "heading": 0.0,
             "num_lidar_points_in_box": 5, "camera_name": None, "bbox": None},
            {"id": "obj3", "type": 2, "center": (3.0, 1.0, 0.5),
             "size": (0.6, 0.6, 1.7), "heading": 0.0,
             "num_lidar_points_in_box": 0, "camera_name": None, "bbox": None},
        ],
    }


def test_create_data_takes_the_jax_cli_choices():
    """The eight subcommands and the options of the JAX CLI."""
    src = (REPO / "tools" / "create_data.py").read_text()
    for choice in ("nuscenes", "nuscenes-map-gt", "semantic-kitti", "kitti",
                   "lyft", "waymo", "scannet", "gt-database"):
        assert f'"{choice}"' in src
        with pytest.raises(SystemExit) as e:
            tcreate.main([choice, "--help"])
        assert e.value.code == 0
    with pytest.raises(SystemExit):
        tcreate.main(["nuplan", "--root-path", "x"])


def test_kitti_choice_writes_what_jax_writes(tmp_path):
    """``create_data kitti``: infos of every split, reduced clouds, the
    2D annotations and the GT database with its db infos."""
    root = str(tmp_path / "kitti")
    assert_same_files(
        root, _make_kitti,
        lambda: jax_create_data().kitti_data_prep(root, "kitti", root),
        lambda: tcreate.main(["kitti", "--root-path", root]))


def test_gt_database_choice_writes_what_jax_writes(tmp_path):
    root = str(tmp_path / "kitti")

    def build(r):
        _make_kitti(r)
        jkitti.create_kitti_infos(r, save_path=r)

    infos = os.path.join(root, "kitti_infos_train.pkl")
    assert_same_files(
        root, build,
        lambda: jgtdb.create_groundtruth_database("kitti", root, infos, "kitti"),
        lambda: tcreate.main(["gt-database", "--root-path", root,
                              "--infos", infos]))


def test_scannet_choice_writes_what_jax_writes(tmp_path):
    """``create_data scannet``: infos, point and mask bins, and the
    segmentation resampling of ScanNetSegData."""
    root = str(tmp_path / "scannet")

    def run(indoor, cli):
        if cli:
            tcreate.main(["scannet", "--root-path", root, "--workers", "2"])
        else:
            jindoor.create_indoor_info_file(root, "scannet", workers=2)
        seg = indoor.ScanNetSegData(
            root, os.path.join(root, "scannet_infos_train.pkl"), "train")
        seg.get_scene_idxs_and_label_weight()

    assert_same_files(root, make_scannet, lambda: run(jindoor, False),
                      lambda: run(tindoor, True))


def test_kitti_geometry_equals_jax():
    rng = np.random.default_rng(0)
    boxes = np.column_stack([rng.normal(0, 5, (6, 3)), rng.uniform(0.5, 4, (6, 3)),
                             rng.uniform(-np.pi, np.pi, 6)])
    pts = rng.normal(0, 5, (400, 3))
    assert np.array_equal(tkitti.points_in_rbbox(pts, boxes),
                          jkitti.points_in_rbbox(pts, boxes))
    r0, tr = np.eye(4), np.eye(4)
    tr[:3, :3] = [[0, -1, 0], [0, 0, -1], [1, 0, 0]]
    tr[:3, 3] = [0.0, -0.08, -0.27]
    assert np.array_equal(tkitti.box_camera_to_lidar(boxes, r0, tr),
                          jkitti.box_camera_to_lidar(boxes, r0, tr))


def test_lyft_infos_equal_jax(tmp_path):
    """fill_trainval_infos on the duck-typed devkit: the pickled infos are
    the same bytes; the CLI choice stops at the devkit's gate."""
    got = tlyft.fill_trainval_infos(_FakeLyft(str(tmp_path)), {"sc0"}, set(),
                                    max_sweeps=2)
    want = jlyft.fill_trainval_infos(_FakeLyft(str(tmp_path)), {"sc0"}, set(),
                                     max_sweeps=2)
    assert pickle.dumps(got) == pickle.dumps(want)
    assert tlyft.LYFT_CLASSES == jlyft.LYFT_CLASSES
    with pytest.raises(SystemExit, match="lyft_dataset_sdk"):
        tcreate.main(["lyft", "--root-path", str(tmp_path)])


def test_waymo_frame_writes_what_jax_writes(tmp_path):
    """convert_frame's KITTI files are the same bytes; the CLI choice
    converts a directory without tfrecords to nothing (on one it stops at
    the tensorflow gate, which chip_smoke.py's converters phase reads: the
    gate imports tensorflow where it is installed)."""
    root = str(tmp_path / "waymo_kitti")
    for test_mode in (False, True):
        assert_same_files(
            root, os.makedirs,
            lambda: jwaymo.convert_frame(waymo_frame(), root, 0, 1, 5,
                                         test_mode=test_mode),
            lambda: twaymo.convert_frame(waymo_frame(), root, 0, 1, 5,
                                         test_mode=test_mode))
    src = tmp_path / "records"
    src.mkdir()
    tcreate.main(["waymo", "--root-path", str(src), "--out-dir", root])


def test_kitti2waymo_writes_what_jax_writes(tmp_path):
    """KittiToWaymoConverter: per-frame and combined JSON, the same bytes
    (the run of tests/test_kitti2waymo.py: one frame without
    predictions, one prediction without a frame)."""
    def result(key, n, name="Car"):
        rng = np.random.default_rng(n)
        return dict(sample_idx=np.array([key] * n), name=np.array([name] * n),
                    location=rng.normal(0, 5, (n, 3)),
                    dimensions=rng.uniform(0.5, 4, (n, 3)),
                    rotation_y=rng.uniform(-np.pi, np.pi, n),
                    score=np.linspace(0.9, 0.5, n))

    results = [result("val000000", 2), result("val000001", 1, "Pedestrian"),
               result("val999999", 3)]
    T = np.eye(4)
    T[:3, 3] = [1.5, 0.1, 2.0]
    frames = [dict(filename=f"val00000{i}", context_name=f"c{i}",
                   frame_timestamp_micros=10 + i, T_front_cam_to_vehicle=T)
              for i in range(3)]
    out = str(tmp_path / "waymo_out")
    assert_same_files(
        out, os.makedirs,
        lambda: jk2w.KittiToWaymoConverter(results, workers=2).convert(frames, out),
        lambda: tk2w.KittiToWaymoConverter(results, workers=2).convert(frames, out))
    assert tk2w.K2W_CLASS_MAP == jk2w.K2W_CLASS_MAP
    assert np.array_equal(tk2w.T_REF_TO_FRONT_CAM, jk2w.T_REF_TO_FRONT_CAM)
