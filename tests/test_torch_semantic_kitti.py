"""The port's SemanticKITTI data layer and occupancy-GT converter against
the JAX package's.

On a sequence written from a seed in the native formats
(``tests/test_semantic_kitti_reader.py::_write_sequence``: velodyne .bin,
.label, the packed voxel bitmaps and labels, calib.txt, poses.txt):

- every reader function of ``data/semantic_kitti_reader.py`` and every
  codec of ``data/semantic_kitti.py`` gives what the JAX original gives
  (arrays equal with their dtypes, records equal);
- ``tools/create_data.py semantic-kitti`` writes the same infos pickle and
  the same occupancy-GT files as the JAX package's ``create_semantic_kitti``;
- ``tools/convert_lidar_to_occ.py`` writes the same sparse GT as the JAX
  tool in single-frame mode and in sequence mode (pose-chained, dynamic
  classes from the centre frame only, voxel-space closing), the JAX tool
  on the JAX package's native library and the port on its own.
"""
import importlib.util
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apollo_vision_net_tpu.data import semantic_kitti as jsk  # noqa: E402
from apollo_vision_net_tpu.data import semantic_kitti_reader as jskr  # noqa: E402
from apollo_vision_net_tpu_torch.data import semantic_kitti as tsk  # noqa: E402
from apollo_vision_net_tpu_torch.data import semantic_kitti_reader as tskr  # noqa: E402
from apollo_vision_net_tpu_torch.tools import convert_lidar_to_occ as tconv  # noqa: E402
from apollo_vision_net_tpu_torch.tools import create_data as tcreate  # noqa: E402
from test_semantic_kitti_reader import _write_sequence  # noqa: E402
from test_torch_data import assert_same  # noqa: E402
from tools import create_data as jcreate  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "jax_convert_lidar_to_occ",
    Path(__file__).resolve().parent.parent / "tools" / "convert_lidar_to_occ.py")
jconv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jconv)


@pytest.fixture
def sequence(tmp_path):
    seq_dir, _, _, _ = _write_sequence(tmp_path, n_frames=3)
    return tmp_path, seq_dir


def test_reader_arrays_equal_the_jax_ones(sequence):
    _, seq_dir = sequence
    f = lambda sub, name: str(seq_dir / sub / name)  # noqa: E731
    for fn, path in ((tskr.read_points, f("velodyne", "000001.bin")),
                     (tskr.read_point_labels, f("labels", "000001.label")),
                     (tskr.read_voxel_bitmap, f("voxels", "000001.bin")),
                     (tskr.read_voxel_bitmap, f("voxels", "000001.invalid")),
                     (tskr.read_voxel_label, f("voxels", "000001.label")),
                     (tskr.read_calib, str(seq_dir / "calib.txt"))):
        assert_same(fn(path), getattr(jskr, fn.__name__)(path))
    calib = tskr.read_calib(str(seq_dir / "calib.txt"))
    for tr in (None, calib["Tr"]):
        assert_same(tskr.read_poses(str(seq_dir / "poses.txt"), tr),
                    jskr.read_poses(str(seq_dir / "poses.txt"), tr))
    label = tskr.read_voxel_label(f("voxels", "000000.label"))
    invalid = tskr.read_voxel_bitmap(f("voxels", "000000.invalid"))
    for inv in (None, invalid):
        assert_same(tskr.build_ssc_gt(label, inv), jskr.build_ssc_gt(label, inv))
    pose = np.arange(16.0).reshape(4, 4)
    assert_same(tskr.frame_info(str(seq_dir), 2, calib, pose, "seq_00", "x.npy"),
                jskr.frame_info(str(seq_dir), 2, calib, pose, "seq_00", "x.npy"))
    with pytest.raises(ValueError, match="expected"):
        tskr.read_voxel_label(f("labels", "000000.label"))


def test_label_codecs_and_record_equal_the_jax_ones():
    rng = np.random.default_rng(5)
    assert tsk.LEARNING_MAP == jsk.LEARNING_MAP and tsk.CLASS_NAMES == jsk.CLASS_NAMES
    assert_same(tsk.build_learning_map_array(), jsk.build_learning_map_array())
    raw = (rng.choice(list(jsk.LEARNING_MAP) + [300, 7], 500)
           | (rng.integers(0, 9, 500) << 16)).astype(np.uint32)
    assert_same(tsk.relabel(raw), jsk.relabel(raw))
    dense = rng.choice([0, 1, 5, 19, 255], (256, 256, 32)).astype(np.uint8)
    labels = tsk.dense_gt_to_training_labels(dense)
    assert_same(labels, jsk.dense_gt_to_training_labels(dense))
    assert_same(tsk.dense_to_sparse(labels), jsk.dense_to_sparse(labels))
    occ = tsk.dense_to_sparse(labels)
    assert_same(tsk.sparse_to_dense(occ), jsk.sparse_to_dense(occ))
    img = rng.integers(0, 256, (376, 1241, 3), np.uint8)
    k, l2c = rng.standard_normal((3, 3)), rng.standard_normal((4, 4))
    assert_same(tsk.sample_record(img, k, l2c, occ, "00", 4),
                jsk.sample_record(img, k, l2c, occ, "00", 4))


def _read_tree(out_dir):
    with open(out_dir / "semantic_kitti_infos.pkl", "rb") as f:
        payload = pickle.load(f)
    gts = {p.name: np.load(p) for p in sorted((out_dir / "occ_gt").iterdir())}
    return payload, gts


def test_create_data_semantic_kitti_equals_the_jax_converter(sequence, capsys):
    """The same out directory for both (the infos carry the GT paths): the
    JAX converter's pickle and GT files, then the port's over them."""
    root, _ = sequence
    out = root / "out"
    jcreate.create_semantic_kitti(str(root), str(out))
    want = _read_tree(out)
    assert tcreate.main(["semantic-kitti", "--root-path", str(root),
                         "--out-dir", str(out)]) == 0
    got = _read_tree(out)
    assert len(got[0]["infos"]) == 3 and len(got[1]) == 3
    assert_same(got, want)
    assert "wrote 3 infos" in capsys.readouterr().out


def _frames(tmp_path, seed=0, n=3, points=20_000):
    """``n`` labeled sweeps (x, y, z, label 0-15) over the tool's default
    100x100x8 m grid with a few points outside it, and poses 1.5 m apart
    with a small yaw."""
    rng = np.random.default_rng(seed)
    d = tmp_path / "lidar"
    d.mkdir()
    poses = []
    for i in range(n):
        xyz = rng.uniform([-52, -52, -6], [52, 52, 4], (points, 3))
        lab = rng.integers(0, 16, (points, 1))
        np.save(d / f"{i:06d}.npy", np.concatenate([xyz, lab], 1).astype(np.float32))
        c, s = np.cos(0.02 * i), np.sin(0.02 * i)
        poses.append(np.array([[c, -s, 0, 1.5 * i], [s, c, 0, 0.3 * i],
                               [0, 0, 1, 0], [0, 0, 0, 1]]))
    np.save(tmp_path / "poses.npy", np.stack(poses))
    return d


@pytest.mark.parametrize("mode", ["single", "sequence", "sequence_closed"])
def test_convert_lidar_to_occ_equals_the_jax_tool(tmp_path, monkeypatch, mode):
    lidar = _frames(tmp_path)
    if mode == "single":
        args = [str(lidar / "000001.npy")]
    else:
        args = ["sequence", str(lidar), "--center-id", "1", "--window", "3",
                "--poses", str(tmp_path / "poses.npy"),
                "--dynamic-classes", "1", "4", "9"]
        if mode == "sequence_closed":
            args += ["--fill", "voxel_morph"]
    outs = {}
    for name in ("jax", "port"):
        out = str(tmp_path / f"{name}.npy")
        argv = ([args[0], out] if mode == "single"
                else [args[0], args[1], out] + args[2:])
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["convert_lidar_to_occ.py"] + argv)
            jconv.main()
        else:
            assert tconv.main(argv) == 0
        outs[name] = np.load(out)
    assert outs["port"].dtype == outs["jax"].dtype == np.int64
    assert outs["port"].shape[1] == 2 and len(outs["port"]) > 10_000
    np.testing.assert_array_equal(outs["port"], outs["jax"])
