"""The port's native host library against the JAX package's, and against
its own plain versions.

- ``data/native.py::resize_normalize_pad`` bit-equal to the JAX package's
  ``data/native.py`` on the same uint8 rings (six cameras at 45x70 and at
  900x1600, scale 0.5), and ``voxelize_points`` bit-equal on points with
  ties, points outside the range, labels outside the classes and a
  120,000-point scan over SemanticKITTI's 256x256x32 grid.
- Against the numpy path (the plain versions): the fused resize within the
  JAX package's own tolerance (``tests/test_native.py``: rtol 2e-4, atol
  2e-3) at 64x96 and the 900x1600 ring; at 45 rows and scale 0.5 the
  library rounds the resized height half away from zero (23 rows) where
  numpy rounds half to even (22), as the JAX package's library does, and
  writes one more row; ``voxelize_points`` equal label for label to
  ``tools/convert_lidar_to_occ.py::voxelize_numpy``.
- The eval ``preprocess_frame`` (native on in both packages) equal to the
  JAX package's, and a failed build raising with the compiler's message.
"""
import numpy as np
import pytest

from apollo_vision_net_tpu.data import native as jnative
from apollo_vision_net_tpu.data import pipeline as jpipe
from apollo_vision_net_tpu_torch.data import native as tnative
from apollo_vision_net_tpu_torch.data import pipeline as tpipe
from apollo_vision_net_tpu_torch.tools.convert_lidar_to_occ import voxelize_numpy

# tests/test_native.py's limits for the fused call against the numpy path
RTOL, ATOL = 2e-4, 2e-3
KITTI_GRID = dict(pc_range=(0.0, -25.6, -2.0, 51.2, 25.6, 4.4),
                  voxel_size=(0.2, 0.2, 0.2), dims=(256, 256, 32),
                  num_classes=19, empty_label=19)


def _ring(h, w, seed=0, n=6):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), np.uint8)


def _bits(a):
    assert a.dtype == np.float32
    return a.view(np.uint32)


@pytest.mark.parametrize("hw", [(45, 70), (900, 1600)])
def test_resize_normalize_pad_is_bit_equal_to_jax(hw):
    imgs = _ring(*hw)
    want = jnative.resize_normalize_pad(imgs, 0.5, jpipe.IMG_MEAN, jpipe.IMG_STD, 32)
    got = tnative.resize_normalize_pad(imgs, 0.5, tpipe.IMG_MEAN, tpipe.IMG_STD, 32)
    assert got.shape == want.shape == (6, -(-hw[0] // 64) * 32, -(-hw[1] // 64) * 32, 3)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _tie_points():
    """Points on a 4x2x2 grid of 0.5 m voxels: a 2-2 tie (the smaller
    label wins), a majority over a minority, one point alone, points
    outside each bound, on the upper faces (outside) and on the lower ones
    (inside), and labels outside [0, 16)."""
    return np.array([
        [0.1, 0.1, 0.1, 7], [0.2, 0.2, 0.2, 7], [0.3, 0.1, 0.2, 3], [0.1, 0.4, 0.4, 3],
        [0.6, 0.1, 0.1, 2], [0.7, 0.2, 0.1, 2], [0.8, 0.3, 0.1, 9],
        [1.5, 0.5, 0.5, 11],
        [-0.1, 0.2, 0.2, 1], [2.0, 0.2, 0.2, 1], [0.2, 1.0, 0.2, 1],
        [0.2, 0.2, 1.0, 1], [0.2, -1e-4, 0.2, 1], [99.0, 0.0, 0.0, 1],
        [0.0, 0.0, 0.0, 5], [1.0, 0.5, 0.5, 4],
        [1.2, 0.2, 0.7, 16], [1.2, 0.2, 0.7, -1], [1.2, 0.2, 0.7, 20.0],
    ], np.float32)


def _scan(n=120_000, seed=0):
    """A scan over and around the SemanticKITTI grid with labels -1..20."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform([-2, -28, -3], [54, 28, 5], (n, 3))
    return np.concatenate([xyz, rng.integers(-1, 21, (n, 1))], 1).astype(np.float32)


TIES = dict(pc_range=(0, 0, 0, 2, 1, 1), voxel_size=(0.5, 0.5, 0.5),
            dims=(4, 2, 2), num_classes=16, empty_label=16)


@pytest.mark.parametrize("case", ["ties", "scan"])
def test_voxelize_points_is_bit_equal_to_jax_and_to_the_plain_version(case):
    pts, grid = (_tie_points(), TIES) if case == "ties" else (_scan(), KITTI_GRID)
    want = jnative.voxelize_points(pts, **grid)
    got = tnative.voxelize_points(pts, **grid)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(voxelize_numpy(pts, **grid), got)
    if case == "ties":
        grid_zyx = got.reshape(2, 2, 4)
        assert grid_zyx[0, 0, 0] == 3   # the 2-2 tie of labels 7 and 3
        assert grid_zyx[0, 0, 1] == 2   # 2 over 9
        assert grid_zyx[1, 1, 3] == 11  # (1.5, .5, .5) alone
        assert grid_zyx[1, 1, 2] == 4   # lower faces are inside
        assert (got != 16).sum() == 4   # nothing else: every other point is out
    else:
        assert 60_000 < (got != 19).sum() < 120_000


@pytest.mark.parametrize("hw", [(64, 96), (900, 1600)])
def test_native_resize_matches_the_numpy_path(hw):
    imgs = _ring(*hw, seed=1)
    got = tnative.resize_normalize_pad(imgs, 0.5, tpipe.IMG_MEAN, tpipe.IMG_STD, 32)
    want = tpipe.plain_resize_normalize_pad(imgs, 0.5)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_native_resize_writes_the_half_way_row_the_numpy_path_pads():
    """45 rows at scale 0.5: the library resizes to lround(22.5) = 23 rows,
    the numpy path to round(22.5) = 22 (both pad to 32); row 22 is the
    resampled last row in one and zeros in the other, the rest agrees."""
    imgs = _ring(45, 70, seed=2)
    got = tnative.resize_normalize_pad(imgs, 0.5, tpipe.IMG_MEAN, tpipe.IMG_STD, 32)
    want = tpipe.plain_resize_normalize_pad(imgs, 0.5)
    assert tnative.resized_size(45, 0.5) == 23 and round(45 * 0.5) == 22
    keep = np.ones(32, bool)
    keep[22] = False
    np.testing.assert_allclose(got[:, keep], want[:, keep], rtol=RTOL, atol=ATOL)
    assert not want[:, 22].any() and np.abs(got[:, 22, :35]).min() > 0
    # a size whose even rounding is a multiple of 32: the buffer holds the
    # library's 33rd row instead of the library writing past it
    assert tnative.resize_normalize_pad(imgs[:1, :1].repeat(65, 1), 0.5,
                                        tpipe.IMG_MEAN, tpipe.IMG_STD).shape[1] == 64


@pytest.mark.parametrize("hw", [(45, 70), (900, 1600)])
def test_eval_preprocess_frame_equals_the_jax_one_with_native_on(hw):
    imgs = _ring(*hw, seed=3)
    l2i = np.random.default_rng(4).standard_normal((6, 4, 4)).astype(np.float32)
    want = jpipe.preprocess_frame(imgs, l2i, scale=0.5, training=False)
    got = tpipe.preprocess_frame(imgs, l2i, scale=0.5, training=False)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(
        _bits(got[0]),
        _bits(tnative.resize_normalize_pad(imgs, 0.5, tpipe.IMG_MEAN, tpipe.IMG_STD)))


def test_a_failed_build_raises_with_the_compilers_message(tmp_path, monkeypatch):
    bad = tmp_path / "host_ops.cpp"
    bad.write_text('extern "C" void resize_normalize_pad( { }\n')
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tpipe.preprocess_frame(_ring(8, 8, n=1), np.eye(4)[None], training=False)
    monkeypatch.setenv("CXX", "no-such-compiler")
    with pytest.raises(RuntimeError, match="no-such-compiler not found"):
        tnative.load()
