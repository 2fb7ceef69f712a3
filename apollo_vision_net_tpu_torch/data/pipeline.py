"""Image pipeline: multi-view load/distort/normalize/scale/pad.

Parity (reference file:line, datasets/pipelines/transform_3d.py):
- PhotoMetricDistortionMultiViewImage (:98-...): brightness delta ±32,
  contrast 0.5-1.5, saturation 0.5-1.5, hue ±18, random channel swap, with
  the torchvision-style random mode ordering
- NormalizeMultiviewImage (:61): (img - mean) / std, BGR→RGB upstream of it
- RandomScaleImageMultiViewImage (:291-330): resize by scale AND scale the
  lidar2img intrinsics rows
- PadMultiViewImage (:8): bottom/right zero-pad to a size divisor (32)

Copy of the JAX package's data/pipeline.py. On the eval path (not
training, uint8 images) ``preprocess_frame`` takes the fused native resize
+ normalize + pad of the port's host library (``data/native.py`` over
``csrc/host_ops.cpp``, built at first use; it raises where it cannot be
built or loaded), as the JAX package's eval path does; training frames take
the numpy path (photometric distortion, normalize, scale, pad), which is
also the native call's plain version (``plain_resize_normalize_pad``: the
same bilinear convention, normalizing before the resize where the native
call normalizes after it, so the two agree to rounding).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from apollo_vision_net_tpu_torch.data import native

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def photometric_distortion(
    imgs: np.ndarray, rng: np.random.Generator,
    brightness_delta: float = 32.0,
    contrast_range: Tuple[float, float] = (0.5, 1.5),
    saturation_range: Tuple[float, float] = (0.5, 1.5),
    hue_delta: float = 18.0,
) -> np.ndarray:
    """imgs: (N, H, W, 3) float32 RGB in [0,255]. One draw for all views
    (the reference applies per-image; per-camera consistency is preferable
    for multi-view geometry — documented deviation)."""
    out = imgs.astype(np.float32)
    if rng.integers(2):
        out = out + rng.uniform(-brightness_delta, brightness_delta)
    mode = rng.integers(2)
    if mode == 1 and rng.integers(2):
        out = out * rng.uniform(*contrast_range)

    # HSV ops via cheap RGB approximations of cv2 conversions
    if rng.integers(2):  # saturation
        gray = out.mean(-1, keepdims=True)
        out = gray + (out - gray) * rng.uniform(*saturation_range)
    if rng.integers(2):  # hue: rotate channels around the gray axis
        theta = np.deg2rad(rng.uniform(-hue_delta, hue_delta)) * 2
        c, s = np.cos(theta), np.sin(theta)
        m = np.array([
            [c + (1 - c) / 3, (1 - c) / 3 - s / np.sqrt(3), (1 - c) / 3 + s / np.sqrt(3)],
            [(1 - c) / 3 + s / np.sqrt(3), c + (1 - c) / 3, (1 - c) / 3 - s / np.sqrt(3)],
            [(1 - c) / 3 - s / np.sqrt(3), (1 - c) / 3 + s / np.sqrt(3), c + (1 - c) / 3],
        ], np.float32)
        out = out @ m.T

    if mode == 0 and rng.integers(2):
        out = out * rng.uniform(*contrast_range)
    if rng.integers(2):  # random channel swap
        out = out[..., rng.permutation(3)]
    return np.clip(out, 0, 255)


def normalize_images(imgs: np.ndarray,
                     mean: np.ndarray = IMG_MEAN,
                     std: np.ndarray = IMG_STD) -> np.ndarray:
    return ((imgs.astype(np.float32) - mean) / std).astype(np.float32)


def scale_images(imgs: np.ndarray, lidar2img: np.ndarray, scale: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Bilinear resize by `scale` and patch the projection matrices
    (transform_3d.py:291-330: scale_factor on rows 0,1)."""
    N, H, W, C = imgs.shape
    nh, nw = int(round(H * scale)), int(round(W * scale))
    ys = (np.arange(nh) + 0.5) / scale - 0.5
    xs = (np.arange(nw) + 0.5) / scale - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, H - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, W - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    fy = np.clip(ys - y0, 0, 1)[None, :, None, None]
    fx = np.clip(xs - x0, 0, 1)[None, None, :, None]
    top = imgs[:, y0][:, :, x0] * (1 - fx) + imgs[:, y0][:, :, x1] * fx
    bot = imgs[:, y1][:, :, x0] * (1 - fx) + imgs[:, y1][:, :, x1] * fx
    out = top * (1 - fy) + bot * fy
    scale_mat = np.eye(4, dtype=lidar2img.dtype)
    scale_mat[0, 0] = scale_mat[1, 1] = scale
    return out.astype(imgs.dtype), scale_mat @ lidar2img


def pad_images(imgs: np.ndarray, size_divisor: int = 32) -> np.ndarray:
    N, H, W, C = imgs.shape
    ph = (H + size_divisor - 1) // size_divisor * size_divisor
    pw = (W + size_divisor - 1) // size_divisor * size_divisor
    if (ph, pw) == (H, W):
        return imgs
    out = np.zeros((N, ph, pw, C), imgs.dtype)
    out[:, :H, :W] = imgs
    return out


def plain_resize_normalize_pad(imgs_u8: np.ndarray, scale: float,
                               mean: np.ndarray = IMG_MEAN,
                               std: np.ndarray = IMG_STD,
                               size_divisor: int = 32) -> np.ndarray:
    """The numpy path's images: the plain version of
    ``native.resize_normalize_pad`` (same arguments and result)."""
    eye = np.eye(4, dtype=np.float32)[None]
    imgs, _ = scale_images(normalize_images(imgs_u8, mean, std), eye, scale)
    return pad_images(imgs, size_divisor)


def preprocess_frame(
    imgs_u8: np.ndarray,            # (N, H, W, 3) RGB
    lidar2img: np.ndarray,          # (N, 4, 4)
    *,
    scale: float = 0.5,
    training: bool = False,
    rng: Optional[np.random.Generator] = None,
    size_divisor: int = 32,
    mean: np.ndarray = IMG_MEAN,
    std: np.ndarray = IMG_STD,
) -> Tuple[np.ndarray, np.ndarray]:
    """Full train/test pipeline for one frame's camera ring."""
    if not training and imgs_u8.dtype == np.uint8:
        # eval path: fused native resize + normalize + pad (csrc/host_ops.cpp)
        out = native.resize_normalize_pad(
            imgs_u8, scale, np.asarray(mean, np.float32),
            np.asarray(std, np.float32), size_divisor)
        scale_mat = np.eye(4, dtype=lidar2img.dtype)
        scale_mat[0, 0] = scale_mat[1, 1] = scale
        return out, scale_mat @ lidar2img
    imgs = imgs_u8.astype(np.float32)
    if training:
        imgs = photometric_distortion(imgs, rng or np.random.default_rng())
    imgs = normalize_images(imgs, mean, std)
    imgs, lidar2img = scale_images(imgs, lidar2img, scale)
    return pad_images(imgs, size_divisor), lidar2img
