"""3D box codec and NMS-free box decoding (static shapes).

Counterpart of the JAX package's utils/box_coder.py (reference
core/bbox/util.py and core/bbox/coders/nms_free_coder.py): 9-dim
(cx, cy, cz, w, l, h, rot, vx, vy) boxes to and from 10-dim regression
targets (cx, cy, log w, log l, cz, log h, sin, cos, vx, vy); top-k over the
flattened sigmoid scores, decode, post_center_range filter as a validity
mask.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch


def normalize_bbox(bboxes: torch.Tensor) -> torch.Tensor:
    """(..., 9) meters/rad boxes -> (..., 10) regression targets."""
    cx, cy, cz = bboxes[..., 0:1], bboxes[..., 1:2], bboxes[..., 2:3]
    w = torch.log(bboxes[..., 3:4])
    l = torch.log(bboxes[..., 4:5])  # noqa: E741
    h = torch.log(bboxes[..., 5:6])
    rot = bboxes[..., 6:7]
    parts = [cx, cy, w, l, cz, h, torch.sin(rot), torch.cos(rot)]
    if bboxes.shape[-1] > 7:
        parts += [bboxes[..., 7:8], bboxes[..., 8:9]]
    return torch.cat(parts, dim=-1)


def denormalize_bbox(nb: torch.Tensor) -> torch.Tensor:
    """(..., 10) regression outputs -> (..., 9) meters/rad boxes."""
    rot = torch.atan2(nb[..., 6:7], nb[..., 7:8])
    cx, cy, cz = nb[..., 0:1], nb[..., 1:2], nb[..., 4:5]
    w = torch.exp(nb[..., 2:3])
    l = torch.exp(nb[..., 3:4])  # noqa: E741
    h = torch.exp(nb[..., 5:6])
    if nb.shape[-1] > 8:
        vx, vy = nb[..., 8:9], nb[..., 9:10]
        return torch.cat([cx, cy, cz, w, l, h, rot, vx, vy], dim=-1)
    return torch.cat([cx, cy, cz, w, l, h, rot], dim=-1)


class Detections(NamedTuple):
    """Static-shape detection output. `valid` masks real boxes."""
    boxes: torch.Tensor   # (max_num, 9)
    scores: torch.Tensor  # (max_num,)
    labels: torch.Tensor  # (max_num,) int64
    valid: torch.Tensor   # (max_num,) bool


def nms_free_decode(
    cls_logits: torch.Tensor,
    bbox_preds: torch.Tensor,
    post_center_range: Sequence[float],
    max_num: int = 100,
    score_threshold: Optional[float] = None,
    num_classes: int = 10,
) -> Detections:
    """Decode one sample's last-layer outputs: cls_logits (num_query,
    num_classes) pre-sigmoid, bbox_preds (num_query, 10)."""
    scores_all = torch.sigmoid(cls_logits.float()).reshape(-1)
    scores, idx = torch.topk(scores_all, min(max_num, scores_all.shape[0]))
    labels = idx % num_classes
    boxes = denormalize_bbox(bbox_preds.float()[idx // num_classes])
    rng = torch.as_tensor(np.asarray(post_center_range, np.float32),
                          device=boxes.device)
    valid = (boxes[..., :3] >= rng[:3]).all(-1) & (boxes[..., :3] <= rng[3:]).all(-1)
    if score_threshold is not None:
        valid = valid & (scores > score_threshold)
    return Detections(boxes=boxes, scores=scores, labels=labels, valid=valid)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Matches mmdet's inverse_sigmoid clamping."""
    x = x.clamp(0.0, 1.0)
    x1 = x.clamp(min=eps)
    x2 = (1.0 - x).clamp(min=eps)
    return torch.log(x1 / x2)
