"""Detection loss: Hungarian assignment + focal cls + weighted L1 bbox.

Counterpart of the JAX package's losses/det_loss.py (reference
HungarianAssigner3D with FocalLossCost(w=2) + BBox3DL1Cost(w=0.25) over the
first 8 normalized box dims, hungarian_assigner_3d.py:17-135; per-layer loss
with num_pos as the normalizer, bevformer_head.py:344-429; code weights
[1.0]*8 + [0.2, 0.2]).

The step is split in two so that one host synchronization serves every
decoder layer (and the map loss too, parallel/train.py):
- ``match_costs`` computes every layer's (Lyr, B, G, V, q) cost matrices on
  the device (padded GT rows included; they are constant);
- ``solve`` runs ``scipy.optimize.linear_sum_assignment`` on the host over
  the real GT rows only, since padded rows change nothing (the reference's
  own solver; the JAX package's ops/hungarian.py is a TPU tactic), once per
  (layer, sample, group), and returns the indices as an (M, 4) int64 array
  of (layer, batch, query, gt row);
- ``det_loss`` computes the loss terms for given indices, so that two runs
  can be held against each other at the same assignment.

Group-DETR (JAX :93-180): with ``num_groups`` G > 1 the query axis holds G
contiguous groups of q = Q / G queries; each group is matched against the
full GT on its own, and the shared normalizer is G times the GT count, which
equals the reference's per-group loss averaged over the groups
(occupancy_head_apollo.py:625-647). G = 1 is the single-group loss.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from apollo_vision_net_tpu_torch.utils.box_coder import normalize_bbox

DEFAULT_CODE_WEIGHTS = (1.0,) * 8 + (0.2, 0.2)


class DetGT(NamedTuple):
    """Padded detection ground truth for one batch."""
    boxes: torch.Tensor   # (B, G, 9) meters/rad (cx,cy,cz,w,l,h,rot,vx,vy)
    labels: torch.Tensor  # (B, G) int in [0, num_classes)
    mask: torch.Tensor    # (B, G) bool


def sigmoid_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                       weights: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """mmdet py_sigmoid_focal_loss, summed (the caller divides): logits
    (M, C), labels (M,) with C meaning background, weights (M,)."""
    C = logits.shape[-1]
    target = F.one_hot(labels.long(), C + 1)[..., :C].to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * target + p * (1.0 - target)
    focal_w = (alpha * target + (1.0 - alpha) * (1.0 - target)) * pt ** gamma
    bce = (torch.clamp(logits, min=0) - logits * target
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return (bce * focal_w * weights[..., None]).sum()


def focal_cls_cost(logits: torch.Tensor, gt_labels: torch.Tensor,
                   alpha: float = 0.25, gamma: float = 2.0, eps: float = 1e-12,
                   weight: float = 2.0) -> torch.Tensor:
    """mmdet FocalLossCost: logits (..., Q, C), gt_labels (..., G) ->
    (..., Q, G)."""
    p = torch.sigmoid(logits.float())
    neg = -torch.log(1.0 - p + eps) * (1.0 - alpha) * p ** gamma
    pos = -torch.log(p + eps) * alpha * (1.0 - p) ** gamma
    cost = pos - neg  # (..., Q, C)
    idx = gt_labels.long().clamp(0, logits.shape[-1] - 1)
    idx = idx[..., None, :].expand(*cost.shape[:-1], idx.shape[-1])
    return torch.gather(cost, -1, idx) * weight


def normalized_gt(gt: DetGT) -> torch.Tensor:
    """(B, G, 10) regression targets; padded rows (which may hold log(0))
    are zeroed."""
    gt_norm = torch.nan_to_num(normalize_bbox(gt.boxes.float()),
                               posinf=0.0, neginf=0.0)
    return torch.where(gt.mask[..., None], gt_norm, torch.zeros_like(gt_norm))


@torch.no_grad()
def match_costs(all_cls_scores: torch.Tensor, all_bbox_preds: torch.Tensor,
                gt: DetGT, *, num_groups: int = 1, cls_cost_weight: float = 2.0,
                reg_cost_weight: float = 0.25) -> torch.Tensor:
    """all_cls_scores (Lyr, B, Q, C), all_bbox_preds (Lyr, B, Q, 10) ->
    cost (Lyr, B, G, V, q) for G = ``num_groups`` groups of q = Q / G
    queries and V GT rows: focal cls cost + L1 over the first 8 normalized
    box dims, rows of padded GT included."""
    n_layers, B, Q, C = all_cls_scores.shape
    G = num_groups
    cls = all_cls_scores.reshape(n_layers, B, G, Q // G, C)
    box = all_bbox_preds.reshape(n_layers, B, G, Q // G, -1)
    gt_norm = normalized_gt(gt)
    cls_cost = focal_cls_cost(cls, gt.labels[None, :, None],
                              weight=cls_cost_weight)      # (Lyr, B, G, q, V)
    reg_cost = (box[..., None, :8].float()
                - gt_norm[None, :, None, None, :, :8]).abs().sum(-1)
    return (cls_cost + reg_cost * reg_cost_weight).transpose(-1, -2)


def solve(costs: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """costs (Lyr, B, G, V, q), mask (B, V) on the host -> (M, 4) int64 rows
    (layer, batch, query, gt row), the query indexing the whole G·q axis:
    the optimal assignment of the real rows of each layer, sample and
    group."""
    out = []
    n_layers, B, G, _, q_per_group = costs.shape
    for lyr in range(n_layers):
        for b in range(B):
            rows = np.flatnonzero(mask[b])
            if rows.size == 0:
                continue
            for g in range(G):
                r, q = linear_sum_assignment(costs[lyr, b, g, rows])
                out.append(np.stack([np.full_like(q, lyr), np.full_like(q, b),
                                     q + g * q_per_group, rows[r]], axis=1))
    if not out:
        return np.zeros((0, 4), np.int64)
    return np.concatenate(out).astype(np.int64)


def _index(indices: np.ndarray, device) -> torch.Tensor:
    """The host indices as a device tensor (pinned, copied without a
    synchronization where the device is a GPU)."""
    t = torch.as_tensor(np.ascontiguousarray(indices))
    if torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def det_loss(all_cls_scores: torch.Tensor, all_bbox_preds: torch.Tensor,
             gt: DetGT, indices: np.ndarray, *, num_classes: int = 10,
             num_groups: int = 1, cls_loss_weight: float = 2.0,
             bbox_loss_weight: float = 0.25,
             code_weights: Sequence[float] = DEFAULT_CODE_WEIGHTS
             ) -> Dict[str, torch.Tensor]:
    """The multi-layer detection loss at the assignment ``indices`` (from
    ``solve``): focal cls over every query (background where unmatched) and
    code-weighted L1 on matched boxes, each normalized by ``num_groups``
    times the count of real GT boxes; ``loss_cls`` / ``loss_bbox`` for the
    last layer, ``.d{l}`` suffixes for the others, ``loss_total`` their
    sum."""
    n_layers, B, Q, C = all_cls_scores.shape
    dev = all_cls_scores.device
    gt_norm = normalized_gt(gt)
    num_pos = torch.clamp(gt.mask.sum().float(), min=1.0) * num_groups
    idx = _index(indices, dev)
    lyr, b, q, r = idx.unbind(-1)
    labels = torch.full((n_layers, B, Q), num_classes, dtype=torch.int64,
                        device=dev)
    labels[lyr, b, q] = gt.labels[b, r].long()
    bbox_targets = torch.zeros((n_layers, B, Q, gt_norm.shape[-1]),
                               dtype=torch.float32, device=dev)
    bbox_targets[lyr, b, q] = gt_norm[b, r]
    bbox_w = torch.zeros((n_layers, B, Q), dtype=torch.float32, device=dev)
    bbox_w[lyr, b, q] = 1.0
    code_w = torch.as_tensor(code_weights, dtype=torch.float32, device=dev)
    ones = torch.ones((B * Q,), dtype=torch.float32, device=dev)

    losses = {}
    total = 0.0
    for lyr_i in range(n_layers):
        loss_cls = sigmoid_focal_loss(
            all_cls_scores[lyr_i].reshape(-1, C).float(),
            labels[lyr_i].reshape(-1), ones) / num_pos * cls_loss_weight
        diff = torch.abs(all_bbox_preds[lyr_i].float() - bbox_targets[lyr_i])
        loss_bbox = ((diff * code_w * bbox_w[lyr_i][..., None]).sum()
                     / num_pos * bbox_loss_weight)
        loss_cls = torch.nan_to_num(loss_cls)
        loss_bbox = torch.nan_to_num(loss_bbox)
        suffix = "" if lyr_i == n_layers - 1 else f".d{lyr_i}"
        losses[f"loss_cls{suffix}"] = loss_cls
        losses[f"loss_bbox{suffix}"] = loss_bbox
        total = total + loss_cls + loss_bbox
    losses["loss_total"] = total
    return losses
