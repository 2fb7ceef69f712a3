"""MapTR v1 losses: ordered-point-set Hungarian matching + cls/pts/dir.

Counterpart of the JAX package's losses/map_loss.py ``map_loss`` (reference
MapTRAssigner: FocalLossCost + min-over-orders OrderedPtsL1Cost,
maptr_assigner.py:52-134; MapTRLossHead.loss_single: focal cls, PtsL1Loss
on the matched ordered points, PtsDirCosLoss on segment directions in
meters, maptr_loss_head.py:327-505; weights cls 2.0, pts 5.0, dir 0.005 as
bev_tiny_det_map_apollo.py:222-246 configures them). MapTRv2's
``map_loss_v2`` is not ported.

Split as det_loss is: ``match_costs`` on the device -> (cost (Lyr, B, V,
Q), the best order of each (query, GT vector) (Lyr, B, Q, V)); ``solve`` on
the host over the real GT vectors -> (M, 5) int64 rows (layer, batch,
query, gt vector, order); ``map_loss`` at given indices.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from apollo_vision_net_tpu_torch.losses.det_loss import (
    _index,
    focal_cls_cost,
    sigmoid_focal_loss,
)


class MapGT(NamedTuple):
    """Padded map GT: every admissible point ordering of each vector (2
    direction flips for polylines, cyclic rolls for polygons)."""
    shift_pts: torch.Tensor   # (B, V, O, P, 2) meters
    labels: torch.Tensor      # (B, V) int
    mask: torch.Tensor        # (B, V) bool, real vectors
    order_mask: torch.Tensor  # (B, V, O) bool, valid orderings


def normalize_pts(pts: torch.Tensor, pc_range: Sequence[float]) -> torch.Tensor:
    pc = np.asarray(pc_range, np.float32)
    x = (pts[..., 0:1] - float(pc[0])) / float(pc[3] - pc[0])
    y = (pts[..., 1:2] - float(pc[1])) / float(pc[4] - pc[1])
    return torch.cat([x, y], dim=-1)


@torch.no_grad()
def match_costs(map_all_cls: torch.Tensor, map_all_pts: torch.Tensor,
                gt: MapGT, *, pc_range: Sequence[float],
                cls_cost_weight: float = 2.0, pts_cost_weight: float = 5.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """map_all_cls (Lyr, B, Q, C), map_all_pts (Lyr, B, Q, P, 2) in [0, 1]
    -> (cost (Lyr, B, V, Q), order (Lyr, B, Q, V) int64): focal cls cost
    plus the ordered-points L1 cost, minimized over each vector's valid
    orders (the first minimizing order, as argmin picks it)."""
    Lyr, B, Q, P, _ = map_all_pts.shape
    gt01 = normalize_pts(gt.shift_pts.float(), pc_range)  # (B, V, O, P, 2)
    V, O = gt01.shape[1:3]
    cls_cost = focal_cls_cost(map_all_cls, gt.labels[None],
                              weight=cls_cost_weight)    # (Lyr, B, Q, V)
    pred = map_all_pts.float().reshape(Lyr, B, Q, 1, 1, P * 2)
    d = (pred - gt01.reshape(1, B, 1, V, O, P * 2)).abs().sum(-1)
    d = torch.where(gt.order_mask[None, :, None], d,
                    torch.full_like(d, 1e9))             # (Lyr, B, Q, V, O)
    pts_cost, order = d.min(dim=-1)
    cost = (cls_cost + pts_cost * pts_cost_weight).transpose(-1, -2)
    return cost, order


def solve(costs: np.ndarray, order: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """costs (Lyr, B, V, Q), order (Lyr, B, Q, V), mask (B, V) on the host ->
    (M, 5) int64 rows (layer, batch, query, gt vector, order)."""
    out = []
    for lyr in range(costs.shape[0]):
        for b in range(costs.shape[1]):
            rows = np.flatnonzero(mask[b])
            if rows.size == 0:
                continue
            r, q = linear_sum_assignment(costs[lyr, b, rows])
            v = rows[r]
            out.append(np.stack([np.full_like(q, lyr), np.full_like(q, b), q,
                                 v, order[lyr, b, q, v]], axis=1))
    if not out:
        return np.zeros((0, 5), np.int64)
    return np.concatenate(out).astype(np.int64)


def map_loss(map_all_cls: torch.Tensor, map_all_pts: torch.Tensor, gt: MapGT,
             indices: np.ndarray, *, pc_range: Sequence[float],
             num_classes: int = 3, cls_loss_weight: float = 2.0,
             pts_loss_weight: float = 5.0, dir_loss_weight: float = 0.005,
             dir_interval: int = 1) -> Dict[str, torch.Tensor]:
    """The multi-layer map loss at the assignment ``indices`` (from
    ``solve``): ``loss_map_cls``, ``loss_map_pts`` and ``loss_map_dir`` per
    layer (``.d{l}`` for all but the last), ``loss_map_total`` their sum."""
    L, B, Q, C = map_all_cls.shape
    P = map_all_pts.shape[-2]
    dev = map_all_cls.device
    gt01 = normalize_pts(gt.shift_pts.float(), pc_range)
    num_pos = torch.clamp(gt.mask.sum().float(), min=1.0)
    idx = _index(indices, dev)
    lyr, b, q, v, o = idx.unbind(-1)
    labels = torch.full((L, B, Q), num_classes, dtype=torch.int64, device=dev)
    labels[lyr, b, q] = gt.labels[b, v].long()
    tgt01 = torch.zeros((L, B, Q, P, 2), dtype=torch.float32, device=dev)
    tgt01[lyr, b, q] = gt01[b, v, o]
    tgt_m = torch.zeros((L, B, Q, P, 2), dtype=torch.float32, device=dev)
    tgt_m[lyr, b, q] = gt.shift_pts[b, v, o].float()
    w = torch.zeros((L, B, Q), dtype=torch.float32, device=dev)
    w[lyr, b, q] = 1.0
    ones = torch.ones((B * Q,), dtype=torch.float32, device=dev)
    pc = np.asarray(pc_range, np.float32)
    scale = torch.tensor([pc[3] - pc[0], pc[4] - pc[1]], device=dev)
    off = torch.tensor([pc[0], pc[1]], device=dev)

    losses: Dict[str, torch.Tensor] = {}
    total = 0.0
    for lyr_i in range(L):
        cls_l = map_all_cls[lyr_i].float()
        pts_l = map_all_pts[lyr_i].float()
        w_l = w[lyr_i]
        loss_cls = sigmoid_focal_loss(cls_l.reshape(-1, C),
                                      labels[lyr_i].reshape(-1), ones
                                      ) / num_pos * cls_loss_weight
        loss_pts = ((pts_l - tgt01[lyr_i]).abs() * w_l[..., None, None]
                    ).sum() / num_pos * pts_loss_weight
        # direction cosine loss in meters: denormalized predicted directions
        # against the raw GT ones (maptr_loss_head.py:415-426)
        pred_m = pts_l * scale + off
        pred_dir = pred_m[:, :, dir_interval:] - pred_m[:, :, :-dir_interval]
        tgt = tgt_m[lyr_i]
        tgt_dir = tgt[:, :, dir_interval:] - tgt[:, :, :-dir_interval]
        cos = ((pred_dir * tgt_dir).sum(-1)
               / torch.clamp(torch.linalg.norm(pred_dir, dim=-1)
                             * torch.linalg.norm(tgt_dir, dim=-1), min=1e-6))
        loss_dir = (((1.0 - cos) * w_l[..., None]).sum(-1).sum()
                    / num_pos * dir_loss_weight)
        suffix = "" if lyr_i == L - 1 else f".d{lyr_i}"
        losses[f"loss_map_cls{suffix}"] = torch.nan_to_num(loss_cls)
        losses[f"loss_map_pts{suffix}"] = torch.nan_to_num(loss_pts)
        losses[f"loss_map_dir{suffix}"] = torch.nan_to_num(loss_dir)
        total = (total + losses[f"loss_map_cls{suffix}"]
                 + losses[f"loss_map_pts{suffix}"]
                 + losses[f"loss_map_dir{suffix}"])
    losses["loss_map_total"] = total
    return losses
