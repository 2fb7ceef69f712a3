"""MapTR v1 losses: ordered-point-set Hungarian matching + cls/pts/dir.

Counterpart of the JAX package's losses/map_loss.py ``map_loss`` (reference
MapTRAssigner: FocalLossCost + min-over-orders OrderedPtsL1Cost,
maptr_assigner.py:52-134; MapTRLossHead.loss_single: focal cls, PtsL1Loss
on the matched ordered points, PtsDirCosLoss on segment directions in
meters, maptr_loss_head.py:327-505; weights cls 2.0, pts 5.0, dir 0.005 as
bev_tiny_det_map_apollo.py:222-246 configures them), and MapTRv2's
``map_loss_v2`` (JAX :185-254): the v1 loss on the one2one vectors, plus λ
times the v1 loss of the one2many vectors against the GT tiled k times, plus
the BCE of the auxiliary BEV and PV segmentation logits.

Split as det_loss is: ``match_costs`` on the device -> (cost (Lyr, B, V,
Q), the best order of each (query, GT vector) (Lyr, B, Q, V)); ``solve`` on
the host over the real GT vectors -> (M, 5) int64 rows (layer, batch,
query, gt vector, order); ``map_loss`` at given indices. For MapTRv2 the
rows of the one2many vectors carry the query index past the one2one ones
and the row of the tiled GT (``tile_gt``); their costs are those of the V
distinct GT rows, repeated k times on the host (``solve_one2many``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
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
    # the range as f32 scalars: no host-to-device copy
    pc = np.asarray(pc_range, np.float32)
    scale = (float(pc[3] - pc[0]), float(pc[4] - pc[1]))
    off = (float(pc[0]), float(pc[1]))

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
        pred_m = torch.stack([pts_l[..., i] * scale[i] + off[i] for i in (0, 1)],
                             dim=-1)
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


def tile_gt(gt: MapGT, k: int) -> MapGT:
    """The GT repeated k times along the vector axis (row r is row r mod V),
    the one2many branch's targets (jnp.tile in the JAX package)."""
    return MapGT(gt.shift_pts.repeat(1, k, 1, 1, 1), gt.labels.repeat(1, k),
                 gt.mask.repeat(1, k), gt.order_mask.repeat(1, k, 1))


def solve_one2many(costs: np.ndarray, order: np.ndarray, mask: np.ndarray,
                   k: int, q_offset: int) -> np.ndarray:
    """``solve`` for the one2many vectors against the GT tiled k times,
    from the costs (Lyr, B, V, Q) and orders (Lyr, B, Q, V) against the V
    distinct rows: a tiled row costs what its distinct row does. Rows
    (layer, batch, q_offset + query, tiled gt row, order)."""
    idx = solve(np.tile(costs, (1, 1, k, 1)), np.tile(order, (1, 1, 1, k)),
                np.tile(mask, (1, k)))
    idx[:, 2] += q_offset
    return idx


def _seg_bce(logits: torch.Tensor, target: torch.Tensor,
             pos_weight: float) -> torch.Tensor:
    """BCE with logits, positives weighted by ``pos_weight``, averaged
    (BCEWithLogitsLoss(pos_weight), the JAX package's stable form)."""
    x, t = logits.float(), target.float()
    soft = torch.log1p(torch.exp(-x.abs()))
    return torch.mean(pos_weight * t * (soft + torch.clamp(-x, min=0))
                      + (1.0 - t) * (soft + torch.clamp(x, min=0)))


def map_loss_v2(map_all_cls: torch.Tensor, map_all_pts: torch.Tensor,
                gt: MapGT, indices: np.ndarray, *, pc_range: Sequence[float],
                num_vec_one2one: int, k_one2many: int = 6,
                lambda_one2many: float = 1.0, num_classes: int = 3,
                bev_seg_logits: Optional[torch.Tensor] = None,
                gt_bev_seg: Optional[torch.Tensor] = None,
                pv_seg_logits: Optional[torch.Tensor] = None,
                gt_pv_seg: Optional[torch.Tensor] = None,
                bev_seg_weight: float = 1.0, pv_seg_weight: float = 2.0,
                seg_pos_weight: float = 2.0) -> Dict[str, torch.Tensor]:
    """MapTRv2's loss at the assignment ``indices`` (``solve`` rows for the
    one2one vectors, ``solve_one2many`` rows for the others): the one2one
    terms, each one2many term times λ as ``{term}_one2many`` (its own
    num_pos, k times the GT's), ``loss_map_bev_seg`` and ``loss_map_pv_seg``
    and ``loss_map_total`` their sum. A PV GT at another resolution than
    the logits is resized to them by nearest neighbour with half-pixel
    centres (jax.image.resize's "nearest")."""
    o1 = num_vec_one2one
    many = indices[:, 2] >= o1
    losses = map_loss(map_all_cls[:, :, :o1], map_all_pts[:, :, :o1], gt,
                      indices[~many], pc_range=pc_range, num_classes=num_classes)
    total = losses.pop("loss_map_total")
    idx_many = indices[many].copy()
    idx_many[:, 2] -= o1
    many_losses = map_loss(map_all_cls[:, :, o1:], map_all_pts[:, :, o1:],
                           tile_gt(gt, k_one2many), idx_many,
                           pc_range=pc_range, num_classes=num_classes)
    total = total + lambda_one2many * many_losses.pop("loss_map_total")
    for k, v in many_losses.items():
        losses[k + "_one2many"] = v * lambda_one2many
    if bev_seg_logits is not None and gt_bev_seg is not None:
        losses["loss_map_bev_seg"] = bev_seg_weight * _seg_bce(
            bev_seg_logits, gt_bev_seg, seg_pos_weight)
        total = total + losses["loss_map_bev_seg"]
    if pv_seg_logits is not None and gt_pv_seg is not None:
        if gt_pv_seg.shape != pv_seg_logits.shape:
            gt_pv_seg = F.interpolate(gt_pv_seg.float(),
                                      size=pv_seg_logits.shape[-2:],
                                      mode="nearest-exact")
        losses["loss_map_pv_seg"] = pv_seg_weight * _seg_bce(
            pv_seg_logits, gt_pv_seg, seg_pos_weight)
        total = total + losses["loss_map_pv_seg"]
    losses["loss_map_total"] = total
    return losses
