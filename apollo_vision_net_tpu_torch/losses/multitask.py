"""Multi-task loss assembly: Group-DETR det + occupancy.

Counterpart of the JAX package's losses/multitask.py (reference
BEVFormerOccupancyHeadApollo.loss, occupancy_head_apollo.py:506-653):
the per-group Hungarian det loss of every decoder layer (at the indices that
``det_loss.solve`` gives, so that a fixed assignment can be passed in) and
the occupancy losses on the head's last-layer voxel logits, focal (or
CustomFocal with the radial BEV weight, or CE) + lovász + sem_scal + geo_scal,
and with a flow branch the L1 flow loss on the object voxels. Predictions of
every queue frame (B·S, voxels, ·) meet GT of shape (B, S, voxels, ·),
both flattened in (b, s) order.

The class weights and the radial weight are built once per class count,
grid and device (``occ_loss_constants``), not copied from the host on
every call.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from apollo_vision_net_tpu_torch.losses import occ_loss as ol
from apollo_vision_net_tpu_torch.losses.det_loss import DetGT, det_loss

# the occupancy focal loss's weight (the reference's loss_weight); lovász,
# sem_scal and geo_scal enter with weight 1
FOCAL_LOSS_WEIGHT = 100.0


@functools.lru_cache(maxsize=16)
def occ_loss_constants(num_classes: int, grid_hw: Optional[Tuple[int, int]],
                       zdim: int, device: str
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(balanced class weights (C,), radial BEV weight per voxel of one
    sample (zdim·y·x,) in the (z, y, x) voxel order, or None without a
    grid) on ``device``, made once per arguments."""
    class_w = torch.as_tensor(ol.balanced_class_weights(num_classes),
                              device=device)
    if grid_hw is None:
        return class_w, None
    rw = ol.radial_bev_weight(*grid_hw)  # (y, x) BEV rows/cols
    return class_w, torch.as_tensor(np.tile(rw.reshape(-1), zdim), device=device)


def det_occ_loss(outs: Dict[str, torch.Tensor], gt: DetGT,
                 gt_occupancy: torch.Tensor, indices: np.ndarray, *,
                 occupancy_classes: int = 16, group_detr: int = 1,
                 num_classes: int = 10,
                 occ_loss_type: str = "CustomFocalLoss",
                 occ_grid_hw: Optional[Tuple[int, int]] = None,
                 occ_zdim: int = 16,
                 flow_preds: Optional[torch.Tensor] = None,
                 gt_flow: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """outs: the head's outputs (``all_cls_scores``, ``all_bbox_preds``,
    ``occupancy_preds`` (B·S, voxels, C_occ)); gt_occupancy (B, voxels) or
    (B, S, voxels) with ``occupancy_classes`` meaning free and 255 ignore;
    indices: the det assignment from ``det_loss.solve`` over the groups.
    ``occ_grid_hw`` is the (occ_y, occ_x) grid of the radial weight;
    ``flow_preds`` (B·S, voxels, 2) and ``gt_flow`` (..., voxels, 2) add
    ``loss_flow`` over the voxels labelled below 10. -> the det terms,
    ``loss_occupancy``, ``lovasz_softmax``, ``loss_sem_scal``,
    ``loss_geo_scal``, ``loss_flow`` with a flow branch, and
    ``loss_total``."""
    losses = det_loss(outs["all_cls_scores"], outs["all_bbox_preds"], gt,
                      indices, num_classes=num_classes, num_groups=group_detr)
    total = losses.pop("loss_total")

    occ_preds = outs["occupancy_preds"]
    Bv, _, C_occ = occ_preds.shape
    logits = occ_preds.reshape(-1, C_occ).float()
    labels = gt_occupancy.reshape(-1).long()
    valid = labels != 255
    class_w, radial = occ_loss_constants(
        C_occ, tuple(occ_grid_hw) if occ_grid_hw is not None else None,
        occ_zdim, str(logits.device))

    if occ_loss_type == "focal_loss":
        num_pos = (labels < occupancy_classes).sum().float()
        loss_occ = ol.occupancy_focal_loss(
            logits, labels, valid, avg_mode="factor", avg_factor=num_pos,
            loss_weight=FOCAL_LOSS_WEIGHT)
    elif occ_loss_type == "CustomFocalLoss":
        loss_occ = ol.occupancy_focal_loss(
            logits, labels, valid, class_weights=class_w,
            spatial_weight=radial.repeat(Bv) if radial is not None else None,
            loss_weight=FOCAL_LOSS_WEIGHT)
    elif occ_loss_type == "ce_loss":
        # CE needs every supervised label to be a real channel
        loss_occ = ol.ce_ssc_loss(logits, labels, valid & (labels < C_occ),
                                  class_w)
    else:
        raise ValueError(occ_loss_type)

    probs = torch.softmax(logits, dim=-1)
    terms = {
        "loss_occupancy": loss_occ,
        "lovasz_softmax": ol.lovasz_softmax(probs, labels, valid),
        "loss_sem_scal": ol.sem_scal_loss(probs, labels, valid),
        # the last semantic class as "empty", exactly as the JAX package
        # (and the reference) call it
        "loss_geo_scal": ol.geo_scal_loss(probs, labels, valid,
                                          empty_idx=occupancy_classes - 1),
    }
    if flow_preds is not None and gt_flow is not None:
        terms["loss_flow"] = ol.flow_l1_loss(
            flow_preds.reshape(-1, flow_preds.shape[-1]).float(),
            gt_flow.reshape(-1, gt_flow.shape[-1]).float(),
            (labels < 10) & valid)
    for k, v in terms.items():
        losses[k] = torch.nan_to_num(v)
        total = total + losses[k]
    losses["loss_total"] = total
    return losses
