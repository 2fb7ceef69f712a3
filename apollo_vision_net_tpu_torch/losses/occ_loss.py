"""Occupancy losses: focal / distance-weighted focal / CE, lovász-softmax,
geometric and semantic affinity (scal) losses, flow L1.

Counterpart of the JAX package's losses/occ_loss.py (reference
occ_loss_utils: CustomFocalLoss focal_loss.py:163-271, lovasz_softmax
lovasz_softmax.py:157-230, geo_scal_loss / sem_scal_loss / CE_ssc_loss
nusc_param.py:164-247; class-balanced weights 1/log(freq),
bevformer_occupancy_head_apollo.py:109-112).

Every function is mask-based, as in the JAX package: labels equal to the
class count mean free, any label outside [0, C] (255) is ignored through
``valid``; one-hot targets are comparisons with the class index, so labels
outside [0, C) give zero rows as ``jax.nn.one_hot`` does. Lovász zeroes the
error and foreground of invalid voxels (they sort to the tail and add
nothing). The per-class loops of the JAX package (``jax.vmap`` over
classes) are one batched tensor expression over the class axis here.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

# reference occ_loss_utils/nusc_param.py:35-51 — 16 semantic classes + free
NUSC_CLASS_FREQUENCIES = np.array([
    32503112, 12135169, 5631079, 4744578, 2264798, 222351, 305051,
    3215271, 528651, 2826015, 302204240, 8065114, 96118458, 145138993,
    279441154, 313481556, 16794374410,
], np.float64)

NUSC_CLASS_NAMES = [
    "car", "truck", "trailer", "bus", "construction_vehicle", "bicycle",
    "motorcycle", "pedestrian", "traffic_cone", "barrier",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation", "free",
]


def balanced_class_weights(num_classes: int) -> np.ndarray:
    """1 / log(freq + eps), truncated to num_classes entries."""
    return (1.0 / np.log(NUSC_CLASS_FREQUENCIES[:num_classes] + 0.001)).astype(
        np.float32)


def radial_bev_weight(h: int, w: int) -> np.ndarray:
    """CustomFocalLoss's center-distance weight in [1, 2] (focal_loss.py
    :197-203)."""
    ys = np.arange(h) - h / 2.0
    xs = np.arange(w) - w / 2.0
    c = np.sqrt(ys[:, None] ** 2 + xs[None, :] ** 2)
    return (c / c.max() + 1.0).astype(np.float32)


def _one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(M,) -> (M, C) f32; labels outside [0, C) give zero rows."""
    classes = torch.arange(num_classes, device=labels.device)
    return (labels[:, None] == classes).float()


def _binary_focal(logits, target, alpha, gamma):
    p = torch.sigmoid(logits)
    pt = (1.0 - p) * target + p * (1.0 - target)
    w = (alpha * target + (1 - alpha) * (1 - target)) * pt ** gamma
    bce = (torch.clamp(logits, min=0) - logits * target
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return bce * w


def occupancy_focal_loss(logits: torch.Tensor, labels: torch.Tensor,
                         valid: torch.Tensor, *,
                         class_weights: Optional[torch.Tensor] = None,
                         spatial_weight: Optional[torch.Tensor] = None,
                         alpha: float = 0.25, gamma: float = 2.0,
                         loss_weight: float = 1.0,
                         avg_mode: str = "visible_mean",
                         avg_factor: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """logits (M, C), labels (M,) with C meaning free, valid (M,) bool;
    optional per-class (C,) and per-voxel (M,) weights. ``visible_mean``
    divides by the valid count (CustomFocalLoss), ``factor`` by
    ``avg_factor``."""
    C = logits.shape[-1]
    loss = _binary_focal(logits.float(), _one_hot(labels, C), alpha, gamma)
    w = torch.ones((logits.shape[0], 1), dtype=torch.float32, device=logits.device)
    if class_weights is not None:
        w = w * class_weights[None, :]
    if spatial_weight is not None:
        w = w * spatial_weight[:, None]
    loss = (loss * w).sum(-1) * valid.float()
    if avg_mode == "visible_mean":
        return loss_weight * loss.sum() / torch.clamp(valid.sum().float(), min=1.0)
    return loss_weight * loss.sum() / torch.clamp(avg_factor, min=1.0)


def ce_ssc_loss(logits: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                class_weights: torch.Tensor) -> torch.Tensor:
    """Weighted CE with ignore — torch CrossEntropyLoss(weight, ignore,
    reduction='mean') semantics: sum(w_y * nll) / sum(w_y over valid).
    Classes past the end of ``class_weights`` take its last entry, as the
    JAX package's gather clamps the index (semantic_kitti_occ's 20 classes
    against the 17 nuScenes weights)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    lbl = torch.clamp(labels.long(), 0, logits.shape[-1] - 1)
    nll = -torch.gather(logp, 1, lbl[:, None])[:, 0]
    wy = class_weights[lbl.clamp(max=class_weights.shape[0] - 1)] * valid.float()
    return (nll * wy).sum() / torch.clamp(wy.sum(), min=1e-6)


def _lovasz_grad(fg_sorted: torch.Tensor) -> torch.Tensor:
    """Jaccard gradient along the last axis of sorted foreground flags."""
    gts = fg_sorted.sum(-1, keepdim=True)
    intersection = gts - torch.cumsum(fg_sorted, -1)
    union = gts + torch.cumsum(1.0 - fg_sorted, -1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]], -1)


def lovasz_softmax(probs: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """'present'-classes lovász-softmax over probs (M, C); invalid voxels
    contribute exactly zero. One stable descending sort of the (C, M)
    errors, as ``jnp.argsort(-errors)`` orders them."""
    C = probs.shape[1]
    validf = valid.float()
    fg = _one_hot(labels, C).t() * validf                  # (C, M)
    errors = torch.abs(fg - probs.t()) * validf
    errors_sorted, order = torch.sort(errors, dim=1, descending=True, stable=True)
    fg_sorted = torch.gather(fg, 1, order)
    losses = (errors_sorted * _lovasz_grad(fg_sorted)).sum(1)
    present = (fg.sum(1) > 0).float()
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)


def _bce_on_prob(p):
    """F.binary_cross_entropy(p, 1) = -log(p), clamped like torch."""
    return -torch.log(torch.clamp(p, 1e-12, 1.0))


def geo_scal_loss(probs: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                  empty_idx: int, eps: float = 1e-5) -> torch.Tensor:
    validf = valid.float()
    empty_probs = probs[:, empty_idx]
    nonempty_probs = 1.0 - empty_probs
    nonempty_target = ((labels != empty_idx) & valid).float()
    empty_target = ((labels == empty_idx) & valid).float()
    inter = (nonempty_target * nonempty_probs * validf).sum()
    precision = inter / ((nonempty_probs * validf).sum() + eps)
    recall = inter / (nonempty_target.sum() + eps)
    spec = (empty_target * empty_probs).sum() / (empty_target.sum() + eps)
    return _bce_on_prob(precision) + _bce_on_prob(recall) + _bce_on_prob(spec)


def sem_scal_loss(probs: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
                  skip_last: bool = True) -> torch.Tensor:
    """Per-class precision, recall and specificity BCE over the present
    classes; ``skip_last`` leaves out the last (free) channel as the
    reference's range(0, C-1) does."""
    C = probs.shape[1]
    n = C - 1 if skip_last else C
    validf = valid.float()[:, None]
    probs = probs[:, :n]
    p = probs * validf
    tgt = _one_hot(labels, n) * validf
    n_tgt = tgt.sum(0)
    nom = (p * tgt).sum(0)
    p_sum = p.sum(0)
    precision = nom / torch.clamp(p_sum, min=1e-12)
    recall = nom / torch.clamp(n_tgt, min=1e-12)
    neg = ((1.0 - probs) * (1.0 - tgt) * validf).sum(0)
    n_neg = (validf * (1.0 - tgt)).sum(0)
    specificity = neg / torch.clamp(n_neg, min=1e-12)
    zero = torch.zeros((), device=probs.device)
    losses = (torch.where(p_sum > 0, _bce_on_prob(precision), zero)
              + _bce_on_prob(recall)
              + torch.where(n_neg > 0, _bce_on_prob(specificity), zero))
    present = (n_tgt > 0).float()
    return (losses * present).sum() / torch.clamp(present.sum(), min=1.0)


def flow_l1_loss(flow_preds: torch.Tensor, gt_flow: torch.Tensor,
                 object_mask: torch.Tensor) -> torch.Tensor:
    """flow_preds, gt_flow (M, 2); object_mask (M,) bool (foreground voxels,
    gt label < 10)."""
    m = object_mask.float()[:, None]
    num = torch.clamp(object_mask.sum().float(), min=1.0)
    return (torch.abs(flow_preds - gt_flow) * m).sum() / num
