"""The training step: loss over a queue batch, backward, clip, AdamW.

Counterpart of the JAX package's parallel/train.py (``loss_fn`` and
``train_step``, :157-229) on one device: the model's training forward over
the (B, T, ...) queue (no-grad history replay, then the supervised last
frame with dropout and grid mask drawn from ``generator``), the det loss
(over the Group-DETR groups) plus, with a map head, the MapTR v1 map loss
or MapTRv2's (one2one, one2many and the aux segmentation terms),
or, with an occupancy head, the occupancy losses and, with a flow branch,
the flow loss (losses/multitask.py).
``loss_total`` is their sum, returned with every term.

Matching takes one host synchronization a step: ``match`` computes every
decoder layer's cost matrices of both heads (of every group, and of
MapTRv2's one2many vectors against the distinct GT rows) on the device,
copies them (and the GT masks) to the host in one transfer and solves them
there with scipy.

``make_train_step(mesh, cfg)`` is the step over a process mesh, the
counterpart of the JAX package's ``make_jitted_train_step`` (batch over
``dp``, state replicated, the loss normalizers global): each rank runs the
forward on its rows of the global batch (and, with ``bev_partition``, its
BEV rows over ``sp``), all-gathers over ``dp`` every output that the
losses read and the ground truth, matches and computes the loss of the
global batch, identical on every rank, and averages the gradients over the
world before the clip and AdamW, so that the parameters stay equal on
every rank. Per-rank losses with per-rank normalizers (``num_pos``, the
occupancy ``avg_factor``, Lovász) would not be JAX's loss.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from apollo_vision_net_tpu_torch.configs import ExperimentConfig
from apollo_vision_net_tpu_torch.losses import det_loss as det_lib
from apollo_vision_net_tpu_torch.losses import map_loss as map_lib
from apollo_vision_net_tpu_torch.losses.multitask import det_occ_loss
from apollo_vision_net_tpu_torch.models.layers import use_generator
from apollo_vision_net_tpu_torch.parallel import collectives
from apollo_vision_net_tpu_torch.parallel.mesh import Mesh, use_mesh
from apollo_vision_net_tpu_torch.parallel.optim import Optimizer

Indices = Tuple[np.ndarray, Optional[np.ndarray]]

# the batch axis of each output that the losses read: the per-layer stacks
# (L, B, ...), the rest (B, ...) or (B·S, ...) in (b, s) order
OUTPUT_BATCH_DIM = {"all_cls_scores": 1, "all_bbox_preds": 1,
                    "map_all_cls_scores": 1, "map_all_pts_preds": 1,
                    "occupancy_preds": 0, "flow_preds": 0,
                    "bev_seg_logits": 0, "pv_seg_logits": 0}
# the model's inputs; every other key of a batch is ground truth
INPUT_KEYS = ("img", "can_bus", "lidar2img", "has_prev")


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """make_batch's arrays as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def ground_truth(batch: Dict[str, torch.Tensor]):
    gt = det_lib.DetGT(batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    mgt = None
    if "map_shift_pts" in batch:
        mgt = map_lib.MapGT(batch["map_shift_pts"], batch["map_labels"],
                            batch["map_mask"], batch["map_order_mask"])
    return gt, mgt


def query_groups(outs: Dict[str, torch.Tensor], cfg: ExperimentConfig) -> int:
    """Group-DETR groups in the det outputs: all ``group_detr`` in training
    mode, the first one alone in eval mode."""
    m = cfg.model
    return outs["all_cls_scores"].shape[2] // (m.num_query // m.group_detr)


@torch.no_grad()
def match(outs: Dict[str, torch.Tensor], gt: det_lib.DetGT,
          mgt: Optional[map_lib.MapGT], cfg: ExperimentConfig) -> Indices:
    """Hungarian matching of every decoder layer of both heads with one
    device-to-host copy: (det indices (M, 4), map indices (M, 5) or None),
    as det_loss.solve and map_loss.solve give them (and, for MapTRv2's
    one2many vectors, map_loss.solve_one2many)."""
    m = cfg.model
    parts = [det_lib.match_costs(outs["all_cls_scores"], outs["all_bbox_preds"],
                                 gt, num_groups=query_groups(outs, cfg)), gt.mask]
    map_cls, map_pts = outs.get("map_all_cls_scores"), outs.get("map_all_pts_preds")
    o1 = m.num_map_vec
    # MapTRv2 in training mode: the one2many vectors after the one2one ones
    one2many = mgt is not None and m.map_version == 2 and map_cls.shape[2] > o1
    if mgt is not None:
        parts += [*map_lib.match_costs(map_cls[:, :, :o1], map_pts[:, :, :o1],
                                       mgt, pc_range=m.pc_range), mgt.mask]
    if one2many:
        # against the V distinct GT rows; solve_one2many tiles them k times
        parts += map_lib.match_costs(map_cls[:, :, o1:], map_pts[:, :, o1:],
                                     mgt, pc_range=m.pc_range)
    # one flat f32 transfer: masks and order indices are exact in f32
    flat = torch.cat([p.reshape(-1).float() for p in parts]).cpu().numpy()
    host, start = [], 0
    for p in parts:
        host.append(flat[start:start + p.numel()].reshape(p.shape))
        start += p.numel()
    det_idx = det_lib.solve(host[0], host[1].astype(bool))
    map_idx = None
    if mgt is not None:
        map_idx = map_lib.solve(host[2], host[3].astype(np.int64),
                                host[4].astype(bool))
    if one2many:
        map_idx = np.concatenate([map_idx, map_lib.solve_one2many(
            host[5], host[6].astype(np.int64), host[4].astype(bool),
            m.map_k_one2many, o1)])
    return det_idx, map_idx


def loss_fn(model, batch: Dict[str, torch.Tensor], cfg: ExperimentConfig,
            indices: Optional[Indices] = None, mesh: Optional[Mesh] = None):
    """-> (loss_total, {term: value}, indices). The model's mode decides
    dropout and grid mask. ``indices`` (from ``match``) fixes the
    assignment, so that two runs can be held against each other at the
    same one; by default the step matches its own outputs. With ``mesh``,
    ``batch`` is this rank's rows of the global batch, the forward runs
    under the mesh, and the loss and indices are those of the global batch
    (the outputs and ground truth gathered over dp)."""
    m = cfg.model
    with use_mesh(mesh):
        outs = model(batch["img"], batch["can_bus"], batch["lidar2img"],
                     batch["has_prev"])
    if mesh is not None:
        outs = {k: collectives.all_gather(mesh, v, OUTPUT_BATCH_DIM[k], "dp")
                if k in OUTPUT_BATCH_DIM else v for k, v in outs.items()}
        batch = collectives.gather_targets(
            mesh, batch, [k for k in batch if k not in INPUT_KEYS])
    gt, mgt = ground_truth(batch)
    if indices is None:
        indices = match(outs, gt, mgt, cfg)
    if m.with_occupancy:
        losses = det_occ_loss(
            outs, gt, batch["gt_occupancy"], indices[0],
            occupancy_classes=m.occupancy_classes,
            group_detr=query_groups(outs, cfg),
            num_classes=m.num_classes, occ_loss_type=m.occ_loss_type,
            occ_grid_hw=(m.occ_ydim, m.occ_xdim), occ_zdim=m.occ_zdim,
            flow_preds=outs.get("flow_preds"), gt_flow=batch.get("gt_flow"))
    else:
        losses = det_lib.det_loss(
            outs["all_cls_scores"], outs["all_bbox_preds"], gt, indices[0],
            num_classes=m.num_classes, num_groups=query_groups(outs, cfg))
    if m.with_map and m.map_version == 2:
        map_losses = map_lib.map_loss_v2(
            outs["map_all_cls_scores"], outs["map_all_pts_preds"], mgt,
            indices[1], pc_range=m.pc_range, num_vec_one2one=m.num_map_vec,
            k_one2many=m.map_k_one2many,
            lambda_one2many=m.map_lambda_one2many,
            num_classes=m.map_num_classes,
            bev_seg_logits=outs.get("bev_seg_logits"),
            gt_bev_seg=batch.get("gt_bev_seg"),
            pv_seg_logits=outs.get("pv_seg_logits"),
            gt_pv_seg=batch.get("gt_pv_seg"))
    elif m.with_map:
        map_losses = map_lib.map_loss(
            outs["map_all_cls_scores"], outs["map_all_pts_preds"], mgt,
            indices[1], pc_range=m.pc_range, num_classes=m.map_num_classes)
    if m.with_map:
        total = losses.pop("loss_total") + map_losses.pop("loss_map_total")
        losses.update(map_losses)
        losses["loss_total"] = total
    return losses["loss_total"], losses, indices


def train_step(model, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator], *,
               cfg: ExperimentConfig) -> Dict[str, torch.Tensor]:
    """One update of a model in training mode: forward and loss with the
    model's random draws from ``generator``, backward, the global-norm clip
    and AdamW. Returns the loss terms (on the device) and ``grad_norm``."""
    optimizer.zero_grad()
    with use_generator(generator):
        total, losses, _ = loss_fn(model, batch, cfg)
    total.backward()
    losses = {k: v.detach() for k, v in losses.items()}
    losses["grad_norm"] = optimizer.step()
    return losses


def average_gradients(mesh: Mesh, model) -> None:
    """Every parameter's gradient averaged over the world (a parameter
    without one counts as zeros, as the optimizer steps it so). The outputs'
    all-gather sums every rank's copy of the loss's gradient in its
    backward (parallel/collectives.py), so a rank holds world times its
    share of the true gradient (dp times through the gather over dp; the
    BEV partition's gathers over sp add the factor sp, and a module
    replicated over sp is counted once a rank of the group): the sum over
    the world is world times the true gradient, and the average is exact."""
    params = [p for p in model.parameters() if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    collectives.average_(mesh, [p.grad for p in params])


def make_train_step(mesh: Optional[Mesh], cfg: ExperimentConfig):
    """The train step over ``mesh`` (``train_step`` itself without one):
    ``step(model, optimizer, batch, generator)`` with this rank's rows of
    the global batch and a generator seeded alike on every rank; returns
    the loss terms of the global batch and ``grad_norm``, equal on every
    rank."""
    if mesh is None:
        return functools.partial(train_step, cfg=cfg)

    def step(model, optimizer: Optimizer, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        with use_generator(generator):
            total, losses, _ = loss_fn(model, batch, cfg, mesh=mesh)
        total.backward()
        # each rank holds world x its share of the gradient (the gathers'
        # backward sums every rank's copy): the mean, not the sum, is exact
        average_gradients(mesh, model)
        losses = {k: v.detach() for k, v in losses.items()}
        losses["grad_norm"] = optimizer.step()
        return losses

    return step
