"""Streaming inference over frames, and the evaluators over its results.

Counterpart of the JAX package's runtime/inference.py (reference
bevformer/apis/test.py:44-209, tools/test.py:336-359): a stateful frame
loop in which ``StreamingState`` resets the history at a scene change and
turns absolute can_bus readings into deltas, ``forward_test_frame`` carries
the BEV, and each frame's last-layer outputs are decoded into detections,
map vectors and the dense occupancy class grid; ``evaluate_results`` runs
the nuScenes detection, MapTR chamfer/IoU and SSC occupancy evaluators
(numpy copies under ``evaluation/``) on the formatted records.
"""
from __future__ import annotations

from typing import Dict

import torch

from apollo_vision_net_tpu_torch.configs import ExperimentConfig
from apollo_vision_net_tpu_torch.data.temporal import StreamingState
from apollo_vision_net_tpu_torch.evaluation.map_eval import evaluate_map
from apollo_vision_net_tpu_torch.evaluation.nuscenes_det import evaluate_detection
from apollo_vision_net_tpu_torch.evaluation.ssc_metrics import SSCMetrics
from apollo_vision_net_tpu_torch.models.heads.map_head import get_map_results
from apollo_vision_net_tpu_torch.models.heads.occ_head import occupancy_prediction
from apollo_vision_net_tpu_torch.utils.box_coder import nms_free_decode

POST_CENTER_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)


def last_layer(outs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The streaming step's outputs (what ``__graft_entry__.entry`` returns
    in the JAX package): last-layer det and map heads (MapTRv2's one2one
    vectors: an eval-mode model runs no others) and its segmentation logits
    (B, H, W) and (B, N, h, w), the occupancy logits (B, voxels, classes)
    of an occupancy head and its per-voxel flows (B, voxels, 2) with a flow
    branch, and the BEV."""
    res = {"cls_scores": outs["all_cls_scores"][-1],
           "bbox_preds": outs["all_bbox_preds"][-1]}
    if "map_all_cls_scores" in outs:
        res["map_cls_scores"] = outs["map_all_cls_scores"][-1]
        res["map_pts_preds"] = outs["map_all_pts_preds"][-1]
    for k in ("bev_seg_logits", "pv_seg_logits", "occupancy_preds", "flow_preds"):
        if k in outs:
            res[k] = outs[k]
    res["bev_embed"] = outs["bev_embed"]
    return res


def occupancy_rule(cfg: ExperimentConfig) -> str:
    """occupancy_prediction's rule for the config's occupancy loss: the
    focal threshold for both focal losses, the argmax for CE."""
    t = cfg.model.occ_loss_type
    return "focal_loss" if t == "CustomFocalLoss" else t


class StreamingRunner:
    """Runs one model over a stream of frames (batch 1). Each frame is a
    dict: img (N, H, W, 3), can_bus (18,) absolute, lidar2img (N, 4, 4),
    scene_token. Arrays may be numpy or tensors (already on the device)."""

    def __init__(self, cfg: ExperimentConfig, model, *,
                 post_center_range=POST_CENTER_RANGE, max_dets: int = 300):
        self.cfg = cfg
        self.model = model
        self.device = next(model.parameters()).device
        self.post_center_range = post_center_range
        self.max_dets = max_dets
        self.state = StreamingState()
        # the carry's tokens are the head's (the BEV, the voxels, or every
        # HybridFormer stage's voxels)
        self.prev = model.zero_carry(1, self.device)

    def _tensor(self, x):
        return torch.as_tensor(x).to(self.device, torch.float32)[None]

    @torch.inference_mode()
    def step(self, frame: dict) -> dict:
        """-> {outs: last-layer outputs, det: Detections, map: vectors,
        occ: the (voxels,) class grid, has_prev}, all on the device."""
        m = self.cfg.model
        cb, has_prev = self.state.prepare_frame(frame["can_bus"],
                                                frame["scene_token"])
        outs, new_prev = self.model.forward_test_frame(
            self._tensor(frame["img"]), self._tensor(cb),
            self._tensor(frame["lidar2img"]), self.prev,
            torch.full((1,), has_prev, dtype=torch.float32, device=self.device))
        self.prev = new_prev
        self.state.update(new_prev)
        res = last_layer(outs)
        out = {"outs": res, "has_prev": has_prev,
               "det": nms_free_decode(res["cls_scores"][0], res["bbox_preds"][0],
                                      self.post_center_range,
                                      max_num=self.max_dets,
                                      num_classes=m.num_classes)}
        if "map_cls_scores" in res:
            out["map"] = get_map_results(res["map_cls_scores"],
                                         res["map_pts_preds"], m.pc_range)
        if "occupancy_preds" in res:
            out["occ"] = occupancy_prediction(res["occupancy_preds"],
                                              occupancy_rule(self.cfg))[0]
        return out


def evaluate_results(cfg: ExperimentConfig, results: Dict[str, list],
                     gt: Dict[str, list]) -> Dict[str, float]:
    """All applicable evaluators: ``results`` and ``gt`` hold per-frame
    records under "det" and "map" (evaluation/formatting.py) and dense
    occupancy class grids (numpy) under "occ"."""
    out: Dict[str, float] = {}
    if results["det"] and gt.get("det"):
        out.update(evaluate_detection(gt["det"], results["det"]))
    if results["map"] and gt.get("map"):
        out.update(evaluate_map(results["map"], gt["map"]))
    if results["occ"] and gt.get("occ") is not None:
        metrics = SSCMetrics(n_classes=cfg.model.occupancy_classes + 1,
                             point_cloud_range=cfg.model.pc_range)
        for pred, true in zip(results["occ"], gt["occ"]):
            metrics.add_batch(pred, true)
        s = metrics.get_stats()
        out["occ_iou"] = float(s["iou"])
        out["occ_miou"] = float(s["miou"])
    return out
