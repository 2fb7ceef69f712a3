"""Streaming inference over frames.

Counterpart of the JAX package's runtime/inference.py (reference
bevformer/apis/test.py:44-209) without the evaluators: a stateful frame loop
in which ``StreamingState`` resets the history at a scene change and turns
absolute can_bus readings into deltas, ``forward_test_frame`` carries the
BEV, and each frame's last-layer outputs are decoded into detections and
map vectors.
"""
from __future__ import annotations

from typing import Dict

import torch

from apollo_vision_net_tpu_torch.configs import ExperimentConfig
from apollo_vision_net_tpu_torch.data.temporal import StreamingState
from apollo_vision_net_tpu_torch.models.heads.map_head import get_map_results
from apollo_vision_net_tpu_torch.utils.box_coder import nms_free_decode

POST_CENTER_RANGE = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)


def last_layer(outs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The streaming step's five outputs (what ``__graft_entry__.entry``
    returns in the JAX package): last-layer det and map heads and the BEV."""
    res = {"cls_scores": outs["all_cls_scores"][-1],
           "bbox_preds": outs["all_bbox_preds"][-1]}
    if "map_all_cls_scores" in outs:
        res["map_cls_scores"] = outs["map_all_cls_scores"][-1]
        res["map_pts_preds"] = outs["map_all_pts_preds"][-1]
    res["bev_embed"] = outs["bev_embed"]
    return res


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
        m = cfg.model
        self.prev = torch.zeros((1, m.bev_h * m.bev_w, m.embed_dims),
                                dtype=torch.float32, device=self.device)

    def _tensor(self, x):
        return torch.as_tensor(x).to(self.device, torch.float32)[None]

    @torch.inference_mode()
    def step(self, frame: dict) -> dict:
        """-> {outs: last-layer outputs, det: Detections, map: vectors,
        has_prev}, all on the device."""
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
        return out
