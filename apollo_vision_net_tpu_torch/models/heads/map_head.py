"""det + vectorized-map head (MapTR v1 protocol).

Counterpart of the JAX package's models/heads/map_head.py (reference
bevformer_det_map_head_apollo.py:64-1179): num_vec × num_pts point queries
(instance ⊕ point embedding), learned 2D reference points, a map2d
refinement decoder over the shared BEV, per-layer points
sigmoid(Δ + inverse_sigmoid(ref)) and vector classes from mean-pooled point
features.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from apollo_vision_net_tpu_torch.models.decoder import DetectionTransformerDecoder
from apollo_vision_net_tpu_torch.models.heads.det_head import BEVFormerHead, ClsBranch
from apollo_vision_net_tpu_torch.models.layers import Dense
from apollo_vision_net_tpu_torch.utils.box_coder import inverse_sigmoid


class BEVFormerDetMapHead(BEVFormerHead):
    def __init__(self, *, num_map_vec: int = 50, map_num_pts: int = 20,
                 map_num_classes: int = 3, map_decoder_layers: int = 6,
                 **kwargs):
        super().__init__(**kwargs)
        C = self.embed_dims
        self.num_map_vec, self.map_num_pts = num_map_vec, map_num_pts
        self.map_instance_embedding = nn.Parameter(torch.empty(num_map_vec, 2 * C))
        self.map_pts_embedding = nn.Parameter(torch.empty(map_num_pts, 2 * C))
        self.map_reference_points_fc = Dense(C, 2)
        self.map_decoder = DetectionTransformerDecoder(
            map_decoder_layers, C,
            feedforward_channels=kwargs.get("feedforward_channels", 512),
            dtype=self.dtype, code_size=2, ref_mode="map2d")
        self.map_cls_branches = nn.ModuleList([
            ClsBranch(C, map_num_classes) for _ in range(map_decoder_layers)])

    def _map_branch(self, bev_embed: torch.Tensor):
        B = bev_embed.shape[0]
        C = self.embed_dims
        nv, npt = self.num_map_vec, self.map_num_pts
        q_embed = (self.map_instance_embedding[:, None, :]
                   + self.map_pts_embedding[None, :, :]).reshape(nv * npt, 2 * C)
        query_pos = q_embed[:, :C][None].expand(B, -1, C)
        query = q_embed[:, C:][None].expand(B, -1, C)
        init_ref = torch.sigmoid(self.map_reference_points_fc(query_pos))
        states, refs, regs = self.map_decoder(
            query, bev_embed, query_pos=query_pos, reference_points=init_ref,
            spatial_shapes=((self.bev_h, self.bev_w),))
        all_cls, all_pts = [], []
        for lvl in range(states.shape[0]):
            ref = init_ref if lvl == 0 else refs[lvl - 1]
            pts01 = torch.sigmoid(regs[lvl][..., :2] + inverse_sigmoid(ref))
            all_pts.append(pts01.reshape(B, nv, npt, 2))
            feat_vec = states[lvl].reshape(B, nv, npt, C).mean(dim=2)
            all_cls.append(self.map_cls_branches[lvl](feat_vec))
        return torch.stack(all_cls), torch.stack(all_pts)

    def forward(self, mlvl_feats, *, can_bus, lidar2img, prev_bev, has_prev,
                only_bev: bool = False):
        if only_bev:
            return super().forward(mlvl_feats, can_bus=can_bus,
                                   lidar2img=lidar2img, prev_bev=prev_bev,
                                   has_prev=has_prev, only_bev=True)
        outs = super().forward(mlvl_feats, can_bus=can_bus, lidar2img=lidar2img,
                               prev_bev=prev_bev, has_prev=has_prev)
        map_cls, map_pts = self._map_branch(outs["bev_embed"])
        outs["map_all_cls_scores"] = map_cls   # (L, B, num_vec, classes)
        outs["map_all_pts_preds"] = map_pts    # (L, B, num_vec, P, 2) in 0..1
        return outs


def get_map_results(map_cls_logits: torch.Tensor, map_pts01: torch.Tensor,
                    pc_range: Sequence[float]):
    """Last-layer map outputs -> vectors in meters with per-vector score
    and label, sigmoid().max(-1) (reference get_map_results :970-1005). All
    vectors are returned; thresholding is the consumer's."""
    scores_all = torch.sigmoid(map_cls_logits.float())
    scores, labels = scores_all.max(dim=-1)
    x = map_pts01[..., 0:1] * (pc_range[3] - pc_range[0]) + pc_range[0]
    y = map_pts01[..., 1:2] * (pc_range[4] - pc_range[1]) + pc_range[1]
    return {"vectors": torch.cat([x, y], dim=-1), "scores": scores,
            "labels": labels}
