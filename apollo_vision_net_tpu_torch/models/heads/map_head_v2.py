"""det + MapTRv2 map head: the decoupled map decoder, the one2one and
one2many query sets and the auxiliary BEV and PV segmentation heads.

Counterpart of the JAX package's models/heads/map_head_v2.py (reference
bevformer_det_map_head_apollo_v2.py:17-761, maptrv2/modules/decoder.py
:11-220):
- ``DecoupledMapDecoderLayer``: self-attention among the P points of each
  vector (vectors folded into the batch), self-attention among the vectors
  at each point index (points folded) under the one2one/one2many
  block-diagonal keep-mask, deformable cross-attention over the BEV, FFN,
  each followed by a LayerNorm;
- ``BEVFormerDetMapHeadV2``: in training mode (``.train()``) the map branch
  runs the one2one and one2many vectors (50 + 300 as configured), in eval
  mode the one2one vectors alone; the reference points are detached after
  each layer, points are sigmoid(Δ + inverse_sigmoid(ref)) and classes come
  from mean-pooled point features;
- ``BEVSegHead``: 3x3 conv without bias, ReLU, 1x1 conv, on the BEV grid
  and on each camera's finest image feature map, in both modes.

The JAX package builds the map branch and the segmentation heads without a
dtype, so they compute in f32 whatever the config's dtype; so does the port
(the det part follows the head's dtype).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.attention import (
    FFN,
    CustomMSDeformableAttention,
    MultiheadAttention,
)
from apollo_vision_net_tpu_torch.models.decoder import RegBranch
from apollo_vision_net_tpu_torch.models.heads.det_head import BEVFormerHead, ClsBranch
from apollo_vision_net_tpu_torch.models.layers import Conv2d, Dense, LayerNorm
from apollo_vision_net_tpu_torch.utils.box_coder import inverse_sigmoid

Shapes = Tuple[Tuple[int, int], ...]


class DecoupledMapDecoderLayer(nn.Module):
    """One decoupled map decoder layer over (B, NV·P, C) point queries, in
    f32."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_points: int = 4, feedforward_channels: int = 512,
                 num_pts_per_vec: int = 20):
        super().__init__()
        C = embed_dims
        self.num_pts_per_vec = num_pts_per_vec
        self.self_attn_pts = MultiheadAttention(C, num_heads)
        self.norm1 = LayerNorm(C)
        self.self_attn_vec = MultiheadAttention(C, num_heads)
        self.norm2 = LayerNorm(C)
        self.cross_attn = CustomMSDeformableAttention(C, num_heads, 1, num_points)
        self.norm3 = LayerNorm(C)
        self.ffn = FFN(C, feedforward_channels)
        self.norm4 = LayerNorm(C)

    def forward(self, query, memory, *, query_pos, reference_points,
                spatial_shapes: Shapes, vec_attn_mask=None):
        """query, query_pos (B, NV·P, C); memory (B, V, C); reference_points
        (B, NV·P, 2); vec_attn_mask (NV, NV) bool keep-mask or None."""
        B, Q, C = query.shape
        P = self.num_pts_per_vec
        NV = Q // P
        # among the points of each vector
        q = self.self_attn_pts(query.reshape(B * NV, P, C),
                               query_pos=query_pos.reshape(B * NV, P, C))
        q = self.norm1(q.reshape(B, Q, C))

        # among the vectors at each point index
        def by_point(t):
            return t.reshape(B, NV, P, C).transpose(1, 2).reshape(B * P, NV, C)

        qv = self.self_attn_vec(by_point(q), query_pos=by_point(query_pos),
                                attn_mask=vec_attn_mask)
        q = self.norm2(qv.reshape(B, P, NV, C).transpose(1, 2).reshape(B, Q, C))
        q = self.cross_attn(q, memory, query_pos=query_pos,
                            reference_points=reference_points,
                            spatial_shapes=spatial_shapes)
        q = self.norm3(q)
        return self.norm4(self.ffn(q))


class BEVSegHead(nn.Module):
    """Aux segmentation head of one class (the reference's seg_classes):
    3x3 conv (no bias) -> ReLU -> 1x1 conv, (B, H, W, C) -> (B, H, W)
    logits, in f32."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.Conv_0 = Conv2d(embed_dims, embed_dims, 3, padding=1)
        self.Conv_1 = Conv2d(embed_dims, 1, 1, padding=0, bias=True)

    def forward(self, grid: torch.Tensor) -> torch.Tensor:
        x = grid.float().permute(0, 3, 1, 2)
        return self.Conv_1(F.relu(self.Conv_0(x)))[:, 0]


class BEVFormerDetMapHeadV2(BEVFormerHead):
    def __init__(self, *, num_vec_one2one: int = 50,
                 num_vec_one2many: int = 300, map_num_pts: int = 20,
                 map_num_classes: int = 3, map_decoder_layers: int = 6,
                 with_aux_seg: bool = True, **kwargs):
        super().__init__(**kwargs)
        C = self.embed_dims
        self.num_vec_one2one = num_vec_one2one
        self.num_vec_total = num_vec_one2one + num_vec_one2many
        self.map_num_pts = map_num_pts
        self.with_aux_seg = with_aux_seg
        self.map_instance_embedding = nn.Parameter(
            torch.empty(self.num_vec_total, 2 * C))
        self.map_pts_embedding = nn.Parameter(torch.empty(map_num_pts, 2 * C))
        self.map_reference_points_fc = Dense(C, 2)
        self.map_layers = nn.ModuleList([
            DecoupledMapDecoderLayer(
                C, feedforward_channels=self.feedforward_channels,
                num_pts_per_vec=map_num_pts)
            for _ in range(map_decoder_layers)])
        self.map_cls_branches = nn.ModuleList([
            ClsBranch(C, map_num_classes) for _ in range(map_decoder_layers)])
        self.map_reg_branches = nn.ModuleList([
            RegBranch(C, 2) for _ in range(map_decoder_layers)])
        if with_aux_seg:
            self.bev_seg_head = BEVSegHead(C)
            self.pv_seg_head = BEVSegHead(C)
        self._vec_masks = {}

    def vec_attn_mask(self, num_vec: int, device) -> torch.Tensor:
        """(num_vec, num_vec) bool keep-mask: one2one and one2many vectors
        attend within their own set only (reference :180-186). Built on the
        device once per (num_vec, device)."""
        key = (num_vec, str(device))
        if key not in self._vec_masks:
            is_o1 = torch.arange(num_vec, device=device) < self.num_vec_one2one
            self._vec_masks[key] = is_o1[:, None] == is_o1[None, :]
        return self._vec_masks[key]

    def _map_branch(self, bev_embed: torch.Tensor):
        B = bev_embed.shape[0]
        C, P = self.embed_dims, self.map_num_pts
        NV = self.num_vec_total if self.training else self.num_vec_one2one
        q_embed = (self.map_instance_embedding[:NV, None, :]
                   + self.map_pts_embedding[None, :, :]).reshape(NV * P, 2 * C)
        query_pos = q_embed[:, :C][None].expand(B, -1, C)
        out = q_embed[:, C:][None].expand(B, -1, C)
        ref = torch.sigmoid(self.map_reference_points_fc(query_pos))
        mask = (self.vec_attn_mask(NV, bev_embed.device)
                if NV > self.num_vec_one2one else None)
        all_cls, all_pts = [], []
        for layer, reg, cls in zip(self.map_layers, self.map_reg_branches,
                                   self.map_cls_branches):
            out = layer(out, bev_embed, query_pos=query_pos,
                        reference_points=ref,
                        spatial_shapes=((self.bev_h, self.bev_w),),
                        vec_attn_mask=mask)
            pts01 = torch.sigmoid(reg(out)[..., :2] + inverse_sigmoid(ref))
            ref = pts01.detach()
            all_cls.append(cls(out.reshape(B, NV, P, C).mean(dim=2)))
            all_pts.append(pts01.reshape(B, NV, P, 2))
        return torch.stack(all_cls), torch.stack(all_pts)

    def forward(self, mlvl_feats, *, can_bus, lidar2img, prev_bev, has_prev,
                only_bev: bool = False):
        kw = dict(can_bus=can_bus, lidar2img=lidar2img, prev_bev=prev_bev,
                  has_prev=has_prev)
        if only_bev:
            return super().forward(mlvl_feats, only_bev=True, **kw)
        outs = super().forward(mlvl_feats, **kw)
        bev = outs["bev_embed"]
        # (L, B, NV, classes) and (L, B, NV, P, 2) in 0..1; NV one2one first
        outs["map_all_cls_scores"], outs["map_all_pts_preds"] = self._map_branch(bev)
        if self.with_aux_seg:
            B = bev.shape[0]
            outs["bev_seg_logits"] = self.bev_seg_head(
                bev.reshape(B, self.bev_h, self.bev_w, self.embed_dims))
            # PV segmentation on each camera's finest feature level
            f = mlvl_feats[0]
            b, n, h, w, c = f.shape
            outs["pv_seg_logits"] = self.pv_seg_head(
                f.reshape(b * n, h, w, c)).reshape(b, n, h, w)
        return outs
