"""BEVFormerHead — DETR-style 3D detection head (NMS-free).

Counterpart of the JAX package's models/heads/det_head.py (reference
bevformer/dense_heads/bevformer_head.py:27-545): learned BEV and object
query tables, per-decoder-layer classification branches, per-layer boxes
decoded into pc_range meters through the refined reference points.

``bev_partition=("dp", "sp", None)`` (JAX's sharding of the BEV queries,
det_head.py:179-217, which the det+map, MapTRv2 and det+occ heads inherit)
splits the encoder's BEV rows over the current mesh's sp axis
(models/encoder.py); the decoders and heads run on the gathered BEV,
replicated in the sp group.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.layers import Dense, LayerNorm
from apollo_vision_net_tpu_torch.models.pos_encoding import LearnedPositionalEncoding
from apollo_vision_net_tpu_torch.models.transformer import PerceptionTransformer
from apollo_vision_net_tpu_torch.utils import geometry
from apollo_vision_net_tpu_torch.utils.box_coder import inverse_sigmoid

FOCAL_BIAS_INIT = float(-np.log((1 - 0.01) / 0.01))  # bias_init_with_prob(0.01)


class ClsBranch(nn.Module):
    """(Dense -> LN -> ReLU) x 2 -> Dense, computed in f32."""

    def __init__(self, embed_dims: int, num_classes: int):
        super().__init__()
        self.Dense_0 = Dense(embed_dims, embed_dims)
        self.LayerNorm_0 = LayerNorm(embed_dims)
        self.Dense_1 = Dense(embed_dims, embed_dims)
        self.LayerNorm_1 = LayerNorm(embed_dims)
        self.Dense_2 = Dense(embed_dims, num_classes)

    def forward(self, x):
        x = F.relu(self.LayerNorm_0(self.Dense_0(x)))
        x = F.relu(self.LayerNorm_1(self.Dense_1(x)))
        return self.Dense_2(x)


class BEVFormerHead(nn.Module):
    def __init__(self, bev_h: int = 50, bev_w: int = 50, num_query: int = 900,
                 num_classes: int = 10, embed_dims: int = 256,
                 code_size: int = 10,
                 pc_range: Sequence[float] = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0),
                 num_points_in_pillar: int = 4,
                 img_shape: Tuple[int, int] = (480, 800), num_cams: int = 6,
                 num_feature_levels: int = 1, encoder_layers: int = 3,
                 decoder_layers: int = 6, feedforward_channels: int = 512,
                 rotate_prev_bev: bool = True, use_shift: bool = True,
                 use_can_bus: bool = True, shift_current_refs: bool = True,
                 attn_logits_clamp: Optional[float] = None,
                 group_detr: int = 1,
                 bev_partition: Optional[Tuple[Optional[str], ...]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if bev_partition is not None and tuple(bev_partition) != ("dp", "sp", None):
            raise NotImplementedError(
                f"bev_partition={bev_partition!r}: the port splits the BEV "
                "queries as ('dp', 'sp', None) only")
        self.bev_h, self.bev_w = bev_h, bev_w
        self.num_query = num_query
        self.embed_dims = embed_dims
        self.pc_range = tuple(pc_range)
        self.num_points_in_pillar = num_points_in_pillar
        self.img_shape = tuple(img_shape)
        self.num_cams = num_cams
        self.num_feature_levels = num_feature_levels
        self.feedforward_channels = feedforward_channels
        self.group_detr = group_detr
        self.dtype = dtype
        self.bev_embedding = nn.Parameter(torch.empty(bev_h * bev_w, embed_dims))
        self.query_embedding = nn.Parameter(torch.empty(num_query, 2 * embed_dims))
        self.positional_encoding = LearnedPositionalEncoding(
            embed_dims // 2, bev_h, bev_w)
        self.transformer = PerceptionTransformer(
            embed_dims, num_feature_levels, num_cams, bev_hw=(bev_h, bev_w),
            encoder_layers=encoder_layers,
            feedforward_channels=feedforward_channels,
            decoder_layers=decoder_layers,
            decoder_self_attn_groups=group_detr, code_size=code_size,
            rotate_prev_bev=rotate_prev_bev, use_shift=use_shift,
            use_can_bus=use_can_bus, shift_current_refs=shift_current_refs,
            attn_logits_clamp=attn_logits_clamp,
            partition=bev_partition is not None, dtype=dtype)
        self.cls_branches = nn.ModuleList([
            ClsBranch(embed_dims, num_classes) for _ in range(decoder_layers)])

    @property
    def real_hw(self) -> Tuple[float, float]:
        pc = self.pc_range
        return (pc[4] - pc[1], pc[3] - pc[0])

    @property
    def prev_tokens(self) -> int:
        """Tokens of the temporal carry: the BEV's cells."""
        return self.bev_h * self.bev_w

    def _geometry(self, lidar2img: torch.Tensor):
        """Pillar refs + per-sample camera projection, cameras leading:
        ref_2d (Q, 2), ref_cam (N, B, Q, D, 2), bev_mask (N, B, Q, D)."""
        dev = lidar2img.device
        ref_3d = torch.as_tensor(geometry.bev_reference_points_3d(
            self.bev_h, self.bev_w, self.pc_range[5] - self.pc_range[2],
            self.num_points_in_pillar), device=dev)
        ref_2d = torch.as_tensor(
            geometry.bev_reference_points_2d(self.bev_h, self.bev_w), device=dev)
        ref_cam, bev_mask = geometry.point_sampling(
            ref_3d, self.pc_range, lidar2img, self.img_shape)
        return ref_2d, ref_cam.transpose(0, 1), bev_mask.transpose(0, 1)

    def forward(self, mlvl_feats, *, can_bus, lidar2img, prev_bev, has_prev,
                only_bev: bool = False):
        """mlvl_feats [(B, N, H, W, C)]; can_bus (B, 18); lidar2img
        (B, N, 4, 4); prev_bev (B, bev_h*bev_w, C); has_prev (B,). With
        ``only_bev`` returns the BEV features (B, bev_h*bev_w, C) alone (the
        history replay of a training queue)."""
        grid_length = (self.real_hw[0] / self.bev_h, self.real_hw[1] / self.bev_w)
        bev_pos = self.positional_encoding(self.bev_h, self.bev_w)
        ref_2d, ref_cam, bev_mask = self._geometry(lidar2img)
        if only_bev:
            return self.transformer.get_bev_features(
                mlvl_feats, self.bev_embedding, bev_h=self.bev_h,
                bev_w=self.bev_w, grid_length=grid_length, bev_pos=bev_pos,
                prev_bev=prev_bev, has_prev=has_prev, can_bus=can_bus,
                ref_2d=ref_2d, reference_points_cam=ref_cam, bev_mask=bev_mask)
        # Group-DETR: inference uses only the first query group, training all
        query_embedding = self.query_embedding
        if self.group_detr > 1 and not self.training:
            query_embedding = query_embedding[: self.num_query // self.group_detr]
        bev_embed, hs, init_ref, inter_refs, inter_regs = self.transformer(
            mlvl_feats, self.bev_embedding, query_embedding,
            bev_h=self.bev_h, bev_w=self.bev_w, grid_length=grid_length,
            bev_pos=bev_pos, prev_bev=prev_bev, has_prev=has_prev,
            can_bus=can_bus, ref_2d=ref_2d, reference_points_cam=ref_cam,
            bev_mask=bev_mask)

        return {"bev_embed": bev_embed, **decode_layers(
            hs, init_ref, inter_refs, inter_regs, self.cls_branches,
            self.pc_range)}


def decode_layers(hs, init_ref, inter_refs, inter_regs, cls_branches,
                  pc_range) -> dict:
    """Every decoder layer's class scores and boxes: centres from the
    layer's regression on the reference points it started from, decoded into
    pc_range meters -> {"all_cls_scores", "all_bbox_preds"}, (Lyr, B, Q, ·)."""
    pc = np.asarray(pc_range, np.float32)
    cls_scores, bbox_preds = [], []
    for lvl in range(hs.shape[0]):
        ref = inverse_sigmoid(init_ref if lvl == 0 else inter_refs[lvl - 1])
        tmp = inter_regs[lvl]
        xy = torch.sigmoid(tmp[..., 0:2] + ref[..., 0:2])
        z = torch.sigmoid(tmp[..., 4:5] + ref[..., 2:3])
        x = xy[..., 0:1] * float(pc[3] - pc[0]) + float(pc[0])
        y = xy[..., 1:2] * float(pc[4] - pc[1]) + float(pc[1])
        z = z * float(pc[5] - pc[2]) + float(pc[2])
        cls_scores.append(cls_branches[lvl](hs[lvl]))
        bbox_preds.append(torch.cat([x, y, tmp[..., 2:4], z, tmp[..., 5:]], -1))
    return {"all_cls_scores": torch.stack(cls_scores),
            "all_bbox_preds": torch.stack(bbox_preds)}
