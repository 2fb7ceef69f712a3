"""PerceptionTransformer: BEV feature pipeline + det decoder front end.

Counterpart of the JAX package's models/transformer.py (reference
bevformer/modules/transformer.py:24-401): can_bus ego-motion shift, rotation
of prev_bev by the ego yaw delta, can_bus MLP added to the BEV queries,
camera and level embeddings on the flattened image features, the encoder;
then the object query split into (pos, content), reference points from the
positional half and the refinement decoder over the BEV memory.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.decoder import DetectionTransformerDecoder
from apollo_vision_net_tpu_torch.models.encoder import BEVFormerEncoder
from apollo_vision_net_tpu_torch.models.layers import Dense, LayerNorm
from apollo_vision_net_tpu_torch.ops.grid_sample import rotate_2d
from apollo_vision_net_tpu_torch.utils import debug
from apollo_vision_net_tpu_torch.utils.geometry import bev_shift_from_can_bus

Shapes = Tuple[Tuple[int, int], ...]


class PerceptionTransformer(nn.Module):
    def __init__(self, embed_dims: int = 256, num_feature_levels: int = 4,
                 num_cams: int = 6, bev_hw: Optional[Tuple[int, int]] = None,
                 encoder_layers: int = 3, num_points_sca: int = 8,
                 num_points_tsa: int = 4, feedforward_channels: int = 512,
                 decoder_layers: int = 6, num_points_decoder: int = 4,
                 decoder_self_attn_groups: int = 1, code_size: int = 10,
                 rotate_prev_bev: bool = True, use_shift: bool = True,
                 use_can_bus: bool = True, shift_current_refs: bool = True,
                 attn_logits_clamp: Optional[float] = None,
                 partition: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = embed_dims
        self.embed_dims = C
        self.rotate_prev_bev = rotate_prev_bev
        self.use_shift = use_shift
        self.use_can_bus = use_can_bus
        self.level_embeds = nn.Parameter(torch.empty(num_feature_levels, C))
        self.cams_embeds = nn.Parameter(torch.empty(num_cams, C))
        if use_can_bus:
            self.can_bus_fc1 = Dense(18, C // 2)
            self.can_bus_fc2 = Dense(C // 2, C)
            self.can_bus_ln = LayerNorm(C)
        self.encoder = BEVFormerEncoder(
            encoder_layers, C, num_levels=num_feature_levels,
            num_points_sca=num_points_sca, num_points_tsa=num_points_tsa,
            num_cams=num_cams, feedforward_channels=feedforward_channels,
            attn_logits_clamp=attn_logits_clamp,
            shift_current_refs=shift_current_refs, bev_hw=bev_hw,
            partition=partition, dtype=dtype)
        self.decoder = DetectionTransformerDecoder(
            decoder_layers, C, num_points=num_points_decoder,
            feedforward_channels=feedforward_channels,
            self_attn_groups=decoder_self_attn_groups, dtype=dtype,
            code_size=code_size, ref_mode="det3d")
        self.reference_points_fc = Dense(C, 3)

    def _flatten_img_feats(self, mlvl_feats: Sequence[torch.Tensor]):
        """(B, N, H, W, C) per level -> (B, N, sum(HW), C) + shapes, with
        camera and level embeddings added (transformer.py:231-254)."""
        flat, shapes = [], []
        for lvl, feat in enumerate(mlvl_feats):
            B, N, H, W, C = feat.shape
            f = feat.reshape(B, N, H * W, C)
            f = f + self.cams_embeds[None, :, None, :].to(f.dtype)
            f = f + self.level_embeds[lvl].to(f.dtype)
            flat.append(f)
            shapes.append((H, W))
        return torch.cat(flat, dim=2), tuple(shapes)

    def get_bev_features(self, mlvl_feats, bev_queries, *, bev_h: int,
                         bev_w: int, grid_length, bev_pos, prev_bev, has_prev,
                         can_bus, ref_2d, reference_points_cam, bev_mask):
        """-> bev_embed (B, bev_h*bev_w, C) in f32 (the temporal carry)."""
        B = mlvl_feats[0].shape[0]
        Q, C = bev_queries.shape
        queries = bev_queries[None].expand(B, Q, C)
        shift = bev_shift_from_can_bus(can_bus, grid_length, bev_h, bev_w,
                                       self.use_shift)
        if self.rotate_prev_bev:
            # can_bus[-1] = ego yaw delta in degrees; zeroed when has_prev=0
            angles = can_bus[:, -1] * has_prev
            prev_bev = rotate_2d(prev_bev.reshape(B, bev_h, bev_w, C),
                                 angles).reshape(B, Q, C)
        if self.use_can_bus:
            cb = F.relu(self.can_bus_fc1(can_bus))
            cb = self.can_bus_ln(F.relu(self.can_bus_fc2(cb)))
            queries = queries + cb[:, None, :]
        img_value, img_shapes = self._flatten_img_feats(mlvl_feats)
        # the finite-value probe at the encoder boundary: the identity
        # unless utils.debug enables it
        return debug.probe("encoder.bev_embed", self.encoder(
            queries, img_value, bev_pos=bev_pos[None].expand(B, Q, C),
            prev_bev=prev_bev, has_prev=has_prev, shift=shift, ref_2d=ref_2d,
            bev_h=bev_h, bev_w=bev_w, img_spatial_shapes=img_shapes,
            reference_points_cam=reference_points_cam, bev_mask=bev_mask,
        ).float())

    def forward(self, mlvl_feats, bev_queries, object_query_embed, *,
                bev_h: int, bev_w: int, grid_length, bev_pos, prev_bev,
                has_prev, can_bus, ref_2d, reference_points_cam, bev_mask):
        bev_embed = self.get_bev_features(
            mlvl_feats, bev_queries, bev_h=bev_h, bev_w=bev_w,
            grid_length=grid_length, bev_pos=bev_pos, prev_bev=prev_bev,
            has_prev=has_prev, can_bus=can_bus, ref_2d=ref_2d,
            reference_points_cam=reference_points_cam, bev_mask=bev_mask)
        B = bev_embed.shape[0]
        C = self.embed_dims
        query_pos = object_query_embed[:, :C][None].expand(B, -1, C)
        query = object_query_embed[:, C:][None].expand(B, -1, C)
        init_reference = torch.sigmoid(self.reference_points_fc(query_pos))
        states, refs, regs = self.decoder(
            query, bev_embed, query_pos=query_pos,
            reference_points=init_reference, spatial_shapes=((bev_h, bev_w),))
        return bev_embed, states, init_reference, refs, regs
