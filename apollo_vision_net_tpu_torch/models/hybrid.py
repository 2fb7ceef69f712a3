"""HybridFormer (the OccNet cascade): a BEV encoder stage, then voxel stages
of growing z and shrinking channels.

Counterpart of the JAX package's models/hybrid.py (reference
modules/hybrid_transformer.py and dense_heads/hybrid_occupancy_head.py):
stage 0 is a ``BEVFormerLayer`` over the bev_h x bev_w queries at
``encoder_embed_dims[0]``; each later stage s is ``VoxelFormerLayer``s over
z_s x bev_h x bev_w voxels at C_s channels; between stages a Dense
(``transition{i}``) maps each pillar's z_i·C_i features to z_j·C_j. Each
stage reads the image features through its own projection
(``value_proj_stage{i}``) and carries its own slice of the temporal state,
rotated by the ego yaw delta in every stage. The carry is every stage's
output, zero-padded to C_max channels and concatenated on the token axis.
The det decoder runs on voxel2bev of the last stage; the occupancy MLP on
the last stage resized to the occupancy grid.

The head computes in f32 whatever the config's dtype, as the JAX package
builds these modules without a dtype. At 8 heads the stages' per-head
widths run down to C_s / 8 = 2 (hybrid_tiny_occ's last stage), which the
MSDA forward takes on its scalar variant and ``msda_bwd`` on its general
plan. Submodules keep the flax names (see bridge.py).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.encoder import BEVFormerLayer
from apollo_vision_net_tpu_torch.models.layers import Dense
from apollo_vision_net_tpu_torch.models.pos_encoding import LearnedPositionalEncoding
from apollo_vision_net_tpu_torch.models.voxel import (
    VoxelDetOccHead,
    VoxelFormerLayer,
    VoxelLearnedPositionalEncoding,
    camera_geometry,
    flatten_levels,
    rotate_slices,
    voxel_reference_points_3d,
)
from apollo_vision_net_tpu_torch.utils import geometry


class HybridFormerOccupancyHead(VoxelDetOccHead):
    """The BEV→voxel cascade. It ignores ``bev_partition``, as the JAX
    package's head does: under a mesh with sp > 1 every rank of an sp group
    runs it unsplit."""

    def __init__(self, *, encoder_embed_dims: Sequence[int] = (256, 128, 64, 32, 16),
                 feature_map_z: Sequence[int] = (1, 2, 4, 8, 16),
                 stage_layers: int = 1, embed_dims: int = 256, **kwargs):
        dims, zs = tuple(encoder_embed_dims), tuple(feature_map_z)
        # the occupancy MLP reads the last stage's channels
        super().__init__(embed_dims=embed_dims, can_bus_dims=dims[0],
                         pillar_dims=zs[-1] * dims[-1], occ_in_dims=dims[-1],
                         **kwargs)
        self.encoder_embed_dims, self.feature_map_z = dims, zs
        self.stage_layers = stage_layers
        h, w = self.bev_h, self.bev_w
        L, N = self.num_feature_levels, self.num_cams
        self.bev_embedding = nn.Parameter(torch.empty(h * w, dims[0]))
        self.positional_encoding = LearnedPositionalEncoding(dims[0] // 2, h, w)
        for i in range(stage_layers):
            self.add_module(f"bev_layer{i}", BEVFormerLayer(
                dims[0], num_levels=L, num_cams=N,
                feedforward_channels=dims[0] * 2, dtype=torch.float32))
        for s in range(1, len(dims)):
            self.add_module(f"pos_stage{s}", VoxelLearnedPositionalEncoding(
                VoxelLearnedPositionalEncoding.feats(dims[s]), zs[s], h, w))
            for i in range(stage_layers):
                self.add_module(f"voxel_stage{s}_layer{i}", VoxelFormerLayer(
                    dims[s], num_levels=L, num_cams=N,
                    feedforward_channels=dims[s] * 2))
        for i in range(len(dims) - 1):
            self.add_module(f"transition{i}",
                            Dense(zs[i] * dims[i], zs[i + 1] * dims[i + 1]))
        for i in range(len(dims)):
            self.add_module(f"value_proj_stage{i}", Dense(embed_dims, dims[i]))

    @property
    def prev_tokens(self) -> int:
        """Tokens of the temporal carry: every stage's volume."""
        return sum(z * self.bev_h * self.bev_w for z in self.feature_map_z)

    def _stage_slices(self):
        starts = np.concatenate([[0], np.cumsum(
            [z * self.bev_h * self.bev_w for z in self.feature_map_z])])
        return [(int(a), int(b)) for a, b in zip(starts[:-1], starts[1:])]

    def forward(self, mlvl_feats, *, can_bus, lidar2img, prev_bev, has_prev,
                only_bev: bool = False):
        """prev_bev (B, prev_tokens, C_max), the concatenated stage carry ->
        the new carry alone with ``only_bev``, else the det outputs, the
        occupancy logits and the carry as ``bev_embed``."""
        B = mlvl_feats[0].shape[0]
        h, w = self.bev_h, self.bev_w
        dims, zs = self.encoder_embed_dims, self.feature_map_z
        Cmax = dims[0]
        dev = prev_bev.device
        shift = self._shift(can_bus, has_prev).float()
        angles = can_bus[:, -1] * has_prev
        img_value, img_shapes = flatten_levels(mlvl_feats)
        hp = has_prev[:, None, None].float()
        q = self._add_can_bus(self.bev_embedding[None].expand(B, h * w, Cmax),
                              can_bus)
        carry = []
        for stage, (start, stop) in enumerate(self._stage_slices()):
            Z, C = zs[stage], dims[stage]
            Q = Z * h * w
            value = getattr(self, f"value_proj_stage{stage}")(img_value)
            prev = rotate_slices(prev_bev[:, start:stop, :C].float(), angles, Z, h, w)
            ref_cam, bev_mask = camera_geometry(
                Z, h, w, self.num_points_in_voxel, self.pc_range, lidar2img,
                self.img_shape)
            q0 = q
            if stage == 0:
                pos = self.positional_encoding(h, w)[None].expand(B, Q, C)
                ref2d = torch.as_tensor(geometry.bev_reference_points_2d(h, w),
                                        device=dev)[None] + shift[:, None, :]
                refs = torch.stack([ref2d, ref2d], dim=1)[:, :, :, None, :]
                for i in range(self.stage_layers):
                    q = getattr(self, f"bev_layer{i}")(
                        q, value, bev_pos=pos,
                        tsa_value=torch.stack([hp * prev + (1.0 - hp) * q,
                                               hp * q0 + (1.0 - hp) * q], dim=1),
                        tsa_refs=refs, bev_spatial_shapes=((h, w),),
                        img_spatial_shapes=img_shapes,
                        reference_points_cam=ref_cam, bev_mask=bev_mask)
            else:
                pos = getattr(self, f"pos_stage{stage}")()[None].expand(B, Q, C)
                ref = torch.as_tensor(voxel_reference_points_3d(Z, h, w)[0],
                                      device=dev)[None] + F.pad(shift, (0, 1))[:, None, :]
                refs = torch.stack([ref, ref], dim=1)[:, :, :, None, :]
                for i in range(self.stage_layers):
                    q = getattr(self, f"voxel_stage{stage}_layer{i}")(
                        q, value, query_pos=pos,
                        tsa_value=torch.stack([hp * prev + (1.0 - hp) * q,
                                               hp * q0 + (1.0 - hp) * q], dim=1),
                        tsa_refs=refs, spatial_shape=(Z, h, w),
                        img_spatial_shapes=img_shapes,
                        reference_points_cam=ref_cam, bev_mask=bev_mask)
            carry.append(F.pad(q, (0, Cmax - C)))
            if stage < len(dims) - 1:
                # pillar transition: (hw, z_i·C_i) -> (hw, z_j·C_j)
                Zn, Cn = zs[stage + 1], dims[stage + 1]
                pillar = q.reshape(B, Z, h * w, C).transpose(1, 2).reshape(B, h * w, Z * C)
                pillar = getattr(self, f"transition{stage}")(pillar)
                q = pillar.reshape(B, h * w, Zn, Cn).transpose(1, 2).reshape(B, Zn * h * w, Cn)
        new_carry = torch.cat(carry, dim=1)
        if only_bev:
            return new_carry
        return self._outputs(new_carry, q, zs[-1])
