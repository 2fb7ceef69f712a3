"""DETR-style decoder with iterative reference refinement.

Counterpart of the JAX package's models/decoder.py (reference
bevformer/modules/decoder.py:51-127, maptr/modules/decoder.py:8-61): each
layer runs self_attn -> LN -> cross_attn -> LN -> FFN -> LN, then its own
regression branch refines the reference points (detached), in 'det3d' mode
from slots (0, 1, 4) or in 'map2d' mode from slots (0, 1).
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
from apollo_vision_net_tpu_torch.models.layers import Dense, LayerNorm
from apollo_vision_net_tpu_torch.utils.box_coder import inverse_sigmoid

Shapes = Tuple[Tuple[int, int], ...]


class DetrDecoderLayer(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_points: int = 4, feedforward_channels: int = 512,
                 self_attn_groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn_groups = self_attn_groups
        self.self_attn = MultiheadAttention(embed_dims, num_heads, dtype=dtype)
        self.norm1 = LayerNorm(embed_dims, dtype=dtype)
        self.cross_attn = CustomMSDeformableAttention(
            embed_dims, num_heads, 1, num_points, dtype=dtype)
        self.norm2 = LayerNorm(embed_dims, dtype=dtype)
        self.ffn = FFN(embed_dims, feedforward_channels, dtype=dtype)
        self.norm3 = LayerNorm(embed_dims, dtype=dtype)

    def forward(self, query, memory, *, query_pos, reference_points,
                spatial_shapes: Shapes):
        dt = self.dtype
        query = query.to(dt)
        query_pos = query_pos.to(dt)
        memory = memory.to(dt)
        B, Q, C = query.shape
        # Group-DETR: groups folded into the batch so self-attention cannot
        # mix them
        G = self.self_attn_groups if Q % self.self_attn_groups == 0 else 1
        q = self.self_attn(query.reshape(B * G, Q // G, C),
                           query_pos=query_pos.reshape(B * G, Q // G, C))
        q = self.norm1(q.reshape(B, Q, C))
        q = self.cross_attn(q, memory, query_pos=query_pos,
                            reference_points=reference_points,
                            spatial_shapes=spatial_shapes)
        q = self.norm2(q)
        return self.norm3(self.ffn(q))


class RegBranch(nn.Module):
    """Per-layer box/point regression MLP, computed in f32."""

    def __init__(self, embed_dims: int, code_size: int):
        super().__init__()
        self.Dense_0 = Dense(embed_dims, embed_dims)
        self.Dense_1 = Dense(embed_dims, embed_dims)
        self.Dense_2 = Dense(embed_dims, code_size)

    def forward(self, x):
        x = F.relu(self.Dense_0(x))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x)


class DetectionTransformerDecoder(nn.Module):
    """Returns (states (Lyr, B, Q, C), refs (Lyr, B, Q, R), regs
    (Lyr, B, Q, code_size)): refs[l] is the refined reference after layer l
    and regs[l] layer l's regression output on states[l]."""

    def __init__(self, num_layers: int = 6, embed_dims: int = 256,
                 num_heads: int = 8, num_points: int = 4,
                 feedforward_channels: int = 512, self_attn_groups: int = 1,
                 dtype: torch.dtype = torch.float32, code_size: int = 10,
                 ref_mode: str = "det3d"):
        super().__init__()
        if ref_mode not in ("det3d", "map2d"):
            raise ValueError(ref_mode)
        self.ref_mode = ref_mode
        self.dtype = dtype
        self.layers = nn.ModuleList([
            DetrDecoderLayer(embed_dims, num_heads, num_points,
                             feedforward_channels, self_attn_groups, dtype)
            for _ in range(num_layers)
        ])
        self.reg_branches = nn.ModuleList([
            RegBranch(embed_dims, code_size) for _ in range(num_layers)
        ])

    def forward(self, query, memory, *, query_pos, reference_points,
                spatial_shapes: Shapes):
        out, ref = query.to(self.dtype), reference_points
        states, refs, regs = [], [], []
        for layer, reg_branch in zip(self.layers, self.reg_branches):
            out = layer(out, memory, query_pos=query_pos,
                        reference_points=ref[..., :2],
                        spatial_shapes=spatial_shapes)
            tmp = reg_branch(out)
            if self.ref_mode == "det3d":
                new_xy = tmp[..., 0:2] + inverse_sigmoid(ref[..., 0:2])
                new_z = tmp[..., 4:5] + inverse_sigmoid(ref[..., 2:3])
                ref = torch.sigmoid(torch.cat([new_xy, new_z], dim=-1)).detach()
            else:
                ref = torch.sigmoid(tmp[..., :2] + inverse_sigmoid(ref)).detach()
            states.append(out)
            refs.append(ref)
            regs.append(tmp)
        return torch.stack(states), torch.stack(refs), torch.stack(regs)
