"""BEVFormer encoder: TSA -> LN -> SCA -> LN -> FFN -> LN per layer.

Counterpart of the JAX package's models/encoder.py (reference
bevformer/modules/encoder.py:25-518). A ``has_prev`` flag in {0, 1} blends
the no-history behaviour (both queue slots = the current query, zero
shift) with the history one, and ``shift_current_refs`` reproduces the
reference's shift aliasing of the current stream's reference points.
Submodule names follow the flax tree (see bridge.py).

With ``partition`` (a config's ``bev_partition``) under a mesh with sp > 1
(``parallel.mesh.use_mesh``), the BEV partition: sp rank j computes the
query rows ``[j·Q/sp, (j+1)·Q/sp)`` of every layer (TSA's queries, SCA with
its tiles built for that band of BEV rows, the FFN), and the layer's whole
BEV, which the next layer's TSA reads as its value and the decoders read
after the last, is all-gathered over sp (``parallel.collectives``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from apollo_vision_net_tpu_torch.models.attention import (
    FFN,
    SpatialCrossAttention,
    TemporalSelfAttention,
)
from apollo_vision_net_tpu_torch.models.layers import LayerNorm, bev_rows
from apollo_vision_net_tpu_torch.parallel.collectives import all_gather
from apollo_vision_net_tpu_torch.parallel.mesh import current_mesh

Shapes = Tuple[Tuple[int, int], ...]


class BEVFormerLayer(nn.Module):
    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points_sca: int = 8,
                 num_points_tsa: int = 4, num_cams: int = 6,
                 feedforward_channels: int = 512,
                 attn_logits_clamp: Optional[float] = None,
                 bev_hw: Optional[Tuple[int, int]] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = embed_dims
        self.tsa = TemporalSelfAttention(
            C, num_heads, 1, num_points_tsa,
            attn_logits_clamp=attn_logits_clamp, dtype=dtype)
        self.norm1 = LayerNorm(C, dtype=dtype)
        self.sca = SpatialCrossAttention(
            C, num_cams, num_heads, num_levels, num_points_sca,
            bev_hw=bev_hw, dtype=dtype)
        self.norm2 = LayerNorm(C, dtype=dtype)
        self.ffn = FFN(C, feedforward_channels, dtype=dtype)
        self.norm3 = LayerNorm(C, dtype=dtype)

    def forward(self, bev_query, img_value, *, bev_pos, tsa_value, tsa_refs,
                bev_spatial_shapes: Shapes, img_spatial_shapes: Shapes,
                reference_points_cam, bev_mask, rows: Optional[slice] = None,
                bev_hw: Optional[Tuple[int, int]] = None):
        """The queries are ``tsa_value``'s rows ``rows`` (all by default),
        a grid of ``bev_hw`` (SCA's own by default)."""
        q = self.tsa(bev_query, tsa_value, query_pos=bev_pos,
                     reference_points=tsa_refs,
                     spatial_shapes=bev_spatial_shapes, rows=rows)
        q = self.norm1(q)
        # the reference's SCA receives query_pos=None
        q = self.sca(q, img_value, query_pos=None,
                     reference_points_cam=reference_points_cam,
                     bev_mask=bev_mask, spatial_shapes=img_spatial_shapes,
                     bev_hw=bev_hw)
        q = self.norm2(q)
        return self.norm3(self.ffn(q))


class BEVFormerEncoder(nn.Module):
    def __init__(self, num_layers: int = 3, embed_dims: int = 256,
                 num_heads: int = 8, num_levels: int = 1,
                 num_points_sca: int = 8, num_points_tsa: int = 4,
                 num_cams: int = 6, feedforward_channels: int = 512,
                 attn_logits_clamp: Optional[float] = None,
                 shift_current_refs: bool = True,
                 bev_hw: Optional[Tuple[int, int]] = None,
                 partition: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.shift_current_refs = shift_current_refs
        self.partition = partition
        self.dtype = dtype
        self.layers = nn.ModuleList([
            BEVFormerLayer(embed_dims, num_heads, num_levels, num_points_sca,
                           num_points_tsa, num_cams, feedforward_channels,
                           attn_logits_clamp, bev_hw, dtype)
            for _ in range(num_layers)
        ])

    def forward(self, bev_query, img_value, *, bev_pos, prev_bev, has_prev,
                shift, ref_2d, bev_h: int, bev_w: int,
                img_spatial_shapes: Shapes, reference_points_cam, bev_mask):
        """bev_query/bev_pos/prev_bev (B, Q, C); img_value (B, N, V, C);
        has_prev (B,); shift (B, 2); ref_2d (Q, 2)."""
        dt = self.dtype
        bev_query = bev_query.to(dt)
        bev_pos = bev_pos.to(dt)
        prev_bev = prev_bev.to(dt)
        img_value = img_value.to(dt)
        B, Q, C = bev_query.shape
        hp = has_prev[:, None, None].to(dt)
        # frame-0 parity: value slots both = current query, shift = 0
        shift = shift * has_prev[:, None]
        # reference points stay f32 (bf16 quantizes them by ~0.4 cell)
        ref = ref_2d.float()[None].expand(B, Q, 2)
        ref_shifted = ref + shift.float()[:, None, :]
        ref_cur = ref_shifted if self.shift_current_refs else ref
        tsa_refs = torch.stack([ref_shifted, ref_cur], dim=1)[:, :, :, None, :]

        mesh = current_mesh()
        split = self.partition and mesh is not None and mesh.sp > 1
        band = dict(bev_pos=bev_pos, tsa_refs=tsa_refs,
                    reference_points_cam=reference_points_cam, bev_mask=bev_mask)
        if split:
            assert bev_h % mesh.sp == 0, (bev_h, mesh.sp)
            n = Q // mesh.sp
            rows = slice(mesh.sp_index * n, (mesh.sp_index + 1) * n)
            band = dict(bev_pos=bev_pos[:, rows], tsa_refs=tsa_refs[:, :, rows],
                        reference_points_cam=reference_points_cam[:, :, rows],
                        bev_mask=bev_mask[:, :, rows], rows=rows,
                        bev_hw=(bev_h // mesh.sp, bev_w))
        q = bev_query
        for layer in self.layers:
            value_prev = hp * prev_bev + (1.0 - hp) * q
            value_cur = hp * bev_query + (1.0 - hp) * q
            kw = dict(tsa_value=torch.stack([value_prev, value_cur], dim=1),
                      bev_spatial_shapes=((bev_h, bev_w),),
                      img_spatial_shapes=img_spatial_shapes, **band)
            if split:
                with bev_rows(rows.start, Q):
                    q = layer(q[:, rows], img_value, **kw)
                q = all_gather(mesh, q, dim=1, axis="sp")
            else:
                q = layer(q, img_value, **kw)
        return q
