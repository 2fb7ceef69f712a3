"""Attention modules of the BEV trunk and decoders.

Counterpart of the JAX package's models/attention.py (reference
temporal_self_attention.py, spatial_cross_attention.py, decoder.py). Every
deformable sampler goes through ``ops.msda.ms_deform_attn`` (or, for SCA
over several levels, ``ops.msda.ms_deform_attn_factored``): a CUDA kernel
on the GPU, its plain version on the CPU. Softmax logits, sampling locations
and the MSDA accumulator stay f32 whatever the activation ``dtype``.

Every module applies dropout (rate ``dropout``, 0.1 as configured) where
the JAX package does, in training mode only (``module.train()``; flax's
``deterministic=False``): on each attention's projected output, on the
decoder self-attention's probabilities and in the FFN.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.layers import Dense, Dropout, dropout_mask
from apollo_vision_net_tpu_torch.ops.msda import (
    materialize_factored,
    ms_deform_attn,
    ms_deform_attn_factored,
)
from apollo_vision_net_tpu_torch.utils.geometry import spatial_block_order

Shapes = Tuple[Tuple[int, int], ...]


def grid_offset_bias(num_heads: int, num_groups: int, num_points: int) -> np.ndarray:
    """mmcv's deformable-attention sampling_offsets bias init: 8 unit
    directions scaled by point index (temporal_self_attention.py:113-128)."""
    thetas = np.arange(num_heads, dtype=np.float64) * (2.0 * np.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)  # (H, 2)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_groups, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


def _normalizer(spatial_shapes: Shapes, device) -> torch.Tensor:
    """(L, 2) per-level (w, h), the (x, y) order of the locations."""
    return torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                        device=device)


class TemporalSelfAttention(nn.Module):
    """Deformable self-attention over the 2-slot BEV queue [prev, cur]:
    offsets and weights are predicted from concat[value_prev, query], the
    queue is folded into the batch for the sampler and averaged after."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 num_bev_queue: int = 2,
                 attn_logits_clamp: Optional[float] = None,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        assert num_bev_queue == 2
        C, H, L, P, NQ = embed_dims, num_heads, num_levels, num_points, num_bev_queue
        self.embed_dims, self.num_heads, self.num_levels = C, H, L
        self.num_points, self.num_bev_queue = P, NQ
        self.attn_logits_clamp = attn_logits_clamp
        self.dtype = dtype
        self.value_proj = Dense(C, C, dtype=dtype)
        self.sampling_offsets = Dense(2 * C, NQ * H * L * P * 2, dtype=dtype)
        self.attention_weights = Dense(2 * C, NQ * H * L * P, dtype=dtype)
        self.output_proj = Dense(C, C, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, query, value, *, query_pos, reference_points,
                spatial_shapes: Shapes, rows: Optional[slice] = None):
        """query (B, Q, C); value (B, 2, V, C) = [prev, cur];
        reference_points (B, 2, Q, L, 2) per-queue refs. The queries are
        the value's rows ``rows`` (all of them, V = Q, by default)."""
        dt = self.dtype
        query = query.to(dt)
        value = value.to(dt)
        B, Q, C = query.shape
        V = value.shape[2]
        H, L, P, NQ = self.num_heads, self.num_levels, self.num_points, self.num_bev_queue
        identity = query
        if query_pos is not None:
            query = query + query_pos.to(dt)
        prev = value[:, 0] if rows is None else value[:, 0, rows]
        q_in = torch.cat([prev, query], dim=-1)  # (B, Q, 2C)

        v = self.value_proj(value.reshape(B * NQ, V, C)).reshape(B * NQ, V, H, C // H)
        offsets = self.sampling_offsets(q_in).float().reshape(B, Q, H, NQ, L, P, 2)
        attn = self.attention_weights(q_in).reshape(B, Q, H, NQ, L * P)
        if self.attn_logits_clamp is not None:
            attn = attn.clamp(-self.attn_logits_clamp, self.attn_logits_clamp)
        attn = torch.softmax(attn.float(), dim=-1).reshape(B, Q, H, NQ, L, P)
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(B * NQ, Q, H, L, P, 2)
        attn = attn.permute(0, 3, 1, 2, 4, 5).reshape(B * NQ, Q, H, L, P)

        ref = reference_points.float().reshape(B * NQ, Q, L, 2)
        locations = (ref[:, :, None, :, None, :]
                     + offsets / _normalizer(spatial_shapes, ref.device)[:, None, :])
        out = ms_deform_attn(v.contiguous(), spatial_shapes, locations.contiguous(),
                             attn.contiguous())
        out = out.reshape(B, NQ, Q, C).mean(dim=1)
        return self.dropout(self.output_proj(out)) + identity


class MSDeformableAttention3D(nn.Module):
    """Inner sampler of SCA: no output projection; offsets spread over the
    pillar's z-anchors. ``query`` may have a smaller batch Bs than ``value``
    (B = Bs · N cameras, camera axis fast): offsets and weights come from the
    shared BEV query once. Over several levels the sampler takes them
    factored (``ms_deform_attn_factored``: on the GPU the per-camera
    locations are never materialized); over one level they are materialized
    per camera for ``ms_deform_attn``, as the JAX package dispatches."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 8,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C, H, L, P = embed_dims, num_heads, num_levels, num_points
        self.num_heads, self.num_levels, self.num_points = H, L, P
        self.dtype = dtype
        self.value_proj = Dense(C, C, dtype=dtype)
        self.sampling_offsets = Dense(C, H * L * P * 2, dtype=dtype)
        self.attention_weights = Dense(C, H * L * P, dtype=dtype)

    def forward(self, query, value, *, reference_points, spatial_shapes: Shapes,
                tile_mask: Optional[torch.Tensor] = None, q_tile: int = 32):
        """query (Bs, Q, C); value (B, V, C); reference_points
        (B, Q, D_z, 2) projected pillar points -> (B, Q, C)."""
        dt = self.dtype
        query = query.to(dt)
        value = value.to(dt)
        Bs, Q, C = query.shape
        H, L, P = self.num_heads, self.num_levels, self.num_points
        B, V = value.shape[0], value.shape[1]
        v = self.value_proj(value).reshape(B, V, H, C // H)
        # raw-cell offsets; the 1/wh normalization happens when materializing
        offsets = self.sampling_offsets(query).float()  # (Bs, Q, H·L·P·2)
        attn = self.attention_weights(query).reshape(Bs, Q, H, L * P)
        attn = torch.softmax(attn.float(), dim=-1).reshape(Bs, Q, H * L * P)
        D_z = reference_points.shape[2]
        assert P % D_z == 0, (P, D_z)
        ref_flat = reference_points.float().reshape(B, Q, D_z * 2).repeat(1, 1, P // D_z)
        if L > 1:
            return ms_deform_attn_factored(
                v.contiguous(), spatial_shapes, ref_flat.contiguous(),
                offsets.contiguous(), attn.contiguous(),
                tile_mask=tile_mask, q_tile=q_tile)
        loc, attn = materialize_factored(ref_flat, offsets, attn, spatial_shapes, H, P)
        return ms_deform_attn(
            v.contiguous(), spatial_shapes,
            loc.reshape(B, Q, H, L, P, 2).contiguous(),
            attn.reshape(B, Q, H, L, P).contiguous(),
            tile_mask=tile_mask, q_tile=q_tile)


class SpatialCrossAttention(nn.Module):
    """Image→BEV cross attention, dense-masked over cameras.

    With ``bev_hw`` set, queries are reordered into 8×(q_tile/8) spatial
    blocks and a per-(camera, query-tile) visibility mask lets the kernel
    skip tiles no pillar of which projects into the camera. Outputs are
    masked by pillar visibility and normalized by the hit count. ``q_tile``
    defaults to the JAX package's choice, 128 over several levels and 32
    over one; it only changes which tiles are skipped, not the result."""

    def __init__(self, embed_dims: int = 256, num_cams: int = 6,
                 num_heads: int = 8, num_levels: int = 1, num_points: int = 8,
                 bev_hw: Optional[Tuple[int, int]] = None,
                 q_tile: Optional[int] = None, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_cams = num_cams
        self.bev_hw = bev_hw
        self.q_tile = q_tile or (128 if num_levels > 1 else 32)
        self.dtype = dtype
        self.deformable_attention = MSDeformableAttention3D(
            embed_dims, num_heads, num_levels, num_points, dtype=dtype)
        self.output_proj = Dense(embed_dims, embed_dims, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, query, value, *, query_pos, reference_points_cam,
                bev_mask, spatial_shapes: Shapes,
                bev_hw: Optional[Tuple[int, int]] = None):
        """query (B, Q, C); value (B, N_cam, V, C); reference_points_cam
        (N_cam, B, Q, D_z, 2); bev_mask (N_cam, B, Q, D_z) bool. ``bev_hw``
        is the grid of the queries where it is not the module's (a band of
        BEV rows under the BEV partition): the tiles are built for it."""
        dt = self.dtype
        query = query.to(dt)
        value = value.to(dt)
        B, Q, C = query.shape
        N = self.num_cams
        identity = query
        if query_pos is not None:
            query = query + query_pos.to(dt)
        ref_cam = reference_points_cam
        hit = bev_mask.any(dim=-1)  # (N, B, Q)
        qt = self.q_tile
        inv_perm = tile_mask = None
        bev_hw = bev_hw or self.bev_hw
        if bev_hw is not None:
            perm, inv = spatial_block_order(*bev_hw, 8, max(1, qt // 8))
            perm = torch.as_tensor(perm, dtype=torch.int64, device=query.device)
            inv_perm = torch.as_tensor(inv, dtype=torch.int64, device=query.device)
            query = query[:, perm]
            ref_cam = ref_cam[:, :, perm]
            hit = hit[:, :, perm]
            Qp = (Q + qt - 1) // qt * qt
            hit_pad = F.pad(hit.transpose(0, 1).reshape(B * N, Q), (0, Qp - Q))
            tile_mask = hit_pad.reshape(B * N, Qp // qt, qt).any(-1).to(torch.int32)

        v_cam = value.reshape(B * N, value.shape[2], C)
        ref = ref_cam.transpose(0, 1).reshape(B * N, Q, ref_cam.shape[3], 2)
        out = self.deformable_attention(
            query, v_cam, reference_points=ref, spatial_shapes=spatial_shapes,
            tile_mask=tile_mask, q_tile=qt)
        out = out.reshape(B, N, Q, C)
        hitf = hit.transpose(0, 1).to(out.dtype)  # (B, N, Q)
        out = (out * hitf[..., None]).sum(dim=1)
        count = hitf.sum(dim=1).clamp(min=1.0)
        out = out / count[..., None]
        if inv_perm is not None:
            out = out[:, inv_perm]
        return self.dropout(self.output_proj(out)) + identity


class CustomMSDeformableAttention(nn.Module):
    """Single-source deformable attention (det/map decoder cross-attention
    over the BEV memory)."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        C, H, L, P = embed_dims, num_heads, num_levels, num_points
        self.num_heads, self.num_levels, self.num_points = H, L, P
        self.dtype = dtype
        self.value_proj = Dense(C, C, dtype=dtype)
        self.sampling_offsets = Dense(C, H * L * P * 2, dtype=dtype)
        self.attention_weights = Dense(C, H * L * P, dtype=dtype)
        self.output_proj = Dense(C, C, dtype=dtype)
        self.dropout = Dropout(dropout)

    def forward(self, query, value, *, query_pos, reference_points,
                spatial_shapes: Shapes):
        """query (B, Q, C); value (B, V, C); reference_points (B, Q, 2)."""
        dt = self.dtype
        query = query.to(dt)
        value = value.to(dt)
        B, Q, C = query.shape
        H, L, P = self.num_heads, self.num_levels, self.num_points
        V = value.shape[1]
        identity = query
        if query_pos is not None:
            query = query + query_pos.to(dt)
        v = self.value_proj(value).reshape(B, V, H, C // H)
        offsets = self.sampling_offsets(query).float().reshape(B, Q, H, L, P, 2)
        attn = self.attention_weights(query).reshape(B, Q, H, L * P)
        attn = torch.softmax(attn.float(), dim=-1).reshape(B, Q, H, L, P)
        locations = (reference_points.float()[:, :, None, None, None, :]
                     + offsets / _normalizer(spatial_shapes, offsets.device)[:, None, :])
        out = ms_deform_attn(v.contiguous(), spatial_shapes, locations.contiguous(),
                             attn.contiguous())
        return self.dropout(self.output_proj(out)) + identity


class _MHAProjections(nn.Module):
    """flax MultiHeadDotProductAttention's four projections, flattened to
    (H·D) features: query/key/value C -> H·D, out H·D -> C."""

    def __init__(self, embed_dims: int, dtype: torch.dtype):
        super().__init__()
        self.query = Dense(embed_dims, embed_dims, dtype=dtype)
        self.key = Dense(embed_dims, embed_dims, dtype=dtype)
        self.value = Dense(embed_dims, embed_dims, dtype=dtype)
        self.out = Dense(embed_dims, embed_dims, dtype=dtype)


class MultiheadAttention(nn.Module):
    """Decoder self-attention with residual, computed as flax does: keys
    from query + pos, values from the query without pos, the query scaled by
    1/sqrt(D) before the product; softmax in f32. ``attn_mask`` is flax's
    boolean keep-mask, (Lq, Lk) broadcast over the batch and the heads: a
    masked logit becomes finfo(f32).min before the softmax. In training mode
    the probabilities take flax's broadcast dropout (one (Lq, Lk) mask
    shared by the batch and the heads) and the output a dropout of its
    own."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.rate = dropout
        self.attn = _MHAProjections(embed_dims, dtype)
        self.dropout = Dropout(dropout)

    def forward(self, query, *, query_pos=None,
                attn_mask: Optional[torch.Tensor] = None):
        dt = self.dtype
        query = query.to(dt)
        identity = query
        q = query + query_pos.to(dt) if query_pos is not None else query
        B, Lq, C = q.shape
        H = self.num_heads
        D = C // H
        qh = self.attn.query(q).reshape(B, Lq, H, D) / math.sqrt(D)
        kh = self.attn.key(q).reshape(B, Lq, H, D)
        vh = self.attn.value(query).reshape(B, Lq, H, D)
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh).float()
        if attn_mask is not None:
            logits = logits.masked_fill(~attn_mask,
                                        torch.finfo(torch.float32).min)
        w = torch.softmax(logits, dim=-1).to(dt)
        if self.training and self.rate > 0.0:
            keep_prob = 1.0 - self.rate
            keep = dropout_mask((Lq, Lq), keep_prob, w.device)
            w = w * (keep.to(dt) / keep_prob)
        out = torch.einsum("bhqk,bkhd->bqhd", w, vh).reshape(B, Lq, C)
        return self.dropout(self.attn.out(out)) + identity


class FFN(nn.Module):
    """mmcv FFN: Dense -> ReLU -> Dropout -> Dense -> Dropout + residual
    (the dropouts act in training mode only)."""

    def __init__(self, embed_dims: int = 256, feedforward_channels: int = 512,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = Dense(embed_dims, feedforward_channels, dtype=dtype)
        self.Dense_1 = Dense(feedforward_channels, embed_dims, dtype=dtype)
        self.Dropout_0 = Dropout(dropout)
        self.Dropout_1 = Dropout(dropout)

    def forward(self, x):
        x = x.to(self.dtype)
        y = self.Dropout_0(F.relu(self.Dense_0(x)))
        return self.Dropout_1(self.Dense_1(y)) + x
