"""VoxelFormer: voxel-query encoder and its det+occupancy head.

Counterpart of the JAX package's models/voxel.py (reference
bevformer/modules/voxel_encoder.py, voxel_temporal_self_attention.py,
voxel_positional_embedding.py, voxel_transformer.py and
dense_heads/voxelformer_occupancy_head.py): bev_z x bev_h x bev_w voxel
queries, flat in (z, y, x) order with x minor, run TSA over the 2-slot voxel
queue (trilinear deformable attention, ``ops.msda3d``) -> LN -> SCA into
the cameras (one projected point a voxel) -> LN -> FFN -> LN per layer;
``voxel2bev`` collapses each pillar's z·C features into the BEV memory of
the det decoder, and the occupancy MLP classifies the voxel features,
resized trilinearly to the occupancy grid.

The whole head computes in f32 whatever the config's dtype, as the JAX
package builds these modules without a dtype (only the conv trunk follows
``compute_dtype``). Submodules keep the flax names (``encoder_layer{i}``,
``voxel_pos``, ``voxel2bev``, ``occ_proj``; see bridge.py).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.attention import (
    FFN,
    SpatialCrossAttention,
    grid_offset_bias,
)
from apollo_vision_net_tpu_torch.models.decoder import DetectionTransformerDecoder
from apollo_vision_net_tpu_torch.models.heads.det_head import ClsBranch, decode_layers
from apollo_vision_net_tpu_torch.models.heads.occ_head import OccMLPBranch
from apollo_vision_net_tpu_torch.models.layers import Dense, Dropout, LayerNorm
from apollo_vision_net_tpu_torch.ops.grid_sample import rotate_2d
from apollo_vision_net_tpu_torch.ops.msda3d import ms_deform_attn_3d
from apollo_vision_net_tpu_torch.utils import geometry
from apollo_vision_net_tpu_torch.utils.geometry import bev_shift_from_can_bus

F32 = torch.float32


def voxel_reference_points_3d(bev_z: int, bev_h: int, bev_w: int,
                              num_points_in_voxel: int = 1) -> np.ndarray:
    """(num_points_in_voxel, z·h·w, 3) normalized (x, y, z) sample points
    per voxel: the centres, or points spread inside the voxel along its
    diagonal (voxel_encoder.py:60-91)."""
    zs = (np.arange(bev_z) + 0.5) / bev_z
    ys = (np.arange(bev_h) + 0.5) / bev_h
    xs = (np.arange(bev_w) + 0.5) / bev_w
    zz, yy, xx = np.meshgrid(zs, ys, xs, indexing="ij")
    centers = np.stack([xx, yy, zz], -1).reshape(1, -1, 3)
    if num_points_in_voxel <= 1:
        return centers.astype(np.float32)
    n = num_points_in_voxel
    dz, dy, dx = 0.5 / bev_z, 0.5 / bev_h, 0.5 / bev_w
    off = np.stack([
        np.linspace(-dx, dx, n + 2)[1:-1],
        np.linspace(-dy, dy, n + 2)[1:-1],
        np.linspace(-dz, dz, n + 2)[1:-1],
    ], -1).reshape(n, 1, 3)
    return (centers + off).astype(np.float32)


def rotate_slices(vol: torch.Tensor, angles: torch.Tensor, z: int, h: int,
                  w: int) -> torch.Tensor:
    """Rotate every z-slice of (B, z·h·w, C) voxel tokens about the grid's
    centre by its sample's angle (B,) in degrees (``rotate_2d``)."""
    B, Q, C = vol.shape
    out = rotate_2d(vol.reshape(B * z, h, w, C), angles.repeat_interleave(z))
    return out.reshape(B, Q, C)


def camera_geometry(z: int, h: int, w: int, num_points_in_voxel: int,
                    pc_range, lidar2img: torch.Tensor, img_shape):
    """Each voxel's points projected into the cameras, cameras leading:
    reference_points_cam (N, B, Q, n, 2) and bev_mask (N, B, Q, n)."""
    ref_3d = torch.as_tensor(voxel_reference_points_3d(
        z, h, w, num_points_in_voxel), device=lidar2img.device)
    ref_cam, mask = geometry.point_sampling(ref_3d, pc_range, lidar2img, img_shape)
    return ref_cam.transpose(0, 1), mask.transpose(0, 1)


def flatten_levels(mlvl_feats: Sequence[torch.Tensor]):
    """(B, N, h, w, C) per level -> (B, N, Σ h·w, C) and the level shapes."""
    flat = [f.reshape(f.shape[0], f.shape[1], -1, f.shape[-1]) for f in mlvl_feats]
    return torch.cat(flat, dim=2), tuple((f.shape[2], f.shape[3]) for f in mlvl_feats)


def resize_voxels(vol: torch.Tensor, src: Tuple[int, int, int],
                  dst: Tuple[int, int, int]) -> torch.Tensor:
    """(B, z·y·x, C) voxel features on grid ``src`` -> on grid ``dst``,
    trilinear with half-pixel centres and the edge voxels held (as
    ``jax.image.resize`` upsamples: samples outside the grid fall back on
    the nearest row)."""
    if tuple(src) == tuple(dst):
        return vol
    B, _, C = vol.shape
    g = vol.reshape(B, *src, C).permute(0, 4, 1, 2, 3)
    g = F.interpolate(g, size=tuple(dst), mode="trilinear", align_corners=False)
    return g.permute(0, 2, 3, 4, 1).reshape(B, -1, C)


class VoxelTemporalSelfAttention(nn.Module):
    """Trilinear deformable self-attention over the 2-slot voxel queue
    [prev, cur]: offsets (x, y, z) and weights from concat[value_prev,
    query], softmax per queue slot over L·P, the slots averaged."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points: int = 4,
                 dropout: float = 0.1):
        super().__init__()
        C, H, L, P, NQ = embed_dims, num_heads, num_levels, num_points, 2
        self.num_heads, self.num_levels, self.num_points = H, L, P
        self.num_bev_queue = NQ
        self.value_proj = Dense(C, C, dtype=F32)
        self.sampling_offsets = Dense(2 * C, NQ * H * L * P * 3, dtype=F32)
        self.attention_weights = Dense(2 * C, NQ * H * L * P, dtype=F32)
        self.output_proj = Dense(C, C, dtype=F32)
        self.dropout = Dropout(dropout)

    def offset_bias(self) -> np.ndarray:
        """The sampling-offset bias init: the 2-D grid bias with z = 0."""
        H, G, P = self.num_heads, self.num_levels * self.num_bev_queue, self.num_points
        grid2d = grid_offset_bias(H, G, P).reshape(H, G, P, 2)
        return np.concatenate([grid2d, np.zeros((H, G, P, 1), np.float32)],
                              -1).reshape(-1)

    def forward(self, query, value, *, query_pos, reference_points,
                spatial_shape: Tuple[int, int, int]):
        """query (B, Q, C) with Q = z·h·w; value (B, 2, Q, C);
        reference_points (B, 2, Q, L, 3); spatial_shape (z, h, w)."""
        query, value = query.float(), value.float()
        B, Q, C = query.shape
        H, L, P, NQ = self.num_heads, self.num_levels, self.num_points, self.num_bev_queue
        identity = query
        if query_pos is not None:
            query = query + query_pos.float()
        q_in = torch.cat([value[:, 0], query], dim=-1)
        v = self.value_proj(value.reshape(B * NQ, Q, C)).reshape(B * NQ, Q, H, C // H)
        offsets = self.sampling_offsets(q_in).reshape(B, Q, H, NQ, L, P, 3)
        attn = self.attention_weights(q_in).reshape(B, Q, H, NQ, L * P)
        attn = torch.softmax(attn, dim=-1).reshape(B, Q, H, NQ, L, P)
        offsets = offsets.permute(0, 3, 1, 2, 4, 5, 6).reshape(B * NQ, Q, H, L, P, 3)
        attn = attn.permute(0, 3, 1, 2, 4, 5).reshape(B * NQ, Q, H, L, P)
        d, h, w = spatial_shape
        offsets = torch.stack([offsets[..., 0] / w, offsets[..., 1] / h,
                               offsets[..., 2] / d], dim=-1)
        ref = reference_points.float().reshape(B * NQ, Q, L, 3)
        locations = ref[:, :, None, :, None, :] + offsets
        out = ms_deform_attn_3d(v, (spatial_shape,), locations, attn)
        out = out.reshape(B, NQ, Q, C).mean(dim=1)
        return self.dropout(self.output_proj(out)) + identity


class VoxelFormerLayer(nn.Module):
    """TSA -> LN -> SCA (one projected point a voxel, 8 samples, dense over
    the cameras: no tile order) -> LN -> FFN -> LN, in f32."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8,
                 num_levels: int = 1, num_points_sca: int = 8,
                 num_points_tsa: int = 4, num_cams: int = 6,
                 feedforward_channels: int = 512):
        super().__init__()
        C = embed_dims
        self.tsa = VoxelTemporalSelfAttention(C, num_heads, 1, num_points_tsa)
        self.norm1 = LayerNorm(C)
        self.sca = SpatialCrossAttention(C, num_cams, num_heads, num_levels,
                                         num_points_sca, dtype=F32)
        self.norm2 = LayerNorm(C)
        self.ffn = FFN(C, feedforward_channels, dtype=F32)
        self.norm3 = LayerNorm(C)

    def forward(self, q, img_value, *, query_pos, tsa_value, tsa_refs,
                spatial_shape, img_spatial_shapes, reference_points_cam,
                bev_mask):
        q = self.tsa(q, tsa_value, query_pos=query_pos,
                     reference_points=tsa_refs, spatial_shape=spatial_shape)
        q = self.norm1(q)
        q = self.sca(q, img_value, query_pos=None,
                     reference_points_cam=reference_points_cam,
                     bev_mask=bev_mask, spatial_shapes=img_spatial_shapes)
        q = self.norm2(q)
        return self.norm3(self.ffn(q))


class VoxelLearnedPositionalEncoding(nn.Module):
    """Learned z/row/col tables -> (z·h·w, C), features concatenated in
    (col, row, z) order (voxel_positional_embedding.py:11-60)."""

    def __init__(self, num_feats: Tuple[int, int, int], z_num: int,
                 row_num: int, col_num: int):
        super().__init__()
        fz, fr, fc = num_feats
        self.z_embed = nn.Parameter(torch.empty(z_num, fz))
        self.row_embed = nn.Parameter(torch.empty(row_num, fr))
        self.col_embed = nn.Parameter(torch.empty(col_num, fc))

    @staticmethod
    def feats(embed_dims: int) -> Tuple[int, int, int]:
        """(z, row, col) widths summing to embed_dims."""
        return (embed_dims - 2 * (embed_dims // 3), embed_dims // 3,
                embed_dims // 3)

    def forward(self) -> torch.Tensor:
        Z, H, W = (self.z_embed.shape[0], self.row_embed.shape[0],
                   self.col_embed.shape[0])
        pos = torch.cat([
            self.col_embed[None, None].expand(Z, H, W, -1),
            self.row_embed[None, :, None].expand(Z, H, W, -1),
            self.z_embed[:, None, None].expand(Z, H, W, -1),
        ], dim=-1)
        return pos.reshape(Z * H * W, -1)


class VoxelDetOccHead(nn.Module):
    """What the voxel and hybrid heads share: the object queries, the det
    decoder over the BEV memory that ``voxel2bev`` collapses from the last
    voxel volume, the per-layer classification branches, the can_bus MLP
    and the occupancy MLP over the voxel features resized to the occupancy
    grid. The BEV grid is bev_h x bev_w; ``can_bus_dims`` is the width the
    can_bus MLP adds to the first queries."""

    def __init__(self, *, bev_h: int, bev_w: int, num_query: int,
                 num_classes: int, embed_dims: int, code_size: int,
                 pc_range: Sequence[float], img_shape: Tuple[int, int],
                 num_cams: int, num_feature_levels: int, decoder_layers: int,
                 feedforward_channels: int, rotate_prev_bev: bool,
                 use_shift: bool, use_can_bus: bool, shift_current_refs: bool,
                 can_bus_dims: int, pillar_dims: int, occupancy_classes: int,
                 occ_xdim: int, occ_ydim: int, occ_zdim: int, occ_dims: int,
                 occ_in_dims: int, num_points_in_voxel: int = 1,
                 num_occ_fcs: int = 2):
        super().__init__()
        self.bev_h, self.bev_w = bev_h, bev_w
        self.embed_dims = embed_dims
        self.pc_range, self.img_shape = tuple(pc_range), tuple(img_shape)
        self.num_cams, self.num_feature_levels = num_cams, num_feature_levels
        self.rotate_prev_bev, self.use_shift = rotate_prev_bev, use_shift
        self.use_can_bus, self.shift_current_refs = use_can_bus, shift_current_refs
        self.num_points_in_voxel = num_points_in_voxel
        self.occ_xdim, self.occ_ydim, self.occ_zdim = occ_xdim, occ_ydim, occ_zdim
        self.query_embedding = nn.Parameter(torch.empty(num_query, 2 * embed_dims))
        self.voxel2bev = Dense(pillar_dims, embed_dims)
        self.decoder = DetectionTransformerDecoder(
            decoder_layers, embed_dims, feedforward_channels=feedforward_channels,
            dtype=F32, code_size=code_size, ref_mode="det3d")
        self.reference_points_fc = Dense(embed_dims, 3)
        self.cls_branches = nn.ModuleList([
            ClsBranch(embed_dims, num_classes) for _ in range(decoder_layers)])
        self.occ_branches = OccMLPBranch(occ_dims, occupancy_classes, num_occ_fcs,
                                         in_dims=occ_in_dims)
        if use_can_bus:
            self.can_bus_fc1 = Dense(18, can_bus_dims // 2)
            self.can_bus_fc2 = Dense(can_bus_dims // 2, can_bus_dims)
            self.can_bus_ln = LayerNorm(can_bus_dims)

    @property
    def real_hw(self) -> Tuple[float, float]:
        pc = self.pc_range
        return (pc[4] - pc[1], pc[3] - pc[0])

    def _shift(self, can_bus, has_prev) -> torch.Tensor:
        """The ego-motion shift of the BEV grid (B, 2), zero without
        history."""
        h, w = self.bev_h, self.bev_w
        grid_length = (self.real_hw[0] / h, self.real_hw[1] / w)
        return bev_shift_from_can_bus(can_bus, grid_length, h, w,
                                      self.use_shift) * has_prev[:, None]

    def _add_can_bus(self, queries, can_bus):
        if not self.use_can_bus:
            return queries
        cb = F.relu(self.can_bus_fc1(can_bus))
        cb = self.can_bus_ln(F.relu(self.can_bus_fc2(cb)))
        return queries + cb[:, None, :]

    def _outputs(self, carry, volume, z: int) -> dict:
        """Det decoder on voxel2bev of ``volume`` (B, z·h·w, c), occupancy
        logits of it resized to the occupancy grid; ``carry`` is the
        temporal state returned as ``bev_embed``."""
        B, _, c = volume.shape
        hw = self.bev_h * self.bev_w
        C = self.embed_dims
        memory = self.voxel2bev(volume.reshape(B, z, hw, c).transpose(1, 2)
                                .reshape(B, hw, z * c))
        query_pos = self.query_embedding[:, :C][None].expand(B, -1, C)
        query = self.query_embedding[:, C:][None].expand(B, -1, C)
        init_ref = torch.sigmoid(self.reference_points_fc(query_pos))
        hs, inter_refs, inter_regs = self.decoder(
            query, memory, query_pos=query_pos, reference_points=init_ref,
            spatial_shapes=((self.bev_h, self.bev_w),))
        return {"bev_embed": carry,
                **decode_layers(hs, init_ref, inter_refs, inter_regs,
                                self.cls_branches, self.pc_range),
                "occupancy_preds": self.occ_branches(self._occ_features(volume, z))}

    def _occ_features(self, volume, z: int) -> torch.Tensor:
        return resize_voxels(volume, (z, self.bev_h, self.bev_w),
                             (self.occ_zdim, self.occ_ydim, self.occ_xdim))


class VoxelFormerOccupancyHead(VoxelDetOccHead):
    """det + occupancy over bev_z x bev_h x bev_w voxel queries; the
    temporal carry is the voxel features (B, z·h·w, C). It ignores
    ``bev_partition``, as the JAX package's head does: under a mesh with
    sp > 1 every rank of an sp group runs it unsplit."""

    def __init__(self, *, bev_z: int = 4, encoder_layers: int = 3,
                 embed_dims: int = 256, occ_dims: int = 64, **kwargs):
        super().__init__(embed_dims=embed_dims, can_bus_dims=embed_dims,
                         pillar_dims=bev_z * embed_dims, occ_dims=occ_dims,
                         occ_in_dims=occ_dims, **kwargs)
        self.bev_z = bev_z
        C = embed_dims
        self.voxel_pos = VoxelLearnedPositionalEncoding(
            VoxelLearnedPositionalEncoding.feats(C), bev_z, self.bev_h, self.bev_w)
        self.voxel_embedding = nn.Parameter(
            torch.empty(bev_z * self.bev_h * self.bev_w, C))
        for i in range(encoder_layers):
            self.add_module(f"encoder_layer{i}", VoxelFormerLayer(
                C, num_levels=self.num_feature_levels, num_cams=self.num_cams,
                feedforward_channels=kwargs["feedforward_channels"]))
        self.encoder_layers = encoder_layers
        self.occ_proj = Dense(C, occ_dims)

    @property
    def prev_tokens(self) -> int:
        return self.bev_z * self.bev_h * self.bev_w

    def _encode(self, mlvl_feats, can_bus, lidar2img, prev_bev, has_prev):
        B = mlvl_feats[0].shape[0]
        Z, h, w, C = self.bev_z, self.bev_h, self.bev_w, self.embed_dims
        Q = Z * h * w
        dev = prev_bev.device
        queries = self.voxel_embedding[None].expand(B, Q, C)
        pos = self.voxel_pos()[None].expand(B, Q, C)
        shift = self._shift(can_bus, has_prev)
        prev_bev = prev_bev.float()
        if self.rotate_prev_bev:
            prev_bev = rotate_slices(prev_bev, can_bus[:, -1] * has_prev, Z, h, w)
        queries = self._add_can_bus(queries, can_bus)
        ref_cam, bev_mask = camera_geometry(Z, h, w, self.num_points_in_voxel,
                                            self.pc_range, lidar2img, self.img_shape)
        # TSA refs: the voxel centres, shifted on x and y (the current
        # slot too with shift_current_refs, the reference's aliasing)
        ref = torch.as_tensor(voxel_reference_points_3d(Z, h, w)[0],
                              device=dev)[None].expand(B, Q, 3)
        shift3d = F.pad(shift.float(), (0, 1))
        ref_shifted = ref + shift3d[:, None, :]
        ref_cur = ref_shifted if self.shift_current_refs else ref
        tsa_refs = torch.stack([ref_shifted, ref_cur], dim=1)[:, :, :, None, :]
        img_value, img_shapes = flatten_levels(mlvl_feats)
        hp = has_prev[:, None, None].float()
        q = queries
        for i in range(self.encoder_layers):
            value_prev = hp * prev_bev + (1.0 - hp) * q
            value_cur = hp * queries + (1.0 - hp) * q
            q = getattr(self, f"encoder_layer{i}")(
                q, img_value, query_pos=pos,
                tsa_value=torch.stack([value_prev, value_cur], dim=1),
                tsa_refs=tsa_refs, spatial_shape=(Z, h, w),
                img_spatial_shapes=img_shapes, reference_points_cam=ref_cam,
                bev_mask=bev_mask)
        return q

    def forward(self, mlvl_feats, *, can_bus, lidar2img, prev_bev, has_prev,
                only_bev: bool = False):
        """mlvl_feats [(B, N, h, w, C)]; prev_bev (B, z·h·w, C) -> the voxel
        features alone with ``only_bev``, else the det outputs, the
        occupancy logits (B, occ voxels, classes) and the voxel features as
        ``bev_embed``."""
        vox = self._encode(mlvl_feats, can_bus, lidar2img, prev_bev, has_prev)
        if only_bev:
            return vox
        return self._outputs(vox, vox, self.bev_z)

    def _occ_features(self, volume, z: int) -> torch.Tensor:
        return super()._occ_features(self.occ_proj(volume), z)
