"""det + occupancy head (BEVFormerOccupancyHead family).

Counterpart of the JAX package's models/heads/occ_head.py (reference
bevformer_occupancy_head.py:182-216, bevformer_occupancy_head_apollo.py
:36-160): the det head (Group-DETR when ``group_detr`` > 1), then the BEV
lifted into voxels and classified per voxel at the last decoder layer:
- ``occ_head_type="cnn"`` (Apollo): ``CNNUpsample`` from the bev_h×bev_w
  grid to occ_y×occ_x with occ_zdim·occ_dims channels;
- ``occ_head_type="mlp"``: a per-token Dense to occ_zdim·occ_dims on a grid
  equal to the BEV grid;
- ``occ_tsa`` (Apollo, occupancy_head_apollo.py:68-144): the CNN upsamples
  to embed_dims channels, a ``BEVFormerLayer`` refines the occ_y×occ_x
  tokens against the current frame's images (TSA over the tokens, SCA at
  occupancy resolution) and ``occ_tsa_head`` projects each to
  occ_zdim·occ_dims;
- ``predict_flow``: a per-voxel flow branch (``flow_branches``);
- ``with_occupancy_flow`` (bevformer_occupancy_head.py:218-301): with the
  queue's history BEVs (``prev_bevs``) every queue frame is lifted, and the
  voxel volumes are warped along learned flows across the queue and fused
  (``occupancy_aggregation``).

Voxel layout: flat (z, y, x) with x minor, BEV rows being world y; the
channels of a BEV cell are (z, d), d minor.

Precision departs from the reference here: the upsampling convolutions
compute in the head's activation dtype (bf16 in the served configs), their
GroupNorms and the per-voxel MLP in f32. The JAX package's CNNUpsample
names no dtype, so flax promotes it to f32 throughout. At the TPU's default
precision an f32 convolution also multiplies bf16-rounded operands in f32
sums; what differs is that each convolution's output is rounded to bf16
before its norm. bf16 runs the 2,048-channel transposed convolution at
200x200 at the tensor cores' bf16 rate and halves its activations
(200x200x2,048 each); ``chip_smoke.py``'s
``stream_occ_bf16_vs_f32`` reads what it changes in the logits and the
class grid. The refinement layer and ``occ_tsa_head`` compute in f32 whatever
the head's dtype, as the JAX package builds them without a dtype: the
upsampled tokens are cast to f32 before the pass.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.encoder import BEVFormerLayer
from apollo_vision_net_tpu_torch.models.heads.det_head import BEVFormerHead
from apollo_vision_net_tpu_torch.models.layers import (
    Conv2d,
    Dense,
    GroupNorm,
    LayerNorm,
    current_generator,
)
from apollo_vision_net_tpu_torch.ops.grid_sample import grid_sample_3d
from apollo_vision_net_tpu_torch.utils import geometry


class OccMLPBranch(nn.Module):
    """(Dense -> LN -> ReLU) x num_fcs -> Dense, computed in f32, on
    ``in_dims``-wide features (occ_dims unless given, as flax infers it)."""

    def __init__(self, occ_dims: int, out_dims: int, num_fcs: int = 2,
                 in_dims: int | None = None):
        super().__init__()
        self.num_fcs = num_fcs
        for i in range(num_fcs):
            self.add_module(f"Dense_{i}", Dense(
                (in_dims or occ_dims) if i == 0 else occ_dims, occ_dims))
            self.add_module(f"LayerNorm_{i}", LayerNorm(occ_dims))
        self.add_module(f"Dense_{num_fcs}", Dense(occ_dims, out_dims))

    def forward(self, x):
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return getattr(self, f"Dense_{self.num_fcs}")(x)


class FlowFuseMLP(nn.Module):
    """The reference's flow_fc: (Dense -> LN -> ReLU) x num_fcs at occ_dims,
    no final projection (bevformer_occupancy_head.py:222-227)."""

    def __init__(self, occ_dims: int, num_fcs: int = 2):
        super().__init__()
        self.num_fcs = num_fcs
        for i in range(num_fcs):
            self.add_module(f"Dense_{i}", Dense(occ_dims, occ_dims))
            self.add_module(f"LayerNorm_{i}", LayerNorm(occ_dims))

    def forward(self, x):
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return x


def flow_mix_weight(device) -> torch.Tensor:
    """The aggregation's mixing weight in training mode: one U[0, 1) draw
    from the current generator (the JAX package's ``flow_mix`` draw)."""
    return torch.rand((), generator=current_generator(), device=device)


class ConvTranspose(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(k=3, padding="SAME")`` on NCHW, in the input's
    dtype. flax correlates the zero-dilated input, padded (k-1-lo, k-1-hi) =
    (2, 1) at stride 2 and (1, 1) at stride 1, with its kernel unflipped:
    that is torch's transposed convolution (which flips) with padding 0,
    cropped to the first s·n rows and columns, given the flax kernel
    flipped (bridge.py flips it)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__(cin, cout, 3, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.stride[0]
        y = F.conv_transpose2d(x, self.weight.to(x.dtype),
                               self.bias.to(x.dtype), s)
        # stride 2: rows 0 .. 2n-1 of 2n+1; stride 1: rows 1 .. n of n+2
        lo = 0 if s == 2 else 1
        return y[:, :, lo:lo + s * x.shape[2], lo:lo + s * x.shape[3]]


class CNNUpsample(nn.Module):
    """Apollo upsample_layer: ConvT(s1) -> GN -> ReLU -> 1×1 (-> z·d) ->
    GN -> ReLU -> ConvT(s2) -> GN -> ReLU (occupancy_head_apollo.py:57-67),
    NCHW; total upsampling s1·s2 = ``upsample_factor`` in {1, 2, 4}."""

    def __init__(self, embed_dims: int, out_channels: int,
                 upsample_factor: int = 4):
        super().__init__()
        if upsample_factor not in (1, 2, 4):
            raise ValueError(f"upsample_factor {upsample_factor}")
        s1 = 2 if upsample_factor >= 2 else 1
        s2 = 2 if upsample_factor >= 4 else 1
        self.ConvTranspose_0 = ConvTranspose(embed_dims, embed_dims, s1)
        self.GroupNorm_0 = GroupNorm(32, embed_dims)
        self.Conv_0 = Conv2d(embed_dims, out_channels, 1, bias=True)
        self.GroupNorm_1 = GroupNorm(32, out_channels)
        self.ConvTranspose_1 = ConvTranspose(out_channels, out_channels, s2)
        self.GroupNorm_2 = GroupNorm(32, out_channels)

    def forward(self, x):  # (B, C, H, W)
        x = F.relu(self.GroupNorm_0(self.ConvTranspose_0(x)))
        x = F.relu(self.GroupNorm_1(self.Conv_0(x)))
        return F.relu(self.GroupNorm_2(self.ConvTranspose_1(x)))


class BEVFormerOccupancyHead(BEVFormerHead):
    def __init__(self, *, occupancy_classes: int = 16, occ_xdim: int = 200,
                 occ_ydim: int = 200, occ_zdim: int = 16, occ_dims: int = 128,
                 num_occ_fcs: int = 2, occ_head_type: str = "cnn",
                 predict_flow: bool = False, occ_tsa: bool = False,
                 with_occupancy_flow: bool = False, **kwargs):
        super().__init__(**kwargs)
        C = self.embed_dims
        self.occ_xdim, self.occ_ydim, self.occ_zdim = occ_xdim, occ_ydim, occ_zdim
        self.occ_dims = occ_dims
        self.occ_head_type = occ_head_type
        # the JAX package builds the refinement pass in the CNN head only
        self.occ_tsa = occ_tsa and occ_head_type == "cnn"
        self.predict_flow = predict_flow
        self.with_occupancy_flow = with_occupancy_flow
        if occ_head_type == "cnn":
            if occ_xdim % self.bev_h:
                raise ValueError(f"occ_xdim {occ_xdim} is not a multiple of "
                                 f"bev_h {self.bev_h}")
            self.upsample_layer = CNNUpsample(
                C, C if self.occ_tsa else occ_zdim * occ_dims,
                upsample_factor=occ_ydim // self.bev_h)
            if self.occ_tsa:
                # one refinement layer, flax's occ_tsa_layer0
                self.occ_tsa_layer0 = BEVFormerLayer(
                    C, num_levels=self.num_feature_levels,
                    num_cams=self.num_cams,
                    feedforward_channels=self.feedforward_channels,
                    bev_hw=(occ_ydim, occ_xdim), dtype=torch.float32)
                self.occ_tsa_head = Dense(C, occ_zdim * occ_dims,
                                          dtype=torch.float32)
        elif occ_head_type == "mlp":
            if (occ_xdim, occ_ydim) != (self.bev_h, self.bev_w):
                raise ValueError("the mlp occupancy head needs the BEV grid")
            self.occ_proj = Dense(C, occ_dims * occ_zdim)
        else:
            raise ValueError(occ_head_type)
        self.occ_branches = OccMLPBranch(occ_dims, occupancy_classes, num_occ_fcs)
        if predict_flow:
            self.flow_branches = OccMLPBranch(occ_dims, 2, num_occ_fcs)
        if with_occupancy_flow:
            self.forward_flow = Dense(occ_dims, 3)
            self.backward_flow = Dense(occ_dims, 3)
            self.flow_fc = FlowFuseMLP(occ_dims, num_occ_fcs)

    @property
    def voxel_num(self) -> int:
        return self.occ_zdim * self.occ_xdim * self.occ_ydim

    def _occ_from_bev(self, bev_embed: torch.Tensor, mlvl_feats=None,
                      lidar2img=None) -> torch.Tensor:
        """(B, bev_h*bev_w, C) -> (B, z*y*x, occ_dims) in (z, y, x) order;
        the refinement pass reads the current frame's image features and
        cameras."""
        B = bev_embed.shape[0]
        z, d = self.occ_zdim, self.occ_dims
        y, x = self.occ_ydim, self.occ_xdim
        if self.occ_head_type == "cnn":
            grid = bev_embed.reshape(B, self.bev_h, self.bev_w, self.embed_dims)
            up = self.upsample_layer(grid.permute(0, 3, 1, 2).to(self.dtype))
            if self.occ_tsa:
                # tokens (B, y·x, z·d), d minor -> (B, z, y, x, d)
                up = self._occ_tsa_pass(up.float(), mlvl_feats, lidar2img)
                up = up.reshape(B, y, x, z, d).permute(0, 3, 1, 2, 4)
            else:
                # channels (z, d) -> (B, z, y, x, d)
                up = up.reshape(B, z, d, y, x).permute(0, 1, 3, 4, 2)
            return up.reshape(B, self.voxel_num, d)
        p = self.occ_proj(bev_embed).reshape(B, x * y, z, d)
        return p.transpose(1, 2).reshape(B, self.voxel_num, d)

    def _occ_tsa_pass(self, up: torch.Tensor, mlvl_feats, lidar2img
                      ) -> torch.Tensor:
        """Deformable refinement at occupancy resolution (reference
        upsample_tsa_occ, occupancy_head_apollo.py:114-144): the upsampled
        tokens attend to themselves (both TSA slots the tokens, no history,
        rotation or shift, zero positional encoding) and to the current
        frame's raw image features through the pillars of the occ_y×occ_x
        grid. up (B, C, y, x) -> (B, y·x, z·d)."""
        B, C, oy, ox = up.shape
        Q = oy * ox
        dev = up.device
        q = up.permute(0, 2, 3, 1).reshape(B, Q, C)
        ref_3d = torch.as_tensor(geometry.bev_reference_points_3d(
            oy, ox, self.pc_range[5] - self.pc_range[2],
            self.num_points_in_pillar), device=dev)
        ref_cam, bev_mask = geometry.point_sampling(
            ref_3d, self.pc_range, lidar2img, self.img_shape)
        ref_2d = torch.as_tensor(geometry.bev_reference_points_2d(oy, ox),
                                 device=dev)
        img_value = torch.cat([f.reshape(f.shape[0], f.shape[1], -1, f.shape[-1])
                               for f in mlvl_feats], dim=2)
        img_shapes = tuple((f.shape[2], f.shape[3]) for f in mlvl_feats)
        q = self.occ_tsa_layer0(
            q, img_value, bev_pos=torch.zeros_like(q),
            tsa_value=torch.stack([q, q], dim=1),
            tsa_refs=ref_2d[None, None, :, None, :].expand(B, 2, Q, 1, 2),
            bev_spatial_shapes=((oy, ox),), img_spatial_shapes=img_shapes,
            reference_points_cam=ref_cam.transpose(0, 1),
            bev_mask=bev_mask.transpose(0, 1))
        return self.occ_tsa_head(q)

    def occupancy_aggregation(self, occ_feat: torch.Tensor, batch: int,
                              seq_len: int) -> torch.Tensor:
        """Learned backward and forward flow warping across the queue
        (reference occupancy_aggregation, bevformer_occupancy_head.py
        :253-301): each frame's voxels predict a 3D flow, the neighbour
        frame's volume is sampled trilinearly along it, blended with a
        weight w (0.5 in eval mode, a draw in training mode) and fused by
        ``flow_fc``. The backward pass (frame i pulls from frame i-1) reads
        the original volumes, the forward pass (frame i pulls from i+1) the
        backward-updated ones. occ_feat (B·S, voxels, d), (b, s) order."""
        B, S = batch, seq_len
        zz, yy, xx = self.occ_zdim, self.occ_ydim, self.occ_xdim
        d = occ_feat.shape[-1]
        dev = occ_feat.device
        vol = occ_feat.reshape(B, S, zz, yy, xx, d)
        # voxel-centre positions in [0, 1] as (x, y, z) coordinates
        axes = [(torch.arange(n, dtype=torch.float32, device=dev) + 0.5) / n
                for n in (zz, yy, xx)]
        ref = torch.stack(torch.meshgrid(*axes, indexing="ij")[::-1], dim=-1)

        def weight():
            return flow_mix_weight(dev) if self.training else 0.5

        def warp(src, flows):
            n = src.shape[0] * src.shape[1]
            grid = (ref + flows) * 2.0 - 1.0
            out = grid_sample_3d(src.reshape(n, zz, yy, xx, d),
                                 grid.reshape(n, zz, yy, xx, 3))
            return out.reshape(src.shape)

        w = weight()
        warped = warp(vol[:, :-1], self.backward_flow(vol[:, 1:]))
        mixed = self.flow_fc(vol[:, 1:] * (1.0 - w) + warped * w)
        vol = torch.cat([vol[:, :1], mixed], dim=1)
        w = weight()
        warped = warp(vol[:, 1:], self.forward_flow(vol[:, :-1]))
        mixed = self.flow_fc(vol[:, :-1] * (1.0 - w) + warped * w)
        vol = torch.cat([mixed, vol[:, -1:]], dim=1)
        return vol.reshape(B * S, self.voxel_num, d)

    def forward(self, mlvl_feats, *, can_bus, lidar2img, prev_bev, has_prev,
                only_bev: bool = False, prev_bevs=None):
        """As ``BEVFormerHead.forward``; ``prev_bevs`` (B, S-1, Q, C), the
        queue's history BEVs, makes every queue frame lifted and classified:
        the occupancy (and flow) predictions are then (B·S, voxels, ·), in
        (b, s) order."""
        outs = super().forward(mlvl_feats, can_bus=can_bus, lidar2img=lidar2img,
                               prev_bev=prev_bev, has_prev=has_prev,
                               only_bev=only_bev)
        if only_bev:
            return outs
        bev = outs["bev_embed"]
        seq_len = 1
        if prev_bevs is not None:
            if self.occ_tsa:
                raise ValueError("occ_tsa and keep_bev_history are mutually "
                                 "exclusive (the refinement pass attends to "
                                 "the current frame's images)")
            seq_len = prev_bevs.shape[1] + 1
            bev = torch.cat([prev_bevs, bev[:, None]], dim=1).reshape(
                -1, *bev.shape[1:])
        occ_feat = self._occ_from_bev(bev, mlvl_feats, lidar2img).float()
        if self.with_occupancy_flow and seq_len > 1:
            occ_feat = self.occupancy_aggregation(
                occ_feat, bev.shape[0] // seq_len, seq_len)
        outs["occupancy_preds"] = self.occ_branches(occ_feat)
        if self.predict_flow:
            outs["flow_preds"] = self.flow_branches(occ_feat)
        return outs


def occupancy_prediction(occupancy_preds: torch.Tensor,
                         occ_loss_type: str = "focal_loss",
                         occ_threshold: float = 0.25) -> torch.Tensor:
    """Per-voxel class decision (reference get_occupancy_prediction,
    occupancy_head.py:1037-1073): (B, voxels, C) -> (B, voxels) int64. The
    focal rule takes the most probable class where its sigmoid reaches
    ``occ_threshold`` and C (free) elsewhere, as the JAX package's argmax
    over [p, threshold] does; CE takes the argmax."""
    if occ_loss_type == "focal_loss":
        p, cls = torch.sigmoid(occupancy_preds.float()).max(dim=-1)
        return torch.where(p >= occ_threshold, cls,
                           torch.full_like(cls, occupancy_preds.shape[-1]))
    return torch.argmax(occupancy_preds, dim=-1)
