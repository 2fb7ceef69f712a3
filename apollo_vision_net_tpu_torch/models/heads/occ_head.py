"""det + occupancy head (BEVFormerOccupancyHead family).

Counterpart of the JAX package's models/heads/occ_head.py (reference
bevformer_occupancy_head.py:182-216, bevformer_occupancy_head_apollo.py
:36-160): the det head (Group-DETR when ``group_detr`` > 1), then the BEV
lifted into voxels and classified per voxel at the last decoder layer:
- ``occ_head_type="cnn"`` (Apollo): ``CNNUpsample`` from the bev_h×bev_w
  grid to occ_y×occ_x with occ_zdim·occ_dims channels;
- ``occ_head_type="mlp"``: a per-token Dense to occ_zdim·occ_dims on a grid
  equal to the BEV grid.
The refinement pass (``occ_tsa``), flow prediction and flow warping are not
ported (``models.detector._check_supported`` refuses them).

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
class grid.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.heads.det_head import BEVFormerHead
from apollo_vision_net_tpu_torch.models.layers import (
    Conv2d,
    Dense,
    GroupNorm,
    LayerNorm,
)


class OccMLPBranch(nn.Module):
    """(Dense -> LN -> ReLU) x num_fcs -> Dense, computed in f32."""

    def __init__(self, occ_dims: int, out_dims: int, num_fcs: int = 2):
        super().__init__()
        self.num_fcs = num_fcs
        for i in range(num_fcs):
            self.add_module(f"Dense_{i}", Dense(occ_dims, occ_dims))
            self.add_module(f"LayerNorm_{i}", LayerNorm(occ_dims))
        self.add_module(f"Dense_{num_fcs}", Dense(occ_dims, out_dims))

    def forward(self, x):
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"LayerNorm_{i}")(getattr(self, f"Dense_{i}")(x)))
        return getattr(self, f"Dense_{self.num_fcs}")(x)


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
                 num_occ_fcs: int = 2, occ_head_type: str = "cnn", **kwargs):
        super().__init__(**kwargs)
        C = self.embed_dims
        self.occ_xdim, self.occ_ydim, self.occ_zdim = occ_xdim, occ_ydim, occ_zdim
        self.occ_dims = occ_dims
        self.occ_head_type = occ_head_type
        if occ_head_type == "cnn":
            if occ_xdim % self.bev_h:
                raise ValueError(f"occ_xdim {occ_xdim} is not a multiple of "
                                 f"bev_h {self.bev_h}")
            self.upsample_layer = CNNUpsample(
                C, occ_zdim * occ_dims, upsample_factor=occ_ydim // self.bev_h)
        elif occ_head_type == "mlp":
            if (occ_xdim, occ_ydim) != (self.bev_h, self.bev_w):
                raise ValueError("the mlp occupancy head needs the BEV grid")
            self.occ_proj = Dense(C, occ_dims * occ_zdim)
        else:
            raise ValueError(occ_head_type)
        self.occ_branches = OccMLPBranch(occ_dims, occupancy_classes, num_occ_fcs)

    @property
    def voxel_num(self) -> int:
        return self.occ_zdim * self.occ_xdim * self.occ_ydim

    def _occ_from_bev(self, bev_embed: torch.Tensor) -> torch.Tensor:
        """(B, bev_h*bev_w, C) -> (B, z*y*x, occ_dims) in (z, y, x) order."""
        B = bev_embed.shape[0]
        z, d = self.occ_zdim, self.occ_dims
        if self.occ_head_type == "cnn":
            grid = bev_embed.reshape(B, self.bev_h, self.bev_w, self.embed_dims)
            up = self.upsample_layer(grid.permute(0, 3, 1, 2).to(self.dtype))
            # channels (z, d) -> (B, z, y, x, d)
            up = up.reshape(B, z, d, self.occ_ydim, self.occ_xdim)
            return up.permute(0, 1, 3, 4, 2).reshape(B, self.voxel_num, d)
        p = self.occ_proj(bev_embed).reshape(B, self.occ_xdim * self.occ_ydim, z, d)
        return p.transpose(1, 2).reshape(B, self.voxel_num, d)

    def forward(self, mlvl_feats, *, can_bus, lidar2img, prev_bev, has_prev,
                only_bev: bool = False):
        outs = super().forward(mlvl_feats, can_bus=can_bus, lidar2img=lidar2img,
                               prev_bev=prev_bev, has_prev=has_prev,
                               only_bev=only_bev)
        if only_bev:
            return outs
        occ_feat = self._occ_from_bev(outs["bev_embed"])
        outs["occupancy_preds"] = self.occ_branches(occ_feat.float())
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
