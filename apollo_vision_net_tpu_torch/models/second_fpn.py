"""SECONDFPNV2 neck — fuse the DLA levels into one map, on NCHW.

Counterpart of the JAX package's models/second_fpn.py (reference
models/necks/second_fpnv2.py:11-104): per level a deblock (ConvTranspose
for stride > 1, strided Conv for a fractional stride, GroupNorm, ReLU),
channel concat, 3×3 fuse conv and GroupNorm + ReLU.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.layers import Conv2d, GroupNorm


class SECONDFPNV2(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (128, 256, 512),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[float] = (0.5, 1.0, 2.0),
                 fuse_channels: int = 256):
        super().__init__()
        self.upsample_strides = tuple(upsample_strides)
        for i, (cin, oc, s) in enumerate(
                zip(in_channels, out_channels, upsample_strides)):
            if s > 1:
                k = int(s)
                # weights stored (in, out, k, k); the flax kernel is flipped
                # spatially when bridged (flax does not flip, torch does)
                self.add_module(f"deblock{i}_up", nn.ConvTranspose2d(
                    cin, oc, k, stride=k, bias=False))
            else:
                k = int(round(1.0 / s))
                self.add_module(f"deblock{i}_conv", Conv2d(cin, oc, k, stride=k))
            self.add_module(f"deblock{i}_norm", GroupNorm(32, oc))
        self.last_conv = Conv2d(sum(out_channels), fuse_channels, 3, padding=1)
        self.last_norm = GroupNorm(32, fuse_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor]:
        assert len(feats) == len(self.upsample_strides)
        ups = []
        for i, (f, s) in enumerate(zip(feats, self.upsample_strides)):
            if s > 1:
                up = getattr(self, f"deblock{i}_up")
                y = F.conv_transpose2d(f, up.weight.to(f.dtype), None, up.stride)
            else:
                y = getattr(self, f"deblock{i}_conv")(f)
            ups.append(F.relu(getattr(self, f"deblock{i}_norm")(y)))
        out = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return (F.relu(self.last_norm(self.last_conv(out))),)
