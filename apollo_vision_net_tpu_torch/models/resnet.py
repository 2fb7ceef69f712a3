"""ResNet backbone with optional DCNv2 stages, on NCHW.

Counterpart of the JAX package's models/resnet.py (mmdet ResNet, pytorch
style): a 7×7 stride-2 stem with FrozenBatchNorm, ReLU and a 3×3 stride-2
max-pool, then Bottleneck stages with the stride on the 3×3 and a 1×1
downsample on block 0 of each stage. In a DCN stage every block's 3×3 is a
modulated deformable conv (ops/dcn.py): a biased 3×3 conv at the block's
stride predicts 27 channels in f32 (flax promotes the input of the
dtype-less ``conv2_offset``), the first 18 are (x, y) offsets per tap,
the last 9 a sigmoid mask; the conv weight ``conv2_dcn_weight`` is kept in
the JAX layout (9, C, O).

The trunk runs in the channels_last memory format, so the DCN's NHWC view
of its input and output is free.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.layers import Conv2d, FrozenBatchNorm
from apollo_vision_net_tpu_torch.ops.dcn import modulated_deform_conv

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
WIDTH = 64
# output channels of the 4 stages (Bottleneck expansion 4)
CHANNELS = tuple(WIDTH * 4 * 2 ** i for i in range(4))


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False):
        super().__init__()
        self.stride, self.with_dcn = stride, with_dcn
        self.conv1 = Conv2d(cin, planes, 1)
        self.bn1 = FrozenBatchNorm(planes)
        if with_dcn:
            self.conv2_offset = Conv2d(planes, 27, 3, stride=stride, padding=1,
                                       bias=True)
            self.conv2_dcn_weight = nn.Parameter(torch.empty(9, planes, planes))
        else:
            self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1)
        self.bn3 = FrozenBatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = Conv2d(cin, planes * 4, 1, stride=stride)
            self.downsample_bn = FrozenBatchNorm(planes * 4)

    def _dcn(self, x: torch.Tensor) -> torch.Tensor:
        om = self.conv2_offset(x.float()).permute(0, 2, 3, 1)  # (B, Ho, Wo, 27)
        B, Ho, Wo, _ = om.shape
        offset = om[..., :18].reshape(B, Ho, Wo, 9, 2).contiguous()
        mask = torch.sigmoid(om[..., 18:]).contiguous()
        out = modulated_deform_conv(
            x.permute(0, 2, 3, 1).contiguous(), offset, mask,
            self.conv2_dcn_weight.to(x.dtype).contiguous(), self.stride)
        return out.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self._dcn(out) if self.with_dcn else self.conv2(out)
        out = F.relu(self.bn2(out))
        out = self.bn3(self.conv3(out))
        identity = x
        if hasattr(self, "downsample_conv"):
            identity = self.downsample_bn(self.downsample_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Returns the stages at ``out_indices`` (0-based over the 4 residual
    stages; stage i has stride 2**(i+2) and ``CHANNELS[i]`` channels)."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (3,),
                 dcn_stages: Sequence[bool] = (False, False, False, False)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.stage_blocks = STAGE_BLOCKS[depth]
        self.stem_conv = Conv2d(3, WIDTH, 7, stride=2, padding=3)
        self.stem_bn = FrozenBatchNorm(WIDTH)
        cin, planes = WIDTH, WIDTH
        for stage, n_blocks in enumerate(self.stage_blocks):
            for b in range(n_blocks):
                stride = 1 if stage == 0 or b > 0 else 2
                self.add_module(f"layer{stage + 1}_{b}", Bottleneck(
                    cin, planes, stride, downsample=b == 0,
                    with_dcn=dcn_stages[stage]))
                cin = planes * 4
            planes *= 2

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, 3, H, W) in the compute dtype -> stages at out_indices."""
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(self.stem_conv(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs: List[torch.Tensor] = []
        for stage, n_blocks in enumerate(self.stage_blocks):
            for b in range(n_blocks):
                x = getattr(self, f"layer{stage + 1}_{b}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
