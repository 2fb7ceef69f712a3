"""FPN neck (mmdet-compatible), on NCHW.

Counterpart of the JAX package's models/fpn.py: biased 1×1 laterals, a
nearest top-down pass (half-pixel nearest, as ``jax.image.resize``), biased
3×3 output convs, then stride-2 3×3 convs on the last output until
``num_outs`` levels ('on_output'). A ReLU comes before each extra conv
after the first (``relu_before_extra_convs`` as the configs set it, with
the JAX package's ``len(outs) > len(laterals)`` condition).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.layers import Conv2d


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: int = 256,
                 num_outs: int = 1):
        super().__init__()
        self.num_outs = num_outs
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral_{i}", Conv2d(cin, out_channels, 1, bias=True))
            self.add_module(f"fpn_conv_{i}", Conv2d(
                out_channels, out_channels, 3, padding=1, bias=True))
        for n in range(len(in_channels), num_outs):
            self.add_module(f"extra_conv_{n}", Conv2d(
                out_channels, out_channels, 3, stride=2, padding=1, bias=True))

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [getattr(self, f"lateral_{i}")(f) for i, f in enumerate(feats)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + F.interpolate(
                laterals[i], size=laterals[i - 1].shape[-2:], mode="nearest-exact")
        outs = [getattr(self, f"fpn_conv_{i}")(x) for i, x in enumerate(laterals)]
        while len(outs) < self.num_outs:
            src = outs[-1]
            if len(outs) > len(laterals):
                src = F.relu(src)
            outs.append(getattr(self, f"extra_conv_{len(outs)}")(src))
        return tuple(outs)
