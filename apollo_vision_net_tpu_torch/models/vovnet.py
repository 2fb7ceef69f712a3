"""VoVNet backbone (OSA modules with the eSE gate) on NCHW.

Counterpart of the JAX package's models/vovnet.py (reference
models/backbones/vovnet.py:268-374): a stem of three 3×3 conv + frozen BN +
ReLU (strides 2, 1, 2), then four stages of OSA blocks (5 sequential 3×3
convs whose outputs are concatenated with the block's input and fused by a
1×1 conv, an effective-SE gate with a hard sigmoid, an identity shortcut
on every block after a stage's first) with a 3×3 stride-2 max-pool before
each stage after the first. That pool is the reference's
``MaxPool2d(3, 2, ceil_mode=True)``: windows start at 0 and the last one
may be partial, which is what the JAX package's -inf padding at the bottom
and right computes.

Modules keep the flax names (``stem{1,2,3}_{conv,bn}``,
``stage{s}_osa{b}`` with ``osa{i}_{conv,bn}``, ``concat_{conv,bn}`` and
``ese.fc``), so the bridge needs no rule of its own. Every conv computes
in its input's dtype, which ``extract_img_feat`` sets to the compute dtype,
as flax's ``dtype=`` on each conv does; FrozenBatchNorm folds its
statistics in f32.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.layers import Conv2d, FrozenBatchNorm

# stem channels, per-stage conv and concat (output) channels, OSA blocks a
# stage
VOVNET99 = dict(stem=(64, 64, 128), stage_conv_ch=(128, 160, 192, 224),
                stage_out_ch=(256, 512, 768, 1024), layers_per_block=5,
                blocks=(1, 3, 9, 3))
VOVNET39 = dict(VOVNET99, blocks=(1, 1, 2, 2))


class ESE(nn.Module):
    """Effective squeeze-excitation: x · hsigmoid(fc(mean over H, W))."""

    def __init__(self, channels: int):
        super().__init__()
        self.fc = Conv2d(channels, channels, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = self.fc(x.mean(dim=(2, 3), keepdim=True))
        return x * (torch.clamp(gate + 3.0, 0.0, 6.0) / 6.0)


class OSABlock(nn.Module):
    def __init__(self, cin: int, conv_ch: int, out_ch: int, layers: int = 5,
                 identity: bool = False):
        super().__init__()
        self.layers = layers
        self.identity = identity and cin == out_ch
        c = cin
        for i in range(layers):
            self.add_module(f"osa{i}_conv", Conv2d(c, conv_ch, 3, padding=1))
            self.add_module(f"osa{i}_bn", FrozenBatchNorm(conv_ch))
            c = conv_ch
        self.concat_conv = Conv2d(cin + layers * conv_ch, out_ch, 1, padding=0)
        self.concat_bn = FrozenBatchNorm(out_ch)
        self.ese = ESE(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [x]
        y = x
        for i in range(self.layers):
            y = F.relu(getattr(self, f"osa{i}_bn")(getattr(self, f"osa{i}_conv")(y)))
            feats.append(y)
        out = F.relu(self.concat_bn(self.concat_conv(torch.cat(feats, dim=1))))
        out = self.ese(out)
        return out + x if self.identity else out


class VoVNet(nn.Module):
    """Returns the stages at ``out_indices`` (0-based over the 4 stages;
    stage i has stride 2**(i+2) and ``out_channels()[k]`` channels)."""

    def __init__(self, arch: str = "V-99-eSE",
                 out_indices: Sequence[int] = (1, 2, 3)):
        super().__init__()
        cfg = VOVNET99 if "99" in arch else VOVNET39
        self.out_indices = tuple(out_indices)
        self.blocks = cfg["blocks"]
        self.stage_out_ch = cfg["stage_out_ch"]
        cin = 3
        for i, (ch, stride) in enumerate(zip(cfg["stem"], (2, 1, 2))):
            self.add_module(f"stem{i + 1}_conv", Conv2d(cin, ch, 3, stride=stride,
                                                        padding=1))
            self.add_module(f"stem{i + 1}_bn", FrozenBatchNorm(ch))
            cin = ch
        for stage, n_blocks in enumerate(self.blocks):
            for b in range(n_blocks):
                self.add_module(f"stage{stage + 2}_osa{b}", OSABlock(
                    cin, cfg["stage_conv_ch"][stage], cfg["stage_out_ch"][stage],
                    cfg["layers_per_block"], identity=b > 0))
                cin = cfg["stage_out_ch"][stage]

    def out_channels(self) -> List[int]:
        return [self.stage_out_ch[i] for i in self.out_indices]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, 3, H, W) in the compute dtype -> stages at out_indices."""
        for i in range(1, 4):
            x = F.relu(getattr(self, f"stem{i}_bn")(getattr(self, f"stem{i}_conv")(x)))
        outs: List[torch.Tensor] = []
        for stage, n_blocks in enumerate(self.blocks):
            if stage > 0:
                x = F.max_pool2d(x, 3, 2, ceil_mode=True)
            for b in range(n_blocks):
                x = getattr(self, f"stage{stage + 2}_osa{b}")(x)
            if stage in self.out_indices:
                outs.append(x)
        return tuple(outs)
