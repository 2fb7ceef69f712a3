"""InternImage backbone built on the DCNv3 op.

Counterpart of the JAX package's models/internimage.py (reference
bevformer/backbones/internimage.py:336-701): a stem of two stride-2 convs
with LayerNorm and GELU, stages of ``InternImageLayer`` (DCNv3 then an MLP
of 4x width, each with a layer-scale residual, post-norm as InternImage-S
and larger use it), and a stride-2 conv with LayerNorm between stages.
InternImage-S (the defaults, the only size the configs build): channels 80,
depths (4, 4, 21, 4), groups (5, 10, 20, 40).

Modules keep the flax names (``stem1``, ``stem_ln1``,
``stage{i}_block{b}.dcn.input_proj``, ``down{i}``, ``down_ln{i}``, ...), so
the bridge maps the flax tree by name alone, and the optimizer's freezing
rule (``stem_``) freezes ``stem_ln1`` and ``stem_ln2`` as in JAX.

Precision follows the JAX package: the convs and the ``input_proj``,
``output_proj`` and MLP projections compute in ``dtype`` (bf16 in the
served configs); the LayerNorms name no dtype, so they return f32, and the
residual stream is f32 from the stem's LayerNorm on; the ``offset`` and
``mask`` projections run in f32 on the f32 ``dw_norm`` output, and the
DCNv3 sampling in f32. GELU is flax's default tanh approximation.

The residual stream is NHWC; the convs see it as an NCHW view in the
channels_last memory format. ``forward`` takes NCHW images and returns the
stage outputs at ``out_indices`` as NCHW views.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.layers import Conv2d, Dense, LayerNorm
from apollo_vision_net_tpu_torch.ops.dcnv3 import dcnv3_core

CHANNELS = 80
DEPTHS = (4, 4, 21, 4)
GROUPS = (5, 10, 20, 40)
MLP_RATIO = 4
LAYER_SCALE = 1.0  # gamma1 / gamma2 at init


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu`` (approximate=True)."""
    return F.gelu(x, approximate="tanh")


def _conv_nhwc(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An NCHW conv on an NHWC tensor, computed in ``dtype``; NHWC out."""
    return conv(x.to(dtype).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class DCNv3Block(nn.Module):
    """3x3 DCNv3 with ``groups`` groups (offset scale 1)."""

    def __init__(self, channels: int, groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C, G, K = channels, groups, 9
        self.groups, self.dtype = G, dtype
        self.input_proj = Dense(C, C, dtype=dtype)
        # flax padding="SAME" at stride 1 is symmetric
        self.dw_conv = Conv2d(C, C, 3, padding=1, bias=True, groups=C)
        self.dw_norm = LayerNorm(C)
        # zero-initialized, no dtype: f32 on the f32 dw_norm output
        self.offset = Dense(C, G * K * 2)
        self.mask = Dense(C, G * K)
        self.output_proj = Dense(C, C, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        B, H, W, C = x.shape
        G = self.groups
        v = self.input_proj(x)
        dw = gelu(self.dw_norm(_conv_nhwc(self.dw_conv, x, self.dtype)))
        offset = self.offset(dw).reshape(B, H, W, G, 9, 2).float()
        mask = torch.softmax(self.mask(dw).reshape(B, H, W, G, 9).float(), -1)
        out = dcnv3_core(v.reshape(B, H, W, G, C // G).float(), offset,
                         mask).to(x.dtype)
        return self.output_proj(out)


class InternImageLayer(nn.Module):
    """Post-norm: x + gamma1 · LN(DCNv3(x)), then x + gamma2 · LN(MLP(x))."""

    def __init__(self, channels: int, groups: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = channels
        self.gamma1 = nn.Parameter(torch.full((C,), LAYER_SCALE))
        self.gamma2 = nn.Parameter(torch.full((C,), LAYER_SCALE))
        self.dcn = DCNv3Block(C, groups, dtype=dtype)
        self.norm1 = LayerNorm(C)
        self.norm2 = LayerNorm(C)
        self.mlp_fc1 = Dense(C, MLP_RATIO * C, dtype=dtype)
        self.mlp_fc2 = Dense(MLP_RATIO * C, C, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, H, W, C)
        x = x + self.gamma1.to(x.dtype) * self.norm1(self.dcn(x))
        y = self.mlp_fc2(gelu(self.mlp_fc1(x)))
        return x + self.gamma2.to(x.dtype) * self.norm2(y)


class InternImage(nn.Module):
    """InternImage-S by default; returns the stage outputs at
    ``out_indices`` (stage i has stride 2^(i+2) and channels·2^i channels)."""

    def __init__(self, channels: int = CHANNELS, depths: Sequence[int] = DEPTHS,
                 groups: Sequence[int] = GROUPS,
                 out_indices: Sequence[int] = (1, 2, 3),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = channels
        self.depths, self.out_indices, self.dtype = tuple(depths), tuple(out_indices), dtype
        self.stem1 = Conv2d(3, c // 2, 3, stride=2, bias=True)
        self.stem_ln1 = LayerNorm(c // 2)
        self.stem2 = Conv2d(c // 2, c, 3, stride=2, bias=True)
        self.stem_ln2 = LayerNorm(c)
        for i, (depth, g) in enumerate(zip(depths, groups)):
            for b in range(depth):
                self.add_module(f"stage{i}_block{b}", InternImageLayer(
                    c * 2**i, g, dtype=dtype))
            if i < len(depths) - 1:
                self.add_module(f"down{i}", Conv2d(
                    c * 2**i, c * 2**(i + 1), 3, stride=2, bias=True))
                self.add_module(f"down_ln{i}", LayerNorm(c * 2**(i + 1)))

    def out_channels(self) -> Tuple[int, ...]:
        return tuple(self.stem2.out_channels * 2**i for i in self.out_indices)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, 3, H, W) -> NCHW stage outputs, f32 (the residual stream's
        dtype)."""
        dt = self.dtype
        x = x.permute(0, 2, 3, 1)
        x = gelu(self.stem_ln1(_conv_nhwc(self.stem1, x, dt)))
        x = self.stem_ln2(_conv_nhwc(self.stem2, x, dt))
        outs = []
        for i, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{i}_block{b}")(x)
            if i in self.out_indices:
                outs.append(x.permute(0, 3, 1, 2))
            if i < len(self.depths) - 1:
                x = getattr(self, f"down_ln{i}")(
                    _conv_nhwc(getattr(self, f"down{i}"), x, dt))
        return tuple(outs)
