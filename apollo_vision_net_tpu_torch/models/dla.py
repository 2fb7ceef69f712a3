"""DLA-34 backbone (Deep Layer Aggregation) on NCHW.

Counterpart of the JAX package's models/dla.py (reference
models/backbones/dla.py:331-428): levels [1, 1, 1, 2, 2, 1], channels
[16, 32, 64, 128, 256, 512], BasicBlocks with hierarchical tree aggregation
and FrozenBatchNorm. The stem is the plain-conv form: the JAX package's
space-to-depth stem (ops/s2d.py) computes the same convolutions in a layout
for the TPU, with the same parameter names and HWIO shapes.
Returns the stages at ``out_indices`` (stage i has stride 2^i).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.models.layers import Conv2d, FrozenBatchNorm


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = Conv2d(cin, planes, 3, stride=stride, padding=1)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = Conv2d(planes, planes, 3, padding=1)
        self.bn2 = FrozenBatchNorm(planes)

    def forward(self, x, residual=None):
        if residual is None:
            residual = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + residual)


class Root(nn.Module):
    def __init__(self, cin: int, cout: int, residual: bool):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1)
        self.bn = FrozenBatchNorm(cout)
        self.residual = residual

    def forward(self, *children):
        x = self.bn(self.conv(torch.cat(children, dim=1)))
        if self.residual:
            x = x + children[0]
        return F.relu(x)


class Tree(nn.Module):
    """``children_ch``: channels of the children handed down by the parent
    tree (they join this tree's root)."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_residual: bool = False,
                 children_ch: Sequence[int] = ()):
        super().__init__()
        self.levels, self.stride, self.level_root = levels, stride, level_root
        children_ch = list(children_ch) + ([cin] if level_root else [])
        # the projection exists only when tree1 is a BasicBlock (reference
        # dla.py Tree.__init__)
        self.has_project = levels == 1 and cin != cout
        if self.has_project:
            self.project_conv = Conv2d(cin, cout, 1)
            self.project_bn = FrozenBatchNorm(cout)
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout, 1)
            self.root = Root(2 * cout + sum(children_ch), cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride,
                              root_residual=root_residual)
            self.tree2 = Tree(levels - 1, cout, cout, 1,
                              root_residual=root_residual,
                              children_ch=children_ch + [cout])

    def forward(self, x, children: Sequence[torch.Tensor] = ()):
        children = list(children)
        bottom = (F.max_pool2d(x, self.stride, self.stride)
                  if self.stride > 1 else x)
        proj = (self.project_bn(self.project_conv(bottom))
                if self.has_project else bottom)
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            x1 = self.tree1(x, residual=proj)
            x2 = self.tree2(x1)
            return self.root(x2, x1, *children)
        x1 = self.tree1(x)
        return self.tree2(x1, children=children + [x1])


class DLA(nn.Module):
    def __init__(self, levels: Sequence[int] = (1, 1, 1, 2, 2, 1),
                 channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 out_indices: Sequence[int] = (3, 4, 5),
                 root_residual: bool = False):
        super().__init__()
        ch = list(channels)
        self.out_indices = tuple(out_indices)
        self.base_conv = Conv2d(3, ch[0], 7, padding=3)
        self.base_bn = FrozenBatchNorm(ch[0])
        self.level0_conv = Conv2d(ch[0], ch[0], 3, padding=1)
        self.level0_bn = FrozenBatchNorm(ch[0])
        self.level1_conv = Conv2d(ch[0], ch[1], 3, stride=2, padding=1)
        self.level1_bn = FrozenBatchNorm(ch[1])
        for i in range(2, 6):
            self.add_module(f"level{i}", Tree(
                levels[i], ch[i - 1], ch[i], stride=2, level_root=i > 2,
                root_residual=root_residual))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x (B, 3, H, W) in the compute dtype -> stages at out_indices."""
        outs: List[torch.Tensor] = []
        x = F.relu(self.base_bn(self.base_conv(x)))
        y = F.relu(self.level0_bn(self.level0_conv(x)))
        if 0 in self.out_indices:
            outs.append(y)
        y = F.relu(self.level1_bn(self.level1_conv(y)))
        if 1 in self.out_indices:
            outs.append(y)
        for i in range(2, 6):
            y = getattr(self, f"level{i}")(y)
            if i in self.out_indices:
                outs.append(y)
        return tuple(outs)
