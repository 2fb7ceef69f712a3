"""Learned BEV positional encoding (mmdet LearnedPositionalEncoding, as the
JAX package's models/pos_encoding.py)."""
from __future__ import annotations

import torch
import torch.nn as nn


class LearnedPositionalEncoding(nn.Module):
    """Row/col learned embedding -> (h*w, 2*num_feats): column features
    first, then row features, flattened row-major (mmdet convention)."""

    def __init__(self, num_feats: int = 128, row_num_embed: int = 200,
                 col_num_embed: int = 200):
        super().__init__()
        self.num_feats = num_feats
        self.row_embed = nn.Parameter(torch.empty(row_num_embed, num_feats))
        self.col_embed = nn.Parameter(torch.empty(col_num_embed, num_feats))

    def forward(self, h: int, w: int) -> torch.Tensor:
        F_ = self.num_feats
        pos = torch.cat([
            self.col_embed[None, :w, :].expand(h, w, F_),
            self.row_embed[:h, None, :].expand(h, w, F_),
        ], dim=-1)
        return pos.reshape(h * w, 2 * F_)
