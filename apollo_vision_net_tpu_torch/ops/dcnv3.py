"""DCNv3 (deformable convolution v3), the InternImage core operator.

Counterpart of ``dcnv3_core`` in the JAX package's ops/dcnv3.py (reference
``dcnv3_core_pytorch``, ops_dcnv3/functions/dcnv3_func.py:19-63): for each
output pixel p0, each of G groups samples the K = 9 taps of a 3x3 kernel at
``p0 + k_offset + Δp_k`` with bilinear/zeros semantics, weighted by
softmaxed modulation masks, over the group's channels. InternImage uses
only 3x3 taps at dilation 1, so those are fixed here.

The sampling is multi-scale deformable attention with one level, the K taps
as points, the G groups as heads and the map's own pixels as queries, so
``dcnv3_core`` runs on ``ops.msda.ms_deform_attn_local``: its plain version
for CPU tensors, the tile-local CUDA entry ``msda_fwd_local`` (and
``msda_bwd_local`` for the gradients) for CUDA tensors, which it takes in
f32 only (InternImage casts to f32 in every config). Stride 1, 'same'
padding.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from apollo_vision_net_tpu_torch.ops.msda import ms_deform_attn_local

K = 9  # 3x3 taps at dilation 1

# (H, W, device) -> (pixel centres (1, H·W, 1, 1, 2), taps (K, 2), [W, H])
_GRIDS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def tap_grid(device) -> torch.Tensor:
    """(K, 2) tap offsets in pixels (x, y), centred, row-major over (ky, kx):
    the JAX package's ``_kernel_grid(3, 3, 1, 1)``. Its entries are -1, 0
    and 1, exact in f32."""
    r = torch.arange(3, dtype=torch.float32, device=device) - 1.0
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)


def _grids(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The pixel centres in [0, 1], the taps and [W, H], built on ``device``
    once per (H, W, device): a frame makes 33 DCNv3 calls at 4 sizes. Built
    outside inference mode, so that a training step may save them for its
    backward after a served frame cached them."""
    key = (H, W, device)
    if key not in _GRIDS:
        with torch.inference_mode(False):
            norm = torch.tensor([W, H], dtype=torch.float32, device=device)
            gy, gx = torch.meshgrid(
                torch.arange(H, dtype=torch.float32, device=device),
                torch.arange(W, dtype=torch.float32, device=device),
                indexing="ij")
            # divided by a tensor, not a Python scalar, which may become a
            # product with the reciprocal
            p0 = (torch.stack([gx.reshape(-1), gy.reshape(-1)], -1) + 0.5) / norm
            _GRIDS[key] = (p0[None, :, None, None, :], tap_grid(device), norm)
    return _GRIDS[key]


def sampling_locations(offset: torch.Tensor) -> torch.Tensor:
    """offset (B, H, W, G, K, 2) pixels (x, y) -> normalized locations
    (B, H·W, G, 1, K, 2): ``(j + 0.5) / W + (grid + offset) / [W, H]``, as
    JAX associates it, so a zero offset puts every tap on a pixel centre."""
    B, H, W, G, _, _ = offset.shape
    p0, grid, norm = _grids(H, W, offset.device)
    locs = p0 + (grid + offset.float().reshape(B, H * W, G, K, 2)) / norm
    return locs[:, :, :, None]


def dcnv3_core(
    value: torch.Tensor,    # (B, H, W, G, Dg) input features (post in-proj)
    offset: torch.Tensor,   # (B, H, W, G, K, 2) learned offsets in pixels (x, y)
    mask: torch.Tensor,     # (B, H, W, G, K) modulation, already softmaxed
) -> torch.Tensor:
    """Returns (B, H, W, G·Dg) sampled features in value's dtype."""
    B, H, W, G, Dg = value.shape
    attn = mask.float().reshape(B, H * W, G, 1, K).contiguous()
    out = ms_deform_attn_local(value.reshape(B, H * W, G, Dg).contiguous(),
                               ((H, W),), sampling_locations(offset),
                               attn)  # (B, Q, G·Dg)
    return out.reshape(B, H, W, G * Dg)
