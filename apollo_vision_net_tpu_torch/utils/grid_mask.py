"""GridMask image augmentation, drawn on the device.

Counterpart of the JAX package's utils/grid_mask.py (reference
models/utils/grid_mask.py: GridMask(True, True, rotate=1, offset=False,
ratio=0.5, mode=1, prob=0.7)). With probability ``prob`` one stripe
pattern, shared by every image of the batch, keeps the union of the rows
and columns with ``((i - st) % d) < l`` and zeroes the rest; ``d`` is drawn
from [2, h), the phases ``st_h`` and ``st_w`` from [0, d), and
``l = clip(int(d * ratio + 0.5), 1, d - 1)``.

``grid_mask_from_draws`` is the pure function of the drawn values;
``grid_mask`` draws them on the device from a ``torch.Generator`` (no host
synchronization) and applies it.
"""
from __future__ import annotations

from typing import Optional

import torch


def grid_mask_from_draws(x: torch.Tensor, d, st_h, st_w, apply,
                         ratio: float = 0.5) -> torch.Tensor:
    """x (..., h, w, c) times the stripe mask of the draws (ints or 0-dim
    tensors on x's device); the identity where ``apply`` is false."""
    h, w = x.shape[-3], x.shape[-2]
    dev = x.device
    d = torch.as_tensor(d, device=dev)
    l = torch.clamp((d * ratio + 0.5).to(torch.int64), min=1)  # noqa: E741
    l = torch.minimum(l, d - 1)  # noqa: E741
    keep_h = ((torch.arange(h, device=dev) - st_h) % d) < l
    keep_w = ((torch.arange(w, device=dev) - st_w) % d) < l
    keep = (keep_h[:, None] | keep_w[None, :]).to(x.dtype)
    mask = torch.where(torch.as_tensor(apply, device=dev), keep,
                       torch.ones_like(keep))
    return x * mask[..., None]


def grid_mask(x: torch.Tensor, generator: Optional[torch.Generator] = None,
              ratio: float = 0.5, prob: float = 0.7) -> torch.Tensor:
    """x (..., h, w, c) with one stripe pattern drawn from ``generator``
    (torch's default generator of x's device when None)."""
    h = x.shape[-3]
    u = torch.rand(4, generator=generator, device=x.device, dtype=torch.float64)
    d = torch.clamp((u[0] * (h - 2)).floor().to(torch.int64) + 2, max=h - 1)
    st_h = torch.minimum((u[1] * d).floor().to(torch.int64), d - 1)
    st_w = torch.minimum((u[2] * d).floor().to(torch.int64), d - 1)
    return grid_mask_from_draws(x, d, st_h, st_w, u[3] <= prob, ratio)
