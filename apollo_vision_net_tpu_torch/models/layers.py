"""Layers with flax.linen's numerics, for the port's modules.

Parameters stay f32; ``dtype`` is the activation dtype a layer computes in,
as flax's ``dtype`` argument: ``None`` promotes the input with the f32
parameters (so a bf16 input runs in f32), a dtype casts input and
parameters to it. Norms take their statistics in f32 and use flax's
epsilon of 1e-6 (FrozenBatchNorm keeps the JAX package's 1e-5).

``Dropout`` is flax's ``nn.Dropout`` in training mode (``module.train()``)
and the identity in eval mode; its draws come from the generator that
``use_generator`` installs (torch's default generator otherwise). Under a
mesh (``parallel.mesh.use_mesh``) every rank seeds that generator alike and
a mask is drawn for the global batch, of which the rank keeps its rows
(and, inside ``bev_rows``, its BEV rows): a step of the world draws what
one process draws on the global batch.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from apollo_vision_net_tpu_torch.parallel.mesh import current_mesh


def _compute_dtype(x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.dtype:
    return dtype if dtype is not None else torch.promote_types(x.dtype, torch.float32)


_GENERATOR: contextvars.ContextVar = contextvars.ContextVar("generator",
                                                          default=None)


@contextlib.contextmanager
def use_generator(generator: Optional[torch.Generator]):
    """Inside, every random draw of the model (dropout, grid mask) comes
    from ``generator``, which must live on the activations' device."""
    token = _GENERATOR.set(generator)
    try:
        yield
    finally:
        _GENERATOR.reset(token)


def current_generator() -> Optional[torch.Generator]:
    return _GENERATOR.get()


# (start, total) of the BEV query rows (dim 1) that the encoder's layers
# compute on this rank under the BEV partition
_BEV_ROWS: contextvars.ContextVar = contextvars.ContextVar("bev_rows",
                                                          default=None)


@contextlib.contextmanager
def bev_rows(start: int, total: int):
    """Inside, dropout masks are drawn for all ``total`` BEV rows (dim 1)
    and keep those from ``start`` on: the encoder layers' queries under the
    BEV partition (models/encoder.py)."""
    token = _BEV_ROWS.set((start, total))
    try:
        yield
    finally:
        _BEV_ROWS.reset(token)


def dropout_mask(shape, keep_prob: float, device,
                 batch_dim: Optional[int] = None) -> torch.Tensor:
    """Bernoulli(keep_prob) draws of ``shape`` as a bool mask: by default
    one that the batch shares. Under a mesh with dp > 1 a mask with a
    ``batch_dim`` (whose leading factor is the batch, as in a (B·G, ...)
    fold) is drawn for the global batch, that dim dp times as long, and
    the rank keeps its dp index's rows. Inside ``bev_rows`` dim 1 is drawn
    whole, and the rank keeps its rows."""
    full, index = list(shape), [slice(None)] * len(shape)
    mesh = current_mesh()
    if mesh is not None and mesh.dp > 1 and batch_dim is not None:
        n = shape[batch_dim]
        full[batch_dim] = n * mesh.dp
        index[batch_dim] = slice(mesh.dp_index * n, (mesh.dp_index + 1) * n)
    rows = _BEV_ROWS.get()
    if rows is not None:
        start, full[1] = rows
        index[1] = slice(start, start + shape[1])
    u = torch.rand(full, generator=current_generator(), device=device)
    return u[tuple(index)] < keep_prob


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in training mode, where(keep, x / keep_prob, 0)
    with keep ~ Bernoulli(1 - rate) per element; the identity in eval
    mode. Its input's batch is dim 0 (or that dim's leading factor) at every
    call site."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        keep = dropout_mask(x.shape, keep_prob, x.device, batch_dim=0)
        return torch.where(keep, x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))


class Dense(nn.Linear):
    """flax ``nn.Dense``: y = x @ W + b in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, *,
                 bias: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.compute_dtype)
        b = self.bias.to(dt) if self.bias is not None else None
        return F.linear(x.to(dt), self.weight.to(dt), b)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm`` (eps 1e-6): f32 statistics, output in dtype."""

    def __init__(self, dim: int, *, dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps=1e-6)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _compute_dtype(x, self.compute_dtype)
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(dt)


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` (eps 1e-6) on NCHW: f32 statistics, output in
    the input's dtype."""

    def __init__(self, num_groups: int, channels: int):
        super().__init__(num_groups, channels, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x.float(), self.num_groups, self.weight,
                            self.bias, self.eps).to(x.dtype)


class FrozenBatchNorm(nn.Module):
    """BN with fixed statistics on NCHW (JAX models/resnet.py:25-42):
    y = x * scale / sqrt(var + 1e-5) + (bias - mean * scale / sqrt(var + 1e-5)),
    the affine folded in f32 and applied in the input's dtype.

    The four tensors are parameters, as in the JAX package, where they are
    flax params: a train step computes their gradients, which enter the
    global gradient norm of the clip, and the optimizer leaves them out of
    every group (parallel/optim.py), so they never change."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.running_mean = nn.Parameter(torch.zeros(channels))
        self.running_var = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = self.weight * torch.rsqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]


class Conv2d(nn.Conv2d):
    """NCHW convolution in the input's dtype, bias-free unless ``bias``
    (flax ``nn.Conv`` has one by default). ``padding=None`` is flax's
    default 'SAME': total padding max((ceil(n/s) - 1)·s + k - n, 0) per
    spatial dim, the smaller half low, as XLA splits it. ``groups`` is
    flax's ``feature_group_count``."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = False,
                 groups: int = 1):
        super().__init__(cin, cout, k, stride=stride,
                         padding=0 if padding is None else padding, bias=bias,
                         groups=groups)
        self.same = padding is None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.same:
            pads = []
            for size, k, s in zip(x.shape[:1:-1], self.kernel_size[::-1],
                                  self.stride[::-1]):
                total = max((-(-size // s) - 1) * s + k - size, 0)
                pads += [total // 2, total - total // 2]
            if any(pads):
                x = F.pad(x, pads)
        b = self.bias.to(x.dtype) if self.bias is not None else None
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride,
                        self.padding, groups=self.groups)
