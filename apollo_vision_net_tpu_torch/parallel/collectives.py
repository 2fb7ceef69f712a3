"""Collectives of the multi-GPU train step, on a mesh's axes.

``all_gather`` is an autograd all-gather of its own: the forward
concatenates every rank's tensor of an axis's group along ``dim`` in rank
order; the backward all-reduces (sums) the incoming gradient over the
group and returns this rank's slice. When every rank then computes the
same loss from the gathered tensor, each rank's copy of the gradient is
summed: the gradient that reaches a rank's inputs is the group's size
times the true one, which the train step's average over the world takes
out again (parallel/train.py). An all-reduce backward also runs on gloo,
which has no reduce-scatter.

``gather_targets`` (the same gather without a gradient) carries the
ground truth; ``average_`` sums tensors over the world and divides by its
size.
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist

from apollo_vision_net_tpu_torch.parallel.mesh import Mesh


def _gather(x: torch.Tensor, dim: int, group: dist.ProcessGroup) -> torch.Tensor:
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        ctx.index, ctx.size = dist.get_rank(group), x.shape[dim]
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


def all_gather(mesh: Mesh, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """Every rank's ``x`` of the mesh axis ``axis`` ("dp" or "sp")
    concatenated along ``dim`` in rank order, with the gradient as the
    module docstring says."""
    group = mesh.dp_group if axis == "dp" else mesh.sp_group
    return _AllGather.apply(x, dim, group)


@torch.no_grad()
def gather_targets(mesh: Mesh, batch: dict, keys) -> dict:
    """``batch`` with the arrays of ``keys`` gathered over dp along their
    leading (batch) axis: the global batch's ground truth."""
    return {k: _gather(v, 0, mesh.dp_group) if k in keys else v
            for k, v in batch.items()}


@torch.no_grad()
def average_(mesh: Mesh, tensors: List[torch.Tensor]) -> None:
    """Each tensor replaced by its mean over the world, in one all-reduce
    of the tensors flattened together (they share a dtype)."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(mesh.world)
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)])
