"""The process mesh of multi-GPU training and the batch's rows on it.

Counterpart of the JAX package's parallel/mesh.py (``make_mesh``,
``batch_sharding``, ``replicated``, ``shard_batch_pytree``). JAX lays its
devices out as a ``Mesh`` with axes ``("dp", "sp")``; here the devices are
the processes of the initialized default process group (one a GPU under
``torchrun``, or gloo processes on the CPU), laid out as JAX's
``np.asarray(devices).reshape(dp, sp)`` lays them: rank ``i·sp + j`` is dp
index i and sp index j. Every rank builds one process group a column
(``dp``: the ranks of one sp index) and one a row (``sp``: the ranks of one
dp index), of one rank where the axis has size 1: the step runs the same
collectives at every size (a world of one over NCCL runs them all).

- ``dp``, data parallel: dp index i takes the rows ``[i·B/dp, (i+1)·B/dp)``
  of the global batch of B samples (``shard_batch``); the parameters are
  replicated (``replicate`` broadcasts rank 0's when the model is built);
  the train step (parallel/train.py) gathers what the losses read over
  ``dp`` and averages the gradients over the world.
- ``sp``, the BEV partition: with a config's ``bev_partition`` the ranks of
  an sp group split the BEV query rows of every encoder layer
  (models/encoder.py); everything else is replicated in the group.

``use_mesh`` makes a mesh the current one for the modules that read it
(the encoder's partition, dropout's draws of the global batch), as JAX's
``set_mesh`` does for its sharding constraints. Collectives run on the
mesh's device: NCCL on CUDA tensors, or gloo on CPU or CUDA tensors (ranks
that share a card, which NCCL refuses).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    dp: int
    sp: int
    rank: int
    device: torch.device
    dp_group: dist.ProcessGroup
    sp_group: dist.ProcessGroup

    @property
    def world(self) -> int:
        return self.dp * self.sp

    @property
    def dp_index(self) -> int:
        return self.rank // self.sp

    @property
    def sp_index(self) -> int:
        return self.rank % self.sp

    @property
    def shape(self) -> Dict[str, int]:
        """{"dp": dp, "sp": sp}, as JAX's ``Mesh.shape`` prints."""
        return {"dp": self.dp, "sp": self.sp}


def mesh_ranks(dp: int, sp: int) -> np.ndarray:
    """(dp, sp) ranks: JAX's ``np.asarray(devices).reshape(dp, sp)`` of the
    devices in rank order."""
    return np.arange(dp * sp).reshape(dp, sp)


def init_distributed(device, rank: int, world: int, init_method: str,
                     backend: Optional[str] = None) -> None:
    """The default process group: NCCL for a CUDA ``device`` and gloo for
    the CPU, unless ``backend`` names one (gloo on CUDA tensors runs ranks
    that share a card, which NCCL refuses)."""
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)


def torchrun_env() -> Optional[Dict[str, int]]:
    """{"rank", "world", "local_rank"} from torchrun's ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK``, or None outside torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return {"rank": int(os.environ["RANK"]),
            "world": int(os.environ["WORLD_SIZE"]),
            "local_rank": int(os.environ.get("LOCAL_RANK", 0))}


def make_mesh(dp: Optional[int] = None, sp: int = 1, device=None) -> Mesh:
    """The (dp, sp) mesh over the default process group's ranks (dp: the
    world over sp by default), its collectives on ``device`` (default: the
    CPU for gloo, the current CUDA device for NCCL). Every rank calls it
    with the same arguments: it creates every group of both axes."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        dp = world // sp
    assert dp * sp == world, (dp, sp, world)
    backend = dist.get_backend()
    if device is None:
        device = ("cuda" if backend == "nccl" else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    ranks = mesh_ranks(dp, sp)
    groups = {}
    # new_group's contract: every rank creates every group, in one order
    for axis, lines in (("dp", ranks.T), ("sp", ranks)):
        for line in lines:
            group = dist.new_group(line.tolist())
            if rank in line:
                groups[axis] = group
    return Mesh(dp, sp, rank, device, groups["dp"], groups["sp"])


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """Dp index i's rows ``[i·B/dp, (i+1)·B/dp)`` of every array of a global
    batch (leading axis B; numpy arrays or tensors)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        assert n % mesh.dp == 0, f"{k}: batch {n} over dp {mesh.dp}"
        rows = n // mesh.dp
        out[k] = v[mesh.dp_index * rows:(mesh.dp_index + 1) * rows]
    return out


@torch.no_grad()
def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (JAX's ``replicated``
    state): a broadcast over the world, once, when the model is built."""
    for t in [*module.parameters(), *module.buffers()]:
        dist.broadcast(t.data, src=0)
    return module


_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Inside, ``current_mesh()`` is ``mesh``: the encoder splits the BEV
    rows over its sp axis where the config asks, and dropout draws the
    global batch's masks and keeps this rank's rows."""
    token = _MESH.set(mesh)
    try:
        yield
    finally:
        _MESH.reset(token)


def current_mesh() -> Optional[Mesh]:
    return _MESH.get()
