"""One multi-device train step of the two headline families, and the
launcher of a world of processes.

Counterpart of the JAX package's ``__graft_entry__.dryrun_multichip``: ``n``
processes (ranks on the ``cuda`` devices by default, or gloo processes on
the CPU with ``--device cpu``) form a (dp, sp) mesh, sp = 2 when n is even and at least
4 as in JAX, and take one train step of ``bev_smoke_det_map`` and
``bev_smoke_det_occ`` on a global batch of n samples, with the BEV
partition ``("dp", "sp", None)`` when sp > 1. Rank 0 prints JAX's line:

    python3 -m apollo_vision_net_tpu_torch.tools.dryrun_multichip 4
    dryrun_multichip(4): ok [bev_smoke_det_map], loss_total=..., mesh={'dp': 2, 'sp': 2}, bev_partition=('dp', 'sp', None)

``spawn_world(n, fn, *args)`` runs ``fn(*args)`` in n spawned processes
with the default process group initialized (``init_method`` a file in a
fresh directory, so that concurrent worlds cannot collide on a port) and
returns each rank's result.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Callable, List, Optional

import torch
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, init_file: str, device: str,
               backend: Optional[str], threads: int, fn: Callable, args,
               out: str) -> None:
    import torch.distributed as dist

    from apollo_vision_net_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(threads)
    if device == "cuda":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    init_distributed(device, rank, world, "file://" + init_file, backend)
    try:
        result = fn(*args)
        torch.save(result, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def spawn_world(world: int, fn: Callable, *args, device: str = "cpu",
                backend: Optional[str] = None, threads: int = 1,
                timeout: float = 600.0) -> List:
    """``fn(*args)`` on each of ``world`` spawned ranks (``fn`` importable
    by the children) -> the ranks' results in rank order (``torch.save``
    round trip). ``device`` "cuda" puts rank r on card r modulo the cards
    (all on one card: NCCL refuses that, gloo takes it); ``backend`` is
    init_distributed's. Raises if a rank fails or outlives ``timeout``
    seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init, out = os.path.join(tmp, "init"), os.path.join(tmp, "result")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, init, device, backend, threads, fn, args, out))
            for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"spawn_world({world}): exit codes {codes}")
        return [torch.load(f"{out}.{r}", weights_only=False)
                for r in range(world)]


def mesh_shape(n: int):
    """(dp, sp) of JAX's dry run: sp = 2 when n is even and >= 4."""
    sp = 2 if n % 2 == 0 and n >= 4 else 1
    return n // sp, sp


def dryrun_rank(n: int, device: str) -> List[str]:
    """One rank's part: both configs' step on an n-sample global batch;
    returns the lines that JAX's dry run prints."""
    from apollo_vision_net_tpu_torch import configs
    from apollo_vision_net_tpu_torch.data.synthetic import make_batch
    from apollo_vision_net_tpu_torch.models.detector import build_model
    from apollo_vision_net_tpu_torch.parallel import train as train_lib
    from apollo_vision_net_tpu_torch.parallel.mesh import (
        make_mesh,
        replicate,
        shard_batch,
    )
    from apollo_vision_net_tpu_torch.parallel.optim import make_optimizer
    from apollo_vision_net_tpu_torch.runtime.train_loop import step_seed

    dp, sp = mesh_shape(n)
    mesh = make_mesh(dp=dp, sp=sp, device=device)
    dev = mesh.device
    lines = []
    for cfg in (configs.bev_smoke_det_map(), configs.bev_smoke_det_occ()):
        if sp > 1:
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, bev_partition=("dp", "sp", None)))
        model = replicate(mesh, build_model(cfg, dev, seed=0).train())
        optimizer = make_optimizer(model, cfg.optim)
        batch = train_lib.batch_to_device(
            shard_batch(mesh, make_batch(cfg, n, seed=0)), dev)
        gen = torch.Generator(device=dev).manual_seed(step_seed(1, 0))
        losses = train_lib.make_train_step(mesh, cfg)(model, optimizer, batch, gen)
        total = float(losses["loss_total"])
        assert torch.isfinite(torch.tensor(total)), losses
        lines.append(f"dryrun_multichip({n}): ok [{cfg.name}], "
                     f"loss_total={total:.4f}, mesh={mesh.shape}, "
                     f"bev_partition={cfg.model.bev_partition}")
    return lines


def dryrun_multichip(n: int, device: str = "cuda") -> List[str]:
    """Run the dry run on ``n`` ranks; prints and returns rank 0's lines."""
    lines = spawn_world(n, dryrun_rank, n, device, device=device,
                        backend="gloo")[0]
    for line in lines:
        print(line, flush=True)
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the ranks on the cards, over gloo; several "
                        "ranks may share one) or 'cpu' (gloo processes)")
    a = p.parse_args(argv)
    dryrun_multichip(a.n, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
