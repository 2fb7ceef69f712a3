"""Training loop on one device or on a process mesh.

Counterpart of the JAX package's runtime/train_loop.py (the replacement of
the reference's mmcv Runner: custom_train_detector, TextLoggerHook /
DetMapTextLoggerHook with det and map losses on separate lines and ~0
losses hidden). ``train`` builds the model in training mode and its
optimizer, imports the pretrained backbone (and FPN) of
``cfg.pretrained_path`` when the config names one (the reference's
``pretrained=dict(img=...)``), optionally resumes from the newest
checkpoint of ``work_dir``, takes ``num_steps`` steps (fewer if
``data_iter`` runs out), logs every ``log_interval`` steps to the console
and to ``<work_dir>/metrics.jsonl`` (``train`` records: the loss terms,
``sec_per_it`` as the JAX package's (the mean since the run started), and
over the steps since the last record ``step_s``, a step's seconds, and
``data_wait_s``, the part of them it waited for its batch; ``eval``
records), runs ``eval_fn`` every ``eval_interval`` steps and checkpoints
every ``checkpoint_interval`` steps and at the last step, with the eval
metrics (the best by NDS are kept when the run evaluates). Dropout and the
grid mask draw from a device generator seeded from (seed, step), so a
resumed run draws as an uninterrupted one.

With a ``mesh`` (parallel/mesh.py; the counterpart of the JAX loop's
``make_mesh()`` and ``shard_batch_pytree``) the function runs on every rank
of a multi-GPU run: ``data_iter`` yields the rank's rows of each global
batch, the model starts from rank 0's weights, the step is
``parallel.train.make_train_step`` (the loss of the global batch, the
gradients averaged over the world), every rank seeds its generator alike,
``resume`` restores on every rank, and rank 0 alone logs, evaluates and
writes checkpoints and ``metrics.jsonl``.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from apollo_vision_net_tpu_torch import resolve_device
from apollo_vision_net_tpu_torch.configs import ExperimentConfig
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.parallel.mesh import Mesh, replicate
from apollo_vision_net_tpu_torch.parallel.optim import make_optimizer
from apollo_vision_net_tpu_torch.runtime.checkpoint import CheckpointManager
from apollo_vision_net_tpu_torch.runtime.metrics_log import MetricsLogger

log = logging.getLogger("avnet")


def format_losses(losses: Dict[str, float], hide_zero: bool = True) -> str:
    """DetMapTextLoggerHook-style grouping: det losses, then map, then occ;
    near-zero (disabled) terms hidden."""
    groups = {"det": [], "map": [], "occ": [], "other": []}
    for k in sorted(losses):
        v = float(losses[k])
        if hide_zero and abs(v) < 1e-8 and k != "loss_total":
            continue
        g = ("map" if "map" in k else
             "occ" if any(t in k for t in ("occ", "lovasz", "scal", "flow"))
             else "det" if "loss" in k else "other")
        groups[g].append(f"{k}={v:.4f}")
    lines = [" ".join(groups[g]) for g in ("det", "map", "occ", "other")
             if groups[g]]
    return "\n  ".join(lines)


def step_seed(seed: int, step: int) -> int:
    """The generator seed of one step (the counterpart of fold_in)."""
    return (seed + 1) * 1_000_003 + step


def load_pretrained(model, cfg: ExperimentConfig) -> None:
    """Import the image backbone (and an FPN neck the checkpoint carries)
    of the torch checkpoint at ``cfg.pretrained_path`` into ``model``."""
    from apollo_vision_net_tpu_torch.utils.torch_import import (
        apply_pretrained,
        load_torch_state_dict,
    )

    apply_pretrained(model, load_torch_state_dict(cfg.pretrained_path),
                     cfg.model.backbone_type,
                     log=lambda *a: log.info(" ".join(str(x) for x in a)))
    log.info("loaded pretrained backbone weights from %s", cfg.pretrained_path)


def train(cfg: ExperimentConfig, data_iter: Iterable[Dict[str, np.ndarray]], *,
          num_steps: int, work_dir: str = "work_dirs/default", device=None,
          seed: int = 0, log_interval: int = 50,
          checkpoint_interval: int = 1000,
          eval_fn: Optional[Callable] = None, eval_interval: int = 0,
          resume: bool = False, mesh: Optional[Mesh] = None):
    """Train ``cfg`` from random weights (``seed``; the backbone from
    ``cfg.pretrained_path`` when set) on batches of make_batch's keys;
    returns (model, optimizer). ``eval_fn(model)`` (the model in eval mode)
    returns a metrics dict. ``device`` None means the GPU (raises without
    one); "cpu" runs the plain versions. With ``mesh``, the run's rank on
    the mesh's device (see the module docstring)."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    lead = mesh is None or mesh.rank == 0
    model = build_model(cfg, dev, seed=seed).train()
    if cfg.pretrained_path:
        load_pretrained(model, cfg)
    if mesh is not None:
        replicate(mesh, model)
    optimizer = make_optimizer(model, cfg.optim)
    ckpt = CheckpointManager(work_dir, best_metric="NDS" if eval_fn else None)
    mlog = MetricsLogger(work_dir) if lead else None
    start = 0
    if resume and ckpt.latest_step() is not None:
        start = ckpt.restore(model, optimizer, cfg)
        log.info("resumed from step %d", start)
    step_fn = train_lib.make_train_step(mesh, cfg)
    generator = torch.Generator(device=dev)
    data_iter = iter(data_iter)
    t0 = t_window = time.time()
    wait, window = 0.0, 0
    done = start
    metrics = None
    try:
        for step in range(start, num_steps):
            t_wait = time.time()
            try:
                batch = next(data_iter)
            except StopIteration:
                break
            wait += time.time() - t_wait
            generator.manual_seed(step_seed(seed, step))
            losses = step_fn(model, optimizer,
                             train_lib.batch_to_device(batch, dev), generator)
            done, window = step + 1, window + 1
            if lead and (done % log_interval == 0 or step == start):
                losses = {k: float(v) for k, v in losses.items()}
                now = time.time()
                dt = (now - t0) / (done - start)
                log.info("step %d/%d (%.2fs/it)\n  %s", done, num_steps, dt,
                         format_losses(losses))
                mlog.log("train", done, losses, sec_per_it=round(dt, 4),
                         step_s=(now - t_window) / window,
                         data_wait_s=wait / window)
                t_window, wait, window = now, 0.0, 0
            if not lead:
                continue
            metrics = None
            if eval_fn and eval_interval and done % eval_interval == 0:
                metrics = run_eval(eval_fn, model)
                log.info("eval @%d: %s", done, metrics)
                mlog.log("eval", done, {k: v for k, v in metrics.items()
                                        if isinstance(v, (int, float))})
            if done % checkpoint_interval == 0 or done == num_steps:
                ckpt.save(done, model, optimizer, cfg, metrics)
        if (lead and done > start and done % checkpoint_interval
                and done != num_steps):
            ckpt.save(done, model, optimizer, cfg, metrics)
    finally:
        if mlog is not None:
            mlog.close()
    return model, optimizer


def run_eval(eval_fn: Callable, model) -> dict:
    """``eval_fn(model)`` with the model in eval mode, back in training
    mode after."""
    model.eval()
    try:
        return eval_fn(model)
    finally:
        model.train()
