"""Training loop on one device.

Counterpart of the JAX package's runtime/train_loop.py (the replacement of
the reference's mmcv Runner: custom_train_detector, TextLoggerHook /
DetMapTextLoggerHook with det and map losses on separate lines and ~0
losses hidden). ``train`` builds the model in training mode and its
optimizer, optionally resumes from the newest checkpoint of ``work_dir``,
takes ``num_steps`` steps (fewer if ``data_iter`` runs out), logs every
``log_interval`` steps and checkpoints every ``checkpoint_interval`` steps
and at the end. Dropout and the grid mask draw from a device generator
seeded from (seed, step), so a resumed run draws as an uninterrupted one.
Training from a pretrained backbone (``cfg.pretrained_path``) is not ported.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Iterable

import numpy as np
import torch

from apollo_vision_net_tpu_torch import resolve_device
from apollo_vision_net_tpu_torch.configs import ExperimentConfig
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.parallel.optim import make_optimizer
from apollo_vision_net_tpu_torch.runtime.checkpoint import CheckpointManager

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


def train(cfg: ExperimentConfig, data_iter: Iterable[Dict[str, np.ndarray]], *,
          num_steps: int, work_dir: str = "work_dirs/default", device=None,
          seed: int = 0, log_interval: int = 50,
          checkpoint_interval: int = 1000, resume: bool = False):
    """Train ``cfg`` from random weights (``seed``) on batches of
    make_batch's keys; returns (model, optimizer). ``device`` None means
    the GPU (raises without one); "cpu" runs the plain versions."""
    dev = resolve_device(device)
    model = build_model(cfg, dev, seed=seed).train()
    optimizer = make_optimizer(model, cfg.optim)
    ckpt = CheckpointManager(work_dir)
    start = 0
    if resume and ckpt.latest_step() is not None:
        start = ckpt.restore(model, optimizer, cfg)
        log.info("resumed from step %d", start)
    generator = torch.Generator(device=dev)
    data_iter = iter(data_iter)
    t0 = time.time()
    done = start
    for step in range(start, num_steps):
        try:
            batch = next(data_iter)
        except StopIteration:
            break
        generator.manual_seed(step_seed(seed, step))
        losses = train_lib.train_step(
            model, optimizer, train_lib.batch_to_device(batch, dev), generator,
            cfg=cfg)
        if (step + 1) % log_interval == 0 or step == start:
            dt = (time.time() - t0) / (step - start + 1)
            log.info("step %d/%d (%.2fs/it)\n  %s", step + 1, num_steps, dt,
                     format_losses({k: float(v) for k, v in losses.items()}))
        done = step + 1
        if done % checkpoint_interval == 0:
            ckpt.save(done, model, optimizer, cfg)
    if done > start and done % checkpoint_interval:
        ckpt.save(done, model, optimizer, cfg)
    return model, optimizer
