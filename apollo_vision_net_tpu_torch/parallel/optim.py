"""Optimizer: AdamW with parameter groups, global-norm clip, warmup + cosine.

Counterpart of the JAX package's parallel/optim.py (reference AdamW lr 2e-4,
weight decay 0.01, ``img_backbone`` lr_mult 0.1, grad clip max_norm 35,
linear warmup over 500 iterations from ratio 1/3, then cosine annealing to
min_lr_ratio 1e-3; bev_tiny_det.py:236-258), following optax:

- the clip scales every gradient by max_norm / norm where the global L2
  norm over ALL parameters reaches max_norm (optax.clip_by_global_norm),
  frozen ones included;
- ``torch.optim.AdamW`` (fused) in two groups, "main" and "backbone"
  (lr x backbone_lr_mult): the same update as optax.adamw, decaying every
  parameter of a group, biases and norms included; a parameter without a
  gradient gets a zero one, as every leaf of optax's tree is updated.
  AdamW keeps the bias corrections 1 - b^t in f64 where optax rounds them
  to f32 (f32(0.999) is 0.99900001), which moves an update by up to ~1e-5
  relative;
- frozen parameters (``param_label`` = "frozen": the JAX package's rule on
  the module path, e.g. every BN of the image backbone) are in no group:
  a zero update and no decay. Their gradients still enter the clip's norm,
  as in the JAX package, where FrozenBatchNorm's statistics are flax
  params; the reference (mmcv) instead sets requires_grad=False on them.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List

import torch
import torch.nn as nn

from apollo_vision_net_tpu_torch.configs import OptimConfig


def _is_frozen(path_s: str) -> bool:
    # all BN params (any *_bn/bnN module) + stem + stage 1, backbone only
    if "img_backbone" in path_s:
        if "/bn" in path_s or "_bn" in path_s or "downsample_bn" in path_s:
            return True
        if "stem_" in path_s or "layer1_" in path_s:
            return True
    return False


def param_label(name: str) -> str:
    """"frozen", "backbone" or "main" for a parameter's dotted name; the
    module names follow the flax tree, so the JAX package's rule applies to
    the name with "/" for ".". On DLA only the BN parameters match."""
    path_s = name.replace(".", "/")
    if _is_frozen(path_s):
        return "frozen"
    return "backbone" if "img_backbone" in path_s else "main"


def make_schedule(lr: float, warmup_iters: int, warmup_ratio: float,
                  min_lr_ratio: float, total_steps: int) -> Callable[[int], float]:
    """The learning rate of update ``step`` (0 for the first), as
    optax.join_schedules of a linear warmup from lr * warmup_ratio over
    warmup_iters steps and a cosine decay to lr * min_lr_ratio over the
    remaining total_steps - warmup_iters."""
    warm = max(warmup_iters, 1)
    decay = max(total_steps - warmup_iters, 1)

    def schedule(step: int) -> float:
        if step < warmup_iters:
            frac = 1.0 - min(max(step, 0), warm) / warm
            return (lr * warmup_ratio - lr) * frac + lr
        count = min(step - warmup_iters, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return lr * ((1.0 - min_lr_ratio) * cosine + min_lr_ratio)

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / norm where their global L2
    norm is at least max_norm (optax.clip_by_global_norm); returns the norm
    (on the device, no host synchronization)."""
    norm = torch.nn.utils.get_total_norm(grads, norm_type=2.0)
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """``torch.optim.AdamW`` (fused) over the "main" and "backbone" groups
    of ``model``, the clip over every parameter that requires a gradient,
    and the schedule. ``step()`` runs one update from the gradients that
    ``backward`` left; ``steps`` counts the updates made."""

    def __init__(self, model: nn.Module, cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = make_schedule(cfg.lr, cfg.warmup_iters, cfg.warmup_ratio,
                                      cfg.min_lr_ratio, cfg.total_steps)
        self.params = [p for p in model.parameters() if p.requires_grad]
        groups: Dict[str, List[torch.Tensor]] = {"main": [], "backbone": []}
        for name, p in model.named_parameters():
            label = param_label(name)
            if p.requires_grad and label != "frozen":
                groups[label].append(p)
        mults = {"main": 1.0, "backbone": cfg.backbone_lr_mult}
        # optax.adamw's defaults, which the JAX package keeps
        self.adamw = torch.optim.AdamW(
            [{"params": ps, "lr_mult": mults[k]} for k, ps in groups.items() if ps],
            lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=cfg.weight_decay, fused=True)
        self.steps = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, then one AdamW update at the schedule's rate; returns the
        gradient norm before the clip."""
        for p in self.params:
            if p.grad is None:  # optax updates (and decays) every leaf
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params],
                                    self.cfg.grad_clip_norm)
        lr = self.schedule(self.steps)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.adamw.step()
        self.steps += 1
        return norm

    def state_dict(self) -> dict:
        return {"adamw": self.adamw.state_dict(), "steps": self.steps}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.steps = int(state["steps"])


def make_optimizer(model: nn.Module, cfg: OptimConfig) -> Optimizer:
    return Optimizer(model, cfg)
