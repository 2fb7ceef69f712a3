"""Checkpoints of a training run: model, optimizer, update count, config.

Counterpart of the JAX package's runtime/checkpoint.py (orbax there): one
``torch.save`` file per saved step, ``ckpt_{step:08d}.pt`` under the run's
directory, holding the model's state_dict, the optimizer's state (AdamW
moments and the number of updates, which the schedule reads) and the
config's name; ``restore`` loads the newest (or a given) step into a model
and optimizer built from the same config and returns that step. The newest
``MAX_TO_KEEP`` files are kept, as the JAX package's manager keeps them.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from apollo_vision_net_tpu_torch.configs import ExperimentConfig

_NAME = re.compile(r"ckpt_(\d+)\.pt$")
MAX_TO_KEEP = 10


class CheckpointManager:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.fullmatch(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def save(self, step: int, model, optimizer, cfg: ExperimentConfig) -> str:
        path = self.path(step)
        tmp = path + ".tmp"
        torch.save({"model": model.state_dict(),
                    "optimizer": optimizer.state_dict(),
                    "step": step, "config": cfg.name}, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-MAX_TO_KEEP]:
            os.remove(self.path(old))
        return path

    def restore(self, model, optimizer, cfg: ExperimentConfig,
                step: Optional[int] = None) -> int:
        """Load ``step`` (default: the newest) into ``model`` and
        ``optimizer``; returns the step. Raises if the checkpoint is of
        another config."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        dev = next(model.parameters()).device
        state = torch.load(self.path(step), map_location=dev, weights_only=True)
        if state["config"] != cfg.name:
            raise ValueError(f"checkpoint of {state['config']}, not {cfg.name}")
        model.load_state_dict(state["model"], strict=True)
        optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])
