"""Checkpoints of a training run: model, optimizer, update count, config.

Counterpart of the JAX package's runtime/checkpoint.py (orbax there): one
``torch.save`` file per saved step, ``ckpt_{step:08d}.pt`` under the run's
directory, holding the model's state_dict, the optimizer's state (AdamW
moments and the number of updates, which the schedule reads) and the
config's name, and beside it ``ckpt_{step:08d}.json``, the step's meta as
the JAX package's: the framework version, the config as a dict, the step
and the eval metrics saved with it. ``restore`` loads the newest (or a
given) step into a model (and optimizer) built from the same config and
returns that step.

Retention follows the JAX package's orbax options: without ``best_metric``
the newest ``MAX_TO_KEEP`` steps stay; with it (the trainer sets "NDS" when
it evaluates) the ``MAX_TO_KEEP`` steps with the highest metric stay, a
save without that metric counting as -1 and ties going to the newer step.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional

import torch

from apollo_vision_net_tpu_torch import __version__
from apollo_vision_net_tpu_torch.configs import ExperimentConfig

_NAME = re.compile(r"ckpt_(\d+)\.pt$")
MAX_TO_KEEP = 10


class CheckpointManager:
    def __init__(self, directory: str, best_metric: Optional[str] = None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric = best_metric

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.fullmatch(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def meta_path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.json")

    def meta(self, step: int) -> dict:
        with open(self.meta_path(step)) as f:
            return json.load(f)

    def _score(self, step: int) -> float:
        return float(self.meta(step)["metrics"].get(self.best_metric, -1.0))

    def save(self, step: int, model, optimizer, cfg: ExperimentConfig,
             metrics: Optional[Dict[str, float]] = None) -> str:
        # the meta first: a step counts (``steps``) once its .pt is in place
        meta = {"framework_version": __version__,
                "config": dataclasses.asdict(cfg), "step": step,
                "metrics": {k: float(v) for k, v in (metrics or {}).items()}}
        with open(self.meta_path(step) + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(self.meta_path(step) + ".tmp", self.meta_path(step))
        path = self.path(step)
        torch.save({"model": model.state_dict(),
                    "optimizer": optimizer.state_dict(),
                    "step": step, "config": cfg.name}, path + ".tmp")
        os.replace(path + ".tmp", path)
        steps = self.steps()
        if self.best_metric:
            steps = sorted(steps, key=lambda s: (self._score(s), s))
        for old in steps[:-MAX_TO_KEEP]:
            os.remove(self.path(old))
            os.remove(self.meta_path(old))
        return path

    def restore(self, model, optimizer=None, cfg: Optional[ExperimentConfig] = None,
                step: Optional[int] = None) -> int:
        """Load ``step`` (default: the newest) into ``model`` (and
        ``optimizer``, when given); returns the step. Raises if the
        checkpoint is of another config than ``cfg``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        dev = next(model.parameters()).device
        state = torch.load(self.path(step), map_location=dev, weights_only=True)
        if cfg is not None and state["config"] != cfg.name:
            raise ValueError(f"checkpoint of {state['config']}, not {cfg.name}")
        model.load_state_dict(state["model"], strict=True)
        if optimizer is not None:
            optimizer.load_state_dict(state["optimizer"])
        return int(state["step"])
