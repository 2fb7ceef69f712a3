"""Temporal queue sampling, can_bus delta bookkeeping and the streaming
state.

Copy of the JAX package's data/temporal.py (reference
datasets/nuscenes_dataset.py, detectors/bevformer.py):
- ``sample_queue_indices`` (:98-138): ``queue_length`` consecutive indices
  with one random drop, in temporal order;
- ``union2one_can_bus`` (:140-178): each queue frame's can_bus rewritten
  into deltas against the previous frame; a frame where the scene changes
  (or the queue starts) gets has_prev = 0 and zeroed deltas;
- ``StreamingState`` (bevformer.py:375-409): the same for the streaming
  step, against the previous processed frame.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


def sample_queue_indices(index: int, queue_length: int,
                         rng: np.random.Generator) -> List[int]:
    """Reference :98-108: take queue_length-1 predecessors, randomly drop
    one of them, keep temporal order, append the current index."""
    prev = list(range(max(index - queue_length, 0), index))
    if len(prev) > queue_length - 1:
        keep = sorted(rng.choice(len(prev), queue_length - 1, replace=False))
        prev = [prev[k] for k in keep]
    while len(prev) < queue_length - 1:
        prev = [prev[0] if prev else index] + prev
    return prev + [index]


def union2one_can_bus(
    can_bus_list: Sequence[np.ndarray],
    scene_tokens: Sequence[str],
) -> Dict[str, np.ndarray]:
    """Rewrite each frame's can_bus into deltas vs the previous frame.

    Returns {'can_bus': (T, 18), 'has_prev': (T,)} — exactly the reference's
    union2one bookkeeping (:140-178): the first frame (or a scene change)
    gets has_prev=0 and zeroed position/angle deltas; other frames get
    can_bus[:3] -= prev_pos, can_bus[-1] -= prev_angle.
    """
    T = len(can_bus_list)
    out = np.stack([np.array(cb, np.float32) for cb in can_bus_list])
    has_prev = np.zeros((T,), np.float32)
    prev_scene = None
    prev_pos = None
    prev_angle = None
    for t in range(T):
        cur_pos = out[t, :3].copy()
        cur_angle = out[t, -1].copy()
        if scene_tokens[t] != prev_scene:
            has_prev[t] = 0.0
            out[t, :3] = 0.0
            out[t, -1] = 0.0
        else:
            has_prev[t] = 1.0
            out[t, :3] -= prev_pos
            out[t, -1] -= prev_angle
        prev_scene = scene_tokens[t]
        prev_pos, prev_angle = cur_pos, cur_angle
    return {"can_bus": out, "has_prev": has_prev}


@dataclasses.dataclass
class StreamingState:
    """Host-side carried state for stateful eval (bevformer.py:68-73,
    375-409)."""
    prev_bev: Optional[Any] = None
    prev_pos: Optional[np.ndarray] = None
    prev_angle: Optional[float] = None
    scene_token: Optional[str] = None

    def prepare_frame(self, can_bus: np.ndarray, scene_token: str):
        """Returns (can_bus_delta (18,), has_prev float) and updates state
        for the next frame. Mirrors forward_test :382-408."""
        cb = np.array(can_bus, np.float32).copy()
        cur_pos = cb[:3].copy()
        cur_angle = float(cb[-1])
        if scene_token != self.scene_token or self.prev_bev is None:
            has_prev = 0.0
            cb[:3] = 0.0
            cb[-1] = 0.0
        else:
            has_prev = 1.0
            cb[:3] -= self.prev_pos
            cb[-1] -= self.prev_angle
        self.scene_token = scene_token
        self.prev_pos = cur_pos
        self.prev_angle = cur_angle
        return cb, has_prev

    def update(self, new_prev_bev) -> None:
        self.prev_bev = new_prev_bev
