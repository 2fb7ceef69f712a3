"""Streaming-inference state: scene reset and can_bus deltas.

Copy of ``StreamingState`` from the JAX package's data/temporal.py (reference
detectors/bevformer.py:375-409): the first frame of a scene gets
has_prev = 0 and zeroed deltas; later frames get position and yaw deltas
against the previous processed frame.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


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
