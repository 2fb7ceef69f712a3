"""Structured per-step metrics stream.

Copy of the JAX package's runtime/metrics_log.py, the replacement for the
reference's TextLogger + TensorboardLogger pair
(projects/configs/_base_/default_runtime.py:6-11): every scalar a run
produces (training losses, learning rate, step time, eval metrics) lands in
one append-only jsonl stream (``<work_dir>/metrics.jsonl``), each record
tagged with its kind; ``read_metrics`` parses it back. jsonl because it is
greppable, diffable and needs no reader library.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only jsonl scalar stream with a `kind` tag per record."""

    def __init__(self, work_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, filename)
        self._f = open(self.path, "a")
        self._t0 = time.time()

    def log(self, kind: str, step: int, scalars: Dict[str, float],
            **extra) -> None:
        rec = {
            "kind": kind,
            "step": int(step),
            "wall_time": round(time.time() - self._t0, 3),
            **{k: float(v) for k, v in scalars.items()},
            **extra,
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def read_metrics(path: str, kind: Optional[str] = None):
    """Parse a metrics.jsonl (or a directory containing one)."""
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.jsonl")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out
