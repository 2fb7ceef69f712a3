"""Operators of the port: each front end runs its plain PyTorch version for
CPU tensors and its hand-written CUDA kernel for CUDA tensors.

``plain_versions()`` is the one explicit way to run the plain versions on
CUDA tensors too: a comparison of the kernels against them on the card
(``chip_smoke.py``, tests) enters it. No entry point does.
"""
from __future__ import annotations

import contextlib

import torch

_plain_depth = 0


@contextlib.contextmanager
def plain_versions():
    """Inside, every front end under ``ops`` runs its plain version whatever
    the device of its tensors."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def use_plain(t: torch.Tensor) -> bool:
    """True for a CPU tensor, or inside ``plain_versions()``."""
    return t.device.type == "cpu" or _plain_depth > 0

