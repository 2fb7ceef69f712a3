"""Debug-mode numerics probes: finite statistics and non-finite checks.

Copy of the JAX package's utils/debug.py (the reference's ``debug_nan``
probe-and-sanitize system: ``_finite_stats`` at the backbone, neck and
encoder boundaries, bevformer/detectors/bevformer.py:111-151,
bevformer/modules/transformer.py:134-149). The model calls ``probe`` at
``backbone.{i}``, ``neck.{i}`` (``BEVFormer.extract_img_feat``) and
``encoder.bev_embed`` (``PerceptionTransformer.get_bev_features``).

A disabled probe is the identity: it records nothing, launches no kernel
and reads nothing to the host, so the call sites cost nothing in a served
frame. An enabled one computes the finite ratio, the largest finite
magnitude and the mean over the finite values in f32 and reads them to the
host (a synchronization each), which is its job. JAX reads its enable flag
at trace time; eager PyTorch reads it at each call, so toggling takes
effect at once. Tests install a sink (``capture_probes``) to collect the
records instead of printing them.

``sanitize`` (the reference's ``nan_to_num`` guards) is opt-in and not on
any path.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import torch

_state = threading.local()


def _enabled() -> bool:
    return getattr(_state, "enabled", False)


def enable_probes(on: bool = True) -> None:
    """Globally enable or disable the probes of this thread."""
    _state.enabled = on


class capture_probes:
    """Context manager: enable probes and collect records into a list.

    Records are dicts ``{"name", "finite_ratio", "max_abs", "mean"}``,
    appended as each probed value is computed."""

    def __init__(self) -> None:
        self.records: List[Dict[str, float]] = []

    def __enter__(self) -> "capture_probes":
        self._prev_enabled = _enabled()
        self._prev_sink = getattr(_state, "sink", None)
        _state.enabled = True
        _state.sink = self.records.append
        return self

    def __exit__(self, *exc) -> None:
        _state.enabled = self._prev_enabled
        _state.sink = self._prev_sink


def finite_stats(x: torch.Tensor):
    """(finite_ratio, max_abs, mean over the finite values), f32 scalars on
    x's device: the reference's ``_finite_stats``."""
    xf = x.detach().float()
    finite = torch.isfinite(xf)
    ratio = finite.float().mean()
    safe = torch.where(finite, xf, torch.zeros((), device=xf.device))
    max_abs = safe.abs().max()
    mean = safe.sum() / finite.float().sum().clamp(min=1.0)
    return ratio, max_abs, mean


def _emit(name: str, ratio, max_abs, mean) -> None:
    rec = {"name": name, "finite_ratio": float(ratio),
           "max_abs": float(max_abs), "mean": float(mean)}
    sink: Optional[Callable] = getattr(_state, "sink", None)
    if sink is not None:
        sink(rec)
    else:
        print(f"[debug_nan] {name}: finite={rec['finite_ratio']:.4f} "
              f"max_abs={rec['max_abs']:.4e} mean={rec['mean']:.4e}")


def probe(name: str, x: torch.Tensor, *, force: bool = False) -> torch.Tensor:
    """Identity passthrough that reports ``finite_stats`` when probes are
    on (or ``force``); returns ``x`` itself either way."""
    if not (_enabled() or force):
        return x
    _emit(name, *torch.stack(finite_stats(x)).tolist())
    return x


def sanitize(x: torch.Tensor, limit: float = 1e4) -> torch.Tensor:
    """Opt-in analog of the reference's ``nan_to_num(posinf=...)`` guards."""
    return torch.nan_to_num(x, nan=0.0, posinf=limit, neginf=-limit)


def _float_leaves(out, path=""):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield path, out
    elif isinstance(out, dict):
        for k, v in out.items():
            yield from _float_leaves(v, f"{path}[{k!r}]")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            yield from _float_leaves(v, f"{path}[{i}]")


def assert_all_finite(fn: Callable) -> Callable:
    """Wrap ``fn`` so that a non-finite value in any floating tensor of its
    output (dicts, lists and tuples searched) raises ``FloatingPointError``
    naming the output's path, as ``jax.tree_util.keystr`` writes it."""

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        for path, leaf in _float_leaves(out):
            if not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError("non-finite values in output " + path)
        return out

    return wrapper
