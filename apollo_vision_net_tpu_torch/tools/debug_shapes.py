"""Shape tracer: every input, the parameter count and every output shape of
one forward, on the ``meta`` device.

Counterpart of the JAX package's tools/debug_shapes.py (reference
tools/debug_shapes_v1mini.py), which traces with ``jax.eval_shape``. Here
the model is built on the meta device (``models.detector.meta_model``) and
the training forward runs in eval mode over a meta copy of the config's
synthetic batch: every shape is computed, no storage is allocated and no
device time is spent, so full-size configs run on any machine. Where an op
of the forward has no meta kernel, or reads a value to the host, the tool
fails and names it.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.debug_shapes [config]
"""
from __future__ import annotations

import argparse

import torch

from apollo_vision_net_tpu_torch import configs

FORWARD_INPUTS = ("img", "can_bus", "lidar2img", "has_prev")


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def trace_shapes(cfg, batch_size: int = 1) -> dict:
    """{"inputs": {key: (shape, dtype)} of the config's synthetic batch,
    "params": the parameter count, "outputs": {key: (shape, dtype)} of the
    training forward in eval mode}, all on the meta device, keys sorted."""
    from apollo_vision_net_tpu_torch.data.synthetic import make_batch
    from apollo_vision_net_tpu_torch.models.detector import meta_model

    batch = make_batch(cfg, batch_size, seed=0)
    model = meta_model(cfg)
    args = [torch.empty(batch[k].shape, device="meta") for k in FORWARD_INPUTS]
    try:
        with torch.no_grad():
            outs = model(*args)
    except (NotImplementedError, RuntimeError) as e:
        raise RuntimeError(
            f"{cfg.name}: an op of the forward has no meta kernel or reads a "
            f"value to the host: {e}") from e
    # keys sorted, the order of the JAX tool's pytrees
    return {"inputs": {k: (tuple(batch[k].shape), _dtype(batch[k].dtype))
                       for k in sorted(batch)},
            "params": sum(p.numel() for p in model.parameters()),
            "outputs": {k: (tuple(outs[k].shape), _dtype(outs[k].dtype))
                        for k in sorted(outs) if outs[k] is not None}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default="bev_smoke_det")
    args = p.parse_args(argv)
    cfg = getattr(configs, args.config)()
    res = trace_shapes(cfg)
    print(f"== {cfg.name} ==")
    for k, (shape, dtype) in res["inputs"].items():
        print(f"input {k:16s} {shape} {dtype}")
    print(f"params: {res['params'] / 1e6:.2f} M")
    for k, (shape, dtype) in res["outputs"].items():
        print(f"output {k:22s} {shape} {dtype}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
