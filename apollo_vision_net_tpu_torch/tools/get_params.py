"""Parameter counts by submodule and the forward FLOPs of one streaming
frame, for a config, with no card.

Counterpart of the JAX package's tools/get_params.py (reference
tools/analysis_tools/get_params.py). The model is built on the ``meta``
device (``models.detector.meta_model``): counts come from
``named_parameters``, grouped by the first ``--depth`` parts of each name.
The FLOPs are those of ``BEVFormer.forward_test_frame`` on meta inputs
(batch 1, with history): ``torch.utils.flop_counter.FlopCounterMode``
counts the aten products and convolutions (2 per multiply-add), and the
front ends of the hand-written kernels, which the counter cannot see in a
ctypes call, add their kernels' operations from the shapes
(``ops.cost``: 8·D a sample for MSDA, every query counted, the tile
mask's skipped tiles included; 2·9·C·O a pixel for DCN). Elementwise work,
gathers, norms and softmaxes are not counted. XLA's ``cost_analysis``,
which the JAX tool reads, counts elementwise work too, so the two totals
are not the same definition.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.get_params [config] [--depth 2]
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Tuple

import torch

from apollo_vision_net_tpu_torch import configs


def parameter_groups(model: torch.nn.Module, depth: int) -> Tuple[int, Dict[str, int]]:
    """(total, {the first ``depth`` parts of a parameter's name: count})."""
    groups: Dict[str, int] = {}
    for name, p in model.named_parameters():
        g = ".".join(name.split(".")[:depth])
        groups[g] = groups.get(g, 0) + p.numel()
    return sum(groups.values()), groups


def count_flops(fn: Callable[[], object]) -> Dict[str, object]:
    """``fn`` run under FlopCounterMode and the kernels' tally:
    {"aten": the counter's total, "kernels": {entry: operations},
    "total": their sum}. The counter's module hooks need the parameters
    that ``fn`` uses frozen (``requires_grad_(False)``) or a graph to
    hook into."""
    from torch.utils.flop_counter import FlopCounterMode

    from apollo_vision_net_tpu_torch.ops import cost

    with cost.tally_kernel_operations() as tally, \
            FlopCounterMode(display=False) as counter:
        fn()
    aten = int(counter.get_total_flops())
    return {"aten": aten, "kernels": dict(tally),
            "total": aten + sum(tally.values())}


def frame_flops(cfg, model=None) -> Dict[str, object]:
    """``count_flops`` of one streaming frame with history, on meta inputs."""
    from apollo_vision_net_tpu_torch.models.detector import meta_model

    model = (model if model is not None else meta_model(cfg)).requires_grad_(False)
    m = cfg.model
    H, W = m.img_shape

    def meta(*shape):
        return torch.zeros(shape, device="meta")

    return count_flops(lambda: model.forward_test_frame(
        meta(1, m.num_cams, H, W, 3), meta(1, 18), meta(1, m.num_cams, 4, 4),
        model.zero_carry(1, "meta"), meta(1)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default="bev_tiny_det_map_apollo")
    p.add_argument("--depth", type=int, default=2,
                   help="module-tree depth for the breakdown")
    args = p.parse_args(argv)

    from apollo_vision_net_tpu_torch.models.detector import meta_model

    cfg = getattr(configs, args.config)()
    model = meta_model(cfg)
    total, groups = parameter_groups(model, args.depth)
    print(f"config: {cfg.name}")
    print(f"total params: {total:,} ({total / 1e6:.2f} M)")
    for g, n in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {n:12,}  {n / total * 100:5.1f}%  {g}")
    flops = frame_flops(cfg, model)
    kernels = ", ".join(f"{k} {v / 1e9:.2f}" for k, v in sorted(flops["kernels"].items()))
    print(f"forward FLOPs (1 frame): {flops['total']:.3e} "
          f"({flops['total'] / 1e9:.1f} GFLOP): aten products and convolutions "
          f"{flops['aten'] / 1e9:.1f}, kernels (GFLOP) {kernels or 'none'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
