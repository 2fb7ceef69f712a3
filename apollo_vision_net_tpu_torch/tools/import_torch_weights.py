"""Import a torch pretrained backbone checkpoint into the port's trunk and
neck, and save their state dict.

Counterpart of the JAX package's tools/import_torch_weights.py (reference
mmcv ``load_checkpoint`` of ``pretrained=dict(img='ckpts/...pth')``), over
the port's ``utils.torch_import``: the config's trunk and neck are built
with the port's random init (``models.detector.init_weights``), the
checkpoint's tensors are name-mapped onto them (``apply_pretrained``: the
backbone always, the neck when the checkpoint carries an mmdet FPN), and
``img_backbone.*`` / ``img_neck.*`` are written with ``torch.save``; load
them into a model with ``load_state_dict(sd, strict=False)``, or give the
checkpoint to ``tools/train.py --pretrained`` directly. It prints the
import summary: the checkpoint's tensor count, the unused torch keys and
the tensors imported a subtree. It runs no forward.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.import_torch_weights ckpt.pth
      --config bev_base_det_map [--out trunk.pt]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Tuple

import torch
import torch.nn as nn

from apollo_vision_net_tpu_torch import configs


def import_weights(ckpt: str, cfg, seed: int = 0, log=print
                   ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """(the trunk and neck's state dict after the import, the summary
    lines, each also passed to ``log``)."""
    from apollo_vision_net_tpu_torch.models.detector import build_trunk, init_weights
    from apollo_vision_net_tpu_torch.utils.torch_import import (
        apply_pretrained,
        load_torch_state_dict,
    )

    lines: List[str] = []

    def say(line: str) -> None:
        lines.append(line)
        if log:
            log(line)

    with torch.device("meta"):
        trunk = nn.Module()
        trunk.img_backbone, trunk.img_neck = build_trunk(cfg)
    trunk = trunk.to_empty(device="cpu")
    init_weights(trunk, torch.Generator().manual_seed(seed))
    sd = load_torch_state_dict(ckpt)
    say(f"torch checkpoint: {len(sd)} tensors")
    apply_pretrained(trunk, sd, cfg.model.backbone_type, log=say)
    state = trunk.state_dict()
    n_bb = sum(k.startswith("img_backbone.") for k in state)
    say(f"imported img_backbone: {n_bb} leaves ({cfg.model.backbone_type})")
    if "[torch_import] imported img_neck (FPN)" in lines:
        n_neck = sum(k.startswith("img_neck.") for k in state)
        say(f"imported img_neck: {n_neck} leaves")
    return state, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ckpt")
    p.add_argument("--config", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    cfg = getattr(configs, args.config)()
    state, _ = import_weights(args.ckpt, cfg)
    if args.out:
        torch.save(state, args.out)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
