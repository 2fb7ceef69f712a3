"""Pretrained backbones and FPNs from mmdet/torch state dicts.

Counterpart of the JAX package's utils/torch_import.py. Every reference
config trains from pretrained image weights: mmcv ``load_checkpoint``
consumes ``pretrained=dict(img=...)`` state dicts (reference
projects/configs/bevformer/bev_tiny_det_map_apollo.py:91, bev_base_occ.py
R101-DCN FCOS3D, DD3D's V2-99). This module maps those state dicts onto
the port's ResNet (mmdet naming, DCNv2 blocks), DLA-34 (reference
models/backbones/dla.py naming), VoVNet (reference models/backbones/
vovnet.py naming) and FPN (mmdet naming) modules:

- convs are OIHW on both sides and copy straight across; BatchNorm's
  weight, bias, running_mean and running_var fill FrozenBatchNorm's
  tensors of the same names (``num_batches_tracked`` is ignored);
- the port keeps the JAX layout where the JAX package has its own: the
  mmdet DCNv2 block's ``conv2.weight`` (O, I, 3, 3) becomes
  ``conv2_dcn_weight`` (9, I, O), taps row-major over (ky, kx) as mmcv
  indexes them, and ``conv2.conv_offset``'s output channels are permuted
  from mmcv's (dy, dx) pairs to the (dx, dy) pairs that ops/dcn.py
  consumes (the 9 mask channels map 1:1, pre-sigmoid on both sides).

The mapping walks the port module's own ``state_dict()`` keys, as the JAX
version walks the flax tree: every tensor must find its torch source
(missing keys raise with the full list), every one is shape-checked, and
the torch keys left unused are returned (a full detector's head keys are
expected leftovers). InternImage has no importer, as in the JAX package.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Tuple

import torch

Converter = Callable[[torch.Tensor], torch.Tensor]
Rule = Tuple[str, Converter]

def _ident(t: torch.Tensor) -> torch.Tensor:
    return t


def _dcn_w(t: torch.Tensor) -> torch.Tensor:
    # (O, I, kh, kw) -> (kh*kw, I, O), taps row-major (ky, kx)
    o, i, kh, kw = t.shape
    return t.permute(2, 3, 1, 0).reshape(kh * kw, i, o).contiguous()


def dcn_offset_perm(k: int = 9) -> torch.Tensor:
    """Output-channel permutation mmcv -> port: mmcv's offset conv emits
    (dy_0, dx_0, ..., dy_8, dx_8, m_0..m_8); ops/dcn.py consumes (dx, dy)
    pairs, then the masks."""
    perm = torch.arange(3 * k)
    perm[0:2 * k:2], perm[1:2 * k:2] = perm[1:2 * k:2].clone(), perm[0:2 * k:2].clone()
    return perm


def _dcn_offset(t: torch.Tensor) -> torch.Tensor:
    return t[dcn_offset_perm(t.shape[0] // 3)].contiguous()


def resnet_rule(key: str) -> Rule:
    """mmdet/torchvision ResNet: conv1, bn1, layer{s}.{b}.conv{1-3} / bn{1-3},
    downsample.0 / .1; a DCN block's conv2.weight and conv2.conv_offset."""
    module, leaf = key.rsplit(".", 1)
    if module == "stem_conv":
        return f"conv1.{leaf}", _ident
    if module == "stem_bn":
        return f"bn1.{leaf}", _ident
    m = re.fullmatch(r"layer(\d)_(\d+)(?:\.(\w+))?", module)
    if m is None:
        raise KeyError(f"resnet: unmapped port tensor {key}")
    tp = f"layer{m.group(1)}.{m.group(2)}"
    inner = m.group(3)
    if inner is None and leaf == "conv2_dcn_weight":
        return f"{tp}.conv2.weight", _dcn_w
    if inner == "conv2_offset":
        return f"{tp}.conv2.conv_offset.{leaf}", _dcn_offset
    if inner == "downsample_conv":
        return f"{tp}.downsample.0.{leaf}", _ident
    if inner == "downsample_bn":
        return f"{tp}.downsample.1.{leaf}", _ident
    if inner is not None and re.fullmatch(r"(conv|bn)[123]", inner):
        return f"{tp}.{inner}.{leaf}", _ident
    raise KeyError(f"resnet: unmapped port tensor {key}")


def dla_rule(key: str) -> Rule:
    """Reference DLA: base_layer, level0.0, level1.0, level{2-5} trees of
    tree1 / tree2 / root / project, each norm attached to its conv as
    ``<conv>.norm``."""
    module, leaf = key.rsplit(".", 1)
    names = module.split(".")
    last = names[-1]
    if module == "base_conv":
        return f"base_layer.{leaf}", _ident
    if module == "base_bn":
        return f"base_layer.norm.{leaf}", _ident
    m = re.fullmatch(r"level([01])_(conv|bn)", module)
    if m:
        return f"level{m.group(1)}.0{'.norm' if m.group(2) == 'bn' else ''}.{leaf}", _ident
    if not re.fullmatch(r"level[2-5]", names[0]):
        raise KeyError(f"dla: unmapped port tensor {key}")
    prefix = ".".join(names[:-1])
    if last in ("conv1", "conv2") or (last == "conv" and names[-2] == "root"):
        return f"{module}.{leaf}", _ident
    if re.fullmatch(r"bn[12]", last):
        return f"{prefix}.conv{last[2:]}.norm.{leaf}", _ident
    if last == "bn" and names[-2] == "root":
        return f"{prefix}.conv.norm.{leaf}", _ident
    if last == "project_conv":
        return f"{prefix}.project.{leaf}", _ident
    if last == "project_bn":
        return f"{prefix}.project.norm.{leaf}", _ident
    raise KeyError(f"dla: unmapped port tensor {key}")


def vovnet_rule(key: str) -> Rule:
    """Reference VoVNet ('/'-joined OrderedDict names): stem.stem_{i}/conv
    and /norm, stage{s}.OSA{s}_{b}.layers.{i}.OSA{s}_{b}_{i}/conv and /norm,
    .concat.OSA{s}_{b}_concat/conv and /norm, .ese.fc."""
    module, leaf = key.rsplit(".", 1)
    m = re.fullmatch(r"stem(\d)_(conv|bn)", module)
    if m:
        part = "conv" if m.group(2) == "conv" else "norm"
        return f"stem.stem_{m.group(1)}/{part}.{leaf}", _ident
    m = re.fullmatch(r"stage(\d)_osa(\d+)\.(\w+?)(?:\.(\w+))?", module)
    if m is None:
        raise KeyError(f"vovnet: unmapped port tensor {key}")
    s, b, inner, sub = m.group(1), int(m.group(2)), m.group(3), m.group(4)
    mod = f"OSA{s}_{b + 1}"
    tp = f"stage{s}.{mod}"
    if inner == "ese" and sub == "fc":
        return f"{tp}.ese.fc.{leaf}", _ident
    m = re.fullmatch(r"osa(\d+)_(conv|bn)|concat_(conv|bn)", inner)
    if m is None or sub is not None:
        raise KeyError(f"vovnet: unmapped port tensor {key}")
    kind = m.group(2) or m.group(3)
    part = "conv" if kind == "conv" else "norm"
    if m.group(1) is not None:
        i = m.group(1)
        return f"{tp}.layers.{i}.{mod}_{i}/{part}.{leaf}", _ident
    return f"{tp}.concat.{mod}_concat/{part}.{leaf}", _ident


def fpn_rule(key: str) -> Rule:
    """mmdet FPN: lateral_convs.{i}.conv, fpn_convs.{i}.conv; the extra
    'on_output' convs continue the fpn_convs index."""
    module, leaf = key.rsplit(".", 1)
    m = re.fullmatch(r"(lateral|fpn_conv|extra_conv)_(\d+)", module)
    if m is None:
        raise KeyError(f"fpn: unmapped port tensor {key}")
    group = "lateral_convs" if m.group(1) == "lateral" else "fpn_convs"
    return f"{group}.{m.group(2)}.conv.{leaf}", _ident


BACKBONE_RULES = {"resnet": resnet_rule, "dla": dla_rule, "vovnet": vovnet_rule}
RULES = {**BACKBONE_RULES, "fpn": fpn_rule}


@torch.no_grad()
def import_module_params(module: torch.nn.Module,
                         state_dict: Dict[str, torch.Tensor], kind: str) -> List[str]:
    """Fill ``module``'s tensors from a torch ``state_dict`` in place;
    returns the unused torch keys (``num_batches_tracked`` aside). A port
    tensor without its torch source raises (all of them listed), and so
    does a shape that does not fit."""
    rule = RULES[kind]
    updates, used, missing = [], set(), []
    for key, target in module.state_dict().items():
        tkey, convert = rule(key)
        if tkey not in state_dict:
            missing.append((key, tkey))
            continue
        w = convert(state_dict[tkey].detach().to("cpu", torch.float32))
        used.add(tkey)
        if tuple(w.shape) != tuple(target.shape):
            raise ValueError(f"{kind}: shape mismatch at {key}: torch {tkey} -> "
                             f"{tuple(w.shape)}, port expects {tuple(target.shape)}")
        updates.append((target, w))
    if missing:
        lines = "\n".join(f"  {k} <- {t}" for k, t in missing)
        raise KeyError(f"{kind}: torch keys missing for port tensors:\n{lines}")
    # nothing is written until every tensor has its source and shape
    for target, w in updates:
        target.copy_(w)
    return sorted(k for k in state_dict
                  if k not in used and not k.endswith("num_batches_tracked"))


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """torch.load a checkpoint (on the CPU) and flatten it to {name: f32
    tensor}: unwraps 'state_dict' / 'model' containers and strips
    'module.' prefixes (the mmcv save format)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model"):
        if isinstance(ckpt, dict) and isinstance(ckpt.get(key), dict):
            ckpt = ckpt[key]
            break
    out = {}
    for k, v in ckpt.items():
        if not isinstance(v, torch.Tensor):
            continue
        out[k.removeprefix("module.")] = v.detach().cpu().float()
    return out


def split_prefix(state_dict: Dict[str, torch.Tensor],
                 prefix: str) -> Dict[str, torch.Tensor]:
    """Sub-dict of keys under ``prefix.`` with the prefix stripped."""
    p = prefix + "."
    return {k[len(p):]: v for k, v in state_dict.items() if k.startswith(p)}


def apply_pretrained(model: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
                     backbone_type: str, log=print) -> None:
    """Fill ``model.img_backbone`` (and ``model.img_neck`` when the
    checkpoint carries a neck, as an mmdet FPN) in place. A full detector's
    checkpoint (FCOS3D, Mask R-CNN) nests the trunk under ``img_backbone.``
    or ``backbone.``; a bare backbone dump does not."""
    sd = state_dict
    for pfx in ("img_backbone", "backbone"):
        if any(k.startswith(pfx + ".") for k in sd):
            bb_sd = split_prefix(sd, pfx)
            break
    else:
        bb_sd = sd
    if backbone_type not in BACKBONE_RULES:
        raise KeyError(f"no pretrained importer for backbone {backbone_type!r}")
    unused = import_module_params(model.img_backbone, bb_sd, backbone_type)
    if unused and log:
        log(f"[torch_import] {len(unused)} unused backbone keys "
            f"(head/aux params are expected leftovers), e.g. {unused[:5]}")
    for pfx in ("img_neck", "neck"):
        if any(k.startswith(pfx + ".") for k in sd):
            import_module_params(model.img_neck, split_prefix(sd, pfx), "fpn")
            if log:
                log("[torch_import] imported img_neck (FPN)")
            break
