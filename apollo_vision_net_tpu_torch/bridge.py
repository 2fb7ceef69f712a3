"""Weights carried across from the JAX package: flax params -> state_dict.

``state_dict_from_flax(params)`` takes the JAX model's param tree as a
nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``) and
returns a ``state_dict`` that the port's model loads with ``strict=True``.
The port's modules are named after the flax tree, so a flax path maps to a
torch key by joining its names with dots, after these rewrites:

- ``nn.scan`` stacks (``encoder/layers``, ``decoder/layers``,
  ``map_decoder/layers``) are unstacked along axis 0 into the ModuleLists:
  ``layers/layer/...`` -> ``layers.{i}...`` and
  ``layers/reg_branch/...`` -> ``reg_branches.{i}...``;
- ``cls_branch{i}`` / ``map_cls_branch{i}`` -> ``cls_branches.{i}`` /
  ``map_cls_branches.{i}``; MapTRv2's ``map_layer{i}`` /
  ``map_reg_branch{i}`` -> ``map_layers.{i}`` / ``map_reg_branches.{i}``;
- Dense kernels (in, out) -> Linear weights (out, in);
- Conv kernels HWIO -> OIHW (MapTRv2's segmentation heads' ``Conv_0``
  and ``Conv_1`` too; InternImage's depthwise ``dw_conv``, (3, 3, 1, C) ->
  (C, 1, 3, 3), by the same rule); ``nn.ConvTranspose`` kernels (k, k, in, out)
  are flipped spatially (flax does not flip, torch does) -> (in, out, k, k).
  A 4-D kernel is a transposed convolution's when its flax module is one:
  named ``*_up`` (SECONDFPNV2's deblocks) or auto-named ``ConvTranspose_{i}``
  (the occupancy head's upsampling). A square kernel fits either layout,
  so ``strict=True`` loading cannot catch the wrong one;
- flax MHA ``query/key/value`` kernels (C, H, D) and biases (H, D), and the
  ``out`` kernel (H, D, C), flatten to (H·D)-wide Linear layers;
- norm ``scale`` -> ``weight``; FrozenBatchNorm ``mean``/``var`` ->
  ``running_mean``/``running_var``;
- every other leaf keeps its name and layout, e.g. conv biases and the
  ResNet DCN weight ``conv2_dcn_weight`` (9, C, O), which the port keeps
  in the JAX layout.

Modules that flax names explicitly keep their names: the occupancy
head's ``occ_tsa_layer{i}`` (a ``BEVFormerLayer`` whose submodules are
named as the encoder's scanned layer), ``occ_tsa_head``, ``flow_branches``,
``forward_flow``, ``backward_flow`` and ``flow_fc`` (its ``Dense_i`` and
``LayerNorm_i`` auto-named as in flax); InternImage's ``stem1``,
``stem_ln1``, ``stage{i}_block{b}`` (``dcn/{input_proj, dw_conv, dw_norm,
offset, mask, output_proj}``, ``norm1``, ``norm2``, ``mlp_fc1``,
``mlp_fc2`` and the layer scales ``gamma1``/``gamma2``, which keep their
name), ``down{i}`` and ``down_ln{i}``; the VoxelFormer head's
``voxel_embedding``, ``voxel_pos`` (``z_embed``, ``row_embed``,
``col_embed``), ``encoder_layer{i}`` (``tsa``, ``sca``, ``ffn``,
``norm1``-``norm3``), ``voxel2bev``, ``occ_proj`` and its ``decoder`` (a
scanned stack, as above); the HybridFormer head's ``bev_embedding``,
``positional_encoding``, ``pos_stage{i}``, ``bev_layer{i}``,
``voxel_stage{s}_layer{i}``, ``transition{i}`` and ``value_proj_stage{i}``.

Every flax leaf is used exactly once.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# nn.scan bodies: layers/<body>/... -> <ModuleList>.{i}...
_SCANNED_BODY = {"layer": "layers", "reg_branch": "reg_branches"}
_BN_RENAME = {"mean": "running_mean", "var": "running_var"}


def _is_conv_transpose(owner: str) -> bool:
    return owner.endswith("_up") or re.fullmatch(r"ConvTranspose_\d+", owner) is not None


def _flatten(tree, prefix=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _unstack(path, arr):
    """Yield (path, arr) per layer for scanned stacks, else once."""
    for i, name in enumerate(path[:-2]):
        if name == "layers" and path[i + 1] in _SCANNED_BODY:
            target = _SCANNED_BODY[path[i + 1]]
            for li in range(arr.shape[0]):
                yield path[:i] + (target, str(li)) + path[i + 2:], arr[li]
            return
    yield path, arr


def _convert(path, arr) -> Tuple[Tuple[str, ...], np.ndarray]:
    *mods, leaf = path
    owner = mods[-1] if mods else ""
    if leaf == "kernel":
        if arr.ndim == 2:
            return (*mods, "weight"), arr.T
        if arr.ndim == 3 and owner in ("query", "key", "value"):
            return (*mods, "weight"), arr.reshape(arr.shape[0], -1).T
        if arr.ndim == 3 and owner == "out":
            return (*mods, "weight"), arr.reshape(-1, arr.shape[-1]).T
        if arr.ndim == 4 and _is_conv_transpose(owner):
            return (*mods, "weight"), arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if arr.ndim == 4:
            return (*mods, "weight"), arr.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel {'/'.join(path)} {arr.shape}")
    if leaf == "bias" and arr.ndim == 2 and owner in ("query", "key", "value"):
        return (*mods, "bias"), arr.reshape(-1)
    if leaf == "scale":
        return (*mods, "weight"), arr
    if leaf in _BN_RENAME:
        return (*mods, _BN_RENAME[leaf]), arr
    return path, arr


# flax's per-layer module names -> the port's ModuleLists
_NUMBERED = {"cls_branch": "cls_branches", "map_cls_branch": "map_cls_branches",
             "map_reg_branch": "map_reg_branches", "map_layer": "map_layers"}


def _rename_branches(path):
    out = []
    for name in path:
        m = re.fullmatch(r"([a-z_]+?)(\d+)", name)
        if m and m.group(1) in _NUMBERED:
            out.extend([_NUMBERED[m.group(1)], m.group(2)])
        else:
            out.append(name)
    return tuple(out)


def state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """flax param tree (nested dict of arrays) -> torch state_dict of the
    port's module built from the same config (the tree alone determines
    the mapping; ``load_state_dict(strict=True)`` checks that it fits)."""
    out: Dict[str, torch.Tensor] = {}
    n_leaves = 0
    for path, arr in _flatten(params):
        n_leaves += 1
        for p, a in _unstack(path, arr):
            p, a = _convert(_rename_branches(p), a)
            key = ".".join(p)
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if n_leaves == 0:
        raise ValueError("empty param tree")
    return out
