"""BEVFormer detector: image features, the training queue and the streaming
inference step.

Counterpart of the JAX package's models/detector.py (reference
bevformer/detectors/bevformer.py): backbone + neck over the folded cameras
(grid mask on the images in training mode), then the head. ``forward`` is
the training forward over a (B, T, ...) queue: a no-grad replay of the T-1
history frames in eval mode builds the BEV that the supervised last frame
starts from (and, with ``keep_bev_history``, the history BEVs whose
occupancy the head supervises too). ``forward_test_frame`` is the stateful
streaming step.
``build_model`` builds a det, det+map (MapTR v1 or v2) or det+occupancy
model (a BEV, VoxelFormer or HybridFormer head) from a config,
with DLA-34 + SECONDFPNV2 (the flagship, Apollo's det+occ model), ResNet
(optionally with DCN stages) + FPN (the R50 and base configs, the smoke
configs), InternImage-S + FPN (the ``*_intern_s`` configs) or VoVNet
V-99-eSE + FPN (``backbone_type="vovnet"``, DD3D's pretrained trunk), with
random weights made from a seed.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from apollo_vision_net_tpu_torch import resolve_device, set_f32_precision
from apollo_vision_net_tpu_torch.configs import ExperimentConfig
from apollo_vision_net_tpu_torch.models.attention import grid_offset_bias
from apollo_vision_net_tpu_torch.models.dla import DLA
from apollo_vision_net_tpu_torch.models.fpn import FPN
from apollo_vision_net_tpu_torch.models.heads.det_head import (
    FOCAL_BIAS_INIT,
    BEVFormerHead,
)
from apollo_vision_net_tpu_torch.models.heads.map_head import BEVFormerDetMapHead
from apollo_vision_net_tpu_torch.models.heads.map_head_v2 import BEVFormerDetMapHeadV2
from apollo_vision_net_tpu_torch.models.heads.occ_head import BEVFormerOccupancyHead
from apollo_vision_net_tpu_torch.models.hybrid import HybridFormerOccupancyHead
from apollo_vision_net_tpu_torch.models.internimage import (
    LAYER_SCALE,
    DCNv3Block,
    InternImage,
    InternImageLayer,
)
from apollo_vision_net_tpu_torch.models.layers import (
    FrozenBatchNorm,
    current_generator,
)
from apollo_vision_net_tpu_torch.models.resnet import CHANNELS, ResNet
from apollo_vision_net_tpu_torch.models.second_fpn import SECONDFPNV2
from apollo_vision_net_tpu_torch.models.vovnet import VoVNet
from apollo_vision_net_tpu_torch.models.voxel import (
    VoxelDetOccHead,
    VoxelFormerOccupancyHead,
    VoxelTemporalSelfAttention,
)
from apollo_vision_net_tpu_torch.utils import debug
from apollo_vision_net_tpu_torch.utils.grid_mask import grid_mask

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class BEVFormer(nn.Module):
    def __init__(self, head: nn.Module, img_backbone: nn.Module,
                 img_neck: nn.Module, *,
                 compute_dtype: torch.dtype = torch.float32,
                 use_grid_mask: bool = True, keep_bev_history: bool = False):
        super().__init__()
        self.img_backbone = img_backbone
        self.img_neck = img_neck
        self.head = head
        self.compute_dtype = compute_dtype
        self.use_grid_mask = use_grid_mask
        self.keep_bev_history = keep_bev_history

    def extract_img_feat(self, img: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """(B, N, H, W, 3) -> [(B, N, h, w, C)] per level, in f32 (the conv
        trunk runs in compute_dtype; InternImage returns its f32 residual
        stream, which the neck's convs take in compute_dtype, as flax's
        ``dtype`` casts it). In training mode the grid mask draws one stripe
        pattern for the batch from the current generator."""
        B, N, H, W, C = img.shape
        x = img.reshape(B * N, H, W, C)
        if self.use_grid_mask and self.training:
            x = grid_mask(x, current_generator())
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        # finite-value probes at the backbone and neck boundaries: the
        # identity unless utils.debug enables them
        bfeats = [debug.probe(f"backbone.{i}", f)
                  for i, f in enumerate(self.img_backbone(x))]
        feats = [debug.probe(f"neck.{i}", f) for i, f in enumerate(
            self.img_neck([f.to(self.compute_dtype) for f in bfeats]))]
        return tuple(
            f.permute(0, 2, 3, 1).reshape((B, N) + f.shape[2:] + f.shape[1:2]).float()
            for f in feats)

    @property
    def prev_tokens(self) -> int:
        """Tokens of the temporal carry: bev_h·bev_w for a BEV head, the
        voxels of a VoxelFormer head, every stage's voxels of a HybridFormer
        head."""
        return self.head.prev_tokens

    def zero_carry(self, batch: int, device) -> torch.Tensor:
        """The carry of a stream with no history: (batch, prev_tokens,
        embed_dims) zeros."""
        return torch.zeros((batch, self.prev_tokens, self.head.embed_dims),
                           dtype=torch.float32, device=device)

    @torch.no_grad()
    def obtain_history_bev(self, imgs_queue, can_bus_queue, lidar2img_queue,
                           has_prev_queue) -> Tuple[torch.Tensor, torch.Tensor]:
        """No-grad replay of the T-1 history frames in eval mode (no dropout,
        no grid mask), each with its own has_prev flag: imgs (B, T-1, N, H,
        W, 3), can_bus (B, T-1, 18), lidar2img (B, T-1, N, 4, 4), has_prev
        (B, T-1) -> (the last BEV (B, Q, C), every history BEV
        (B, T-1, Q, C)), detached (reference obtain_history_bev)."""
        was_training = self.training
        self.eval()
        try:
            prev_bev = self.zero_carry(imgs_queue.shape[0], imgs_queue.device)
            history = []
            for t in range(imgs_queue.shape[1]):
                feats = self.extract_img_feat(imgs_queue[:, t])
                prev_bev = self.head(
                    feats, can_bus=can_bus_queue[:, t],
                    lidar2img=lidar2img_queue[:, t], prev_bev=prev_bev,
                    has_prev=has_prev_queue[:, t], only_bev=True)
                history.append(prev_bev)
        finally:
            self.train(was_training)
        return prev_bev.detach(), torch.stack(history, dim=1).detach()

    def forward(self, img, can_bus, lidar2img, has_prev):
        """Training forward over a queue: img (B, T, N, H, W, 3), can_bus
        (B, T, 18), lidar2img (B, T, N, 4, 4), has_prev (B, T) -> the head's
        outputs for the last frame, which starts from the replayed history
        BEV (reference forward_train). With ``keep_bev_history`` the
        occupancy head also lifts the history BEVs: its predictions cover
        every queue frame."""
        T = img.shape[1]
        kwargs = {}
        if T > 1:
            prev_bev, history = self.obtain_history_bev(
                img[:, :-1], can_bus[:, :-1], lidar2img[:, :-1],
                has_prev[:, :-1])
            if self.keep_bev_history:
                kwargs["prev_bevs"] = history
        else:
            prev_bev = self.zero_carry(img.shape[0], img.device)
        feats = self.extract_img_feat(img[:, -1])
        return self.head(feats, can_bus=can_bus[:, -1],
                         lidar2img=lidar2img[:, -1], prev_bev=prev_bev,
                         has_prev=has_prev[:, -1], **kwargs)

    def forward_test_frame(self, img, can_bus, lidar2img, prev_bev, has_prev):
        """Streaming inference step: img (B, N, H, W, 3), can_bus (B, 18)
        with the deltas applied, lidar2img (B, N, 4, 4), prev_bev (B, Q, C),
        has_prev (B,) -> (outs, new_prev_bev)."""
        feats = self.extract_img_feat(img)
        outs = self.head(feats, can_bus=can_bus, lidar2img=lidar2img,
                         prev_bev=prev_bev, has_prev=has_prev)
        return outs, outs["bev_embed"]


def build_head(cfg: ExperimentConfig) -> BEVFormerHead:
    m = cfg.model
    common = dict(
        bev_h=m.bev_h, bev_w=m.bev_w, num_query=m.num_query,
        num_classes=m.num_classes, embed_dims=m.embed_dims,
        code_size=m.code_size, pc_range=m.pc_range,
        num_points_in_pillar=m.num_points_in_pillar, img_shape=m.img_shape,
        num_cams=m.num_cams, num_feature_levels=m.num_feature_levels,
        encoder_layers=m.encoder_layers, decoder_layers=m.decoder_layers,
        feedforward_channels=m.feedforward_channels,
        rotate_prev_bev=m.rotate_prev_bev, use_shift=m.use_shift,
        use_can_bus=m.use_can_bus, shift_current_refs=m.shift_current_refs,
        attn_logits_clamp=m.attn_logits_clamp, group_detr=m.group_detr,
        bev_partition=m.bev_partition,
        # transformer activations follow the conv trunk's dtype unless the
        # config pins them
        dtype=_DTYPES[m.transformer_dtype or cfg.compute_dtype],
    )
    if m.head_family in ("voxel", "hybrid"):
        # the JAX package builds these heads' modules without a dtype: f32;
        # they ignore bev_partition, as JAX's do, and run unsplit under sp
        kw = {k: common[k] for k in (
            "bev_h", "bev_w", "num_query", "num_classes", "embed_dims",
            "code_size", "pc_range", "img_shape", "num_cams",
            "num_feature_levels", "decoder_layers", "feedforward_channels",
            "rotate_prev_bev", "use_shift", "use_can_bus",
            "shift_current_refs")}
        kw.update(occupancy_classes=m.occupancy_classes, occ_xdim=m.occ_xdim,
                  occ_ydim=m.occ_ydim, occ_zdim=m.occ_zdim, occ_dims=m.occ_dims,
                  num_points_in_voxel=m.num_points_in_voxel)
        if m.head_family == "voxel":
            return VoxelFormerOccupancyHead(
                bev_z=m.bev_z, encoder_layers=m.encoder_layers, **kw)
        return HybridFormerOccupancyHead(
            encoder_embed_dims=m.hybrid_encoder_embed_dims,
            feature_map_z=m.hybrid_feature_map_z, **kw)
    if m.with_occupancy:
        return BEVFormerOccupancyHead(
            occupancy_classes=m.occupancy_classes, occ_xdim=m.occ_xdim,
            occ_ydim=m.occ_ydim, occ_zdim=m.occ_zdim, occ_dims=m.occ_dims,
            occ_head_type=m.occ_head_type, occ_tsa=m.occ_tsa,
            predict_flow=m.predict_flow,
            with_occupancy_flow=m.with_occupancy_flow, **common)
    if m.with_map and m.map_version == 2:
        return BEVFormerDetMapHeadV2(
            num_vec_one2one=m.num_map_vec, num_vec_one2many=m.num_vec_one2many,
            map_num_pts=m.map_num_pts, map_num_classes=m.map_num_classes,
            map_decoder_layers=m.map_decoder_layers,
            with_aux_seg=m.with_aux_seg, **common)
    if m.with_map:
        return BEVFormerDetMapHead(
            num_map_vec=m.num_map_vec, map_num_pts=m.map_num_pts,
            map_num_classes=m.map_num_classes,
            map_decoder_layers=m.map_decoder_layers, **common)
    return BEVFormerHead(**common)


def build_trunk(cfg: ExperimentConfig) -> Tuple[nn.Module, nn.Module]:
    """(img_backbone, img_neck) of the config: DLA-34 + SECONDFPNV2, or
    ResNet, InternImage-S or VoVNet V-99-eSE + FPN with
    ``num_feature_levels`` outputs, its input widths the trunk's stages at
    ``backbone_out_indices``."""
    m = cfg.model
    if m.backbone_type == "dla":
        dla_ch = (16, 32, 64, 128, 256, 512)
        return (DLA(out_indices=m.backbone_out_indices),
                SECONDFPNV2(in_channels=[dla_ch[i] for i in m.backbone_out_indices],
                            fuse_channels=m.embed_dims))
    if m.backbone_type == "internimage":
        trunk = InternImage(out_indices=m.backbone_out_indices,
                            dtype=_DTYPES[cfg.compute_dtype])
    elif m.backbone_type == "vovnet":
        trunk = VoVNet(out_indices=m.backbone_out_indices)
    else:
        return (ResNet(m.backbone_depth, m.backbone_out_indices, m.backbone_dcn_stages),
                FPN([CHANNELS[i] for i in m.backbone_out_indices], m.embed_dims,
                    num_outs=m.num_feature_levels))
    return trunk, FPN(trunk.out_channels(), m.embed_dims,
                      num_outs=m.num_feature_levels)


def keep_bev_history(cfg: ExperimentConfig) -> bool:
    """Whether the training forward supervises every queue frame's
    occupancy: ``keep_bev_history``, which ``with_occupancy_flow`` implies."""
    m = cfg.model
    return m.with_occupancy and (m.keep_bev_history or m.with_occupancy_flow)


def _check_supported(cfg: ExperimentConfig) -> None:
    m = cfg.model
    trunks = {("dla", "secondfpn"), ("resnet", "fpn"), ("internimage", "fpn"),
              ("vovnet", "fpn")}
    if (m.backbone_type, m.neck_type) not in trunks:
        raise NotImplementedError(
            f"{cfg.name}: {m.backbone_type} + {m.neck_type} is not ported yet "
            f"(port has {sorted(trunks)})")
    if m.head_family not in ("bev", "voxel", "hybrid"):
        raise ValueError(f"{cfg.name}: head_family={m.head_family!r}")
    if m.head_family != "bev" and m.with_map:
        raise NotImplementedError(
            f"{cfg.name}: head_family={m.head_family!r} has no map branch "
            "(nor has the JAX package's)")
    if m.with_map and m.with_occupancy:
        raise NotImplementedError(
            f"{cfg.name}: with_map together with with_occupancy is not ported "
            "yet (the port has a det+map or a det+occupancy head)")
    if m.occ_tsa and (m.keep_bev_history or m.with_occupancy_flow):
        # the JAX package asserts the same (models/heads/occ_head.py:315)
        raise NotImplementedError(
            f"{cfg.name}: occ_tsa together with keep_bev_history or "
            "with_occupancy_flow: the refinement pass attends to the current "
            "frame's images only")


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights shaped like the JAX package's initializers:
    lecun-normal convs with zero biases, a zero DCN offset conv and a
    truncated-normal DCN weight (variance scaling 2.0, fan_out),
    xavier-uniform dense layers, zero sampling-offset and attention kernels
    with the grid offset bias (z = 0 in the voxel TSA's), focal-prior
    classification bias, N(0, 1) BEV, voxel and level/camera embeddings,
    U[0, 1) query and positional tables, identity norms and frozen BN
    statistics. InternImage's dense layers take flax's default lecun-normal
    kernels (truncated normal) with zero biases, its DCNv3 ``offset`` and
    ``mask`` layers zeros and its layer scales ``gamma1``/``gamma2`` the
    constant ``LAYER_SCALE``. So do the voxel and hybrid heads' dense
    layers, as the JAX package gives them no kernel_init, but for the
    attention projections (``value_proj``, ``output_proj``: xavier-uniform)
    and the zero offset and weight layers."""
    def normal_(t, std=1.0):
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    def uniform_(t, lo, hi):
        t.copy_(torch.rand(t.shape, generator=generator) * (hi - lo) + lo)

    def trunc_normal_(t, std):
        # N(0, std) truncated at two std, by its inverse CDF: one draw an
        # element (torch's trunc_normal_ redraws in a loop: tens of seconds
        # for InternImage-S on a CPU)
        lo = 0.5 * math.erfc(math.sqrt(2.0))
        u = torch.rand(t.shape, generator=generator, dtype=torch.float64)
        x = torch.erfinv((lo + u * (1.0 - 2.0 * lo)) * 2.0 - 1.0)
        t.copy_((x * (std * math.sqrt(2.0))).clamp(-2.0 * std, 2.0 * std))

    def lecun_normal_(dense):
        # flax lecun_normal: variance_scaling(1.0, "fan_in",
        # "truncated_normal"), truncated at two std
        trunc_normal_(dense.weight,
                      math.sqrt(1.0 / dense.in_features) / 0.87962566103423978)

    for name, mod in model.named_modules():
        leaf = name.rsplit(".", 1)[-1]
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            fan_in = w[0].numel() if isinstance(mod, nn.Conv2d) else w.shape[0] * w[0, 0].numel()
            normal_(w, 0.0 if leaf == "conv2_offset" else 1.0 / math.sqrt(fan_in))
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Linear):
            if leaf in ("sampling_offsets", "attention_weights"):
                mod.weight.zero_()
                mod.bias.zero_()
                if leaf == "sampling_offsets":
                    attn = model.get_submodule(name.rsplit(".", 1)[0])
                    if isinstance(attn, VoxelTemporalSelfAttention):
                        mod.bias.copy_(torch.as_tensor(attn.offset_bias()))
                        continue
                    groups = mod.out_features // (2 * attn.num_heads * attn.num_points)
                    mod.bias.copy_(torch.as_tensor(grid_offset_bias(
                        attn.num_heads, groups, attn.num_points)))
                continue
            fan_out, fan_in = mod.weight.shape
            a = math.sqrt(6.0 / (fan_in + fan_out))
            uniform_(mod.weight, -a, a)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, FrozenBatchNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("bev_embedding", "voxel_embedding", "level_embeds",
                    "cams_embeds"):
            normal_(p)
        elif leaf == "conv2_dcn_weight":
            # flax variance_scaling(2.0, "fan_out", "truncated_normal") on
            # (9, C, O): fan_out = 9·O, truncated at two std
            std = math.sqrt(2.0 / (p.shape[0] * p.shape[2])) / 0.87962566103423978
            trunc_normal_(p, std)
        elif leaf in ("query_embedding", "row_embed", "col_embed", "z_embed",
                      "map_instance_embedding", "map_pts_embedding"):
            uniform_(p, 0.0, 1.0)
        elif name.endswith("Dense_2.bias") and "cls_branches" in name:
            p.fill_(FOCAL_BIAS_INIT)
    for trunk in model.modules():
        if not isinstance(trunk, InternImage):
            continue
        for mod in trunk.modules():
            if isinstance(mod, nn.Linear):
                lecun_normal_(mod)
                mod.bias.zero_()
            elif isinstance(mod, InternImageLayer):
                mod.gamma1.fill_(LAYER_SCALE)
                mod.gamma2.fill_(LAYER_SCALE)
        # after the pass above, which gave them lecun-normal kernels
        for mod in trunk.modules():
            if isinstance(mod, DCNv3Block):
                for dense in (mod.offset, mod.mask):
                    dense.weight.zero_()
                    dense.bias.zero_()
    for head in model.modules():
        if not isinstance(head, VoxelDetOccHead):
            continue
        # the biases stay as the first pass left them (zero, or the focal
        # prior of the classification)
        for name, mod in head.named_modules():
            if isinstance(mod, nn.Linear) and name.rsplit(".", 1)[-1] not in (
                    "value_proj", "output_proj", "sampling_offsets",
                    "attention_weights"):
                lecun_normal_(mod)


def conv_tf32(cfg: ExperimentConfig) -> bool:
    """Whether the model's f32 convolutions run in TF32 on the card: on a
    VoVNet trunk only, where cuDNN's true-f32 algorithms for V-99's 3x3
    convolutions are FFTs at 13x the time of TF32 (chip_smoke.py's
    ``stream_vovnet_trunk`` times both and holds the TF32 trunk to the f32
    one). Every other model's f32 is f32."""
    return cfg.model.backbone_type == "vovnet"


def meta_model(cfg: ExperimentConfig) -> BEVFormer:
    """The config's model on the ``meta`` device, in eval mode: shapes and
    dtypes without storage or weights. A forward on meta inputs computes
    every shape and allocates nothing (tools/debug_shapes.py,
    tools/get_params.py)."""
    _check_supported(cfg)
    with torch.device("meta"):
        return BEVFormer(build_head(cfg), *build_trunk(cfg),
                         compute_dtype=_DTYPES[cfg.compute_dtype],
                         use_grid_mask=cfg.model.use_grid_mask,
                         keep_bev_history=keep_bev_history(cfg)).eval()


def build_model(cfg: ExperimentConfig, device=None, seed: int = 0) -> BEVFormer:
    """The config's model on ``device`` (default: the GPU; raises without
    one unless ``device="cpu"``), in eval mode (``.train()`` for training),
    with random weights from ``seed``. Load bridged weights with
    ``load_state_dict`` afterwards. On the card it also sets the process's
    f32 precision for this model (``conv_tf32``)."""
    dev = resolve_device(device)
    model = meta_model(cfg)
    if dev.type == "cuda":
        set_f32_precision(conv_tf32(cfg))
    model = model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
