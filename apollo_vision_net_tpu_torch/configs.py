"""Typed experiment configs (copy of the JAX package's configs/base.py).

Plain frozen dataclasses, one factory function per experiment. The port
keeps its own copy so that it imports nothing of the JAX package; a test
holds the copy equal to the original field for field. ``msda_impl``, which
only the TPU path reads, is kept for that equality and ignored by the
port; ``bev_partition`` is the BEV partition of multi-GPU training (the
encoder's BEV rows split over the mesh's sp axis, models/encoder.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # BEV grid
    bev_h: int = 200
    bev_w: int = 200
    pc_range: Tuple[float, ...] = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    num_points_in_pillar: int = 4
    # queries / classes
    num_query: int = 900
    num_classes: int = 10
    code_size: int = 10
    # trunk
    embed_dims: int = 256
    encoder_layers: int = 3
    decoder_layers: int = 6
    feedforward_channels: int = 512
    num_cams: int = 6
    num_feature_levels: int = 1
    backbone_type: str = "resnet"
    backbone_depth: int = 50
    backbone_out_indices: Tuple[int, ...] = (3,)
    backbone_dcn_stages: Tuple[bool, ...] = (False, False, False, False)
    neck_type: str = "fpn"
    group_detr: int = 1
    # inputs
    img_shape: Tuple[int, int] = (480, 800)  # post-pipeline (H, W)
    queue_length: int = 3
    # behaviour
    use_grid_mask: bool = True
    rotate_prev_bev: bool = True
    use_shift: bool = True
    use_can_bus: bool = True
    shift_current_refs: bool = True  # reference aliasing-bug parity
    attn_logits_clamp: Optional[float] = None
    video_test_mode: bool = True
    msda_impl: str = "auto"
    # transformer-trunk activation dtype; None -> follow compute_dtype
    # (conv trunk). Pin "float32" for exact-parity runs on bf16 configs.
    transformer_dtype: Optional[str] = None
    bev_partition: Optional[Tuple[Optional[str], ...]] = None
    # tasks
    with_occupancy: bool = False
    with_map: bool = False
    # occupancy (Apollo det+occ: 200x200x16 @0.5m, occ_dims 128)
    occupancy_classes: int = 16
    occ_xdim: int = 200
    occ_ydim: int = 200
    occ_zdim: int = 16
    occ_dims: int = 128
    occ_head_type: str = "cnn"
    occ_tsa: bool = False
    predict_flow: bool = False
    # temporal flow warping of occupancy features across the queue
    # (reference with_occupancy_flow, bevformer_occupancy_head.py:253-301);
    # implies keep_bev_history (multi-frame occ supervision)
    with_occupancy_flow: bool = False
    # supervise occupancy at every queue frame (reference keep_bev_history /
    # obtain_all_history_bev, detectors/bevformer.py:278-296); the dataset
    # then provides gt_occupancy of shape (S, voxel_num) per sample
    keep_bev_history: bool = False
    occ_loss_type: str = "CustomFocalLoss"
    # map (MapTR v1 protocol)
    num_map_vec: int = 50
    map_num_pts: int = 20
    map_num_classes: int = 3
    map_decoder_layers: int = 6
    map_shift_pattern: str = "v2"
    # MapTRv2 (one2one/one2many)
    map_version: int = 1
    num_vec_one2many: int = 300
    map_k_one2many: int = 6
    map_lambda_one2many: float = 1.0
    with_aux_seg: bool = False
    # rasterized aux-seg GT dilation radii (v2 head map_aux_seg_radius /
    # map_aux_pv_radius, bevformer_det_map_head_apollo_v2.py:246,374)
    map_aux_seg_radius: int = 1
    map_aux_pv_radius: int = 1
    # voxel / hybrid trunks
    head_family: str = "bev"  # 'bev' | 'voxel' | 'hybrid'
    bev_z: int = 4
    num_points_in_voxel: int = 1
    hybrid_encoder_embed_dims: Tuple[int, ...] = (256, 128, 64, 32, 16)
    hybrid_feature_map_z: Tuple[int, ...] = (1, 2, 4, 8, 16)

    @property
    def map_patch_size(self) -> Tuple[float, float]:
        """(patch_h, patch_w) — derived from pc_range like the reference's
        VectorizedLocalMap (det_occ_map_dataset.py:300-307)."""
        return (
            self.pc_range[4] - self.pc_range[1],
            self.pc_range[3] - self.pc_range[0],
        )


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 2e-4
    weight_decay: float = 0.01
    backbone_lr_mult: float = 0.1  # paramwise_cfg img_backbone lr_mult
    grad_clip_norm: float = 35.0   # optimizer_config grad_clip max_norm
    warmup_iters: int = 500
    warmup_ratio: float = 1.0 / 3.0
    min_lr_ratio: float = 1e-3     # CosineAnnealing min_lr_ratio
    total_steps: int = 100_000


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size_per_device: int = 1
    max_gt_boxes: int = 64
    img_mean: Tuple[float, ...] = (123.675, 116.28, 103.53)
    img_std: Tuple[float, ...] = (58.395, 57.12, 57.375)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str
    model: ModelConfig
    optim: OptimConfig = OptimConfig()
    data: DataConfig = DataConfig()
    compute_dtype: str = "float32"  # or "bfloat16"
    # torch checkpoint to initialize img_backbone (+ FPN neck when present)
    # from — the reference's pretrained=dict(img=...) + mmcv load_checkpoint
    # (bev_tiny_det_map_apollo.py:91); '' trains from random init.
    pretrained_path: str = ""


def bev_tiny_det_occ_apollo() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_det_occ_apollo.py — DLA-34 +
    SECONDFPNV2, 50×50 BEV, group_detr=11 (900 queries/group), CNN-upsample
    occupancy 200×200×16 @0.5m, CustomFocal+lovász+affinity losses."""
    return ExperimentConfig(
        name="bev_tiny_det_occ_apollo",
        model=ModelConfig(
            bev_h=50, bev_w=50,
            backbone_type="dla", backbone_out_indices=(3, 4, 5),
            neck_type="secondfpn",
            num_query=900 * 11, group_detr=11,
            with_occupancy=True, msda_impl="auto_fast",
        ),
        compute_dtype="bfloat16",
    )


def bev_tiny_det_occ_flow() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_det_occ_flow.py — det+occ with
    the per-voxel flow branch (L1 on object voxels)."""
    return ExperimentConfig(
        name="bev_tiny_det_occ_flow",
        model=ModelConfig(
            bev_h=50, bev_w=50,
            backbone_type="dla", backbone_out_indices=(3, 4, 5),
            neck_type="secondfpn",
            num_query=900 * 11, group_detr=11,
            with_occupancy=True, predict_flow=True,
        ),
        compute_dtype="bfloat16",
    )


def bev_tiny_det_occ_tsa_apollo() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_det_occ_tsa_apollo.py — the
    apollo det+occ model with the extra occ-resolution deformable pass."""
    base = bev_tiny_det_occ_apollo()
    return dataclasses.replace(
        base, name="bev_tiny_det_occ_tsa_apollo",
        model=dataclasses.replace(base.model, occ_tsa=True),
    )


def bev_tiny_det_map_apollo() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_det_map_apollo.py — det+map:
    DLA-34 + SECONDFPNV2, 50×50 BEV, queue 3, 900 det queries, 50×20 map
    point queries (cfg:74-246)."""
    return ExperimentConfig(
        name="bev_tiny_det_map_apollo",
        model=ModelConfig(
            bev_h=50, bev_w=50,
            backbone_type="dla", backbone_out_indices=(3, 4, 5),
            neck_type="secondfpn",
            with_map=True, msda_impl="auto_fast",
        ),
        compute_dtype="bfloat16",
    )


def bev_tiny_det_mapv2() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_det_mapv2.py — det + MapTRv2:
    o2o 50 + o2m 300 (k=6), decoupled decoder, aux BEV/PV seg."""
    return ExperimentConfig(
        name="bev_tiny_det_mapv2",
        model=ModelConfig(
            bev_h=50, bev_w=50,
            backbone_type="dla", backbone_out_indices=(3, 4, 5),
            neck_type="secondfpn",
            with_map=True, map_version=2, map_num_classes=4,
            with_aux_seg=True,
        ),
        compute_dtype="bfloat16",
    )


def smoke_det_mapv2() -> ExperimentConfig:
    """CI-sized det + MapTRv2."""
    return ExperimentConfig(
        name="smoke_det_mapv2",
        model=ModelConfig(
            bev_h=8, bev_w=8, num_query=12, embed_dims=32,
            encoder_layers=1, decoder_layers=2, feedforward_channels=64,
            num_cams=2, img_shape=(64, 96), queue_length=2,
            with_map=True, map_version=2, num_map_vec=4,
            num_vec_one2many=8, map_k_one2many=2, map_num_pts=4,
            map_decoder_layers=2, with_aux_seg=True,
        ),
        data=DataConfig(max_gt_boxes=4),
        optim=OptimConfig(warmup_iters=2, total_steps=100),
    )


def bev_smoke_det_occ() -> ExperimentConfig:
    """CI-sized det+occ (the JAX package's occupancy overfit-check config):
    ResNet-50 stage 4 + FPN, 8x8 BEV, embed_dims 32, 2 Group-DETR groups of
    12 queries, CNN upsampling to a 32x32x4 grid of 16-wide voxels."""
    return ExperimentConfig(
        name="bev_smoke_det_occ",
        model=ModelConfig(
            bev_h=8, bev_w=8, num_query=24, embed_dims=32,
            encoder_layers=1, decoder_layers=2, feedforward_channels=64,
            num_cams=2, img_shape=(64, 96), queue_length=2,
            group_detr=2, with_occupancy=True,
            occ_xdim=32, occ_ydim=32, occ_zdim=4, occ_dims=16,
        ),
        data=DataConfig(max_gt_boxes=8),
        optim=OptimConfig(warmup_iters=2, total_steps=100),
    )


def bev_smoke_det_map() -> ExperimentConfig:
    """CI-sized det+map (the JAX package's overfit-check config): ResNet-50
    stage 4 + FPN, 8x8 BEV, embed_dims 32, 2 cams at 64x96, queue 2."""
    return ExperimentConfig(
        name="bev_smoke_det_map",
        model=ModelConfig(
            bev_h=8, bev_w=8, num_query=12, embed_dims=32,
            encoder_layers=1, decoder_layers=2, feedforward_channels=64,
            num_cams=2, img_shape=(64, 96), queue_length=2,
            with_map=True, num_map_vec=5, map_num_pts=4,
            map_decoder_layers=2,
        ),
        data=DataConfig(max_gt_boxes=8),
        optim=OptimConfig(warmup_iters=2, total_steps=100),
    )


def bev_smoke_det_occ_flow() -> ExperimentConfig:
    """CI-sized det+occ with the flow branch, multi-frame occ supervision
    AND temporal flow aggregation (with_occupancy_flow)."""
    return ExperimentConfig(
        name="bev_smoke_det_occ_flow",
        model=ModelConfig(
            bev_h=8, bev_w=8, num_query=24, embed_dims=32,
            encoder_layers=1, decoder_layers=2, feedforward_channels=64,
            num_cams=2, img_shape=(64, 96), queue_length=2,
            with_occupancy=True, occ_head_type="mlp",
            occ_xdim=8, occ_ydim=8, occ_zdim=4, occ_dims=16,
            predict_flow=True, with_occupancy_flow=True,
        ),
        data=DataConfig(max_gt_boxes=8),
        optim=OptimConfig(warmup_iters=2, total_steps=100),
    )


def bev_base_det_map() -> ExperimentConfig:
    """Base-scale det+map: the flagship's det and MapTR v1 heads on
    BEVFormer-base's trunk (R101 with DCN in stages 3-4, a 4-level FPN over
    stages 2-4, 200×200 BEV, 6 encoder layers)."""
    return ExperimentConfig(
        name="bev_base_det_map",
        model=ModelConfig(
            bev_h=200, bev_w=200, backbone_depth=101,
            backbone_dcn_stages=(False, False, True, True),
            backbone_out_indices=(1, 2, 3), num_feature_levels=4,
            encoder_layers=6, with_map=True,
            msda_impl="auto_fast",
        ),
        compute_dtype="bfloat16",
    )


def bev_base_occ() -> ExperimentConfig:
    """projects/configs/bevformer/bev_base_occ.py: BEVFormer-base's trunk
    (R101 with DCN in stages 3-4, a 4-level FPN, 200×200 BEV, 6 encoder
    layers) with the det head and the MLP occupancy head on a 200×200×16
    grid at 0.5 m."""
    return ExperimentConfig(
        name="bev_base_occ",
        model=ModelConfig(
            bev_h=200, bev_w=200, backbone_depth=101,
            backbone_dcn_stages=(False, False, True, True),
            backbone_out_indices=(1, 2, 3), num_feature_levels=4,
            encoder_layers=6, with_occupancy=True,
            occ_head_type="mlp", occ_xdim=200, occ_ydim=200,
            msda_impl="auto_fast",
        ),
        compute_dtype="bfloat16",
    )


def bev_tiny_det() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_det.py — R50, 200×200 BEV,
    900 queries, 3 encoder / 6 decoder layers, queue 3."""
    return ExperimentConfig(name="bev_tiny_det", model=ModelConfig())


def bev_smoke_det() -> ExperimentConfig:
    """Small-everything variant for CI / CPU-mesh tests (the analog of the
    reference's smoke_det_map_forward_train.py path)."""
    return ExperimentConfig(
        name="bev_smoke_det",
        model=ModelConfig(
            bev_h=8, bev_w=8, num_query=12, embed_dims=32,
            encoder_layers=1, decoder_layers=2, feedforward_channels=64,
            num_cams=2, img_shape=(64, 96), queue_length=2,
        ),
        data=DataConfig(max_gt_boxes=8),
        optim=OptimConfig(warmup_iters=2, total_steps=100),
    )


def bev_tiny_det_occ() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_det_occ.py — R50 det+occ
    (non-Apollo: one det query group, the CNN occupancy head)."""
    return ExperimentConfig(
        name="bev_tiny_det_occ",
        model=ModelConfig(
            bev_h=50, bev_w=50, with_occupancy=True,
            occ_head_type="cnn",
        ),
        compute_dtype="bfloat16",
    )


def bev_tiny_occ() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_occ.py — occ-only tiny (R50)."""
    return ExperimentConfig(
        name="bev_tiny_occ",
        model=ModelConfig(
            bev_h=50, bev_w=50, with_occupancy=True, occ_head_type="cnn",
        ),
        compute_dtype="bfloat16",
    )


def bev_tiny_occ_intern_s() -> ExperimentConfig:
    """projects/configs/bevformer/bev_tiny_occ_intern_s.py — InternImage-S
    backbone (channels 80, depths [4,4,21,4]) on the tiny occ config."""
    return ExperimentConfig(
        name="bev_tiny_occ_intern_s",
        model=ModelConfig(
            bev_h=50, bev_w=50, with_occupancy=True, occ_head_type="cnn",
            backbone_type="internimage", backbone_out_indices=(3,),
        ),
        compute_dtype="bfloat16",
    )


def bev_base_occ_intern_s() -> ExperimentConfig:
    """projects/configs/bevformer/bev_base_occ_intern_s.py: bev_base_occ
    with InternImage-S stages 2-4 in place of R101-DCN."""
    cfg = bev_base_occ()
    return dataclasses.replace(
        cfg, name="bev_base_occ_intern_s",
        model=dataclasses.replace(
            cfg.model, backbone_type="internimage", backbone_depth=50,
            backbone_dcn_stages=(False,) * 4,
            backbone_out_indices=(1, 2, 3)))


def semantic_kitti_occ() -> ExperimentConfig:
    """semantic_kitti SSC: 19+empty classes over [0,-25.6,-2,51.2,25.6,4.4]
    @0.2 m (semantic_kitti/kitti_dataset.py:25-45)."""
    return ExperimentConfig(
        name="semantic_kitti_occ",
        model=ModelConfig(
            bev_h=128, bev_w=128, num_cams=1,
            pc_range=(0.0, -25.6, -2.0, 51.2, 25.6, 4.4),
            with_occupancy=True, occupancy_classes=20,
            occ_xdim=256, occ_ydim=256, occ_zdim=32,
            occ_loss_type="ce_loss",
        ),
        compute_dtype="bfloat16",
    )


def voxel_tiny_occ() -> ExperimentConfig:
    """projects/configs/voxelformer/voxel_tiny_occ.py — VoxelFormer with
    bev_z=4 voxel queries, R50, det+occ."""
    return ExperimentConfig(
        name="voxel_tiny_occ",
        model=ModelConfig(
            bev_h=50, bev_w=50, bev_z=4, head_family="voxel",
            with_occupancy=True, occ_dims=64,
        ),
        compute_dtype="bfloat16",
    )


def hybrid_tiny_occ() -> ExperimentConfig:
    """projects/configs/hybrid/hybrid_tiny_occ.py — OccNet cascade encoder
    dims [256,128,64,32,16], z [1,2,4,8,16]."""
    return ExperimentConfig(
        name="hybrid_tiny_occ",
        model=ModelConfig(
            bev_h=50, bev_w=50, head_family="hybrid",
            with_occupancy=True, occ_dims=16,
        ),
        compute_dtype="bfloat16",
    )


def voxel_base_occ() -> ExperimentConfig:
    """projects/configs/voxelformer/voxel_base_occ.py — voxel queries at
    the 100×100×4 base grid."""
    return ExperimentConfig(
        name="voxel_base_occ",
        model=ModelConfig(
            bev_h=100, bev_w=100, head_family="voxel", bev_z=4,
            backbone_depth=101,
            backbone_dcn_stages=(False, False, True, True),
            with_occupancy=True, occ_dims=32,
        ),
        compute_dtype="bfloat16",
    )


def hybrid_base_occ() -> ExperimentConfig:
    """projects/configs/hybrid/hybrid_base_occ.py — the OccNet cascade at
    base resolution (100×100 BEV stage 0)."""
    return ExperimentConfig(
        name="hybrid_base_occ",
        model=ModelConfig(
            bev_h=100, bev_w=100, head_family="hybrid",
            backbone_depth=101,
            backbone_dcn_stages=(False, False, True, True),
            with_occupancy=True, occ_dims=16,
        ),
        compute_dtype="bfloat16",
    )


def hybrid_tiny_occ_intern_s() -> ExperimentConfig:
    """projects/configs/hybrid/hybrid_tiny_occ_intern_s.py: hybrid_tiny_occ
    with InternImage-S in place of R50."""
    cfg = hybrid_tiny_occ()
    return dataclasses.replace(
        cfg, name="hybrid_tiny_occ_intern_s",
        model=dataclasses.replace(
            cfg.model, backbone_type="internimage",
            backbone_out_indices=(3,)))


def smoke_voxel_occ() -> ExperimentConfig:
    """CI-sized VoxelFormer det+occ."""
    return ExperimentConfig(
        name="smoke_voxel_occ",
        model=ModelConfig(
            bev_h=6, bev_w=6, bev_z=2, head_family="voxel", num_query=12,
            embed_dims=32, encoder_layers=1, decoder_layers=2,
            feedforward_channels=64, num_cams=2, img_shape=(64, 96),
            queue_length=2, with_occupancy=True,
            occ_xdim=12, occ_ydim=12, occ_zdim=4, occ_dims=16,
        ),
        data=DataConfig(max_gt_boxes=8),
        optim=OptimConfig(warmup_iters=2, total_steps=100),
    )


def smoke_hybrid_occ() -> ExperimentConfig:
    """CI-sized HybridFormer det+occ."""
    return ExperimentConfig(
        name="smoke_hybrid_occ",
        model=ModelConfig(
            bev_h=6, bev_w=6, head_family="hybrid", num_query=12,
            embed_dims=32, decoder_layers=2, feedforward_channels=64,
            num_cams=2, img_shape=(64, 96), queue_length=2,
            hybrid_encoder_embed_dims=(32, 16, 8),
            hybrid_feature_map_z=(1, 2, 4),
            with_occupancy=True,
            occ_xdim=12, occ_ydim=12, occ_zdim=4, occ_dims=8,
        ),
        data=DataConfig(max_gt_boxes=8),
        optim=OptimConfig(warmup_iters=2, total_steps=100),
    )
