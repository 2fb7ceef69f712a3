"""Smoke run of the PyTorch/H100 port on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one NVIDIA GPU, nvcc (PATH or /usr/local/cuda/bin) and this checkout.

Phases, each printing JSON lines:
  env          card name and power limit (nvidia-smi), torch and CUDA versions.
  build        builds the kernels of csrc/ (the MSDA forward and backward,
               DCN) in parallel (one nvcc each) and
               prints each source's seconds and, per kernel, the compiler's
               registers, shared memory, stack frame and spills; fails if
               any instance of a vector kernel (VECTOR_KERNELS: the plain/
               masked and factored MSDA forwards, the factored MSDA
               backward's privatizing kernel, the DCN backward's d-input
               kernel) has a stack frame or spills.
  kernels      every CUDA kernel against its plain PyTorch version, in f32 and
               bf16: max abs error and tolerance, device time per call (CUDA
               graph replay), the plain version's time, an eager call's time
               and the bound. Shapes: the flagship's four MSDA calls (TSA, SCA
               with a tile mask from the camera-ring geometry, det and map
               decoders); the base config's TSA over 200x200, det and map
               decoders over the 200x200 BEV, SCA over 4 levels on factored
               operands (tile mask at q_tile 128) and the same SCA on
               materialized operands through the masked entry (F.grid_sample's
               time on the base TSA's value and grid beside it as a
               yardstick); the four DCN shapes of R101 stages 3-4 (random ~2
               px offsets, sigmoid masks; cuDNN's time for a plain 3x3 conv
               of the same shape beside them as a yardstick); small edge
               shapes of both kernels that reach the ragged edges of their
               tiles and both variants (vector and general) of every MSDA
               entry and the DCN kernel. Each row names the variant that
               ran, and an edge case fails off the variant it targets.
  stream       the flagship bev_tiny_det_map_apollo at full width (6 cams at
               480x800, 50x50 BEV, 3 encoder + 6 det + 6 map decoder layers,
               random weights from a seed) through the streaming runner: frames
               with can_bus deltas and one scene change, exact launch counts
               per frame (every MSDA call on its vector variant), finite
               outputs, one f32 frame held against the CPU plain
               path, steady-state frames/s as configured (bf16) and in f32, and
               a profile of each (tools/profile_step.py); the stage split of
               each (``stream_stages``: profile_step's trunk and neck,
               encoder, encoder and decoders, and whole frame, in ms a
               frame by CUDA events with the residual, each stage's
               launches a frame held to ``stage_launches``); the probes'
               cost (``stream_probes``: kernels and host syncs a frame with
               the probe call sites disabled equal those without them).
  stream_base  bev_base_det_map at full width (R101 with DCN in stages 3-4, a
               4-level FPN, 200x200 BEV, 6 encoder + 6 det + 6 map decoder
               layers) the same way, with exact launch counts per frame (the
               MSDA and DCN calls all on their vector variants); its
               f32 frame with history is held against the same frame run
               under ``ops.plain_versions()`` on the GPU. Its random weights
               come from seed 0, and the zero-initialized offset predictors
               (``conv2_offset``, ``sampling_offsets``) get seeded noise so
               that the deformable samples land between pixels.
               Its stage split as ``stream``'s (``stream_base_stages``: the
               26 DCN calls in ``bb``, the factored SCA in ``enc``).
  project_pv   tools/project_det_map_to_pv on one served flagship frame:
               a served frame's launches, finite boxes and vectors, the
               six-camera picture at its size.
  train        the flagship's train step at full width (queue 3, batch 1,
               bf16 as configured, random weights from seed 0, synthetic
               batch with painted GT): 3 steps through
               ``parallel.train.train_step`` (no-grad history replay,
               grid mask and dropout from a device generator, det + map
               losses with Hungarian matching, backward through the CUDA
               MSDA backward, clip, AdamW) with exact launch counts per step
               (forward 21 plain + 9 masked on the vector variant, backward
               15 + 3) and finite loss terms; one f32 step's loss terms and
               every parameter's gradient against the same step under
               ``ops.plain_versions()`` (same draws and assignment),
               beside the witnesses of the step's own sensitivity (the
               plain step on images moved by a relative 1e-6, three noise
               seeds, and with every weight so moved; the gradient the
               kernels move most is read in each);
               steady-state steps/s in bf16 and f32 and a profile of each.
  stream_occ   Apollo's det+occ model bev_tiny_det_occ_apollo at full width
               (the flagship's trunk and encoder, 11 Group-DETR groups of
               900 queries of which a frame serves the first, CNN
               upsampling to a 200x200x16 grid of 128-wide voxels, 16
               classes) through the streaming runner as ``stream``: exact
               launch counts per frame (9 plain + 3 masked, vector), finite
               outputs, the class histogram of each frame's occupancy grid;
               its f32 frame with history against the same frame under
               ``ops.plain_versions()``; the bf16 frame's occupancy logits
               and class grid against the f32 frame's, and the bf16 head
               alone against the f32 head on one BEV (the upsampling
               convolutions run in bf16, the JAX package's in f32),
               within OCC_BF16_REL_TOL and OCC_BF16_AGREEMENT
               (``stream_occ_bf16_vs_f32``); frames/s, peak memory,
               profiles.
  train_occ    its train step as ``train`` (all 11 groups, 9,900 queries
               in the det decoder, the occupancy losses): forward 15 plain
               + 9 masked, backward 9 + 3 launches per step, the f32 step
               against plain versions beside the witnesses with ``train``'s
               limits, steps/s, peak memory, profiles.
  stream_occ_tsa, train_occ_tsa  bev_tiny_det_occ_tsa_apollo (the det+occ
               model with a refinement encoder layer over the 200x200
               upsampled tokens: TSA over them, SCA through the 200x200
               pillars into the six cameras) as ``stream_occ`` and
               ``train_occ``: 10 plain + 4 masked launches a frame, forward
               16 + 10 and backward 10 + 4 a step, all on the vector and
               gather variants; the f32 frame and step against plain
               versions with the witnesses; the bf16 occupancy against the
               f32 one (``stream_occ_tsa_bf16_vs_f32``: the refinement pass
               runs in f32 in both, as the JAX package's; the head alone
               reads the f32 model's image features); frames/s, steps/s,
               peak memory, profiles.
  stream_occ_flow, train_occ_flow  bev_tiny_det_occ_flow (the det+occ
               model with a per-voxel flow branch) the same way: flows
               (1, 640000, 2) finite, loss_flow finite and > 0, the det+occ
               launch counts, the f32 frame against plain versions, the
               bf16 occupancy against the f32 one, frames/s and steps/s in
               bf16 and f32, peak memory, profiles (no f32 step
               comparison: the step runs the det+occ model's kernels).
  stream_occ_aggr, train_occ_aggr  bev_smoke_det_occ_flow (every queue
               frame's occupancy supervised, the voxel volumes warped
               across the queue along learned flows): 6 frames through the
               streaming runner with exact launch counts (3 plain + 1
               masked a frame) and finite flows; 3 f32 steps with the
               mixing weights drawn
               from the step's generator, exact launch counts, the step
               against plain versions with the witnesses, steps/s, a
               profile.
  stream_mapv2, train_mapv2  MapTRv2's bev_tiny_det_mapv2 at full width
               (the flagship's trunk, encoder and det decoder; 6 decoupled
               map layers over 50 one2one vectors of 20 points served and
               50 + 300 trained, the one2many ones under the block-diagonal
               self-attention mask; the BEV and PV segmentation heads; the
               map branch in f32 as the JAX package runs it) as ``stream``
               and ``train``: 15 plain + 3 masked launches a frame, forward
               21 + 9 and backward 15 + 3 a step, all on the vector and
               gather variants; both segmentation logits finite on the BEV
               grid and each camera's finest level; every loss term finite,
               the one2many and segmentation terms among them; the f32
               frame and step against plain versions with the witnesses;
               frames/s, steps/s, peak memory, profiles.
  stream_intern_s, train_intern_s  bev_tiny_occ_intern_s at full width
               (InternImage-S: 33 DCNv3 blocks on the plain MSDA entry at
               D = 16, 9 taps, 5-40 groups over 120x200 to 15x25 with the six
               cameras folded into the batch; an FPN level over its last
               stage, 50x50 BEV, the CNN occupancy head; bf16 as configured,
               the trunk's residual stream f32 as in the JAX package; the
               DCNv3 ``offset`` and ``mask`` layers and the stem biases
               seeded with noise) as ``stream_occ`` and ``train_occ``: 42
               plain + 3 masked launches a frame, forward 114 + 9 and
               backward 42 + 3 a step, all on the vector and gather
               variants; the f32 frame against plain versions, and the f32
               step at 1 encoder and 2 decoder layers (BASE_CMP_SIZES) with
               the witnesses; the bf16 occupancy against the f32 one;
               frames/s, steps/s, peak memory, profiles.
  stream_tiny_det, train_tiny_det  bev_tiny_det, the reference's
               BEVFormer-tiny (R50 stage 4 through one FPN level, 200x200
               BEV, the det head alone, f32 as configured): 9 plain + 3
               masked launches a frame (the SCA at 40,000 pillars over
               15x25), forward 15 + 9 and backward 9 + 3 a step; the f32
               frame against plain versions, and the f32 step at 1 encoder
               and 2 decoder layers with the witnesses; frames/s, steps/s,
               profiles.
  stream_kitti, train_kitti  semantic_kitti_occ (one camera, 128x128 BEV,
               CNN upsampling to a 256x256x32 grid of 20 classes, CE loss,
               bf16): frames with exact launch counts (9 plain + 3 masked)
               and each frame's class histogram, frames/s and a profile;
               3 train steps with exact launch counts and a finite CE loss,
               steps/s and a profile (no f32 comparison).
  stream_base_intern_s  bev_base_occ_intern_s (InternImage-S stages 2-4
               through a 4-level FPN into bev_base_occ's encoder and heads)
               streamed as ``base_occ``: 45 plain (33 DCNv3) + 6 factored
               launches a frame, the f32 frame against plain versions, bf16
               frames/s and a profile.
  stream_voxel, train_voxel  VoxelFormer's voxel_tiny_occ at full width
               (R50 + one FPN level, 4x50x50 voxel queries at 256
               channels, 3 encoder layers of trilinear TSA over the voxel
               queue (ops.msda3d) and SCA into the cameras, the det decoder
               over voxel2bev's 50x50 memory, the occupancy MLP over the
               voxels resized to 200x200x16; the head in f32 in every
               config, as the JAX package builds it) as ``stream_occ`` and
               ``train_occ``: 9 plain launches a frame (dense SCA: no tile
               mask), forward 15 and backward 9 a step, all on the vector
               variant and the gather plan; the f32 frame and step against
               plain versions with the witnesses, the bf16 occupancy
               against the f32 one (the trunk alone differs), frames/s,
               steps/s, peak memory, profiles with the device time of
               ``grid_sampler_3d`` (msda3d).
  stream_hybrid, train_hybrid  the OccNet cascade hybrid_tiny_occ (a BEV
               stage at 256 channels, then voxel stages of 2, 4, 8 and 16
               z-slices at 128, 64, 32 and 16 channels, per-head widths 16
               to 2) the same way: 12 plain launches a frame, 11 on the
               vector variant and the last stage's SCA (D = 2) on the
               scalar one ("general"); forward 24 (21 + 3) and backward 12
               a step, the last stage's on msda_bwd's general plan.
  stream_voxel_base, stream_hybrid_base, stream_hybrid_intern_s
               voxel_base_occ (R101-DCN, 4x100x100 voxels), hybrid_base_occ
               (its last stage 160,000 voxels) and hybrid_tiny_occ_intern_s
               (InternImage-S, 33 DCNv3 calls a frame) served: exact
               launches a frame, bf16 frames/s and a profile.
  train_voxel_base, train_hybrid_base, train_base_intern_s,
  train_hybrid_intern_s  the train steps of voxel_base_occ, hybrid_base_occ,
               bev_base_occ_intern_s (after ``stream_base_intern_s``) and
               hybrid_tiny_occ_intern_s at full width as ``train_voxel``:
               3 bf16 steps with exact launch counts by entry and variant
               (``train_launches_per_step``: R101's 26 DCN and 26 dcn_bwd,
               InternImage-S's 33 DCNv3 calls a frame and their msda_bwd,
               the hybrids' D = 2 stage on the scalar forward and
               msda_bwd's general plan, the base SCA on the factored
               entries), loss terms finite and moving, steps/s, peak memory
               of the steps, a profile with ``grid_sampler_3d``'s device
               time; the f32 step against plain versions beside the
               witnesses at 1 encoder and 2 decoder layers (BASE_CMP_SIZES;
               the hybrids' five stages whole), with ``train``'s limits.
  kitti_files  semantic_kitti_occ trained from a SemanticKITTI tree: one
               sequence written from a seed into a temporary directory at
               full size (``write_fake_kitti``: 1241x376 PNGs, scans of
               KITTI_POINTS points with their labels, 256x256x32 voxel
               labels, occupancy and invalid bitmaps, calib.txt,
               poses.txt), ``tools.create_data semantic-kitti`` over it,
               then 3 bf16 train steps on a batch read from its files (each
               image through the port's training pipeline onto the
               config's 480x800 canvas, lidar2img from the infos, the GT
               through ``dense_gt_to_training_labels``); fails unless the
               launches equal ``train_kitti``'s and the losses are finite.
               Prints the host seconds of reading a frame, of the native
               voxelizer against ``voxelize_numpy`` on a full scan (their
               outputs equal) and of the native eval pipeline against the
               numpy one on a 1600x900 six-camera ring (within
               NATIVE_PIPE_RTOL / NATIVE_PIPE_ATOL).
  stream_vovnet, train_vovnet  bev_tiny_det on VoVNet V-99-eSE (stage 3,
               1024 channels at 15x25, into the one FPN level; f32 as
               configured, with the convolutions in TF32 as the port runs a
               VoVNet model, ``models.detector.conv_tf32``; every other
               model's f32 is f32) as ``stream_tiny_det`` and
               ``train_tiny_det``: the same launches a frame and a step,
               the f32 frame against plain versions, the f32 step at 1
               encoder and 2 decoder layers with the witnesses, frames/s,
               steps/s, peak memory, profiles; then the trunk alone at the
               frame's shape in f32 with TF32 off and on and in bf16
               (``stream_vovnet_trunk``: without TF32 cuDNN runs V-99's f32
               3x3 convolutions as FFTs), the TF32 output within
               VOVNET_TF32_LIMIT of the f32 one and below the bf16 one's
               difference.
  cli_nuscenes  the flagship through the port's CLIs, in-process, on a
               nuScenes tree written from a seed into a temporary directory
               (``write_fake_nuscenes``: v1.0-mini tables for a train and a
               val scene, CAN poses, six 1600x900 JPEGs a sample, a city
               map): ``tools.create_data`` nuscenes and nuscenes-map-gt,
               ``tools.train --data nuscenes --img-scale 0.5 --num-workers
               2`` for 4 steps from a DLA-34 checkpoint in the reference
               naming (``fake_dla34_checkpoint``; the import alone holds
               every trunk tensor to the saved one), ``--resume`` to 6
               steps ("resumed from step 4"), ``tools.test --eval bbox
               chamfer --dump-results`` over the val scene. Fails unless the
               infos carry map vectors, metrics.jsonl has a train record a
               step, both checkpoints exist with the imported BN statistics
               kept, NDS and chamfer mAP are finite, the results JSON
               reloads, and each step and frame ran the train and stream
               phases' launches. Prints the loader's host seconds at full
               size (PIL decode and the numpy pipeline a camera ring, over
               the train samples, and the eval pipeline on each ring both
               ways, native and numpy; a queue sample whole,
               CLI_QUEUE_SAMPLES times), each step's seconds and wait for its batch, and the
               streaming eval's frames/s over CLI_EVAL_PASSES passes, each
               as a median and a spread.
  train_dp     multi-GPU training on the one card: two ranks of a dp = 2
               mesh on cuda:0 over gloo (``tools.dryrun_multichip
               .spawn_world``; NCCL refuses two ranks on one device; gloo
               runs the collectives on the CUDA tensors), the flagship at full width
               and depth, a global batch of 2: the f32 step in training
               mode (the outputs and ground truth gathered over dp, the
               loss of the global batch, the gradients averaged over the
               world) against the one process on the global batch with
               ``train``'s limits; DP_STEPS bf16 steps through
               ``parallel.train.make_train_step`` with each rank's exact
               launches (``train``'s a step), finite and equal loss terms
               and bit-equal parameters on both ranks; the world's ms a
               step beside the one process's on the global batch (two
               processes share the card and the host: a reading, not a
               target); then a world of one over NCCL in this process, its
               f32 step against the non-distributed one.
  train_sp     the BEV partition: bev_base_det_map (200x200 BEV) at
               BASE_CMP_SIZES depth with ``bev_partition``, dp1 x sp2 over
               gloo on cuda:0, one f32 training-mode step (each rank's
               encoder on its 100 BEV rows, the BEV gathered between layers
               and before the heads) with each rank's exact launches,
               against the one process with ``train_base``'s limits.
  converters   host only: the five ``tools.create_data`` choices that the
               port added, on trees written from a seed (a KITTI 3D tree of
               four frames: kitti's infos, reduced clouds, 2D annotations
               and GT database, gt-database over the val infos; a ScanNet
               export of two scans; lyft and waymo stop at their devkit
               gates, and their conversion code runs on the devkit's duck
               type and on a five-camera Waymo frame); fails unless each
               wrote what its tree holds.
  train_overfit_voxel_s0-3  smoke_voxel_occ through the overfit tool as
               the JAX package's run of it: 1,500 steps at lr 6e-4
               (VOXEL_OVERFIT_LR), at seeds 0-3 (VOXEL_OVERFIT_SEEDS);
               loss_occupancy to OCC_OVERFIT_SHARE at each, and the median
               of det mAP, occ_iou and occ_miou over the seeds at least the
               JAX tool's lowest reading at those seeds (voxel_overfit_parity;
               VOXEL_JAX_METRICS: JAX's bars, det mAP > 0.5, occ_iou > 20,
               occ_miou > 10, hold at its seed 0 alone).
  train_overfit_mapv2  smoke_det_mapv2 through the overfit tool as
               ``train_overfit``, for the JAX package's 800 steps
               (MAPV2_OVERFIT_STEPS; loss_total at most 30% of its first
               value), and the tool's chamfer bar (map chamfer mAP > 0.5)
               on the trained model; not the det bar, which the JAX
               package's own 800-step run of this config missed (det mAP
               0.041; artifacts/overfit_r5/smoke_det_mapv2_metrics.json).
  train_overfit  bev_smoke_det_map, batch 4 with painted GT, lr 4e-4,
               300 steps with warmup 30, as the JAX package's
               tools/overfit_check.py runs it: the loss curve every 10
               steps; fails unless the last loss_total is at most 30% of
               the first.
  train_overfit_occ  bev_smoke_det_occ the same way; fails unless the last
               loss_occupancy is at most OCC_OVERFIT_SHARE of the first
               (loss_total stays high: loss_geo_scal does not fall, as in
               the JAX package's run); prints the SSC occ_iou / occ_miou
               of the trained model on its batch.
  train_base   bev_base_det_map's train step as ``train`` (R101 with DCN in
               stages 3-4, 4-level FPN, 200x200 BEV, 6 encoder layers, queue
               3, offset predictors seeded as in ``stream_base``): 3 bf16
               steps with exact launch counts per step (forward 30 plain,
               18 factored, 78 DCN; backward 18 msda_bwd, 6
               msda_bwd_factored, 26 dcn_bwd; on their vector,
               gather, privatized and quad variants), loss
               terms finite and moving;
               the f32 step at 1 encoder and 2 + 2 decoder layers
               (BASE_CMP_SIZES) against plain versions beside the witnesses,
               with ``train``'s limits; steps/s in bf16 and f32 (full
               depth), peak memory of the steps, profiles.
  base_occ     bev_base_occ (the base trunk with the MLP occupancy head on a
               200x200x16 grid) streamed as ``stream_base`` (12 plain, 6
               factored, 26 DCN launches a frame), its f32 frame against
               plain versions, bf16 frames/s and a profile; then 3 bf16
               train steps with exact launch counts (forward 24 plain, 18
               factored, 78 DCN; backward 12 + 6 + 26), steps/s, peak
               memory and a profile.
The kernels phase also holds the backwards against autograd through their
plain versions: ``msda_bwd`` (plain and masked) at the flagship's four
MSDA shapes, the det+occ train step's 9,900-query decoder, the refinement
pass's TSA (2, 40000) over 200x200 and masked SCA (6, 40000) over 30x50
(``tsa_occ``, ``sca_occ``, whose forward has rows too), MapTRv2's trained
map decoder, 7,000 queries over 50x50 (``map_decoder_v2_train``, forward
too), InternImage-S's four DCNv3 shapes (``dcnv3_stage0``-``3``) and
bev_tiny_det's SCA (``sca_tiny_det``), forward too, and the voxel and
hybrid SCAs (``sca_voxel``, ``sca_hybrid_stage1``-``4``, forward too; at D = 2
the general plan) and their base shapes (``sca_voxel_base``,
``tsa_hybrid_base``, ``sca_hybrid_base_stage0``-``4``, ``det_decoder_base100``
over the 100x100 BEV, forward too); each MSDA
backward row counts its value rows' list lengths, ``corners_per_row``),
the base TSA over 200x200 and both base decoders, and the MSDA edge
shapes (the
gather and general plans: L·P of 3 to 64 an item, tiles that a warp's
items straddle, D = 4 to 64, a misaligned value, a hot row);
``msda_bwd_factored`` at the base
SCA shape (the full shape, ~35 GB of plain autograd), the same geometry
with 16-channel heads and with its first level alone (no level private),
and the factored edge shapes (tail tiles, random masks, a misaligned
value; the privatized, vector and general variants: every level's rows in
shared memory, none, and a tile active on all six cameras); ``dcn_bwd`` at
the four R101 shapes and the DCN edge shapes (the quad and general
variants, offsets of ~40 px at stride 1 and 2). Each timed backward row
also gives its device time by kernel (``parts``).
The full overfit-to-metric check (det mAP, map chamfer mAP, occ IoU/mIoU
bars) is ``python3 -m apollo_vision_net_tpu_torch.tools.overfit_check``,
not part of this run.
Each phase is followed by a ``seconds`` line (its wall time); the seven
overfit phases run last, side by side in the spawned processes of
OVERFIT_GROUPS (their steps are host-bound), and share one ``seconds``
line. Then the
run's seconds (kernel builds included), the ``{"kernels": [...]}``
line, the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from apollo_vision_net_tpu_torch import ops
from apollo_vision_net_tpu_torch.configs import (
    bev_base_det_map,
    bev_base_occ,
    bev_base_occ_intern_s,
    bev_smoke_det_map,
    bev_smoke_det_occ,
    bev_smoke_det_occ_flow,
    bev_tiny_det,
    bev_tiny_det_map_apollo,
    bev_tiny_det_mapv2,
    bev_tiny_det_occ_apollo,
    bev_tiny_det_occ_flow,
    bev_tiny_det_occ_tsa_apollo,
    bev_tiny_occ_intern_s,
    hybrid_base_occ,
    hybrid_tiny_occ,
    hybrid_tiny_occ_intern_s,
    semantic_kitti_occ,
    smoke_det_mapv2,
    smoke_voxel_occ,
    voxel_base_occ,
    voxel_tiny_occ,
)
from apollo_vision_net_tpu_torch.data.synthetic import (
    camera_ring_lidar2img,
    make_batch,
    make_stream,
)
from apollo_vision_net_tpu_torch.data.temporal import StreamingState
from apollo_vision_net_tpu_torch.models import internimage
from apollo_vision_net_tpu_torch.models.attention import (
    CustomMSDeformableAttention,
    MSDeformableAttention3D,
    TemporalSelfAttention,
)
from apollo_vision_net_tpu_torch.models.decoder import DetectionTransformerDecoder
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.models.heads.occ_head import occupancy_prediction
from apollo_vision_net_tpu_torch.models.layers import use_generator
from apollo_vision_net_tpu_torch.models.resnet import STAGE_BLOCKS
from apollo_vision_net_tpu_torch.models.voxel import voxel_reference_points_3d
from apollo_vision_net_tpu_torch.ops import _build, cost, dcn_cuda, msda_cuda
from apollo_vision_net_tpu_torch.ops.dcn import modulated_deform_conv_ref
from apollo_vision_net_tpu_torch.ops.dcnv3 import sampling_locations
from apollo_vision_net_tpu_torch.ops.msda import (
    materialize_factored,
    ms_deform_attn_factored,
    ms_deform_attn_ref,
)
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.parallel.mesh import (
    init_distributed,
    make_mesh,
    replicate,
    shard_batch,
)
from apollo_vision_net_tpu_torch.parallel.optim import make_optimizer
from apollo_vision_net_tpu_torch.runtime.inference import (
    StreamingRunner,
    last_layer,
    occupancy_rule,
)
from apollo_vision_net_tpu_torch.runtime.train_loop import step_seed
from apollo_vision_net_tpu_torch.tools import profile_step, project_det_map_to_pv
from apollo_vision_net_tpu_torch.tools.dryrun_multichip import spawn_world
from apollo_vision_net_tpu_torch.tools.overfit_check import (
    BARS,
    evaluate_overfit,
    overfit,
    overfit_config,
)
from apollo_vision_net_tpu_torch.utils import debug, geometry

# kernel vs plain: f32 differs only in summation order; bf16 rounds the same
# f32 sum to bf16 in both, which may land one bf16 ulp apart (2^-7 at |x|<2,
# 2^-6 at |x|<4; the DCN rows' outputs stay under 4)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# one f32 frame on the GPU against the CPU plain path: different conv and
# matmul algorithms and summation orders through ~60 layers; error relative
# to each output's largest magnitude
STREAM_REL_TOL = 2e-3
# the bf16 occupancy logits (head alone, and the whole bf16 frame) against
# the f32 ones, relative to the f32 logits' largest magnitude, and the share
# of voxels given the same class; set from readings (H100: 9.5e-3 head,
# 1.7e-2 frame, 99.2-99.5% equal classes; the bf16 smoke copy on the CPU:
# 2.7e-2 and 4.3e-2, 99.1-99.2%)
OCC_BF16_REL_TOL = 6e-2
OCC_BF16_AGREEMENT = 0.97
# the base f32 frame with kernels against the same frame under
# ops.plain_versions() on the GPU: the same convolutions and products, the
# kernels' sums in other orders through 101 + ~80 layers; relative as above
BASE_REL_TOL = 2e-3
# the same f32 frames where no decoder has amplified the kernels' other
# summation orders yet: the BEV, relative as above, and the det decoder's
# first cross-attention, each query against its own magnitude (H100 at
# 700 W, the 9 GPU f32 frame phases: BEV 5.4e-7 - 1.9e-6, first
# cross-attention 5.1e-7 - 8.2e-7). The decoder's reference-point loop
# then grows any such difference up to 18x a layer in its cross-attention,
# to 1.5e-3 of `tiny_det`'s boxes (``decoder_split``), which
# STREAM_REL_TOL and BASE_REL_TOL hold.
UNAMPLIFIED_REL_TOL = 1e-5
# one f32 flagship train step with the kernels against the same step under
# ops.plain_versions() (same weights, batch, random draws and assignment).
# Loss terms relative to each one's magnitude, as BASE_REL_TOL (the forwards
# differ by the kernels' summation order, ~1e-5 relative at the last decoder
# layer). Gradients: each one's max abs error beyond a floor of
# TRAIN_GRAD_FLOOR of the model's largest gradient (gradients that are zero
# in exact arithmetic, as the self-attention key biases that softmax
# cancels, are noise on both sides), relative to its largest magnitude; and
# each one's error relative to its L2 norm. The step is sensitive: a forward
# difference of ~1e-5 crosses a few ReLU and max kinks, and a weight
# gradient dominated by the few matched queries then moves by percents in
# its largest elements. The witness shows it: the plain step on images
# perturbed by a relative WITNESS_EPS moves the loss terms about as much as
# the kernels' summation order does (6.5e-6 against 7.4e-6) and the
# gradients by up to 1.2% of their largest elements and 6.6e-3 of their
# norms, where the kernels move them by 2.7% and 7.0e-3 (H100 chip run;
# one gradient, map reg branch 4's, moved by 1.2107% in both). The limits
# are about twice the larger reading. A second run with the kernels agrees
# with the first to within the floor; a wrong backward is off by O(1).
TRAIN_REL_TOL = 2e-3
TRAIN_GRAD_REL_TOL = 5e-2
# a trunk parameter whose gradient the f32 step reports, per backbone (the
# DCN weight of R101's first stage-3 block, the DCNv3 offset layer of
# InternImage-S's first stage-2 block; a ResNet without DCN stages reports
# its largest trunk gradient)
TRUNK_PARAM = {"dla": "img_backbone.level5.tree2.conv2.weight",
               "resnet": "img_backbone.layer3_0.conv2_dcn_weight",
               "internimage": "img_backbone.stage2_block0.dcn.offset.weight",
               "vovnet": "img_backbone.stage4_osa0.concat_conv.weight"}
TRAIN_GRAD_NORM_TOL = 2e-2
TRAIN_GRAD_FLOOR = 1e-6
# The step is split (``kernel_split``) where the kernels move the parameter
# they move most by more than SPLIT_SHARE times what every witness moves it
# by, and by more than SPLIT_SHARE times the CPU tests' gradient limit
# (1e-4): the witnesses then do not show the step's sensitivity there. A
# step whose kernels ran a general variant (the scalar MSDA forward,
# msda_bwd's general plan: hybrid_tiny_occ's D = 2 stage, no other main
# path) is split always.
SPLIT_SHARE = 10.0
SPLIT_FLOOR = 1e-4
# the modules that call an MSDA kernel: the TSAs, the SCAs' deformable
# attention, the det and map decoders' cross-attention
MSDA_MODULES = (TemporalSelfAttention, MSDeformableAttention3D,
                CustomMSDeformableAttention)
WITNESS_EPS = 1e-6
# the witnesses: the plain step on images moved by WITNESS_EPS (three
# noise seeds) and with every weight moved by WITNESS_EPS (which also
# reaches the kinks that depend on no image). Each crosses a few kinks of
# its own, the kernels' summation order others. In each f32 step an image
# witness moves the gradient the kernels move most as much (H100 chip run):
# flagship cls branch 5's weight 2.6890% (kernels) and 2.6888% (seed 3);
# det+occ cls branch 5's LayerNorm bias 1.0059% and 1.0059% (seed 1); base
# head.bev_embedding 2.0468% and 2.0463% (seed 3; one BEV query's row,
# behind a ReLU of the encoder's FFN whose input sits next to zero), where
# seeds 1 and 2 move it by nothing beyond the floor. So one set of limits
# holds for all three: about twice the largest of these readings. Moving
# every weight moves each forward ~10x as much as the kernels do and
# crosses more kinks (6.1%, 9.2% and 8.3% at decoder sampling offsets and
# reg branches): it bounds the steps' sensitivity from above.
WITNESSES = (("images", 1), ("images", 2), ("images", 3), ("weights", 1))
# The base f32 step is held against plain versions at 1 encoder layer and
# 2 + 2 decoder layers. Memory: the plain factored MSDA's autograd keeps
# ~34 GB a layer at the base shape (16 gathers of (6, 8, 320,000, 32) f32).
# Sensitivity: at random weights each base decoder layer, sampling a
# 200x200 BEV (four times the flagship's cells a side), amplifies a
# difference ~10x, so at 6 + 6 layers the kernels' summation order moved
# loss_bbox by 2e-6, 2e-5, 5e-5, 1e-3 and 3.7e-3 relative at decoder layers
# 1-5 and the last decoder's sampling-offset gradient by 98.9% of its
# largest element, and the witness moved them as much (95.3%; H100 chip
# run), which no limit can tell from a fault. bev_tiny_det's f32 step,
# whose decoders sample the same 200x200 BEV, is held at the same depth: at
# its 3 + 6 layers the kernels moved head.bev_embedding's gradient by 49.6%
# of its largest element, the image witnesses by 33.1%, 11.4% and 7.6% and
# the weight witness by 70.3% (H100 chip run). bev_tiny_occ_intern_s's f32
# step is held at the same depth too (its 33 InternImage blocks cannot be
# cut by a config field): at its 3 + 6 layers the plain step sat on a kink,
# where the kernels and each image witness moved decoder layer 4's
# sampling-offset gradient by the same 15.37% of its largest element
# (15.373%, 15.376%, 15.370%, 15.376%; H100 chip run).
BASE_CMP_SIZES = dict(encoder_layers=1, decoder_layers=2, map_decoder_layers=2)
# the depth of the f32 model whose steps/s and profile a bf16 train phase
# reads beside its own: at full depth the run would not end within its
# time limit with every config's train phase in it
F32_SPEED_SIZES = BASE_CMP_SIZES
# the overfit run must bring loss_total to this share of its first value in
# OVERFIT_STEPS steps (warmup 30, cosine to 300). The JAX package's run
# (artifacts/overfit_r3, a 3000-step schedule) stood at 16.1% of its first
# loss after 300 steps; the port's 300-step runs at 18.8-20.3% (H100) and
# 19.6% (CPU). A loop that does not train stays near 100%.
OVERFIT_SHARE = 0.30
OVERFIT_STEPS = 300
# the det+occ overfit (bev_smoke_det_occ, the same schedule) must bring
# loss_occupancy to this share of its first value. The JAX package's run
# (artifacts/overfit_r5, a 1500-step schedule) read 27.23 -> 0.659 (2.4%)
# at step 300; the port's 300-step schedule on the CPU read 31.89 -> 4.03
# (12.6%; its learning rate is down to a tenth by step 250). The limit is
# about twice that reading. loss_total is not limited: loss_geo_scal (~27.6,
# a third of the first total) does not fall in either package.
OCC_OVERFIT_SHARE = 0.25
# smoke_det_mapv2's overfit runs the JAX package's 800 steps
# (artifacts/overfit_r5/smoke_det_mapv2_metrics.json: chamfer mAP 0.7315):
# at 300 steps the port's run read chamfer mAP 0.2897 against the bar of
# 0.5, at 800 0.7731, with loss_total at 11.0% and 5.8% of its first value
# (H100 chip runs)
MAPV2_OVERFIT_STEPS = 800
# smoke_voxel_occ's overfit runs the JAX package's run of it
# (artifacts/overfit_r5/smoke_voxel_occ_*: det mAP 0.522, occ_iou 23.6,
# occ_miou 22.4 at step 1,499, below the tool's occ_iou bar of 30): 1,500
# steps at lr 6e-4, which that run's loss curve shows (steps 10 and 20:
# 72.234 and 67.784; the JAX tool rerun on the CPU at lr 6e-4: 72.389 and
# 67.785, at its default 4e-4: 74.250 and 69.657). Bars under JAX's
# readings: det mAP > 0.5, occ_iou > 20, occ_miou > 10; loss_occupancy to
# OCC_OVERFIT_SHARE of its first value (JAX: 22.45 -> 0.151). The metrics
# turn on the seed (the initial draw and the painted batch), in the JAX
# package as in the port: the JAX package's tools/overfit_check.py at this
# protocol on a CPU (XLA on one thread) read at seeds 0-3 the
# VOXEL_JAX_METRICS below, so JAX's bars hold at seed 0 alone (from JAX's
# initial weights the port reproduces the recorded run's occ_iou of 23.636
# on a CPU). The port runs the same four seeds (VOXEL_OVERFIT_SEEDS) and
# each metric's median over them must reach the lowest of the JAX tool's
# four readings: the port's median draw trains as well as JAX's weakest at
# least. Not the JAX tool's median: three card runs of the same code read
# the port's medians of occ_iou at 20.8, 18.0 and 13.6 and of occ_miou at
# 20.4, 18.6 and 18.9 (H100 chip runs), a spread wider than their margin
# over JAX's single-run medians (11.2, 17.6).
VOXEL_OVERFIT_STEPS = 1500
VOXEL_OVERFIT_LR = 6e-4
VOXEL_OVERFIT_SEEDS = (0, 1, 2, 3)
VOXEL_JAX_METRICS = {"mean_ap": (0.522, 0.456, 0.244, 0.279),
                     "occ_iou": (26.000, 13.462, 8.333, 9.023),
                     "occ_miou": (24.643, 18.601, 16.518, 15.454)}
# msda_bwd against autograd through the plain version, relative to each
# gradient's largest magnitude: f32 sums in other orders (the atomics'
# order changes from run to run); bf16 grad_value is the same f32 sum
# rounded to bf16 in both, which may land one bf16 ulp apart (2^-7 of the
# largest magnitude at most), while grad_loc and grad_attn stay f32 sums of
# the same bf16 products
BWD_REL_TOL = {"float32": {"grad_value": 1e-4, "grad_loc": 1e-4, "grad_attn": 1e-4},
               "bfloat16": {"grad_value": 1e-2, "grad_loc": 1e-4, "grad_attn": 1e-4}}
# msda_bwd_factored against autograd through the plain factored version:
# as BWD_REL_TOL (grad_ref, grad_off and grad_attn are f32 sums, over the
# cameras too, of the same products)
FACTORED_BWD_REL_TOL = {
    "float32": {"grad_value": 1e-4, "grad_ref": 1e-4, "grad_off": 1e-4,
                "grad_attn": 1e-4},
    "bfloat16": {"grad_value": 1e-2, "grad_ref": 1e-4, "grad_off": 1e-4,
                 "grad_attn": 1e-4}}
# dcn_bwd against autograd through the plain DCN, relative to each
# gradient's largest magnitude: f32 sums in other orders (the atomics' order
# changes from run to run); in bf16 the samples' gradient dcol is g . W^T
# rounded to bf16 on both sides, from a bf16 GEMM with f32 accumulation
# here and an f32 product there, so single elements may land one bf16 ulp
# apart (2^-8 relative) before the f32 scatter and dot products, and
# grad_x and grad_weight are rounded to bf16 (2^-8) at the end
DCN_BWD_REL_TOL = {
    "float32": {"grad_x": 1e-4, "grad_offset": 1e-4, "grad_mask": 1e-4,
                "grad_weight": 1e-4},
    "bfloat16": {"grad_x": 3e-2, "grad_offset": 3e-2, "grad_mask": 3e-2,
                 "grad_weight": 3e-2}}
CSRC = "apollo_vision_net_tpu_torch/csrc"
# the sources nvcc builds (dcn_fwd.cu includes the DCN backward's kernels
# from dcn_bwd.cuh)
SOURCES = {"msda_fwd.cu": f"{CSRC}/msda_fwd.cu",
           "msda_bwd.cu": f"{CSRC}/msda_bwd.cu",
           "dcn_fwd.cu": f"{CSRC}/dcn_fwd.cu"}
MSDA_PALLAS = "apollo_vision_net_tpu/ops/msda_pallas.py"
REPLACES = {
    "msda_fwd": (f"{MSDA_PALLAS}:194 (_msda_kernel); {MSDA_PALLAS}:234 "
                 f"(_msda_kernel_slab, TSA use); {MSDA_PALLAS}:1293 "
                 "(_msda_kernel_window, 200x200 TSA, run exactly)"),
    "msda_fwd_masked": (f"{MSDA_PALLAS}:234 (_msda_kernel_slab with tile mask, "
                        f"SCA use); {MSDA_PALLAS}:212 (_msda_kernel_masked); "
                        f"{MSDA_PALLAS}:385 (_msda_kernel_ml_chunk, "
                        "multi-level SCA on materialized operands)"),
    "msda_fwd_factored": f"{MSDA_PALLAS}:676 (_msda_kernel_pt2d)",
    "dcn_fwd": "apollo_vision_net_tpu/ops/dcn_pallas.py:73 (_dcn_kernel)",
    # the JAX package's MSDA backward is not a Pallas kernel
    "msda_bwd": (f"{MSDA_PALLAS}:1468 (_bwd: XLA VJP of ms_deform_attn_xla, "
                 "the backward of _msda_kernel and _msda_kernel_slab)"),
    "msda_bwd_masked": (f"{MSDA_PALLAS}:1468 (_bwd: XLA VJP of "
                        "ms_deform_attn_xla, the backward of "
                        "_msda_kernel_slab with a tile mask)"),
    "msda_bwd_factored": (f"{MSDA_PALLAS}:1586 (_factored_bwd: XLA VJP of "
                          "_materialize_factored -> ms_deform_attn_xla, the "
                          "backward of _msda_kernel_pt2d)"),
    "dcn_bwd": ("apollo_vision_net_tpu/ops/dcn_pallas.py:248 (_dense_bwd: "
                "XLA VJP of _dcn_xla_ref, the backward of _dcn_kernel)"),
}
TRAIN_STEP = "bev_tiny_det_map_apollo train step"
BASE_TRAIN_STEP = "bev_base_det_map train step"
# per-frame calls of each entry point, by kernels-phase case: the base frame
# where the base path launches the entry, else the flagship frame
FRAME_CALLS = {
    "msda_fwd": ("bev_base_det_map", {"tsa_base": 6, "det_decoder_base": 6,
                                      "map_decoder_base": 6}),
    "msda_fwd_masked": ("bev_tiny_det_map_apollo", {"sca": 3}),
    "msda_fwd_factored": ("bev_base_det_map", {"sca_base_factored": 6}),
    "dcn_fwd": ("bev_base_det_map", {"dcn_s3_stride2": 1, "dcn_s3": 22,
                                     "dcn_s4_stride2": 1, "dcn_s4": 2}),
    # per flagship train step: the supervised frame's 3 TSA and 6 + 6
    # decoder calls, and its 3 SCA calls, take the backward
    "msda_bwd": (TRAIN_STEP, {"tsa_bwd": 3, "det_decoder_bwd": 6,
                              "map_decoder_bwd": 6}),
    "msda_bwd_masked": (TRAIN_STEP, {"sca_bwd": 3}),
    # per base train step: the supervised frame's 6 SCA calls and 26 DCN
    # calls take the backward
    "msda_bwd_factored": (BASE_TRAIN_STEP, {"sca_base_factored_bwd": 6}),
    "dcn_bwd": (BASE_TRAIN_STEP, {"dcn_s3_stride2_bwd": 1, "dcn_s3_bwd": 22,
                                  "dcn_s4_stride2_bwd": 1, "dcn_s4_bwd": 2}),
}
# the file of csrc/ that holds each entry's kernels
ENTRY_SOURCE = {"msda_fwd": "msda_fwd.cu", "msda_fwd_masked": "msda_fwd.cu",
                "msda_fwd_factored": "msda_fwd.cu", "dcn_fwd": "dcn_fwd.cu",
                "msda_bwd": "msda_bwd.cu", "msda_bwd_masked": "msda_bwd.cu",
                "msda_bwd_factored": "msda_bwd.cu", "dcn_bwd": "dcn_bwd.cuh"}
# kernels whose every instance must build without a stack frame or spills
VECTOR_KERNELS = ("msda_vec_kernel", "msda_factored_vec_kernel",
                  "msda_bwd_vec_kernel", "msda_bwd_gather_kernel",
                  "msda_bwd_factored_priv_kernel", "dcn_dinput_kernel")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, warmup: int = 10, iters: int = 100) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_parts(fn, n: int = 20) -> dict:
    """{kernel or memset: device ms a call} of the work ``fn`` launches,
    from torch.profiler over n calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            out[e.key[:120]] = t / n / 1e3
    return out


def graph_time_ms(fn, iters: int = 50) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph and
    replayed, so host launch cost (Python, the wrapper's checks, ctypes)
    is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def reset_launch_counts() -> None:
    msda_cuda.reset_launch_counts()
    dcn_cuda.reset_launch_counts()


def variant_counts() -> dict:
    """Launches by kernel variant of every entry."""
    out = {}
    for name, counts in (("msda_fwd", msda_cuda.launches_plain_by_variant),
                         ("msda_fwd_masked", msda_cuda.launches_masked_by_variant),
                         ("msda_fwd_factored", msda_cuda.launches_factored_by_variant),
                         ("dcn_fwd", dcn_cuda.launches_by_variant),
                         ("msda_bwd", msda_cuda.launches_bwd_plain_by_variant),
                         ("msda_bwd_masked",
                          msda_cuda.launches_bwd_masked_by_variant),
                         ("msda_bwd_factored",
                          msda_cuda.launches_bwd_factored_by_variant),
                         ("dcn_bwd", dcn_cuda.launches_bwd_by_variant)):
        out.update({f"{name}.{v}": n for v, n in counts.items()})
    return out


def read_launch_counts() -> dict:
    return {"msda_fwd": msda_cuda.launches_plain,
            "msda_fwd_masked": msda_cuda.launches_masked,
            "msda_fwd_factored": msda_cuda.launches_factored,
            "dcn_fwd": dcn_cuda.launches,
            "msda_bwd": msda_cuda.launches_bwd_plain,
            "msda_bwd_masked": msda_cuda.launches_bwd_masked,
            "msda_bwd_factored": msda_cuda.launches_bwd_factored,
            "dcn_bwd": dcn_cuda.launches_bwd,
            **variant_counts()}


def kernel_name(mangled: str) -> str:
    """The ``..._kernel`` identifier inside an Itanium-mangled name (its
    length-prefixed parts read in order), else the mangled name."""
    i = 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if m:
            n, j = int(m.group()), i + len(m.group())
            ident = mangled[j:j + n]
            if ident.endswith("_kernel"):
                return ident
            i = j + n if ident.isidentifier() else j
        else:
            i += 1
    return mangled


def ptxas_kernels(report: str) -> list:
    """Per function of an ``nvcc -Xptxas -v`` report: registers, static
    shared memory, stack frame and spill bytes."""
    out, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            cur = {"kernel": kernel_name(m.group(1)), "mangled": m.group(1)}
            out.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def check_vector_kernels(kernels: list) -> None:
    """The vector kernels (VECTOR_KERNELS) keep everything in registers and
    shared memory: no instance built has a stack frame or spills."""
    for name in VECTOR_KERNELS:
        vec = [k for k in kernels if k["kernel"] == name]
        bad = [k for k in vec if k.get("stack_bytes", 1)
               or k.get("spill_stores", 1) or k.get("spill_loads", 1)]
        if not vec or bad:
            raise AssertionError(f"{name}: stack frame or spills (or no "
                                 f"report): {bad or vec}")


# ---------------------------------------------------------------- kernels

def tile_sizes(Q: int, q_tile: int, n_tiles: int, device) -> torch.Tensor:
    per_tile = torch.full((n_tiles,), q_tile, device=device)
    per_tile[-1] = Q - q_tile * (n_tiles - 1)
    return per_tile


def corner_counts(value, shapes, loc, tile_mask, q_tile):
    """In-grid corners of the active queries' samples per (batch, cell,
    head) value row of an MSDA call: (B·V·H,) counts, the lengths of the
    lists that msda_bwd's gather plan pushes and sums."""
    B, V, H, _ = value.shape
    _, Q, _, _, P, _ = loc.shape
    dev = loc.device
    keep = torch.ones((B, Q), dtype=torch.bool, device=dev)
    if tile_mask is not None:
        keep = tile_mask.to(torch.bool).repeat_interleave(q_tile, 1)[:, :Q]
    bh = (torch.arange(B, device=dev)[:, None, None, None] * V * H
          + torch.arange(H, device=dev)[None, None, :, None])  # (B, 1, H, 1)
    counts = torch.zeros(B * V * H, dtype=torch.int64, device=dev)
    start = 0
    for lvl, (h, w) in enumerate(shapes):
        x0 = torch.floor(loc[:, :, :, lvl, :, 0] * w - 0.5).long()
        y0 = torch.floor(loc[:, :, :, lvl, :, 1] * h - 0.5).long()
        for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            xx, yy = x0 + cx, y0 + cy
            ok = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
                  & keep[:, :, None, None])
            counts += torch.bincount((bh + (start + yy * w + xx) * H)[ok],
                                     minlength=B * V * H)
        start += h * w
    return counts


def touched_value_bytes(value, shapes, loc, tile_mask, q_tile):
    """Bytes of the value rows that an MSDA call needs: each distinct
    (batch, cell, head) row of D values under an in-grid corner of a sample
    of an active tile, read once. A decoder call touches a fraction of its
    value; TSA nearly all of it."""
    rows = int((corner_counts(value, shapes, loc, tile_mask, q_tile) > 0).sum())
    return rows * value.shape[3] * value.element_size()


def corner_list_lengths(value, shapes, loc, tile_mask, q_tile):
    """``corner_counts`` over the rows that get any corner: {"mean", "max"}."""
    counts = corner_counts(value, shapes, loc, tile_mask, q_tile)
    used = counts[counts > 0].float()
    return {"mean": float(used.mean()), "max": int(used.max())}


def msda_bound(value, shapes, loc, tile_mask, q_tile, shared_batch=None):
    """Least time for an MSDA call: the value rows its samples touch read
    once (``touched_value_bytes``), locations and weights of active tiles
    read once, the output written once; 4 corners x D FMAs per sample.
    ``shared_batch`` = Bs for the factored entry (``loc`` materialized):
    per-camera refs, and offsets/weights read once per sample for the
    queries that any of its cameras needs."""
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    elem = value.element_size()
    active_q = B * Q
    if tile_mask is not None:
        sizes = tile_sizes(Q, q_tile, tile_mask.shape[1], tile_mask.device)
        active_q = int((tile_mask.to(torch.int64) * sizes).sum())
    if shared_batch is None:
        operand_bytes = active_q * H * L * P * (2 + 1) * 4
    else:
        Bs = shared_batch
        union_q = Bs * Q
        if tile_mask is not None:
            any_cam = tile_mask.reshape(Bs, B // Bs, -1).any(1).to(torch.int64)
            union_q = int((any_cam * sizes).sum())
        operand_bytes = active_q * P * 2 * 4 + union_q * H * L * P * (2 + 1) * 4
    nbytes = (touched_value_bytes(value, shapes, loc, tile_mask, q_tile)
              + operand_bytes + B * Q * H * D * elem)
    ops_ = cost.msda_operations(active_q, H, L, P, D)
    return cost.bound_ms(nbytes, ops_ / cost.F32_FLOP_PER_S)



def dcn_bound(x, offset, weight, out):
    """Least time for a DCN call: x, offsets, mask and weight read once,
    the output written once; 2·9·C·O operations per output pixel at the
    card's rate for the dtype (bf16 tensor cores, f32 CUDA cores)."""
    B, Ho, Wo, _, _ = offset.shape
    _, C, O = weight.shape
    nbytes = (x.numel() * x.element_size() + offset.numel() * 4
              + offset.numel() // 2 * 4 + weight.numel() * weight.element_size()
              + out.numel() * out.element_size())
    rate = cost.BF16_TENSOR_FLOP_PER_S if x.dtype == torch.bfloat16 else cost.F32_FLOP_PER_S
    return cost.bound_ms(nbytes, cost.dcn_operations(B, Ho, Wo, C, O) / rate)


def _softmax_attn(g, dev, shape, groups):
    """Softmaxed weights (..., H·L·P) normalized over each head's L·P."""
    a = torch.randn(shape[:-1] + (shape[-1] // groups, groups),
                    generator=g, device=dev)
    return torch.softmax(a, -1).reshape(shape).contiguous()


def msda_case(name, g, dev, *, B, hw, H, D, Q, P, ref_xy):
    """Inputs of one single-level MSDA call: ref_xy (B, Q, P, 2) normalized
    reference points per point, offsets of ~2 cells, softmaxed weights."""
    h, w = hw
    value = torch.randn((B, h * w, H, D), generator=g, device=dev)
    off = torch.randn((B, Q, H, 1, P, 2), generator=g, device=dev) * 2.0
    off = off / torch.tensor([w, h], device=dev, dtype=torch.float32)
    loc = (ref_xy[:, :, None, None] + off).contiguous()
    attn = _softmax_attn(g, dev, (B, Q, H * P), P).reshape(B, Q, H, 1, P)
    return dict(name=name, kind="msda", value=value, shapes=((h, w),), loc=loc,
                attn=attn, tile_mask=None, q_tile=32)


def sca_geometry(cfg, dev, q_tile, hw=None):
    """Pillar reference points of the (bh, bw) grid ``hw`` (the BEV grid by
    default) projected into the camera ring, queries in 8 x (q_tile / 8)
    blocks as SpatialCrossAttention orders them, and the per-(camera, tile)
    visibility mask: ref (N, Q, D_z, 2), mask (N, T)."""
    m = cfg.model
    bh, bw = hw or (m.bev_h, m.bev_w)
    Q, N = bh * bw, m.num_cams
    ref3d = torch.as_tensor(geometry.bev_reference_points_3d(
        bh, bw, m.pc_range[5] - m.pc_range[2], m.num_points_in_pillar),
        device=dev)
    l2i = torch.as_tensor(camera_ring_lidar2img(N, *m.img_shape), device=dev)
    ref_cam, bev_mask = geometry.point_sampling(
        ref3d, m.pc_range, l2i[None], m.img_shape)
    perm, _ = geometry.spatial_block_order(bh, bw, 8, q_tile // 8)
    perm = torch.as_tensor(perm, device=dev, dtype=torch.int64)
    ref_cam = ref_cam[0][:, perm]                      # (N, Q, Dz, 2)
    hit = bev_mask[0].any(-1)[:, perm]                 # (N, Q)
    n_tiles = (Q + q_tile - 1) // q_tile
    hit_pad = F.pad(hit, (0, n_tiles * q_tile - Q))
    return ref_cam, hit_pad.reshape(N, n_tiles, q_tile).any(-1).to(torch.int32)


def flagship_cases(dev):
    """The four MSDA call shapes of one flagship frame."""
    cfg = bev_tiny_det_map_apollo()
    m = cfg.model
    g = torch.Generator(device=dev).manual_seed(0)
    bh, bw = m.bev_h, m.bev_w
    Q = bh * bw
    fh, fw = m.img_shape[0] // 16, m.img_shape[1] // 16
    N, H, D = m.num_cams, 8, m.embed_dims // 8
    cases = []
    # TSA: 2-slot queue folded into the batch, refs on the BEV grid
    ref2d = torch.as_tensor(geometry.bev_reference_points_2d(bh, bw), device=dev)
    cases.append(msda_case("tsa", g, dev, B=2, hw=(bh, bw), H=H, D=D, Q=Q, P=4,
                           ref_xy=ref2d[None, :, None].expand(2, Q, 4, 2)))
    # SCA: tiles of 32 masked by visibility (as SpatialCrossAttention)
    qt = 32
    ref_cam, tile_mask = sca_geometry(cfg, dev, qt)
    P = 8
    ref_flat = ref_cam.reshape(N, Q, -1).repeat(1, 1, P // ref_cam.shape[2])
    off = torch.randn((1, Q, H * P * 2), generator=g, device=dev) * 2.0
    attn = torch.softmax(torch.randn((1, Q, H, P), generator=g, device=dev), -1)
    loc, attn = materialize_factored(ref_flat, off, attn.reshape(1, Q, -1),
                                     ((fh, fw),), H, P)
    cases.append(dict(
        name="sca", kind="msda",
        value=torch.randn((N, fh * fw, H, D), generator=g, device=dev),
        shapes=((fh, fw),), loc=loc.reshape(N, Q, H, 1, P, 2).contiguous(),
        attn=attn.reshape(N, Q, H, 1, P).contiguous(), tile_mask=tile_mask,
        q_tile=qt))
    # det and map decoders: queries at random reference points on the BEV
    for name, nq in (("det_decoder", m.num_query),
                     ("map_decoder", m.num_map_vec * m.map_num_pts)):
        ref = torch.rand((1, nq, 1, 2), generator=g, device=dev)
        cases.append(msda_case(name, g, dev, B=1, hw=(bh, bw), H=H, D=D, Q=nq,
                               P=4, ref_xy=ref.expand(1, nq, 4, 2)))
    return cases


def occ_cases(dev):
    """The MSDA shape that the det+occ train step adds: the det decoder's
    cross-attention over all 11 groups, 9,900 queries over the 50x50 BEV
    (a served frame runs the first group, the flagship's 900)."""
    m = bev_tiny_det_occ_apollo().model
    g = torch.Generator(device=dev).manual_seed(5)
    ref = torch.rand((1, m.num_query, 1, 2), generator=g, device=dev)
    return [msda_case("det_decoder_occ_train", g, dev, B=1,
                      hw=(m.bev_h, m.bev_w), H=8, D=m.embed_dims // 8,
                      Q=m.num_query, P=4,
                      ref_xy=ref.expand(1, m.num_query, 4, 2))]


def mapv2_cases(dev):
    """The MSDA shape that bev_tiny_det_mapv2's train step adds: the map
    decoder's cross-attention over all (50 + 300) x 20 = 7,000 point
    queries over the 50x50 BEV, run in f32 as configured (a served frame
    runs the 1,000 one2one queries, the flagship's map_decoder shape)."""
    m = bev_tiny_det_mapv2().model
    g = torch.Generator(device=dev).manual_seed(7)
    nq = (m.num_map_vec + m.num_vec_one2many) * m.map_num_pts
    ref = torch.rand((1, nq, 1, 2), generator=g, device=dev)
    return [msda_case("map_decoder_v2_train", g, dev, B=1,
                      hw=(m.bev_h, m.bev_w), H=8, D=m.embed_dims // 8, Q=nq,
                      P=4, ref_xy=ref.expand(1, nq, 4, 2))]


def dcnv3_cases(dev):
    """The four DCNv3 call shapes of an InternImage-S frame (the six 480x800
    cameras folded into the batch): stage i samples its (120, 200) / 2^i map
    with 5·2^i groups of 16 channels as heads, 9 taps as points, one level;
    locations from ``ops.dcnv3.sampling_locations`` on N(0, 1) px offsets,
    masks softmaxed over the taps. f32 is what the path runs (the value is
    cast to f32 in every config); on the plain entry's vector variant and
    msda_bwd's gather plan in both dtypes."""
    m = bev_tiny_occ_intern_s().model
    g = torch.Generator(device=dev).manual_seed(8)
    B, K = m.num_cams, 9
    h, w = m.img_shape[0] // 4, m.img_shape[1] // 4
    cases = []
    for i, G in enumerate(internimage.GROUPS):
        D = internimage.CHANNELS * 2**i // G
        off = torch.randn((B, h, w, G, K, 2), generator=g, device=dev)
        attn = _softmax_attn(g, dev, (B, h * w, G * K), K)
        cases.append(dict(
            name=f"dcnv3_stage{i}", kind="msda",
            value=torch.randn((B, h * w, G, D), generator=g, device=dev),
            shapes=((h, w),), loc=sampling_locations(off),
            attn=attn.reshape(B, h * w, G, 1, K), tile_mask=None, q_tile=32,
            variant=dict.fromkeys(("float32", "bfloat16"), "vector"),
            bwd_variant=dict.fromkeys(("float32", "bfloat16"), "gather")))
        # a stride-2 'SAME' conv rounds up
        h, w = (h + 1) // 2, (w + 1) // 2
    return cases


def tiny_det_cases(dev):
    """bev_tiny_det's SCA: the 200x200 pillars over the six cameras' single
    15x25 map (R50 stage 4 through one FPN level), tiles of 32 masked by
    the camera ring's visibility; its TSA over 200x200 is the base TSA's
    geometry (``tsa_base``)."""
    cfg = bev_tiny_det()
    m = cfg.model
    g = torch.Generator(device=dev).manual_seed(9)
    Q = m.bev_h * m.bev_w
    fh, fw = m.img_shape[0] // 32, m.img_shape[1] // 32
    N, H, D, P, qt = m.num_cams, 8, m.embed_dims // 8, 8, 32
    ref_cam, tile_mask = sca_geometry(cfg, dev, qt)
    ref_flat = ref_cam.reshape(N, Q, -1).repeat(1, 1, P // ref_cam.shape[2])
    off = torch.randn((1, Q, H * P * 2), generator=g, device=dev) * 2.0
    attn = torch.softmax(torch.randn((1, Q, H, P), generator=g, device=dev), -1)
    loc, attn = materialize_factored(ref_flat, off, attn.reshape(1, Q, -1),
                                     ((fh, fw),), H, P)
    return [dict(name="sca_tiny_det", kind="msda",
                 value=torch.randn((N, fh * fw, H, D), generator=g, device=dev),
                 shapes=((fh, fw),),
                 loc=loc.reshape(N, Q, H, 1, P, 2).contiguous(),
                 attn=attn.reshape(N, Q, H, 1, P).contiguous(),
                 tile_mask=tile_mask, q_tile=qt)]


def fwd_variant(D, dtype) -> str:
    """The plain and masked MSDA entry's variant at head width D: the
    vector kernel when D fills G = D·sizeof(T)/16 lanes, G in {1, 2, 4, 8,
    16} (csrc/msda_fwd.cu launch_msda), else the scalar one ("general")."""
    vec = 16 // torch.tensor([], dtype=dtype).element_size()
    return "vector" if D % vec == 0 and D // vec in (1, 2, 4, 8, 16) else "general"


def voxel_sca_case(name, cfg, g, dev, z, channels):
    """SCA of a voxel head's z·h·w voxel centres (one point each, 8 samples
    a head) over the six cameras' single 15x25 map (R50/R101 stage 4
    through one FPN level), dense: no tile order or mask (the JAX package
    builds the voxel SCA without ``bev_hw``); value (6, 375, 8,
    channels / 8), f32 as the head runs it. The variants expected: the
    plain entry's at D (``fwd_variant``), msda_bwd's plan at D."""
    m = cfg.model
    h, w = m.bev_h, m.bev_w
    Q, N, H, P = z * h * w, m.num_cams, 8, 8
    D = channels // H
    fh, fw = m.img_shape[0] // 32, m.img_shape[1] // 32
    ref3d = torch.as_tensor(voxel_reference_points_3d(
        z, h, w, m.num_points_in_voxel), device=dev)
    l2i = torch.as_tensor(camera_ring_lidar2img(N, *m.img_shape), device=dev)
    ref_cam, _ = geometry.point_sampling(ref3d, m.pc_range, l2i[None], m.img_shape)
    ref_flat = ref_cam[0].reshape(N, Q, -1).repeat(1, 1, P // ref_cam.shape[-2])
    off = torch.randn((1, Q, H * P * 2), generator=g, device=dev) * 2.0
    attn = torch.softmax(torch.randn((1, Q, H, P), generator=g, device=dev), -1)
    loc, attn = materialize_factored(ref_flat, off, attn.reshape(1, Q, -1),
                                     ((fh, fw),), H, P)
    dtypes = ("float32", "bfloat16")
    return dict(
        name=name, kind="msda",
        value=torch.randn((N, fh * fw, H, D), generator=g, device=dev),
        shapes=((fh, fw),), loc=loc.reshape(N, Q, H, 1, P, 2).contiguous(),
        attn=attn.reshape(N, Q, H, 1, P).contiguous(), tile_mask=None,
        q_tile=32,
        variant={d: fwd_variant(D, getattr(torch, d)) for d in dtypes},
        bwd_variant={d: msda_cuda.BWD_VARIANTS[msda_cuda.bwd_plan(
            N, fh * fw, H, D, Q, P)] for d in dtypes})


def voxel_cases(dev):
    """The SCA shapes that the voxel and hybrid heads add: voxel_tiny_occ's
    over 4x50x50 = 10,000 voxels at D = 32 (``sca_voxel``), and
    hybrid_tiny_occ's voxel stages 1-4, 5,000 to 40,000 voxels at D = 16,
    8, 4 and 2 (``sca_hybrid_stage{s}``): f32 D = 2 and bf16 D <= 4 take the
    forward's scalar variant, D = 2 msda_bwd's general plan. Their TSAs
    run ``ops.msda3d``; hybrid stage 0 and both det decoders take the
    flagship's shapes (``tsa``, ``sca`` without a mask, ``det_decoder``)."""
    g = torch.Generator(device=dev).manual_seed(10)
    vox = voxel_tiny_occ()
    cases = [voxel_sca_case("sca_voxel", vox, g, dev, vox.model.bev_z,
                            vox.model.embed_dims)]
    hyb = hybrid_tiny_occ()
    m = hyb.model
    for s in range(1, len(m.hybrid_encoder_embed_dims)):
        cases.append(voxel_sca_case(
            f"sca_hybrid_stage{s}", hyb, g, dev, m.hybrid_feature_map_z[s],
            m.hybrid_encoder_embed_dims[s]))
    return cases


def voxel_base_cases(dev):
    """The MSDA shapes that the base voxel and hybrid heads add, at their
    100x100 grid: voxel_base_occ's SCA over 4x100x100 = 40,000 voxels at
    D = 32 (``sca_voxel_base``); hybrid_base_occ's BEV stage, TSA over the
    100x100 grid (2, 10,000) and a dense SCA of its cells at one z-slice
    (D = 32), and its voxel stages 1-4, 20,000 to 160,000 voxels at D =
    16, 8, 4 and 2 (``sca_hybrid_base_stage{s}``); the det decoder over
    both heads' 100x100 voxel2bev memory (``det_decoder_base100``)."""
    g = torch.Generator(device=dev).manual_seed(11)
    vox = voxel_base_occ()
    cases = [voxel_sca_case("sca_voxel_base", vox, g, dev, vox.model.bev_z,
                            vox.model.embed_dims)]
    hyb = hybrid_base_occ()
    m = hyb.model
    bh, bw = m.bev_h, m.bev_w
    Q, H, D = bh * bw, 8, m.hybrid_encoder_embed_dims[0] // 8
    ref2d = torch.as_tensor(geometry.bev_reference_points_2d(bh, bw), device=dev)
    cases.append(msda_case("tsa_hybrid_base", g, dev, B=2, hw=(bh, bw), H=H,
                           D=D, Q=Q, P=4,
                           ref_xy=ref2d[None, :, None].expand(2, Q, 4, 2)))
    for s in range(len(m.hybrid_encoder_embed_dims)):
        cases.append(voxel_sca_case(
            f"sca_hybrid_base_stage{s}", hyb, g, dev, m.hybrid_feature_map_z[s],
            m.hybrid_encoder_embed_dims[s]))
    ref = torch.rand((1, m.num_query, 1, 2), generator=g, device=dev)
    cases.append(msda_case("det_decoder_base100", g, dev, B=1, hw=(bh, bw),
                           H=H, D=m.embed_dims // 8, Q=m.num_query, P=4,
                           ref_xy=ref.expand(1, m.num_query, 4, 2)))
    return cases


def occ_tsa_cases(dev):
    """The MSDA shapes that bev_tiny_det_occ_tsa_apollo's refinement pass
    adds: TSA of the 40,000 upsampled tokens over the 200x200 grid (2 queue
    slots; the base TSA's geometry) and SCA of the 200x200 pillars over the
    six cameras' 30x50 map, tiles of 32 masked by the camera ring's
    visibility at occupancy resolution."""
    cfg = bev_tiny_det_occ_tsa_apollo()
    m = cfg.model
    g = torch.Generator(device=dev).manual_seed(6)
    oh, ow = m.occ_ydim, m.occ_xdim
    Q = oh * ow
    fh, fw = m.img_shape[0] // 16, m.img_shape[1] // 16
    N, H, D, P, qt = m.num_cams, 8, m.embed_dims // 8, 8, 32
    ref2d = torch.as_tensor(geometry.bev_reference_points_2d(oh, ow), device=dev)
    tsa = msda_case("tsa_occ", g, dev, B=2, hw=(oh, ow), H=H, D=D, Q=Q, P=4,
                    ref_xy=ref2d[None, :, None].expand(2, Q, 4, 2))
    ref_cam, tile_mask = sca_geometry(cfg, dev, qt, hw=(oh, ow))
    ref_flat = ref_cam.reshape(N, Q, -1).repeat(1, 1, P // ref_cam.shape[2])
    off = torch.randn((1, Q, H * P * 2), generator=g, device=dev) * 2.0
    attn = torch.softmax(torch.randn((1, Q, H, P), generator=g, device=dev), -1)
    loc, attn = materialize_factored(ref_flat, off, attn.reshape(1, Q, -1),
                                     ((fh, fw),), H, P)
    sca = dict(name="sca_occ", kind="msda",
               value=torch.randn((N, fh * fw, H, D), generator=g, device=dev),
               shapes=((fh, fw),), loc=loc.reshape(N, Q, H, 1, P, 2).contiguous(),
               attn=attn.reshape(N, Q, H, 1, P).contiguous(),
               tile_mask=tile_mask, q_tile=qt)
    return tsa, sca


def base_msda_cases(dev):
    """The MSDA call shapes of one bev_base_det_map frame: TSA over the
    200x200 BEV (kernel 6's contract, exact), det and map decoders over it,
    SCA over the 4 FPN levels on factored operands (kernel 4) and on
    materialized ones through the masked entry (kernel 5's contract)."""
    cfg = bev_base_det_map()
    m = cfg.model
    g = torch.Generator(device=dev).manual_seed(2)
    bh, bw = m.bev_h, m.bev_w
    Q = bh * bw
    N, H, D = m.num_cams, 8, m.embed_dims // 8
    cases = []
    ref2d = torch.as_tensor(geometry.bev_reference_points_2d(bh, bw), device=dev)
    cases.append(msda_case("tsa_base", g, dev, B=2, hw=(bh, bw), H=H, D=D, Q=Q,
                           P=4, ref_xy=ref2d[None, :, None].expand(2, Q, 4, 2)))
    for name, nq in (("det_decoder_base", m.num_query),
                     ("map_decoder_base", m.num_map_vec * m.map_num_pts)):
        ref = torch.rand((1, nq, 1, 2), generator=g, device=dev)
        cases.append(msda_case(name, g, dev, B=1, hw=(bh, bw), H=H, D=D, Q=nq,
                               P=4, ref_xy=ref.expand(1, nq, 4, 2)))
    # the 4 FPN levels of a 480x800 image: stride 8, then each stride-2 conv
    # (3x3, padding 1) halves rounding up: (60, 100) ... (8, 13)
    hh, ww = m.img_shape[0] // 8, m.img_shape[1] // 8
    shapes = []
    for _ in range(m.num_feature_levels):
        shapes.append((hh, ww))
        hh, ww = (hh + 1) // 2, (ww + 1) // 2
    shapes = tuple(shapes)
    V, L, P, qt = sum(h * w for h, w in shapes), len(shapes), 8, 128
    ref_cam, tile_mask = sca_geometry(cfg, dev, qt)
    ref_flat = ref_cam.reshape(N, Q, -1).repeat(1, 1, P // ref_cam.shape[2]).contiguous()
    off = (torch.randn((1, Q, H * L * P * 2), generator=g, device=dev) * 2.0).contiguous()
    attn = _softmax_attn(g, dev, (1, Q, H * L * P), L * P)
    value = torch.randn((N, V, H, D), generator=g, device=dev)
    cases.append(dict(name="sca_base_factored", kind="factored", value=value,
                      shapes=shapes, ref_flat=ref_flat, off=off, attn=attn,
                      tile_mask=tile_mask, q_tile=qt))
    loc, attn_m = materialize_factored(ref_flat, off, attn, shapes, H, P)
    cases.append(dict(name="sca_base_materialized", kind="msda", value=value,
                      shapes=shapes,
                      loc=loc.reshape(N, Q, H, L, P, 2).contiguous(),
                      attn=attn_m.reshape(N, Q, H, L, P).contiguous(),
                      tile_mask=tile_mask, q_tile=qt,
                      same_as="sca_base_factored"))
    return cases


def base_factored_bwd_cases(sca):
    """msda_bwd_factored at the base SCA's size where no config calls it:
    its geometry and tile mask with 16-channel heads (the privatizing
    kernel at G = 4), and with the first FPN level alone (60x100: no level
    fits the shared budget, so the vector kernel adds every row
    globally)."""
    dev = sca["value"].device
    g = torch.Generator(device=dev).manual_seed(5)
    N, V, H, D = sca["value"].shape
    Bs, Q = sca["attn"].shape[:2]
    P = sca["ref_flat"].shape[2] // 2
    shapes1 = sca["shapes"][:1]
    V1 = shapes1[0][0] * shapes1[0][1]
    return [
        dict(sca, name="sca_base_factored_D16", bwd_variant="privatized",
             value=torch.randn((N, V, H, 16), generator=g, device=dev)),
        dict(sca, name="sca_base_factored_L1", bwd_variant="vector",
             shapes=shapes1,
             value=torch.randn((N, V1, H, D), generator=g, device=dev),
             off=(torch.randn((Bs, Q, H * P * 2), generator=g, device=dev)
                  * 2.0),
             attn=_softmax_attn(g, dev, (Bs, Q, H * P), P)),
    ]


def msda_edge_pair(name, g, dev, *, B, H, D, Q, P, shapes, q_tile, variant,
                   misaligned=False, bwd_variant=None, hot=None):
    """One plain and one masked MSDA call on the same inputs: locations
    spread past the grid ([-0.2, 1.2]), random weights, a random tile mask
    with a tail tile when q_tile does not divide Q. ``variant``,
    ``bwd_variant`` (the plan msda_bwd must take) and ``misaligned`` as in
    ``factored_case``; ``hot`` = (x, y) puts every sample of every query at
    the centre of that cell of the first level (its whole weight on one
    corner row)."""
    L, V = len(shapes), sum(h * w for h, w in shapes)
    value = torch.randn((B, V, H, D), generator=g, device=dev)
    loc = torch.rand((B, Q, H, L, P, 2), generator=g, device=dev) * 1.4 - 0.2
    if hot is not None:
        h0, w0 = shapes[0]
        loc[..., 0] = (hot[0] + 0.5) / w0
        loc[..., 1] = (hot[1] + 0.5) / h0
    attn = torch.rand((B, Q, H, L, P), generator=g, device=dev)
    n_tiles = (Q + q_tile - 1) // q_tile
    tm = (torch.rand((B, n_tiles), generator=g, device=dev) > 0.4).to(torch.int32)
    common = dict(kind="msda", value=value, shapes=shapes, loc=loc, attn=attn,
                  q_tile=q_tile, variant=variant, misaligned=misaligned,
                  bwd_variant=bwd_variant)
    return [dict(name=name, tile_mask=None, **common),
            dict(name=name + "_masked", tile_mask=tm, **common)]


def msda_edge_cases(dev):
    """Small shapes of the plain and masked entries that the main paths do
    not reach, each on the variant it targets: H·L·P below, at and above
    one warp (12, 32, 64, 96, 256), D = 4, 16, 32, 40 and 64, L = 1-4, Q
    off the tile, locations outside the grid and a misaligned value row;
    then the factored entry with N = 3 cameras and a tail tile; then the
    shapes of msda_bwd's vector kernel (``bwd_variant``, the plan it must
    take): L·P = 3, 5, 12 and 64 an item (8, 4, 2 and 1 items a warp, the
    last in rounds of 32 samples), B·Q·H not a multiple of the items a warp
    takes, tiles of 3 or 4 queries so that a warp's items straddle masked,
    unmasked and tail tiles, D = 8, and a hot row: every sample of 500
    queries on one corner of one cell."""
    g = torch.Generator(device=dev).manual_seed(1)
    vec = {"float32": "vector", "bfloat16": "vector"}
    gen = {"float32": "general", "bfloat16": "general"}
    gat = {"float32": "gather", "bfloat16": "gather"}
    return [
        *msda_edge_pair("edge_D4", g, dev, B=2, H=4, D=4, Q=37, P=5,
                        shapes=((6, 9), (3, 5)), q_tile=32,
                        variant={"float32": "vector", "bfloat16": "general"},
                        bwd_variant=gat),
        *msda_edge_pair("edge_D40", g, dev, B=1, H=2, D=40, Q=70, P=3,
                        shapes=((7, 5),), q_tile=32, variant=gen,
                        bwd_variant=gen),
        *msda_edge_pair("edge_msda_HLP12_D16", g, dev, B=2, H=2, D=16, Q=45,
                        P=3, shapes=((6, 9), (3, 5)), q_tile=16, variant=vec,
                        bwd_variant=gat),
        *msda_edge_pair("edge_msda_HLP32_D32", g, dev, B=2, H=8, D=32, Q=70,
                        P=4, shapes=((9, 11),), q_tile=32, variant=vec,
                        bwd_variant=gat),
        *msda_edge_pair("edge_msda_HLP64_D32", g, dev, B=3, H=8, D=32, Q=100,
                        P=8, shapes=((5, 8),), q_tile=32, variant=vec,
                        bwd_variant=gat),
        *msda_edge_pair("edge_msda_L3_HLP96_D64", g, dev, B=1, H=4, D=64, Q=50,
                        P=8, shapes=((7, 9), (4, 5), (2, 3)), q_tile=16,
                        variant=vec, bwd_variant=gen),
        *msda_edge_pair("edge_msda_L4_HLP256_D32", g, dev, B=2, H=8, D=32,
                        Q=200, P=8, shapes=((9, 13), (5, 7), (3, 4), (1, 1)),
                        q_tile=128, variant=vec, bwd_variant=gat),
        *msda_edge_pair("edge_msda_L2_D40", g, dev, B=2, H=3, D=40, Q=33, P=4,
                        shapes=((6, 7), (3, 4)), q_tile=8, variant=gen,
                        bwd_variant=gen),
        *msda_edge_pair("edge_msda_misaligned", g, dev, B=1, H=4, D=32, Q=40,
                        P=4, shapes=((6, 8), (3, 4)), q_tile=16, variant=gen,
                        misaligned=True, bwd_variant=gen),
        factored_case("edge_factored", g, dev, Bs=2, N=3, H=4, D=24, Q=150,
                      P=4, shapes=((9, 11), (5, 6), (3, 3)), q_tile=64),
        *msda_edge_pair("edge_bwd_LP3_D16", g, dev, B=2, H=3, D=16, Q=37, P=3,
                        shapes=((6, 9),), q_tile=4, variant=None,
                        bwd_variant=gat),
        *msda_edge_pair("edge_bwd_LP5_D32", g, dev, B=1, H=8, D=32, Q=45, P=5,
                        shapes=((5, 7),), q_tile=4, variant=None,
                        bwd_variant=gat),
        *msda_edge_pair("edge_bwd_LP12_D8", g, dev, B=2, H=2, D=8, Q=29, P=4,
                        shapes=((7, 9), (4, 5), (2, 3)), q_tile=8,
                        variant=None, bwd_variant=gat),
        *msda_edge_pair("edge_bwd_LP64_D32", g, dev, B=1, H=2, D=32, Q=20,
                        P=32, shapes=((6, 7), (3, 4)), q_tile=8, variant=None,
                        bwd_variant=gat),
        *msda_edge_pair("edge_bwd_items_tail_D4", g, dev, B=1, H=3, D=4, Q=37,
                        P=4, shapes=((5, 6),), q_tile=3, variant=None,
                        bwd_variant=gat),
        *msda_edge_pair("edge_bwd_hot_row", g, dev, B=1, H=2, D=32, Q=500,
                        P=4, shapes=((8, 8),), q_tile=32, variant=None,
                        bwd_variant=gat, hot=(3, 5)),
    ]


def factored_case(name, g, dev, *, Bs, N, H, D, Q, P, shapes, q_tile,
                  variant=None, misaligned=False, bwd_variant=None,
                  all_cameras_tile=None):
    """A factored MSDA call with references spread past the grid
    ([-0.2, 1.2]), offsets of ~3 cells and a random tile mask with a tail
    tile. ``variant`` {dtype: "vector" | "general"} is the variant the
    forward kernel must take, ``bwd_variant`` the one msda_bwd_factored
    must take (else ``factored_bwd_variant``'s); ``misaligned`` shifts
    value by one element off its 16-byte alignment; tile
    ``all_cameras_tile`` is active on every camera."""
    L, V = len(shapes), sum(h * w for h, w in shapes)
    n_tiles = (Q + q_tile - 1) // q_tile
    tile_mask = (torch.rand((Bs * N, n_tiles), generator=g, device=dev)
                 > 0.3).to(torch.int32)
    if all_cameras_tile is not None:
        tile_mask[:, all_cameras_tile] = 1
    return dict(
        name=name, kind="factored", variant=variant, misaligned=misaligned,
        bwd_variant=bwd_variant,
        value=torch.randn((Bs * N, V, H, D), generator=g, device=dev),
        shapes=shapes,
        ref_flat=torch.rand((Bs * N, Q, P * 2), generator=g, device=dev) * 1.4 - 0.2,
        off=torch.randn((Bs, Q, H * L * P * 2), generator=g, device=dev) * 3.0,
        attn=_softmax_attn(g, dev, (Bs, Q, H * L * P), L * P),
        tile_mask=tile_mask, q_tile=q_tile)


def factored_edge_cases(dev):
    """The ragged edges of the factored kernel's tiling: L = 1..4 with odd
    level sizes, L·P below, at and above one warp (P = 4, 5, 6, 8, 12),
    D = 4, 16, 32, 40 and 64 (vector and general variants), two samples of
    3 cameras, tail tiles, samples outside the grid, and a misaligned value
    row; for msda_bwd_factored, every level's rows in shared memory, none
    (the last level too large for FACTORED_BWD_PRIVATE_BYTES), and a tile
    active on all six cameras (its busiest case)."""
    g = torch.Generator(device=dev).manual_seed(4)
    vec, gen = "vector", "general"
    return [
        factored_case("edge_factored_L1_P6_D64", g, dev, Bs=1, N=2, H=2, D=64,
                      Q=45, P=6, shapes=((7, 9),), q_tile=16,
                      variant={"float32": vec, "bfloat16": gen}),
        factored_case("edge_factored_L2_P5_D16", g, dev, Bs=1, N=3, H=4, D=16,
                      Q=61, P=5, shapes=((6, 10), (3, 5)), q_tile=32,
                      variant={"float32": vec, "bfloat16": vec}),
        factored_case("edge_factored_L2_P4_D4", g, dev, Bs=2, N=3, H=3, D=4,
                      Q=70, P=4, shapes=((5, 7), (3, 3)), q_tile=32,
                      variant={"float32": vec, "bfloat16": gen}),
        factored_case("edge_factored_L4_P8_D32", g, dev, Bs=1, N=6, H=8, D=32,
                      Q=200, P=8, shapes=((9, 13), (5, 7), (3, 4), (1, 1)),
                      q_tile=128, variant={"float32": vec, "bfloat16": vec}),
        factored_case("edge_factored_L3_P12_D32", g, dev, Bs=2, N=3, H=2, D=32,
                      Q=33, P=12, shapes=((11, 5), (6, 3), (3, 2)), q_tile=8,
                      variant={"float32": vec, "bfloat16": vec}),
        factored_case("edge_factored_L4_P6_D40", g, dev, Bs=1, N=3, H=3, D=40,
                      Q=50, P=6, shapes=((9, 7), (5, 4), (3, 2), (2, 1)),
                      q_tile=16, variant={"float32": gen, "bfloat16": gen}),
        factored_case("edge_factored_misaligned", g, dev, Bs=1, N=2, H=4, D=32,
                      Q=40, P=8, shapes=((6, 8), (3, 4)), q_tile=16,
                      variant={"float32": gen, "bfloat16": gen},
                      misaligned=True),
        factored_case("edge_factored_all_private", g, dev, Bs=1, N=3, H=4,
                      D=32, Q=150, P=4, shapes=((10, 12), (5, 6), (3, 3)),
                      q_tile=32, variant={"float32": vec, "bfloat16": vec},
                      bwd_variant="privatized"),
        factored_case("edge_factored_none_private", g, dev, Bs=1, N=2, H=2,
                      D=32, Q=100, P=4, shapes=((100, 100),), q_tile=32,
                      variant={"float32": vec, "bfloat16": vec},
                      bwd_variant="vector"),
        factored_case("edge_factored_all_cameras", g, dev, Bs=1, N=6, H=8,
                      D=32, Q=293, P=8,
                      shapes=((12, 20), (6, 10), (3, 5), (2, 3)), q_tile=128,
                      variant={"float32": vec, "bfloat16": vec},
                      bwd_variant="privatized", all_cameras_tile=1),
    ]


def dcn_case(name, g, dev, *, B, H, W, C, O, stride, off_std, variant=None,
             misaligned=False, bwd_variant=None):
    """One DCN call: x ~ N(0, 1), offsets ~ N(0, off_std) pixels, sigmoid
    masks, weights ~ N(0, 1 / (9 C)) so that outputs stay of order 1.
    ``variant``, ``bwd_variant`` and ``misaligned`` as in ``factored_case``
    (on x)."""
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    return dict(
        name=name, kind="dcn", stride=stride, variant=variant,
        misaligned=misaligned, bwd_variant=bwd_variant,
        x=torch.randn((B, H, W, C), generator=g, device=dev),
        offset=torch.randn((B, Ho, Wo, 9, 2), generator=g, device=dev) * off_std,
        mask=torch.sigmoid(torch.randn((B, Ho, Wo, 9), generator=g, device=dev)),
        weight=torch.randn((9, C, O), generator=g, device=dev) / math.sqrt(9 * C))


def dcn_cases(dev):
    """The four DCN shapes of R101 stages 3-4 on six 480x800 cameras (the
    vector variant), then edge shapes: odd sizes at stride 2, offsets far
    beyond the image, pixel counts that are not multiples of the pixel tile,
    C that is neither a multiple of 8 nor of the chunk (20, 33, 24), O that
    is not a multiple of the output tile (37, 70, 72, 520: past one 512-wide
    tile), a misaligned x, and offsets of ~40 px (most samples tens of
    pixels from their tap) on larger images at stride 1 and 2. In the
    backward, C = 33 or a misaligned x takes the general variant, the rest
    the quad one."""
    g = torch.Generator(device=dev).manual_seed(3)
    vec = {"float32": "vector", "bfloat16": "vector"}
    gen = {"float32": "general", "bfloat16": "general"}
    return [
        dcn_case("dcn_s3_stride2", g, dev, B=6, H=60, W=100, C=256, O=256, stride=2, off_std=2.0, variant=vec),
        dcn_case("dcn_s3", g, dev, B=6, H=30, W=50, C=256, O=256, stride=1, off_std=2.0, variant=vec),
        dcn_case("dcn_s4_stride2", g, dev, B=6, H=30, W=50, C=512, O=512, stride=2, off_std=2.0, variant=vec),
        dcn_case("dcn_s4", g, dev, B=6, H=15, W=25, C=512, O=512, stride=1, off_std=2.0, variant=vec),
        dcn_case("edge_dcn_odd_stride2", g, dev, B=1, H=7, W=9, C=20, O=37, stride=2, off_std=4.0, variant=gen),
        dcn_case("edge_dcn_far", g, dev, B=2, H=5, W=6, C=33, O=70, stride=1, off_std=8.0, variant=gen),
        dcn_case("edge_dcn_vec_tail", g, dev, B=1, H=9, W=11, C=64, O=72, stride=1, off_std=3.0, variant=vec),
        dcn_case("edge_dcn_vec_wide", g, dev, B=1, H=7, W=9, C=24, O=520, stride=2, off_std=3.0, variant=vec),
        dcn_case("edge_dcn_misaligned", g, dev, B=1, H=6, W=5, C=32, O=64, stride=1, off_std=2.0, variant=gen, misaligned=True),
        dcn_case("edge_dcn_offsets_40px", g, dev, B=1, H=96, W=128, C=32, O=32, stride=1, off_std=40.0, variant=vec, bwd_variant="quad"),
        dcn_case("edge_dcn_offsets_40px_stride2", g, dev, B=1, H=96, W=128, C=32, O=40, stride=2, off_std=40.0, variant=vec, bwd_variant="quad"),
    ]


def misaligned(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


def bind(case, dtype):
    """(kernel, plain, bound) callables and numbers of one case in one
    dtype. The plain versions of the factored and DCN cases copy host
    constants to the device, which a CUDA graph cannot capture, so their
    ``plain_ms`` are eager calls timed with CUDA events."""
    kind = case["kind"]
    shift = misaligned if case.get("misaligned") else (lambda t: t)
    if kind == "dcn":
        x = shift(case["x"].to(dtype).contiguous())
        w = case["weight"].to(dtype).contiguous()
        args = (x, case["offset"], case["mask"], w, case["stride"])
        kernel = lambda: dcn_cuda.dcn_fwd(*args)          # noqa: E731
        plain = lambda: modulated_deform_conv_ref(*args)  # noqa: E731
        return kernel, plain, lambda out: dcn_bound(x, case["offset"], w, out)
    value = shift(case["value"].to(dtype).contiguous())
    kw = dict(tile_mask=case["tile_mask"], q_tile=case["q_tile"])
    if kind == "factored":
        args = (value, case["shapes"], case["ref_flat"], case["off"], case["attn"])
        Q, P = case["ref_flat"].shape[1], case["ref_flat"].shape[2] // 2

        def plain():
            with ops.plain_versions():
                return ms_deform_attn_factored(*args, **kw)

        def bound(out):
            H, L = value.shape[2], len(case["shapes"])
            loc, _ = materialize_factored(*args[2:], case["shapes"], H, P)
            return msda_bound(value, case["shapes"],
                              loc.reshape(value.shape[0], Q, H, L, P, 2),
                              kw["tile_mask"], kw["q_tile"],
                              shared_batch=case["attn"].shape[0])

        return (lambda: msda_cuda.msda_fwd_factored(*args, **kw), plain, bound)
    args = (value, case["shapes"], case["loc"], case["attn"])
    return (lambda: msda_cuda.msda_fwd(*args, **kw),
            lambda: ms_deform_attn_ref(*args, **kw),
            lambda out: msda_bound(value, case["shapes"], case["loc"],
                                   kw["tile_mask"], kw["q_tile"]))


def _grad_out(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def bind_bwd(case, dtype, seed=0):
    """The MSDA backward on a single-level case: msda_bwd against autograd
    through ms_deform_attn_ref on the same inputs and a seeded grad_out.
    Returns (kernel, plain, bound, gradient names, tolerances, expected
    variant or None). The plain version is timed eagerly with CUDA events
    (autograd is not captured in a graph here)."""
    shift = misaligned if case.get("misaligned") else (lambda t: t)
    value = shift(case["value"].to(dtype).contiguous())
    loc, attn, shapes = case["loc"], case["attn"], case["shapes"]
    kw = dict(tile_mask=case["tile_mask"], q_tile=case["q_tile"])
    B, _, H, D = value.shape
    grad_out = _grad_out((B, loc.shape[1], H * D), dtype, value.device, seed)

    def kernel():
        return msda_cuda.msda_bwd(value, shapes, loc, attn, grad_out, **kw)

    def plain():
        ins = [t.detach().requires_grad_() for t in (value, loc, attn)]
        out = ms_deform_attn_ref(ins[0], shapes, ins[1], ins[2], **kw)
        return torch.autograd.grad(out, ins, grad_out)

    return (kernel, plain,
            lambda: msda_bwd_bound(value, shapes, loc, attn, kw["tile_mask"],
                                   kw["q_tile"]),
            ("grad_value", "grad_loc", "grad_attn"),
            BWD_REL_TOL[str(dtype).replace("torch.", "")],
            msda_bwd_variant(case, dtype))


def msda_bwd_variant(case, dtype):
    """The plan msda_bwd must take on a case: the one it names
    (``bwd_variant``), else ``msda_cuda.bwd_plan``'s on its shapes with
    value aligned unless the case shifts it."""
    dname = str(dtype).replace("torch.", "")
    if case.get("bwd_variant"):
        return case["bwd_variant"][dname]
    B, V, H, D = case["value"].shape
    _, Q, _, L, P, _ = case["loc"].shape
    return msda_cuda.BWD_VARIANTS[msda_cuda.bwd_plan(
        B, V, H, D, Q, L * P, aligned=not case.get("misaligned"))]


def factored_bwd_variant(D, misaligned_value, shapes, P):
    """The variant msda_bwd_factored takes, in either dtype: the vector
    kernel when D = 4, 8, 16 or 32 and value and grad_out are aligned to 4
    channels (csrc/msda_bwd.cu launch_bwd_factored), "privatized" when
    ``msda_cuda.factored_bwd_plan`` puts at least one level's rows in shared
    memory, "vector" when none; else "general"."""
    vec = D in (4, 8, 16, 32) and not misaligned_value
    if not vec:
        return "general"
    private_from = msda_cuda.factored_bwd_plan(shapes, D, P)
    return "privatized" if private_from < len(shapes) else "vector"


def bind_bwd_factored(case, dtype, seed=0):
    """msda_bwd_factored (d ref asked for) against autograd through the
    plain factored version (materialize, then ms_deform_attn_ref), as
    ``bind_bwd``."""
    shift = misaligned if case.get("misaligned") else (lambda t: t)
    value = shift(case["value"].to(dtype).contiguous())
    shapes, ref, off, attn = case["shapes"], case["ref_flat"], case["off"], case["attn"]
    kw = dict(tile_mask=case["tile_mask"], q_tile=case["q_tile"])
    B, _, H, D = value.shape
    grad_out = _grad_out((B, ref.shape[1], H * D), dtype, value.device, seed)

    def kernel():
        return msda_cuda.msda_bwd_factored(value, shapes, ref, off, attn,
                                           grad_out, **kw)

    def plain():
        ins = [t.detach().requires_grad_() for t in (value, ref, off, attn)]
        with ops.plain_versions():
            out = ms_deform_attn_factored(ins[0], shapes, *ins[1:], **kw)
        return torch.autograd.grad(out, ins, grad_out)

    return (kernel, plain,
            lambda: factored_bwd_bound(value, shapes, ref, off, attn,
                                       kw["tile_mask"], kw["q_tile"]),
            ("grad_value", "grad_ref", "grad_off", "grad_attn"),
            FACTORED_BWD_REL_TOL[str(dtype).replace("torch.", "")],
            case.get("bwd_variant") or factored_bwd_variant(
                D, case.get("misaligned", False), shapes, ref.shape[2] // 2))


def bind_dcn_bwd(case, dtype, seed=0):
    """dcn_bwd against autograd through modulated_deform_conv_ref, as
    ``bind_bwd``; the quad variant when C is a multiple of 4 and x is
    aligned to 4 channels (csrc/dcn_bwd.cuh col2im_dispatch), else the
    general one."""
    shift = misaligned if case.get("misaligned") else (lambda t: t)
    x = shift(case["x"].to(dtype).contiguous())
    w = case["weight"].to(dtype).contiguous()
    offset, mask, stride = case["offset"], case["mask"], case["stride"]
    B, Ho, Wo = offset.shape[:3]
    grad_out = _grad_out((B, Ho, Wo, w.shape[-1]), dtype, x.device, seed)

    def kernel():
        return dcn_cuda.dcn_bwd(x, offset, mask, w, grad_out, stride)

    def plain():
        ins = [t.detach().requires_grad_() for t in (x, offset, mask, w)]
        out = modulated_deform_conv_ref(*ins, stride)
        return torch.autograd.grad(out, ins, grad_out)

    quad = x.shape[-1] % 4 == 0 and not case.get("misaligned")
    return (kernel, plain, lambda: dcn_bwd_bound(x, offset, w, grad_out),
            ("grad_x", "grad_offset", "grad_mask", "grad_weight"),
            DCN_BWD_REL_TOL[str(dtype).replace("torch.", "")],
            case.get("bwd_variant") or ("quad" if quad else "general"))


def msda_bwd_bound(value, shapes, loc, attn, tile_mask, q_tile):
    """Least time for the MSDA backward as a function: grad_out, locations
    and weights of the active queries read once, the value rows that their
    samples touch read once, grad_value written once in value's dtype,
    grad_loc and grad_attn written; per sample and corner a D-long dot
    product and a D-long scaled add (4·D flops). Returns (ms, bound_by,
    design_bytes): the last is what the plan that runs moves besides, and
    is not in the bound: for "gather" the row lists (a row's head set and
    read, a (link, weight) pair a corner written and read) and a
    grad_out row re-read for every corner; for "general" the f32 scratch
    zero-filled, every corner row's f32 read-modify-write and for bf16 the
    scratch read and cast."""
    B, V, H, D = value.shape
    _, Q, _, L, P, _ = loc.shape
    elem = value.element_size()
    active_q = B * Q
    if tile_mask is not None:
        sizes = tile_sizes(Q, q_tile, tile_mask.shape[1], tile_mask.device)
        active_q = int((tile_mask.to(torch.int64) * sizes).sum())
    rows = touched_value_bytes(value, shapes, loc, tile_mask, q_tile) // (D * elem)
    n_value = B * V * H * D
    corners = active_q * H * L * P * 4
    nbytes = (active_q * H * D * elem                # grad_out
              + active_q * H * L * P * 3 * 4         # loc and attn read
              + rows * D * elem                      # touched value rows
              + n_value * elem                       # grad_value written
              + B * Q * H * L * P * 3 * 4)           # grad_loc, grad_attn
    aligned = value.data_ptr() % (4 * elem) == 0
    if msda_cuda.bwd_plan(B, V, H, D, Q, L * P, aligned):
        design = B * V * H * 4 * 2 + corners * (8 * 2 + D * elem)
    else:
        design = n_value * 4 + corners * D * 8 + (n_value * 4 if elem == 2 else 0)
    ms, by = cost.bound_ms(nbytes, corners * 4 * D / cost.F32_FLOP_PER_S)
    return ms, by, design


def factored_bwd_bound(value, shapes, ref, off, attn, tile_mask, q_tile):
    """Least time for msda_bwd_factored as a function: grad_out and the
    references of the active (camera, query) pairs read once, offsets and
    weights once per (sample, query) that any camera needs, the value rows
    the active samples touch once; grad_value, grad_ref, grad_off and
    grad_attn written once; 4·D flops per active sample and corner.
    Returns (ms, bound_by, design_bytes) as ``msda_bwd_bound``."""
    B, V, H, D = value.shape
    Bs, Q, L, P = attn.shape[0], ref.shape[1], len(shapes), ref.shape[2] // 2
    elem = value.element_size()
    active_q, union_q = B * Q, Bs * Q
    if tile_mask is not None:
        sizes = tile_sizes(Q, q_tile, tile_mask.shape[1], tile_mask.device)
        active_q = int((tile_mask.to(torch.int64) * sizes).sum())
        any_cam = tile_mask.reshape(Bs, B // Bs, -1).any(1).to(torch.int64)
        union_q = int((any_cam * sizes).sum())
    loc, _ = materialize_factored(ref, off, attn, shapes, H, P)
    rows = touched_value_bytes(value, shapes, loc.reshape(B, Q, H, L, P, 2),
                               tile_mask, q_tile) // (D * elem)
    del loc
    n_value = B * V * H * D
    nbytes = (active_q * H * D * elem + active_q * P * 2 * 4
              + union_q * H * L * P * 3 * 4 + rows * D * elem
              + n_value * elem + B * Q * P * 2 * 4 + Bs * Q * H * L * P * 3 * 4)
    design = n_value * 4 + rows * D * 8 + (n_value * 4 if elem == 2 else 0)
    ms, by = cost.bound_ms(nbytes, active_q * H * L * P * 4 * 4 * D / cost.F32_FLOP_PER_S)
    return ms, by, design


def dcn_bwd_bound(x, offset, weight, grad_out):
    """Least time for dcn_bwd as a function: x, offsets, mask, weight and
    grad_out read once, the gradients of all four written once; the two
    products (dcol = g . W^T and grad_weight = col^T . g, 2·9·C·O each per
    output pixel) at the card's rate for the dtype. Returns (ms, bound_by,
    design_bytes): the im2col matrix and dcol written and read (M · 9C in
    x's dtype, twice each) and the f32 scratch of grad_x (zero-filled, read
    and written by the scatter, read by the bf16 cast)."""
    B, Ho, Wo, _, _ = offset.shape
    _, C, O = weight.shape
    M = B * Ho * Wo
    elem = x.element_size()
    n_off = offset.numel()
    nbytes = (2 * x.numel() * elem + 2 * n_off * 4 + n_off // 2 * 4 * 2
              + 2 * weight.numel() * weight.element_size()
              + grad_out.numel() * grad_out.element_size())
    rate = cost.BF16_TENSOR_FLOP_PER_S if x.dtype == torch.bfloat16 else cost.F32_FLOP_PER_S
    ms, by = cost.bound_ms(nbytes, 2 * 2 * M * 9 * C * O / rate)
    design = 4 * M * 9 * C * elem + x.numel() * 4 * (3 if elem == 2 else 2)
    return ms, by, design


BWD_BINDERS = {"msda": bind_bwd, "factored": bind_bwd_factored,
               "dcn": bind_dcn_bwd}


def bwd_entry(case):
    if case["kind"] == "dcn":
        return "dcn_bwd"
    if case["kind"] == "factored":
        return "msda_bwd_factored"
    return "msda_bwd_masked" if case["tile_mask"] is not None else "msda_bwd"


def bwd_rows(dev, cases):
    """Each backward kernel on each case in f32 and bf16 against autograd
    through its plain version: each gradient's max abs error and its error
    relative to its largest magnitude against its tolerance, the variant
    that ran (an edge case fails off the variant it targets), CUDA-graph
    time, its device time by kernel (``parts``, torch.profiler), the plain
    autograd's eager time and the bound."""
    rows = []
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            kernel, plain, bound, names, tol, expect = BWD_BINDERS[case["kind"]](
                case, dtype)
            entry = bwd_entry(case)
            before = variant_counts()
            got = kernel()
            torch.cuda.synchronize()
            ran = [k.split(".", 1)[1] for k, v in variant_counts().items()
                   if v > before[k] and k.startswith(entry + ".")]
            want = plain()
            row = dict(case=case["name"] + "_bwd", dtype=dname,
                       variant=ran[0] if ran else None, entry=entry)
            ok = len(ran) == 1 and (expect is None or ran == [expect])
            for key, a, b in zip(names, got, want):
                err = float((a.float() - b.float()).abs().max())
                scale = float(b.float().abs().max())
                row[f"{key}_max_abs_err"] = err
                row[f"{key}_rel_err"] = err / max(scale, 1e-30)
                row[f"{key}_max_abs"] = scale
                ok = (ok and bool(torch.isfinite(a).all())
                      and row[f"{key}_rel_err"] <= tol[key])
            row["max_abs_err"] = max(row[f"{k}_max_abs_err"] for k in names)
            row["tol"] = tol
            del got, want
            if not case["name"].startswith("edge"):
                row["ms"] = graph_time_ms(kernel)
                row["parts"] = device_parts(kernel, n=10)
                row["plain_ms"] = time_ms(plain, warmup=1, iters=3)
                row["call_ms"] = time_ms(kernel, warmup=3, iters=20)
                row["bound_ms"], row["bound_by"], row["design_bytes"] = bound()
                if case["kind"] == "msda":
                    row["corners_per_row"] = corner_list_lengths(
                        case["value"], case["shapes"], case["loc"],
                        case["tile_mask"], case["q_tile"])
                if case.get("tile_mask") is not None:
                    row["active_tiles"] = int(case["tile_mask"].sum())
                    row["tiles"] = int(case["tile_mask"].numel())
            rows.append(row)
            emit({"phase": "kernels", **row})
            if not ok:
                raise AssertionError(f"{entry} disagrees with plain autograd "
                                     f"or ran off its variant: {row}")
            del kernel, plain
            torch.cuda.empty_cache()
    return rows


def grid_sample_ms(case, dtype):
    """CUDA-graph time of F.grid_sample (bilinear, zeros, align_corners=False)
    on a single-level case's value viewed as (B·H, D, h, w) at its
    (B·H, Q, P, 2) grid: a yardstick that samples but neither weights nor
    sums, and not the same function."""
    (h, w), = case["shapes"]
    B, _, H, D = case["value"].shape
    _, Q, _, _, P, _ = case["loc"].shape
    x = case["value"].to(dtype).permute(0, 2, 3, 1).reshape(B * H, D, h, w)
    grid = (case["loc"][:, :, :, 0] * 2 - 1).transpose(1, 2).reshape(B * H, Q, P, 2)
    grid = grid.to(dtype)
    return graph_time_ms(lambda: F.grid_sample(
        x, grid, mode="bilinear", padding_mode="zeros", align_corners=False))


def conv3x3_ms(case, dtype):
    """cuDNN's time for a plain 3x3 conv of the DCN case's shape (NCHW,
    channels_last), a yardstick and not the same function."""
    B, H, W, C = case["x"].shape
    O = case["weight"].shape[-1]
    x = case["x"].to(dtype).permute(0, 3, 1, 2)
    w = case["weight"].to(dtype).permute(2, 1, 0).reshape(O, C, 3, 3)
    w = w.contiguous(memory_format=torch.channels_last)
    return graph_time_ms(lambda: F.conv2d(x, w, None, case["stride"], 1))


def phase_kernels(dev):
    rows, outs = [], {}
    cases = (flagship_cases(dev) + occ_cases(dev) + [occ_tsa_cases(dev)[1]]
             + mapv2_cases(dev) + dcnv3_cases(dev) + tiny_det_cases(dev)
             + voxel_cases(dev) + voxel_base_cases(dev) + base_msda_cases(dev)
             + msda_edge_cases(dev) + factored_edge_cases(dev) + dcn_cases(dev))
    for case in cases:
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype).replace("torch.", "")
            kernel, plain, bound = bind(case, dtype)
            before = variant_counts()
            got = kernel()
            torch.cuda.synchronize()
            ran = [k.split(".")[1] for k, v in variant_counts().items()
                   if v > before[k]]
            want = plain()
            err = float((got.float() - want.float()).abs().max())
            finite = bool(torch.isfinite(got).all())
            entry = {"dcn": "dcn_fwd", "factored": "msda_fwd_factored"}.get(
                case["kind"], "msda_fwd" if case.get("tile_mask") is None
                else "msda_fwd_masked")
            row = dict(case=case["name"], dtype=dname, entry=entry,
                       max_abs_err=err, tol=TOL[dname], finite=finite,
                       max_abs_out=float(want.float().abs().max()))
            if ran:
                row["variant"] = ran[0]
            ok = finite and err <= TOL[dname]
            if case.get("variant") and ran != [case["variant"][dname]]:
                ok = False  # the case exists to reach this variant
            if "same_as" in case:
                # the materialized route against the factored kernel
                other = outs[(case["same_as"], dname)]
                row["max_abs_err_vs_" + case["same_as"]] = float(
                    (got.float() - other.float()).abs().max())
                ok = ok and row["max_abs_err_vs_" + case["same_as"]] <= TOL[dname]
            if not case["name"].startswith("edge"):
                # ms: device time (CUDA graph replay); call_ms: an eager call
                # as the main path makes it; plain_ms: see bind()
                row["ms"] = graph_time_ms(kernel)
                row["plain_ms"] = (graph_time_ms(plain, iters=5)
                                   if case["kind"] == "msda"
                                   else time_ms(plain, warmup=1, iters=3))
                row["call_ms"] = time_ms(kernel, warmup=3, iters=20)
                row["bound_ms"], row["bound_by"] = bound(got)
                if case.get("tile_mask") is not None:
                    row["active_tiles"] = int(case["tile_mask"].sum())
                    row["tiles"] = int(case["tile_mask"].numel())
                if case["kind"] == "dcn":
                    row["conv3x3_cudnn_ms"] = conv3x3_ms(case, dtype)
                if case["name"] == "tsa_base":
                    row["grid_sample_ms"] = grid_sample_ms(case, dtype)
                if case["name"] == "sca_base_factored":
                    outs[(case["name"], dname)] = got
            rows.append(row)
            emit({"phase": "kernels", **row})
            if not ok:
                raise AssertionError(f"kernel disagrees with plain: {row}")
            del got, want, kernel, plain, bound
    del cases, outs
    torch.cuda.empty_cache()
    base = [c for c in base_msda_cases(dev) if c["name"] != "sca_base_materialized"]
    rows += bwd_rows(dev, flagship_cases(dev) + occ_cases(dev)
                     + list(occ_tsa_cases(dev)) + mapv2_cases(dev)
                     + dcnv3_cases(dev) + tiny_det_cases(dev)
                     + voxel_cases(dev) + voxel_base_cases(dev) + base
                     + base_factored_bwd_cases(next(
                         c for c in base if c["name"] == "sca_base_factored"))
                     + msda_edge_cases(dev) + factored_edge_cases(dev)
                     + dcn_cases(dev))
    torch.cuda.empty_cache()
    reset_launch_counts()
    return rows


# ----------------------------------------------------------------- stream

def _frame_to(frame, dev):
    out = dict(frame)
    for k in ("img", "lidar2img"):
        out[k] = torch.as_tensor(frame[k]).to(dev)
    return out


def _rel_err(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / max(1.0, float(b.abs().max())))


def f32_config(cfg):
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        model=dataclasses.replace(cfg.model, transformer_dtype="float32"))


def frame_step(model, dev, frame, delta, prev):
    cb, hp = delta
    with torch.inference_mode():
        outs, new_prev = model.forward_test_frame(
            frame["img"].to(dev)[None], torch.as_tensor(cb, device=dev)[None],
            frame["lidar2img"].to(dev)[None], prev,
            torch.full((1,), hp, device=dev))
    return last_layer(outs), new_prev


def first_deltas(frames):
    """(can_bus delta, has_prev) of the stream's first two frames."""
    state = StreamingState()
    deltas = []
    for f in frames[:2]:
        deltas.append(state.prepare_frame(f["can_bus"], f["scene_token"]))
        state.update(True)
    return deltas


def drive(name, cfg, model, frames, expect_per_frame):
    """The main path: counts set to 0 just before the frames run through
    the streaming runner, read just after; exact launches per frame, finite
    outputs and the scene resets checked."""
    runner = StreamingRunner(cfg, model)
    reset_launch_counts()
    results = [runner.step(f) for f in frames]
    torch.cuda.synchronize()
    launches = read_launch_counts()
    n = len(frames)
    finite = all(bool(torch.isfinite(t.float()).all())
                 for r in results for t in r["outs"].values())
    has_prev = [r["has_prev"] for r in results]
    line = {"phase": name, "frames": n, "launches": launches,
            "per_frame": {k: v / n for k, v in launches.items()},
            "finite": finite, "has_prev": has_prev,
            "dets_valid": [int(r["det"].valid.sum()) for r in results]}
    if "occ" in results[0]:
        # voxels per class (the last one free) of each frame's grid
        line["occ_class_hist"] = [torch.bincount(
            r["occ"], minlength=cfg.model.occupancy_classes + 1).tolist()
            for r in results]
    m = cfg.model
    flow_shape = (1, m.occ_zdim * m.occ_ydim * m.occ_xdim, 2)
    if m.with_map and m.with_aux_seg:
        line["seg_shapes"] = {k: list(results[0]["outs"][k].shape) for k in (
            "bev_seg_logits", "pv_seg_logits") if k in results[0]["outs"]}
    if m.with_occupancy and m.predict_flow:
        line["flow_preds_shape"] = list(results[0]["outs"]["flow_preds"].shape)
        line["flow_preds_max_abs"] = max(
            float(r["outs"]["flow_preds"].abs().max()) for r in results)
    emit(line)
    expect = {k: v * n for k, v in expect_per_frame.items()}
    if launches != expect:
        raise AssertionError(f"{name}: launches {launches} != expected {expect}")
    if "flow_preds_shape" in line and tuple(line["flow_preds_shape"]) != flow_shape:
        raise AssertionError(f"{name}: flow_preds {line['flow_preds_shape']}")
    # BEV logits on the BEV grid, PV logits on each camera's finest level
    if "seg_shapes" in line and (
            line["seg_shapes"].get("bev_seg_logits") != [1, m.bev_h, m.bev_w]
            or line["seg_shapes"].get("pv_seg_logits", [])[:2] != [1, m.num_cams]):
        raise AssertionError(f"{name}: segmentation logits {line['seg_shapes']}")
    if not finite or has_prev != [0.0, 1.0, 1.0, 0.0, 1.0, 1.0]:
        raise AssertionError(f"{name}: non-finite outputs or wrong scene resets")
    return launches


def frames_per_s(cfg, model, frames, n):
    """Steady state (``profile_step.frame_ms``): 2 warm frames, then CUDA
    events around ``n`` frames."""
    return 1e3 / profile_step.frame_ms(cfg, model, frames, n)


def phase_stream(dev):
    cfg = bev_tiny_det_map_apollo()
    cfg32 = f32_config(cfg)
    torch.cuda.reset_peak_memory_stats()
    n_frames = 6
    frames = [_frame_to(f, dev) for f in
              make_stream(cfg, n_frames, seed=1, scene_change_at=(3,))]
    model = build_model(cfg, device=dev, seed=0)
    # per frame: TSA in every encoder layer and cross-attention in every det
    # and map decoder layer (15 at the flagship), SCA per encoder layer (3),
    # all on the vector variants
    m = cfg.model
    n_plain = m.encoder_layers + m.decoder_layers + m.map_decoder_layers
    launches = drive("stream", cfg, model, frames, {
        **dict.fromkeys(read_launch_counts(), 0),
        "msda_fwd": n_plain, "msda_fwd.vector": n_plain,
        "msda_fwd_masked": m.encoder_layers,
        "msda_fwd_masked.vector": m.encoder_layers})

    # one f32 frame with history (frame 1 after frame 0) on the GPU against
    # the CPU plain path, same weights and inputs
    state = model.state_dict()
    model32 = build_model(cfg32, device=dev, seed=0)
    model32.load_state_dict(state)
    cpu32 = build_model(cfg32, device="cpu", seed=0)
    cpu32.load_state_dict(state)
    deltas = first_deltas(frames)
    Q = m.bev_h * m.bev_w
    _, prev = frame_step(model32, dev, frames[0], deltas[0],
                         torch.zeros((1, Q, m.embed_dims), device=dev))
    gpu, _ = frame_step(model32, dev, frames[1], deltas[1], prev)
    t0 = time.perf_counter()
    cpu, _ = frame_step(cpu32, "cpu", frames[1], deltas[1], prev.cpu())
    cpu_s = time.perf_counter() - t0
    errs = {k: _rel_err(gpu[k], cpu[k]) for k in gpu}
    emit({"phase": "stream_f32_vs_cpu", "has_prev": deltas[1][1],
          "rel_err": errs, "tol": STREAM_REL_TOL, "cpu_frame_s": cpu_s})
    if deltas[1][1] != 1.0 or max(errs.values()) > STREAM_REL_TOL:
        raise AssertionError(f"GPU f32 frame disagrees with the CPU: {errs}")

    fps = {name: frames_per_s(c, mdl, frames, 20)
           for name, c, mdl in (("bf16", cfg, model), ("f32", cfg32, model32))}
    emit({"phase": "stream_fps", "frames_per_s": fps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for name, c, mdl in (("bf16", cfg, model), ("f32", cfg32, model32)):
        profile_frames("profile", name, c, mdl, frames, 1e3 / fps[name])
    stage_split("stream_stages", cfg, (("bf16", model), ("f32", model32)), frames)
    probes_add_nothing(cfg, model, frames, 1e3 / fps["bf16"])
    return launches


def f32_frame_vs_plain(phase, cfg, model32, dev, frames, tol):
    """One f32 frame with history (frame 1 after frame 0) on the GPU,
    kernels against the plain versions of the same frame from the same
    carried BEV; no kernel may launch under the plain versions. A third
    frame, plain versions with the kernels' BEV put into the det decoder,
    splits the decoder's difference (``decoder_split``). Every output is
    held at ``tol``; the BEV and the decoder's first cross-attention at
    UNAMPLIFIED_REL_TOL."""
    deltas = first_deltas(frames)
    _, prev = frame_step(model32, dev, frames[0], deltas[0],
                         model32.zero_carry(1, dev))
    with decoder_taps(model32) as (calls, swap):
        got, _ = frame_step(model32, dev, frames[1], deltas[1], prev)
        torch.cuda.synchronize()
        before = read_launch_counts()
        t0 = time.perf_counter()
        with ops.plain_versions():
            want, _ = frame_step(model32, dev, frames[1], deltas[1], prev)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        plain_launches = {k: v - before[k] for k, v in read_launch_counts().items()}
        swap["memory"] = calls[0]["memory"]
        with ops.plain_versions():
            mixed, _ = frame_step(model32, dev, frames[1], deltas[1], prev)
    errs = {k: _rel_err(got[k], want[k]) for k in got}
    emit({"phase": phase, "has_prev": deltas[1][1], "rel_err": errs,
          "tol": tol, "plain_frame_s": plain_s, "plain_launches": plain_launches})
    split = decoder_split(phase + "_split", model32, lidar2img=frames[1]["lidar2img"],
                          outs=(got, want, mixed), calls=calls,
                          pillar_points=cfg.model.num_points_in_pillar)
    emit(split)
    first = split["layers"][0]["AB"]["cross_attn"]
    if (deltas[1][1] != 1.0 or max(errs.values()) > tol
            or max(errs["bev_embed"], first) > UNAMPLIFIED_REL_TOL
            or read_launch_counts() != before):
        raise AssertionError(f"{phase}: GPU f32 frame disagrees with plain: {errs}, "
                             f"first decoder cross-attention {first}")


@contextlib.contextmanager
def decoder_taps(model):
    """Records, on every call of the model's det decoder, its BEV input,
    its (states, refs, regs) and each layer's self-attention,
    cross-attention and FFN outputs; a BEV put into ``swap["memory"]``
    replaces the decoder's input."""
    dec = next(x for x in model.modules()
               if isinstance(x, DetectionTransformerDecoder) and x.ref_mode == "det3d")
    calls, swap = [], {}
    subs = {}

    def pre(mod, args, kwargs):
        subs.clear()
        if "memory" in swap:
            return (args[0], swap["memory"], *args[2:]), kwargs
        return None

    def post(mod, args, kwargs, out):
        states, refs, regs = out
        calls.append({"memory": args[1].clone(), "states": states, "refs": refs,
                      "regs": regs, **{k: torch.stack(v) for k, v in subs.items()}})

    def sub(name):
        return lambda mod, args, out: subs.setdefault(name, []).append(out)

    hooks = [dec.register_forward_pre_hook(pre, with_kwargs=True),
             dec.register_forward_hook(post, with_kwargs=True)]
    for layer in dec.layers:
        hooks += [getattr(layer, n).register_forward_hook(sub(n))
                  for n in ("self_attn", "cross_attn", "ffn")]
    try:
        yield calls, swap
    finally:
        for h in hooks:
            h.remove()


def _row_rel(a, b):
    """max over rows of |a - b| / |b|, each row's max magnitude its scale."""
    a, b = a.float(), b.float()
    return float(((a - b).abs().amax(-1) / b.abs().amax(-1).clamp_min(1e-30)).max())


def decoder_split(phase, model, lidar2img, outs, calls, pillar_points):
    """Where an f32 frame's det difference, kernels (A) against plain
    versions (B), arises. C is the plain frame with A's BEV put into the
    decoder: C against B is the BEV's difference carried through the
    decoder, A against C the decoder's own MSDA kernels. For each decoder
    layer: the worst query's relative difference of the self-attention,
    cross-attention, FFN output and state (each row against its own
    magnitude), the refs' largest difference in BEV cells and the
    regressions' (``_rel_err``). For the worst box channel of the last
    layer: its query, the query's state difference and ref after each layer,
    and whether a camera sees the BEV cell under each ref (at any of the
    config's ``pillar_points`` heights of the cell's pillar). The decoder's
    BEV memory's difference per cell against each cell's magnitude, seen
    and unseen (the encoder's BEV, or voxel2bev of a voxel or hybrid head's
    last volume)."""
    head = model.head
    (ka, kb, kc), (oa, ob, oc) = calls, outs
    cells = float(max(head.bev_h, head.bev_w))
    pairs = {"AB": (ka, kb), "CB": (kc, kb), "AC": (ka, kc)}
    layers = []
    for lvl in range(ka["states"].shape[0]):
        row = {}
        for name, (x, y) in pairs.items():
            row[name] = {
                **{k: _row_rel(x[k][lvl], y[k][lvl])
                   for k in ("self_attn", "cross_attn", "ffn", "states")},
                "ref_cells": float((x["refs"][lvl] - y["refs"][lvl])[..., :2]
                                   .abs().max()) * cells,
                "regs": _rel_err(x["regs"][lvl], y["regs"][lvl])}
        layers.append(row)
    final = {name: {k: _rel_err(x[k], y[k]) for k in ("cls_scores", "bbox_preds")}
             for name, (x, y) in {"AB": (oa, ob), "CB": (oc, ob), "AC": (oa, oc)}.items()}
    diff = (oa["bbox_preds"] - ob["bbox_preds"]).abs()[0]       # (Q, code)
    q, c = divmod(int(diff.argmax()), diff.shape[-1])
    pc = head.pc_range
    ref3d = torch.as_tensor(geometry.bev_reference_points_3d(
        head.bev_h, head.bev_w, pc[5] - pc[2], pillar_points),
        device=ka["memory"].device)
    _, bev_mask = geometry.point_sampling(
        ref3d, pc, lidar2img.to(ref3d.device)[None], head.img_shape)
    seen = bev_mask[0].any(-1).any(0)                           # (HW,)
    refs = kb["refs"][:, 0, q]                                  # (Lyr, 3)
    ix = (refs[:, 0] * head.bev_w).long().clamp(0, head.bev_w - 1)
    iy = (refs[:, 1] * head.bev_h).long().clamp(0, head.bev_h - 1)
    worst = {"query": q, "channel": c, "abs_err": float(diff[q, c]),
             "state": [_row_rel(ka["states"][lvl, 0, q], kb["states"][lvl, 0, q])
                       for lvl in range(refs.shape[0])],
             "ref": [[round(float(v), 6) for v in r] for r in refs],
             "ref_cell_seen": [bool(seen[i * head.bev_w + j]) for i, j in zip(iy, ix)]}
    bev = (ka["memory"] - kb["memory"]).abs().amax(-1)[0] \
        / kb["memory"].abs().amax(-1)[0].clamp_min(1e-30)
    edge = torch.minimum(kb["refs"][..., :2], 1 - kb["refs"][..., :2])
    return {"phase": phase, "layers": layers, "final": final, "worst": worst,
            "bev_cell_rel": {"seen": float(bev[seen].max()) if bool(seen.any()) else None,
                             "unseen": float(bev[~seen].max()) if bool((~seen).any()) else None,
                             "unseen_share": float((~seen).float().mean())},
            "refs_within_1e-3_of_edge": float((edge < 1e-3).float().mean())}


def occ_bf16_vs_f32(phase, cfg, model, model32, dev, frames):
    """What computing the occupancy upsampling in bf16 (the JAX package's
    CNNUpsample computes in f32) changes: frame 1 (after frame 0) of the
    bf16 model against the f32 model, and the bf16 head alone against the
    f32 head on the f32 model's BEV (and, with the refinement pass, the f32
    model's image features). Logits as error relative to the f32 logits'
    largest magnitude; class grids as the share of voxels of equal class,
    over all voxels and over those the f32 grid marks occupied. Fails above
    OCC_BF16_REL_TOL or below OCC_BF16_AGREEMENT."""
    deltas = first_deltas(frames)
    outs = {}
    for name, mdl in (("bf16", model), ("f32", model32)):
        _, prev = frame_step(mdl, dev, frames[0], deltas[0], mdl.zero_carry(1, dev))
        outs[name], _ = frame_step(mdl, dev, frames[1], deltas[1], prev)
    want = outs["f32"]["occupancy_preds"]
    parts = [("frame", outs["bf16"]["occupancy_preds"])]
    # a voxel or hybrid head is f32 in both models: only the trunk differs
    if cfg.model.head_family == "bev":
        with torch.inference_mode():
            images = ()
            if model.head.occ_tsa:
                images = (model32.extract_img_feat(frames[1]["img"].to(dev)[None]),
                          frames[1]["lidar2img"].to(dev)[None])
            parts.append(("head", model.head.occ_branches(model.head._occ_from_bev(
                outs["f32"]["bev_embed"], *images).float())))
    rule = occupancy_rule(cfg)
    free = want.shape[-1]
    w = occupancy_prediction(want, rule)
    occupied = w != free
    line = {"phase": phase, "f32_occupied_share": float(occupied.float().mean())}
    for name, got in parts:
        same = occupancy_prediction(got, rule) == w
        line[name] = {
            "logits_rel_err": _rel_err(got, want),
            "class_agreement": float(same.float().mean()),
            "class_agreement_occupied": float(same[occupied].float().mean())
            if bool(occupied.any()) else None}
    line.update(tol=OCC_BF16_REL_TOL, min_agreement=OCC_BF16_AGREEMENT)
    emit(line)
    if (not all(bool(torch.isfinite(got).all()) for _, got in parts)
            or any(line[k]["logits_rel_err"] > OCC_BF16_REL_TOL
                   or line[k]["class_agreement"] < OCC_BF16_AGREEMENT
                   for k, _ in parts)):
        raise AssertionError(f"{phase}: {line}")


def phase_stream_model(dev, cfg, phase, n_fps=20, f32=True):
    """A det, det+occ, MapTRv2, voxel or hybrid model at full width
    through the streaming runner: TSA per encoder layer, cross-attention per
    det (and map) decoder layer and, with InternImage, DCNv3 per trunk
    block on the plain entry, SCA per encoder layer on the masked one, plus
    one TSA and one SCA with the refinement pass (``occ_tsa``), all on the
    vector variants (a voxel or hybrid head: ``voxel_family_launches``,
    with R101's DCN);
    the occupancy grid's class histogram (and the flows' shape with a flow
    branch) or both segmentation logits' shapes; offset predictors seeded
    as ``new_model`` seeds them; frames/s and a profile in the configured
    dtype. With ``f32``: the f32 frame against plain versions and, for a
    bf16 config, the bf16 occupancy against the f32 one
    (``occ_bf16_vs_f32``, with an occupancy head), f32 frames/s and a
    profile."""
    cfg32 = f32_config(cfg)
    m = cfg.model
    torch.cuda.reset_peak_memory_stats()
    frames = [_frame_to(f, dev) for f in
              make_stream(cfg, 6, seed=1, scene_change_at=(3,))]
    model = new_model(cfg, dev)
    expect = stream_launches_per_frame(cfg)
    if m.head_family != "bev":
        expect = voxel_family_launches(cfg, train=False)
    launches = drive(phase, cfg, model, frames, expect)
    dname = "bf16" if cfg.compute_dtype == "bfloat16" else "f32"
    runs = [(dname, cfg, model)]
    if f32:
        model32 = model
        if dname != "f32":
            model32 = build_model(cfg32, device=dev, seed=0)
            model32.load_state_dict(model.state_dict())
            runs.append(("f32", cfg32, model32))
        f32_frame_vs_plain(phase + "_f32_vs_plain", cfg32, model32, dev, frames,
                           STREAM_REL_TOL)
        if m.with_occupancy and dname != "f32":
            occ_bf16_vs_f32(phase + "_bf16_vs_f32", cfg, model, model32, dev,
                            frames)
    fps = {name: frames_per_s(c, mdl, frames, n_fps) for name, c, mdl in runs}
    emit({"phase": phase + "_fps", "frames_per_s": fps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for name, c, mdl in runs:
        profile_frames("profile_" + phase.removeprefix("stream_"), name, c,
                       mdl, frames, 1e3 / fps[name])
    return launches


def phase_stream_occ_aggr(dev):
    """bev_smoke_det_occ_flow served (the warping acts in training only):
    6 frames through the streaming runner with exact launches (TSA and 2
    decoder layers on the plain entry, SCA on the masked one), finite
    outputs and flows of every voxel."""
    cfg = bev_smoke_det_occ_flow()
    m = cfg.model
    frames = [_frame_to(f, dev) for f in
              make_stream(cfg, 6, seed=1, scene_change_at=(3,))]
    n_plain = m.encoder_layers + m.decoder_layers
    return drive("stream_occ_aggr", cfg, build_model(cfg, device=dev, seed=0),
                 frames, {**dict.fromkeys(read_launch_counts(), 0),
                          "msda_fwd": n_plain, "msda_fwd.vector": n_plain,
                          "msda_fwd_masked": m.encoder_layers,
                          "msda_fwd_masked.vector": m.encoder_layers})


@torch.no_grad()
def perturb_offset_predictors(model, seed):
    """Seeded N(0, 1/fan_in) noise on the zero-initialized offset
    predictors: the DCN offset convs (``conv2_offset``), the
    deformable-attention offset layers (``sampling_offsets``) and
    InternImage's DCNv3 ``offset`` and ``mask`` layers, so that samples
    land between pixels and cells (with zero kernels every DCN and DCNv3
    tap samples a whole pixel, at a kink of the bilinear weights, every
    DCNv3 tap weighs 1/9 and every attention offset is a constant). On the
    unit-scale ``dw_norm`` output the DCNv3 offsets come out ~N(0, 1) px."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith(("conv2_offset.weight", "sampling_offsets.weight",
                          "dcn.offset.weight", "dcn.mask.weight")):
            noise = torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel())
            p.add_(noise.to(p.device))


@torch.no_grad()
def perturb_trunk_stem_biases(model, seed):
    """Seeded N(0, 1/fan_in) noise on the biases of InternImage's stem and
    downsampling convs (zero-initialized, as flax initializes them). Where
    the grid mask blanks the image, a zero bias makes every LayerNorm of
    the trunk normalize an all-zero vector, whose backward gain is
    1/sqrt(1e-6) = 1,000 a norm: through the 33 blocks the gradient of
    such a pixel overflows to inf, with the kernels and with the plain
    versions alike, and the step's clip turns every gradient into NaN.
    The JAX package's trunk overflows in the same parameters
    (tests/test_torch_internimage.py,
    ``test_zero_stem_biases_over_a_blanked_stripe_overflow_as_in_jax``), so
    this is the model's own behaviour at flax's init, not the port's. With
    the bias noise the blanked pixels carry a generic vector from the first
    conv on."""
    g = torch.Generator().manual_seed(seed)
    for name, p in model.named_parameters():
        if re.fullmatch(r"img_backbone\.(stem[12]|down\d+)\.bias", name):
            conv = model.get_submodule(name.rsplit(".", 1)[0])
            std = 1.0 / math.sqrt(conv.weight[0].numel())
            p.add_((torch.randn(p.shape, generator=g) * std).to(p.device))


def phase_stream_base(dev):
    cfg = bev_base_det_map()
    cfg32 = f32_config(cfg)
    m = cfg.model
    torch.cuda.reset_peak_memory_stats()
    frames = [_frame_to(f, dev) for f in
              make_stream(cfg, 6, seed=1, scene_change_at=(3,))]
    model = new_model(cfg, dev)
    n_dcn = dcn_blocks(cfg)
    # per frame: TSA per encoder layer and cross-attention per det and map
    # decoder layer (18), factored SCA per encoder layer (6), DCN in every
    # block of stages 3-4 (23 + 3); all on their vector variants
    n_plain = m.encoder_layers + m.decoder_layers + m.map_decoder_layers
    launches = drive("stream_base", cfg, model, frames, {
        **dict.fromkeys(read_launch_counts(), 0),
        "msda_fwd": n_plain, "msda_fwd.vector": n_plain,
        "msda_fwd_factored": m.encoder_layers,
        "msda_fwd_factored.vector": m.encoder_layers,
        "dcn_fwd": n_dcn, "dcn_fwd.vector": n_dcn})

    model32 = build_model(cfg32, device=dev, seed=0)
    model32.load_state_dict(model.state_dict())
    f32_frame_vs_plain("stream_base_f32_vs_plain", cfg32, model32, dev, frames,
                       BASE_REL_TOL)

    fps = {name: frames_per_s(c, mdl, frames, 10)
           for name, c, mdl in (("bf16", cfg, model), ("f32", cfg32, model32))}
    emit({"phase": "stream_base_fps", "frames_per_s": fps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    for name, c, mdl in (("bf16", cfg, model), ("f32", cfg32, model32)):
        profile_frames("profile_base", name, c, mdl, frames, 1e3 / fps[name])
    stage_split("stream_base_stages", cfg, (("bf16", model), ("f32", model32)), frames)
    return launches


def phase_base_occ(dev, cfg=None, phase="base_occ", train=True,
                   train_phase=None, cmp_sizes=None):
    """bev_base_occ at full width (the base trunk, 200x200 BEV, the MLP
    occupancy head on a 200x200x16 grid), or another base-scale occupancy
    config (``bev_base_occ_intern_s``: InternImage-S stages 2-4 in place of
    R101-DCN): streamed frames with exact launch counts per frame (12
    plain: 6 TSA and 6 det decoder, plus 33 DCNv3 with InternImage-S; 6
    factored; 26 DCN with R101-DCN; vector), finite outputs, its f32 frame
    with history against the same frame under ``ops.plain_versions()``,
    bf16 frames/s and a profile; then, with ``train``, its train step
    (``phase_train`` as ``train_phase``, by default ``phase`` + "_train"):
    3 bf16 steps with exact launch counts, steps/s, peak memory and a
    profile, and with ``cmp_sizes`` the f32 step against plain versions at
    those sizes."""
    cfg = cfg or bev_base_occ()
    cfg32 = f32_config(cfg)
    m = cfg.model
    torch.cuda.reset_peak_memory_stats()
    frames = [_frame_to(f, dev) for f in
              make_stream(cfg, 6, seed=1, scene_change_at=(3,))]
    model = new_model(cfg, dev)
    n_plain = m.encoder_layers + m.decoder_layers + dcnv3_blocks(cfg)
    n_dcn = dcn_blocks(cfg)
    stream = drive(phase, cfg, model, frames, {
        **dict.fromkeys(read_launch_counts(), 0),
        "msda_fwd": n_plain, "msda_fwd.vector": n_plain,
        "msda_fwd_factored": m.encoder_layers,
        "msda_fwd_factored.vector": m.encoder_layers,
        "dcn_fwd": n_dcn, "dcn_fwd.vector": n_dcn})
    model32 = build_model(cfg32, device=dev, seed=0)
    model32.load_state_dict(model.state_dict())
    f32_frame_vs_plain(phase + "_f32_vs_plain", cfg32, model32, dev, frames,
                       BASE_REL_TOL)
    del model32
    fps = frames_per_s(cfg, model, frames, 10)
    emit({"phase": phase + "_fps", "frames_per_s": {"bf16": fps},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    profile_frames("profile_" + phase.removeprefix("stream_"), "bf16", cfg,
                   model, frames, 1e3 / fps)
    del model
    torch.cuda.empty_cache()
    if not train:
        return stream
    train = phase_train(dev, cfg, train_phase or phase + "_train", f32=False,
                        compare=cmp_sizes is not None, cmp_sizes=cmp_sizes)
    return stream, train


# ------------------------------------------------------------------ train

def occ_tsa_layers(cfg) -> int:
    """Refinement layers at occupancy resolution that a supervised frame
    runs (TSA and SCA each): one with ``occ_tsa`` on the CNN head."""
    m = cfg.model
    return int(m.with_occupancy and m.occ_tsa and m.occ_head_type == "cnn")


def dcn_blocks(cfg) -> int:
    """DCN convolutions a frame runs: every block of the ResNet's DCN
    stages (23 + 3 in R101 stages 3-4), none in DLA or InternImage."""
    m = cfg.model
    if m.backbone_type != "resnet":
        return 0
    return sum(n for n, dcn in zip(STAGE_BLOCKS[m.backbone_depth],
                                   m.backbone_dcn_stages) if dcn)


def dcnv3_blocks(cfg) -> int:
    """DCNv3 calls a frame runs on the plain MSDA entry: one a block of
    InternImage-S (4 + 4 + 21 + 4), none in the other trunks."""
    if cfg.model.backbone_type != "internimage":
        return 0
    return sum(internimage.DEPTHS)


def head_widths(cfg):
    """The per-head widths D of a voxel or hybrid head's MSDA calls in one
    frame: (encoder calls, det decoder calls). The VoxelFormer's encoder
    makes one SCA a layer (its TSA runs ``ops.msda3d``); the HybridFormer's
    a TSA and an SCA at stage 0 and one SCA in each voxel stage (one layer a
    stage, as the JAX package builds it), 8 heads each."""
    m = cfg.model
    dec = [m.embed_dims // 8] * m.decoder_layers
    if m.head_family == "voxel":
        return [m.embed_dims // 8] * m.encoder_layers, dec
    dims = m.hybrid_encoder_embed_dims
    return [dims[0] // 8] * 2 + [c // 8 for c in dims[1:]], dec


def voxel_family_launches(cfg, train: bool) -> dict:
    """Launches of one frame, or with ``train`` of one train step, of a
    voxel or hybrid model, by entry and variant: every MSDA call of the
    head on the plain entry in f32 (the head's dtype in every config) on
    ``fwd_variant``'s variant at its width, in each of the queue's T frames
    for the encoder and on the supervised one for the det decoder;
    InternImage-S's DCNv3 and R101's DCN per frame; the backward on the
    supervised frame's calls (msda_bwd's gather plan at D = 4-32, its
    general one at D = 2)."""
    m = cfg.model
    T = m.queue_length if train else 1
    enc, dec = head_widths(cfg)
    n_v3, n_dcn = dcnv3_blocks(cfg), dcn_blocks(cfg)
    out = dict.fromkeys(read_launch_counts(), 0)

    def add(entry, variant, n):
        out[entry] += n
        out[f"{entry}.{variant}"] += n

    for D in enc * T + dec:
        add("msda_fwd", fwd_variant(D, torch.float32), 1)
    add("msda_fwd", "vector", T * n_v3)
    add("dcn_fwd", "vector", T * n_dcn)
    if train:
        for D in enc + dec:
            add("msda_bwd", "gather" if D in msda_cuda.BWD_VECTOR_WIDTHS
                else "general", 1)
        add("msda_bwd", "gather", n_v3)
        add("dcn_bwd", "quad", n_dcn)
    return out


# the variant each entry takes on the main paths where it is not "vector"
MAIN_PATH_VARIANT = {"msda_bwd": "gather", "msda_bwd_masked": "gather",
                     "msda_bwd_factored": "privatized", "dcn_bwd": "quad"}


def train_launches_per_step(cfg) -> dict:
    """Launches of one train step, by entry and variant: the forward runs
    TSA per encoder layer in each of the T queue frames and the det (and
    map) decoder layers on the supervised one (plain entry), SCA per encoder
    layer in each frame (the masked entry over one level, the factored
    entry over several) and DCN in every block of the DCN stages in each
    frame; the backward runs on the supervised frame's calls only (the
    history replay is under no_grad). The occupancy refinement pass adds
    one TSA and one SCA on the supervised frame, forward and backward.
    MapTRv2's decoupled map layers make one cross-attention call each, as
    MapTR v1's do, over all 350 vectors in training. InternImage-S's 33
    DCNv3 blocks run the plain entry in each frame and its backward on the
    supervised one. Voxel and hybrid models: ``voxel_family_launches``."""
    m = cfg.model
    if m.head_family != "bev":
        return voxel_family_launches(cfg, train=True)
    T, E, R = m.queue_length, m.encoder_layers, occ_tsa_layers(cfg)
    dec = m.decoder_layers + (m.map_decoder_layers if m.with_map else 0)
    n_v3 = dcnv3_blocks(cfg)
    multi = m.num_feature_levels > 1
    sca_fwd = "msda_fwd_factored" if multi else "msda_fwd_masked"
    sca_bwd = "msda_bwd_factored" if multi else "msda_bwd_masked"
    n_dcn = dcn_blocks(cfg)
    n = {"msda_fwd": T * (E + n_v3) + R + dec, sca_fwd: T * E + R,
         "msda_bwd": E + n_v3 + R + dec, sca_bwd: E + R, "dcn_fwd": T * n_dcn,
         "dcn_bwd": n_dcn}
    out = dict.fromkeys(read_launch_counts(), 0)
    out.update({k: v for k, v in n.items() if v})
    out.update({f"{k}.{MAIN_PATH_VARIANT.get(k, 'vector')}": v
                for k, v in n.items() if v})
    return out


def new_model(cfg, dev):
    """The config's model from seed 0, with seeded noise on its
    zero-initialized offset predictors where the trunk has DCN or DCNv3 (as
    ``phase_stream_base``) or the head is a voxel or hybrid one (whose TSA
    offsets would otherwise be constants of the grid), and on InternImage's stem and downsampling
    biases (``perturb_trunk_stem_biases``)."""
    model = build_model(cfg, device=dev, seed=0)
    if dcn_blocks(cfg) or dcnv3_blocks(cfg) or cfg.model.head_family != "bev":
        perturb_offset_predictors(model, seed=0)
    if dcnv3_blocks(cfg):
        perturb_trunk_stem_biases(model, seed=0)
    return model


def train_steps(cfg, model, optimizer, batch, gen, first, n):
    """``n`` train steps from step index ``first``, each with its generator
    seed as the training loop draws it; returns the last step's terms."""
    for i in range(first, first + n):
        gen.manual_seed(step_seed(0, i))
        losses = train_lib.train_step(model, optimizer, batch, gen, cfg=cfg)
    return losses


def steps_per_s(cfg, model, optimizer, batch, gen, n):
    """Steady state: 2 warm steps, then host clock around ``n`` steps that
    end in a synchronize (each step waits on the host once anyway, for the
    matching)."""
    train_steps(cfg, model, optimizer, batch, gen, 100, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_steps(cfg, model, optimizer, batch, gen, 102, n)
    torch.cuda.synchronize()
    return n / (time.perf_counter() - t0)


def grad_step(model, cfg, batch, gen, seed, indices=None):
    """One f32 forward and backward in training mode: (loss terms,
    {name: gradient}, indices)."""
    model.zero_grad(set_to_none=True)
    gen.manual_seed(seed)
    with use_generator(gen):
        total, losses, indices = train_lib.loss_fn(model, batch, cfg, indices)
    total.backward()
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v.detach()) for k, v in losses.items()}, grads, indices


def witness_step(model, cfg, batch, gen, seed, indices, kind, wseed):
    """The plain step (as ``grad_step``) with its images (``kind``
    "images") or every parameter ("weights") moved by a relative
    WITNESS_EPS of noise from ``wseed``; the weights are restored after."""
    dev = batch["img"].device
    noise_gen = torch.Generator(device=dev).manual_seed(wseed)

    def moved(t):
        return t * (1 + WITNESS_EPS * torch.randn(
            t.shape, device=dev, generator=noise_gen, dtype=t.dtype))

    saved = None
    if kind == "images":
        batch = dict(batch, img=moved(batch["img"]))
    else:
        saved = {k: p.detach().clone() for k, p in model.named_parameters()}
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(moved(p))
    try:
        with ops.plain_versions():
            losses, grads, _ = grad_step(model, cfg, batch, gen, seed, indices)
    finally:
        if saved is not None:
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(saved[k])
    return losses, grads


def phase_train(dev, cfg, phase, *, cmp_sizes=None, f32=True, compare=True,
                split_on_general=True):
    """A train step (the flagship's, ``phase`` "train", the det+occ
    models', "train_occ", "train_occ_tsa", "train_occ_flow", the base
    models', "train_base" and "base_occ_train", at full width; the smoke
    flow-warping model's, "train_occ_aggr"): steps in the configured dtype
    with exact launch counts, finite loss terms (``loss_flow`` > 0 with a
    flow branch) and the peak memory of those steps; with ``compare``, the
    f32 step with kernels against plain versions beside the witnesses (with
    the model fields ``cmp_sizes`` where given, see BASE_CMP_SIZES; with
    ``split_on_general``, split by kernel where a general variant ran); with
    ``f32``, steady-state steps/s of the f32 model at F32_SPEED_SIZES beside
    the configured dtype's at full depth; a profile of each."""
    cfg32 = f32_config(cfg)
    torch.cuda.reset_peak_memory_stats()
    batch = train_lib.batch_to_device(
        make_batch(cfg, 1, seed=0, paint_gt=True), dev)
    model = new_model(cfg, dev).train()
    optimizer = make_optimizer(model, cfg.optim)
    gen = torch.Generator(device=dev)
    n_steps = 3
    # the main path: counts set to 0 just before the steps, read just after
    reset_launch_counts()
    t0 = time.perf_counter()
    history = []
    for i in range(n_steps):
        losses = train_steps(cfg, model, optimizer, batch, gen, i, 1)
        history.append({k: float(v) for k, v in losses.items()})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    steps_peak = torch.cuda.max_memory_allocated() / 1e9
    expect = {k: v * n_steps for k, v in train_launches_per_step(cfg).items()}
    finite = all(math.isfinite(v) for h in history for v in h.values())
    if cfg.model.with_occupancy and cfg.model.predict_flow:
        finite = finite and all(h["loss_flow"] > 0 for h in history)
    if cfg.model.with_map and cfg.model.map_version == 2:
        # the one2many and aux segmentation terms are there
        finite = finite and all(k in h for h in history for k in (
            "loss_map_pts_one2many", "loss_map_bev_seg", "loss_map_pv_seg"))
    emit({"phase": phase, "config": cfg.name, "steps": n_steps,
          "seconds_incl_first": seconds, "launches": launches,
          "per_step": {k: v / n_steps for k, v in launches.items()},
          "finite": finite,
          "loss_total": [h["loss_total"] for h in history],
          "grad_norm": [h["grad_norm"] for h in history],
          "terms_last": history[-1], "peak_mem_gb_steps": steps_peak})
    if launches != expect:
        raise AssertionError(f"{phase}: launches {launches} != expected {expect}")
    if not finite:
        raise AssertionError(f"{phase}: non-finite loss terms {history}")
    if len({h["loss_total"] for h in history}) < n_steps:
        raise AssertionError(f"{phase}: loss_total does not move {history}")

    dname = "bf16" if cfg.compute_dtype == "bfloat16" else "f32"
    t0 = time.perf_counter()
    sps = {dname: steps_per_s(cfg, model, optimizer, batch, gen, 5)}
    runs = [(dname, cfg, model, optimizer)]
    parts = {"steps": seconds, "steps_per_s": time.perf_counter() - t0}
    if compare:
        t0 = time.perf_counter()
        cfg_cmp = cfg32
        if cmp_sizes is not None:
            cfg_cmp = dataclasses.replace(cfg32, model=dataclasses.replace(
                cfg32.model, **cmp_sizes))
        f32_step_vs_plain(dev, cfg_cmp, phase, batch, gen,
                          split_on_general=split_on_general)
        parts["f32_vs_plain"] = time.perf_counter() - t0
    if f32 and dname != "f32":
        t0 = time.perf_counter()
        cfg_speed = dataclasses.replace(cfg32, model=dataclasses.replace(
            cfg32.model, **F32_SPEED_SIZES))
        model32 = new_model(cfg_speed, dev).train()
        optimizer32 = make_optimizer(model32, cfg_speed.optim)
        sps["f32"] = steps_per_s(cfg_speed, model32, optimizer32, batch, gen, 5)
        runs.append(("f32", cfg_speed, model32, optimizer32))
        parts["f32_steps_per_s"] = time.perf_counter() - t0
    emit({"phase": phase + "_steps_per_s", "steps_per_s": sps,
          "peak_mem_gb_steps": steps_peak,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds_by_part": parts})
    for name, c, mdl, opt in runs:
        profile_train("profile_" + phase, c, mdl, opt, batch, gen, name,
                      1e3 / sps[name])
    return launches


def f32_step_vs_plain(dev, cfg32, phase, batch, gen, split_on_general=True):
    """One f32 step with kernels against the same step under plain
    versions (same weights, batch, generator draws and the kernels' run's
    assignment), beside the witnesses of the step's own sensitivity
    (WITNESSES: the plain step on moved images or weights) and a second run
    with the kernels, and, where the witnesses do not cover the kernels'
    difference or a general variant ran, the step split by kernel
    (``kernel_split``); fails beyond TRAIN_REL_TOL, TRAIN_GRAD_REL_TOL or
    TRAIN_GRAD_NORM_TOL, or if a kernel launched under the plain
    versions."""
    model32 = new_model(cfg32, dev).train()
    seed = step_seed(0, 0)
    start = read_launch_counts()
    got_l, got_g, indices = grad_step(model32, cfg32, batch, gen, seed)
    before = read_launch_counts()
    general = sum(v - start[k] for k, v in before.items() if k.endswith(".general"))
    t0 = time.perf_counter()
    with ops.plain_versions():
        want_l, want_g, _ = grad_step(model32, cfg32, batch, gen, seed, indices)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_launches = {k: v - before[k] for k, v in read_launch_counts().items()}
    _, again_g, _ = grad_step(model32, cfg32, batch, gen, seed, indices)
    loss_err = {k: abs(got_l[k] - w) / max(abs(w), 1e-12) for k, w in want_l.items()}
    floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in want_g.values())
    # gradients below 100x the floor are noise on both sides in their norm
    big = {k for k, w in want_g.items() if float(w.abs().max()) > 100 * floor}

    def rel_errs(a, b):
        """Each gradient's max abs error beyond the floor, over its largest
        magnitude (or the floor, where that is larger)."""
        return {k: max(0.0, float((a[k] - w).abs().max()) - floor)
                / max(float(w.abs().max()), floor) for k, w in b.items()}

    def norm_errs(a, b):
        return {k: float((a[k] - b[k]).norm()) / float(b[k].norm()) for k in big}

    def worst(errs):
        return sorted(errs.items(), key=lambda kv: -kv[1])[:8]

    rel = rel_errs(got_g, want_g)
    norm = norm_errs(got_g, want_g)
    trunk = TRUNK_PARAM[cfg32.model.backbone_type]
    if trunk not in want_g:  # a ResNet without DCN stages
        trunk = max((k for k in want_g if k.startswith("img_backbone")),
                    key=lambda k: float(want_g[k].abs().max()))
    # the parameter the kernels move most, read by the rerun and every witness
    top = max(rel, key=rel.get)
    top_param = {"name": top, "kernels": rel[top],
                 "kernels_rerun": rel_errs(again_g, got_g)[top], "witnesses": []}
    # the witnesses of the step's own sensitivity (see TRAIN_GRAD_REL_TOL)
    witnesses = []
    for kind, wseed in WITNESSES:
        wit_l, wit_g = witness_step(model32, cfg32, batch, gen, seed, indices,
                                    kind, wseed)
        wit_rel = rel_errs(wit_g, want_g)
        witnesses.append({
            "kind": kind, "seed": wseed, "eps": WITNESS_EPS,
            "max_loss_rel_err": max(abs(wit_l[k] - w) / max(abs(w), 1e-12)
                                    for k, w in want_l.items()),
            "grad_worst_rel_err": worst(wit_rel),
            "grad_worst_norm_rel_err": worst(norm_errs(wit_g, want_g))})
        top_param["witnesses"].append(wit_rel[top])
        del wit_g
    split = None
    if ((general and split_on_general)
            or rel[top] > SPLIT_SHARE * max(top_param["witnesses"] + [SPLIT_FLOOR])):
        split = kernel_split(model32, cfg32, batch, gen, seed, indices, top,
                             rel_errs, got_g, want_g)
    emit({"phase": phase + "_f32_vs_plain", "config": cfg32.name,
          "layers": {k: getattr(cfg32.model, k) for k in (
              "encoder_layers", "decoder_layers", "map_decoder_layers")},
          "loss_rel_err": loss_err,
          "max_loss_rel_err": max(loss_err.values()),
          "params_with_grad": len(want_g), "params": len(dict(model32.named_parameters())),
          "grad_worst_rel_err": worst(rel),
          "grad_worst_norm_rel_err": worst(norm),
          "grad_worst_rel_err_kernels_rerun": worst(rel_errs(again_g, got_g)),
          "grad_worst_rel_err_trunk": worst({
              k: v for k, v in rel.items() if k.startswith("img_backbone")}),
          "witnesses": witnesses, "top_param": top_param, "split": split,
          "grad_floor": floor, "loss_tol": TRAIN_REL_TOL,
          "grad_tol": TRAIN_GRAD_REL_TOL, "grad_norm_tol": TRAIN_GRAD_NORM_TOL,
          "floor_share": TRAIN_GRAD_FLOOR,
          "plain_step_s": plain_s, "plain_launches": plain_launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "trunk_grad_param": trunk,
          "trunk_grad_max": float(want_g[trunk].abs().max())})
    bad = ([(k, v) for k, v in rel.items() if v > TRAIN_GRAD_REL_TOL]
           + [(k, v) for k, v in norm.items() if v > TRAIN_GRAD_NORM_TOL]
           + [(k, "non-finite") for k in set(want_g) & set(got_g)
              if not (bool(torch.isfinite(want_g[k]).all())
                      and bool(torch.isfinite(got_g[k]).all()))])
    if (max(loss_err.values()) > TRAIN_REL_TOL or bad
            or set(got_g) != set(want_g) or any(plain_launches.values())
            or len(want_g) != len(dict(model32.named_parameters()))):
        raise AssertionError(f"{phase}: f32 step disagrees with plain: {bad[:8]}")
    del got_g, want_g, again_g, model32
    torch.cuda.empty_cache()


@contextlib.contextmanager
def plain_inside(module):
    """The plain versions inside ``module``'s forward only (the backward of
    what it computes follows, as each front end picks at its forward)."""
    entered = []

    def enter(mod, args):
        entered.append(ops.plain_versions())
        entered[-1].__enter__()

    def leave(mod, args, out):
        entered.pop().__exit__(None, None, None)

    handles = (module.register_forward_pre_hook(enter),
               module.register_forward_hook(leave))
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def kernel_split(model, cfg, batch, gen, seed, indices, top, rel_errs, got_g,
                 want_g):
    """Which kernel carries the f32 step's difference in the parameter the
    kernels move most (``top``; ``rel_errs(a, b)``: every gradient's error
    in a against b), and whether a kink shows it. First the output of the
    module that owns ``top``, with the kernels and with the plain versions:
    how many of its elements change sign (a ReLU after it takes the other
    side of its kink there) and the largest of those against the output's
    largest magnitude (where that output is one tensor). Then, for each
    module that calls an MSDA kernel (MSDA_MODULES), the step with that
    module alone on its plain versions:
    ``top``'s error against the kernels' step and against the plain step
    (a module that carries the difference brings its step near the plain
    one), and the gradient it moves most against the kernels' step. The
    module that moves ``top`` most gets three witnesses of its own: the
    plain step with that module's output moved by a relative WITNESS_EPS of
    noise (seeds 1-3), which shows whether a difference of rounding size
    there moves the parameter as much."""

    def top_err(a, b):
        return rel_errs({top: a[top]}, {top: b[top]})[top]

    owner = model.get_submodule(top.rsplit(".", 1)[0])
    outs = []
    handle = owner.register_forward_hook(lambda m, args, out: outs.append(
        out.detach().clone() if isinstance(out, torch.Tensor) else None))
    try:
        grad_step(model, cfg, batch, gen, seed, indices)
        with ops.plain_versions():
            grad_step(model, cfg, batch, gen, seed, indices)
    finally:
        handle.remove()
    (a, *_), (b, *_) = outs[:len(outs) // 2], outs[len(outs) // 2:]
    kink = None
    if a is not None:
        flips = torch.sign(a) != torch.sign(b)
        scale = float(b.abs().max())
        kink = {"module": top.rsplit(".", 1)[0], "elements": b.numel(),
                "sign_flips": int(flips.sum()),
                "largest_flipped": float(b[flips].abs().max()) / scale
                if bool(flips.any()) else None,
                "max_rel_diff": float((a - b).abs().max()) / scale}
    rows = []
    for name, mod in model.named_modules():
        if not isinstance(mod, MSDA_MODULES):
            continue
        with plain_inside(mod):
            _, g, _ = grad_step(model, cfg, batch, gen, seed, indices)
        worst = max(rel_errs(g, got_g).items(), key=lambda kv: kv[1])
        rows.append({"module": name, "vs_kernels": top_err(g, got_g),
                     "vs_plain": top_err(g, want_g), "worst_vs_kernels": worst})
        del g
    carrier = max(rows, key=lambda r: r["vs_kernels"])
    mod = model.get_submodule(carrier["module"])
    carrier["witnesses"] = []
    for wseed in (1, 2, 3):
        noise_gen = torch.Generator(device=batch["img"].device).manual_seed(wseed)

        def moved(m, args, out):
            return out * (1 + WITNESS_EPS * torch.randn(
                out.shape, device=out.device, generator=noise_gen, dtype=out.dtype))

        handle = mod.register_forward_hook(moved)
        try:
            with ops.plain_versions():
                _, g, _ = grad_step(model, cfg, batch, gen, seed, indices)
        finally:
            handle.remove()
        carrier["witnesses"].append(top_err(g, want_g))
        del g
    return {"owner_output": kink, "modules": rows}


def profile_train(phase, cfg, model, optimizer, batch, gen, name, step_ms):
    """torch.profiler over 2 warm train steps: device busy ms per step, idle
    share against the unprofiled step time, kernels and host syncs per
    step, the top kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    train_steps(cfg, model, optimizer, batch, gen, 200, 1)
    torch.cuda.synchronize()
    n = 2
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train_steps(cfg, model, optimizer, batch, gen, 201, n)
        torch.cuda.synchronize()
    summarize_profile(prof, phase, name, n, "step", step_ms, t0)


def phase_train_overfit(dev, cfg, phase, term, share, steps=OVERFIT_STEPS,
                        bars=None, lr=4e-4, seed=0):
    """A smoke config through the port's overfit tool, set up as the JAX
    package's tools/overfit_check.py sets it up: batch 4 with GT cues
    painted into the images, lr ``lr``, warmup max(steps / 10, 10), cosine
    to ``steps``, at ``seed`` (the initial draw and the painted batch); the
    loss curve every 10 steps and the metrics of the trained model on its
    batch -> (launch counts, metrics). Fails unless
    the last value of the loss term ``term`` is at most ``share`` of the
    first, and each metric in ``bars`` passes the bar it gives it."""
    cfg = overfit_config(cfg, steps, lr)
    bars = bars or {}
    reset_launch_counts()
    t0 = time.perf_counter()
    model, batch, curve = overfit(cfg, steps=steps, device=dev, seed=seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    metrics = evaluate_overfit(cfg, model, batch)
    first, last = curve[0][term], curve[-1][term]
    emit({"phase": phase, "config": cfg.name, "steps": steps, "seed": seed,
          "seconds": seconds, "curve": curve, "term": term, "first": first,
          "last": last, "share": last / first, "limit": share,
          "metrics": metrics, "bars": bars,
          "launches": launches})
    expect = {k: v * steps for k, v in train_launches_per_step(cfg).items()}
    if launches != expect:
        raise AssertionError(f"{phase}: launches {launches} != {expect}")
    if not math.isfinite(last) or last > share * first:
        raise AssertionError(f"{phase}: {term} {first} -> {last}")
    failed = {k: metrics.get(k) for k, bar in bars.items()
              if not metrics.get(k, 0.0) > bar}
    if failed:
        raise AssertionError(f"{phase}: below the bars {failed}")
    return launches, metrics


def voxel_overfit_parity(metrics_by_seed):
    """The median over VOXEL_OVERFIT_SEEDS of each metric of the port's
    smoke_voxel_occ overfits against the JAX tool's readings at the same
    seeds (VOXEL_JAX_METRICS), their median and their lowest; fails below
    the lowest."""
    line = {"phase": "train_overfit_voxel", "seeds": list(metrics_by_seed),
            "metrics": {}}
    for k, theirs in VOXEL_JAX_METRICS.items():
        ours = [metrics_by_seed[s][k] for s in VOXEL_OVERFIT_SEEDS]
        line["metrics"][k] = {"port": ours, "jax": list(theirs),
                              "port_median": statistics.median(ours),
                              "jax_median": statistics.median(theirs),
                              "jax_lowest": min(theirs)}
    emit(line)
    below = {k: v for k, v in line["metrics"].items()
             if not v["port_median"] >= v["jax_lowest"]}
    if below:
        raise AssertionError(f"train_overfit_voxel: medians below JAX's lowest {below}")


def summarize_profile(prof, phase, name, n, unit, unit_ms, t0):
    """``profile_step.summarize`` of a finished window, emitted with its
    phase and dtype."""
    emit({"phase": phase, "dtype": name,
          **profile_step.summarize(prof, n, unit, unit_ms, t0)})


def profile_frames(phase, name, cfg, model, frames, frame_ms):
    """``profile_step.profile_frames`` over 4 warm frames, emitted with its
    phase and dtype."""
    emit({"phase": phase, "dtype": name,
          **profile_step.profile_frames(cfg, model, frames, frame_ms)})


STAGE_FRAMES = 3


def stage_launches(cfg) -> dict:
    """Forward launches a frame that each stage of
    ``profile_step.stage_split`` must make: ``bb`` the trunk's DCN calls and
    no MSDA; ``enc`` the TSA calls and the SCA calls (the masked entry over
    one level, the factored one over four); ``head`` those and the det and
    map decoder layers'; ``full`` all of them."""
    m = cfg.model
    sca = "msda_fwd_factored" if m.num_feature_levels > 1 else "msda_fwd_masked"
    n_dec = m.decoder_layers + (m.map_decoder_layers if m.with_map else 0)
    zero = dict.fromkeys(profile_step.kernel_launches(), 0.0)
    n_dcn = dcn_blocks(cfg)
    enc = {**zero, "msda_fwd": m.encoder_layers, sca: m.encoder_layers}
    head = {**enc, "msda_fwd": m.encoder_layers + n_dec}
    return {"bb": {**zero, "dcn_fwd": n_dcn}, "enc": enc, "head": head,
            "full": {**head, "dcn_fwd": n_dcn}}


def stage_split(phase, cfg, runs, frames):
    """``profile_step.stage_split`` of each (dtype, model) of ``runs`` over
    STAGE_FRAMES frames: each stage's ms a frame (CUDA events), the residual
    full - bb - head and the launches a frame, beside the card's name and
    power limit; fails if a stage's launches differ from
    ``stage_launches``."""
    want = stage_launches(cfg)
    smi = nvidia_smi_line()
    for name, model in runs:
        split = profile_step.stage_split(model, frames[1], frames=STAGE_FRAMES)
        emit({"phase": phase, "dtype": name, "nvidia_smi": smi, **split})
        bad = {k: v for k, v in split["launches_per_frame"].items() if v != want[k]}
        if bad:
            raise AssertionError(f"{phase} {name}: stage launches {bad}, "
                                 f"expected {want}")


def probes_add_nothing(cfg, model, frames, frame_ms):
    """The flagship frame's kernels and host syncs with the probe call sites
    present and disabled, against the same frames with ``debug.probe``
    replaced by the bare identity (no probe code); fails unless equal. The
    enabled probes' kernels, syncs and records a frame beside them."""
    keys = ("kernels_per_frame", "host_syncs_per_frame", "device_busy_ms_per_frame")
    runs = {}
    runs["disabled"] = profile_step.profile_frames(cfg, model, frames, frame_ms)
    real_probe = debug.probe
    debug.probe = lambda name, x, force=False: x
    try:
        runs["without_probe_code"] = profile_step.profile_frames(
            cfg, model, frames, frame_ms)
    finally:
        debug.probe = real_probe
    with debug.capture_probes() as rec:
        runs["enabled"] = profile_step.profile_frames(cfg, model, frames, frame_ms)
    line = {"phase": "stream_probes",
            **{name: {k: r[k] for k in keys} for name, r in runs.items()},
            "records_per_frame": len(rec.records) / (profile_step.WARM + 4)}
    emit(line)
    for k in keys[:2]:
        if line["disabled"][k] != line["without_probe_code"][k]:
            raise AssertionError(f"stream_probes: disabled probes change {k}: {line}")


def phase_project_pv(dev):
    """tools/project_det_map_to_pv on one served flagship frame on the card
    (random weights from seed 0, the synthetic batch's last frame): exact
    launches of a served frame, finite decoded boxes and map vectors, the
    six-camera picture written at its size."""
    cfg = bev_tiny_det_map_apollo()
    m = cfg.model
    batch = make_batch(cfg, 1, seed=0)
    reset_launch_counts()
    det, map_res = project_det_map_to_pv.run_model_frame(cfg, batch, dev, seed=0)
    torch.cuda.synchronize()
    launches = read_launch_counts()
    scale = 0.25
    with tempfile.TemporaryDirectory() as tmp:
        img = project_det_map_to_pv.draw_frame(
            batch["img"][0, -1], batch["lidar2img"][0, -1], det=det, map_res=map_res,
            gt_boxes=batch["gt_boxes"][0][batch["gt_mask"][0]],
            out_path=os.path.join(tmp, "pv.png"), score_thr=-1.0, scale=scale)
    H, W = m.img_shape
    size = (3 * round(W * scale) + 2 * project_det_map_to_pv.GAP,
            2 * round(H * scale) + project_det_map_to_pv.GAP)
    finite = bool(np.isfinite(det["boxes"]).all() and np.isfinite(map_res["vectors"]).all())
    emit({"phase": "project_pv", "launches": launches, "boxes": len(det["boxes"]),
          "vectors": len(map_res["vectors"]), "finite": finite,
          "image_size": list(img.size)})
    expect = stream_launches_per_frame(cfg)
    if launches != expect:
        raise AssertionError(f"project_pv: launches {launches} != {expect}")
    if not finite or tuple(img.size) != size:
        raise AssertionError(f"project_pv: finite {finite}, image {img.size} != {size}")
    return launches


# ------------------------------------------------------------ cli_nuscenes

CLI_CAMS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT", "CAM_BACK",
            "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
# nuScenes' camera yaws (degrees, ego frame) and image size
CLI_CAM_YAW = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)
CLI_IMG_WH = (1600, 900)
# (scene name, samples): v1.0-mini routes scene-0061 to train, scene-0103
# to val
CLI_SCENES = (("scene-0061", 4), ("scene-0103", 3))
CLI_LOCATION = "singapore-onenorth"
CLI_TRAIN_STEPS, CLI_RESUME_STEPS = 3, 4


def _rot_to_quat(r):
    """3x3 rotation -> (w, x, y, z)."""
    w = math.sqrt(max(0.0, 1.0 + r[0][0] + r[1][1] + r[2][2])) / 2.0
    x = math.copysign(math.sqrt(max(0.0, 1.0 + r[0][0] - r[1][1] - r[2][2])) / 2.0,
                      r[2][1] - r[1][2])
    y = math.copysign(math.sqrt(max(0.0, 1.0 - r[0][0] + r[1][1] - r[2][2])) / 2.0,
                      r[0][2] - r[2][0])
    z = math.copysign(math.sqrt(max(0.0, 1.0 - r[0][0] - r[1][1] + r[2][2])) / 2.0,
                      r[1][0] - r[0][1])
    return [w, x, y, z]


def _yaw_quat(yaw):
    return [math.cos(yaw / 2), 0.0, 0.0, math.sin(yaw / 2)]


def fake_city_map():
    """A map-expansion JSON: a 14 m road along x with two lanes (a lane and a
    lane connector with straight arcline paths, connected), a lane divider
    and a road divider, and a pedestrian crossing."""
    nodes, lines, polygons = [], [], []

    def points(tok, pts):
        toks = [f"n_{tok}_{i}" for i in range(len(pts))]
        nodes.extend({"token": t, "x": float(x), "y": float(y)}
                     for t, (x, y) in zip(toks, pts))
        return toks

    def line(tok, pts):
        lines.append({"token": tok, "node_tokens": points(tok, pts)})

    def polygon(tok, x0, y0, x1, y1):
        polygons.append({"token": tok, "holes": [], "exterior_node_tokens": points(
            tok, [(x0, y0), (x1, y0), (x1, y1), (x0, y1)])})

    line("ln_lane", [(-40.0, 0.0), (80.0, 0.0)])
    line("ln_road", [(-40.0, 3.5), (80.0, 3.5)])
    polygon("pg_road", -40.0, -7.0, 80.0, 7.0)
    polygon("pg_lane_a", -40.0, 0.0, 20.0, 3.5)
    polygon("pg_lane_b", 20.0, 0.0, 80.0, 3.5)
    polygon("pg_ped", 12.0, -7.0, 16.0, 7.0)

    def straight(x0, x1):
        return [{"start_pose": [x0, 1.75, 0.0], "end_pose": [x1, 1.75, 0.0],
                 "shape": "LSR", "radius": 999.0,
                 "segment_length": [0.0, x1 - x0, 0.0]}]

    return {"node": nodes, "line": lines, "polygon": polygons,
            "lane_divider": [{"token": "ld", "line_token": "ln_lane"}],
            "road_divider": [{"token": "rd", "line_token": "ln_road"}],
            "ped_crossing": [{"token": "ped", "polygon_token": "pg_ped"}],
            "road_segment": [{"token": "rs", "polygon_token": "pg_road"}],
            "lane": [{"token": "lane_a", "polygon_token": "pg_lane_a"}],
            "lane_connector": [{"token": "lane_b", "polygon_token": "pg_lane_b"}],
            "arcline_path_3": [{"token": "lane_a", "arcline_paths": straight(-40.0, 20.0)},
                               {"token": "lane_b", "arcline_paths": straight(20.0, 80.0)}],
            "connectivity": [
                {"token": "lane_a", "connectivity": {"incoming": [], "outgoing": ["lane_b"]}},
                {"token": "lane_b", "connectivity": {"incoming": ["lane_a"], "outgoing": []}}]}


def write_fake_nuscenes(root, seed: int = 0):
    """A nuScenes tree at ``root`` from ``seed``: v1.0-mini tables for the
    CLI_SCENES (the ego driving +x at 4 m/s, three moving objects a scene:
    two cars and a pedestrian), CAN pose messages, six 1600x900 JPEGs a
    sample from nuScenes-like cameras (intrinsics fx = fy = 1266, principal
    point at the centre; yaws CLI_CAM_YAW), and the city map
    (``fake_city_map``) under maps/expansion."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    tdir = root / "v1.0-mini"
    for d in (tdir, root / "can_bus", root / "samples", root / "maps" / "expansion"):
        d.mkdir(parents=True)
    (root / "maps" / "expansion" / f"{CLI_LOCATION}.json").write_text(
        json.dumps(fake_city_map()))
    t = {name: [] for name in ("category", "instance", "sensor", "calibrated_sensor",
                               "ego_pose", "log", "scene", "sample", "sample_data",
                               "sample_annotation")}
    t["category"] = [{"token": "cat_car", "name": "vehicle.car"},
                     {"token": "cat_ped", "name": "human.pedestrian.adult"}]
    t["sensor"].append({"token": "sen_lidar", "channel": "LIDAR_TOP"})
    t["calibrated_sensor"].append({"token": "cs_lidar", "sensor_token": "sen_lidar",
                                   "translation": [0.94, 0.0, 1.84],
                                   "rotation": [1.0, 0.0, 0.0, 0.0],
                                   "camera_intrinsic": []})
    w, h = CLI_IMG_WH
    for cam, yaw in zip(CLI_CAMS, CLI_CAM_YAW):
        c, s = math.cos(math.radians(yaw)), math.sin(math.radians(yaw))
        # camera x right, y down, z forward, turned by the yaw about ego z
        rot = [[s, 0.0, c], [-c, 0.0, s], [0.0, -1.0, 0.0]]
        t["sensor"].append({"token": f"sen_{cam}", "channel": cam})
        t["calibrated_sensor"].append({
            "token": f"cs_{cam}", "sensor_token": f"sen_{cam}",
            "translation": [1.5 * c, 0.5 * s, 1.55], "rotation": _rot_to_quat(rot),
            "camera_intrinsic": [[1266.0, 0.0, w / 2], [0.0, 1266.0, h / 2],
                                 [0.0, 0.0, 1.0]]})
    noise = rng.normal(0, 12, (h, w, 3)).astype(np.float32)
    base_ts = 1_532_402_927_647_951
    for si, (scene_name, n) in enumerate(CLI_SCENES):
        toks = [f"s{si}_{k}" for k in range(n)]
        t["log"].append({"token": f"log{si}", "location": CLI_LOCATION})
        t["scene"].append({"token": f"scene{si}", "name": scene_name,
                           "log_token": f"log{si}", "nbr_samples": n,
                           "first_sample_token": toks[0], "last_sample_token": toks[-1]})
        objects = [("cat_car", [12.0, -2.0], [3.0, 0.0], [1.9, 4.6, 1.7]),
                   ("cat_car", [-9.0, 4.5], [5.0, 0.0], [2.0, 4.9, 1.8]),
                   ("cat_ped", [6.0, 6.0], [0.0, -1.2], [0.7, 0.7, 1.8])]
        for oi, (cat, *_) in enumerate(objects):
            t["instance"].append({"token": f"inst{si}_{oi}", "category_token": cat})
        can = []
        for k in range(n):
            ts = base_ts + si * 60_000_000 + k * 500_000
            ego = [30.0 * si + 2.0 * k, 1.75, 0.0]
            yaw = 0.02 * k
            t["sample"].append({"token": toks[k], "scene_token": f"scene{si}",
                                "timestamp": ts, "prev": toks[k - 1] if k else "",
                                "next": toks[k + 1] if k + 1 < n else ""})
            t["ego_pose"].append({"token": f"ep{si}_{k}", "timestamp": ts,
                                  "translation": ego, "rotation": _yaw_quat(yaw)})
            t["sample_data"].append({
                "token": f"sd_lidar{si}_{k}", "sample_token": toks[k],
                "calibrated_sensor_token": "cs_lidar", "ego_pose_token": f"ep{si}_{k}",
                "timestamp": ts, "is_key_frame": True,
                "filename": f"samples/LIDAR_TOP/{toks[k]}.bin"})
            for ci, cam in enumerate(CLI_CAMS):
                name = f"samples/{cam}/{toks[k]}.jpg"
                (root / name).parent.mkdir(parents=True, exist_ok=True)
                # a low-frequency scene plus pixel noise, as a JPEG of camera size
                low = rng.uniform(0, 255, (h // 100, w // 100, 3))
                img = np.repeat(np.repeat(low, 100, 0), 100, 1) + np.roll(
                    noise, 37 * (k * len(CLI_CAMS) + ci), axis=1)
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    root / name, quality=90)
                t["ego_pose"].append({"token": f"ep_{cam}{si}_{k}", "timestamp": ts + 1000,
                                      "translation": ego, "rotation": _yaw_quat(yaw)})
                t["sample_data"].append({
                    "token": f"sd_{cam}{si}_{k}", "sample_token": toks[k],
                    "calibrated_sensor_token": f"cs_{cam}",
                    "ego_pose_token": f"ep_{cam}{si}_{k}", "timestamp": ts + 1000,
                    "is_key_frame": True, "filename": name})
            for oi, (cat, xy, vel, size) in enumerate(objects):
                dt = 0.5 * k
                t["sample_annotation"].append({
                    "token": f"a{si}_{oi}_{k}", "sample_token": toks[k],
                    "instance_token": f"inst{si}_{oi}",
                    "translation": [ego[0] - 2.0 * k + xy[0] + vel[0] * dt,
                                    xy[1] + vel[1] * dt, 0.9],
                    "size": size, "rotation": _yaw_quat(0.1 * oi),
                    "prev": f"a{si}_{oi}_{k - 1}" if k else "",
                    "next": f"a{si}_{oi}_{k + 1}" if k + 1 < n else "",
                    "num_lidar_pts": 20, "num_radar_pts": 1,
                    "visibility_token": "4"})
            for j in range(2):
                can.append({"utime": ts - 20_000 + j * 250_000,
                            "pos": [ego[0] + j, ego[1], 0.0],
                            "orientation": _yaw_quat(yaw),
                            "accel": [0.2, 0.0, 9.8], "rotation_rate": [0.0, 0.0, 0.04],
                            "vel": [4.0, 0.0, 0.0]})
        (root / "can_bus" / f"{scene_name}_pose.json").write_text(json.dumps(can))
    for name, rows in t.items():
        (tdir / f"{name}.json").write_text(json.dumps(rows))


def fake_dla34_checkpoint(path, seed: int = 0) -> dict:
    """A DLA-34 state dict in the reference naming (models/backbones/
    dla.py: ``base_layer``, ``level{i}``, norms as ``<conv>.norm``) drawn
    from ``seed``, saved as a full detector's mmcv checkpoint
    (``state_dict`` with ``img_backbone.`` keys, a head key, BN counters);
    returns {port trunk key: tensor} of what the import must give."""
    from apollo_vision_net_tpu_torch.models.dla import DLA
    from apollo_vision_net_tpu_torch.utils.torch_import import dla_rule

    g = torch.Generator().manual_seed(seed)
    with torch.device("meta"):
        trunk = DLA(out_indices=(3, 4, 5))
    want, sd = {}, {}
    for key, p in trunk.state_dict().items():
        if key.endswith("weight") and p.dim() == 4:
            v = torch.randn(p.shape, generator=g) / math.sqrt(p[0].numel())
        elif key.endswith(("weight", "running_var")):
            v = 0.5 + torch.rand(p.shape, generator=g)
        else:
            v = 0.1 * torch.randn(p.shape, generator=g)
        want[key] = v
        tkey = dla_rule(key)[0]
        sd[f"img_backbone.{tkey}"] = v
        if tkey.endswith("running_var"):
            sd[f"img_backbone.{tkey[:-len('running_var')]}num_batches_tracked"] = \
                torch.tensor(1000)
    sd["pts_bbox_head.query_embedding.weight"] = torch.zeros(900, 512)
    torch.save({"state_dict": sd, "meta": {"seed": seed}}, path)
    return want


def stream_launches_per_frame(cfg) -> dict:
    """Launches of one served frame of a BEV-head model: TSA, the det (and
    map) decoder layers and InternImage's DCNv3 blocks on the plain entry,
    SCA (and the refinement pass's) on the masked one, all vector."""
    m = cfg.model
    n_sca = m.encoder_layers + occ_tsa_layers(cfg)
    n_plain = (n_sca + dcnv3_blocks(cfg) + m.decoder_layers
               + (m.map_decoder_layers if m.with_map else 0))
    return {**dict.fromkeys(read_launch_counts(), 0),
            "msda_fwd": n_plain, "msda_fwd.vector": n_plain,
            "msda_fwd_masked": n_sca, "msda_fwd_masked.vector": n_sca}


CLI_QUEUE_SAMPLES, CLI_EVAL_PASSES = 2, 4


def spread(xs) -> dict:
    """Median, least and most of repeated readings, and the readings."""
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs), "all": list(xs)}


def loader_seconds(cfg, infos_path, data_root) -> dict:
    """Host seconds of the nuScenes loader at full size (six 1600x900
    JPEGs, scale 0.5, pad to 32, training mode), one thread: per camera
    ring over every train sample, the PIL decode and the numpy pipeline
    apart, and the eval pipeline on the same ring, native
    (``preprocess_frame`` in eval mode) and numpy (its plain version); a
    queue sample (3 frames, GT and map GT packed) whole, CLI_QUEUE_SAMPLES
    times."""
    from apollo_vision_net_tpu_torch.data import pipeline as pipe
    from apollo_vision_net_tpu_torch.data.infos import CAM_ORDER, lidar2img_from_info
    from apollo_vision_net_tpu_torch.data.nuscenes_dataset import NuScenesTemporalDataset

    ds = NuScenesTemporalDataset(cfg, infos_path, data_root=data_root,
                                 training=True, img_scale=0.5, seed=0)
    decode, pipeline, eval_native, eval_numpy = [], [], [], []
    for info in ds.infos:
        t0 = time.perf_counter()
        imgs = ds._load_images(info)
        t1 = time.perf_counter()
        l2i = lidar2img_from_info(info, CAM_ORDER)
        img, _ = pipe.preprocess_frame(imgs, l2i, scale=0.5, training=True,
                                       rng=ds.rng)
        t2 = time.perf_counter()
        pipe.preprocess_frame(imgs, l2i, scale=0.5, training=False)
        t3 = time.perf_counter()
        pipe.plain_resize_normalize_pad(imgs, 0.5)
        decode.append(t1 - t0)
        pipeline.append(t2 - t1)
        eval_native.append(t3 - t2)
        eval_numpy.append(time.perf_counter() - t3)
    sample = []
    for _ in range(CLI_QUEUE_SAMPLES):
        t0 = time.perf_counter()
        ds.get_queue_sample(len(ds) - 1)
        sample.append(time.perf_counter() - t0)
    return {"decode_s_per_frame": spread(decode),
            "pipeline_s_per_frame": spread(pipeline),
            "eval_pipeline_native_s_per_frame": spread(eval_native),
            "eval_pipeline_numpy_s_per_frame": spread(eval_numpy),
            "queue_sample_s": spread(sample),
            "frames_per_sample": cfg.model.queue_length,
            "raw_shape": list(imgs.shape), "img_shape": list(img.shape)}


def phase_cli_nuscenes(dev):
    """The flagship through the port's CLIs on a fake nuScenes tree
    (``write_fake_nuscenes``): create_data nuscenes and nuscenes-map-gt,
    train from a DLA-34 checkpoint (``fake_dla34_checkpoint``) for
    CLI_TRAIN_STEPS steps, resumed to CLI_RESUME_STEPS, then test over the
    val scene with the bbox and chamfer evaluators and the results dumped;
    every step's and frame's launches exactly the train and stream phases'
    (counts set to 0 before each CLI call, read after); the loader's host
    seconds, its wait for a batch, the step time and the streaming eval's
    frames/s, each as the median and spread of its readings."""
    import logging
    import pathlib
    import pickle
    import tempfile
    import types

    from apollo_vision_net_tpu_torch.evaluation.formatting import load_results_json
    from apollo_vision_net_tpu_torch.runtime.checkpoint import CheckpointManager
    from apollo_vision_net_tpu_torch.runtime.inference import run_streaming_eval
    from apollo_vision_net_tpu_torch.runtime.metrics_log import read_metrics
    from apollo_vision_net_tpu_torch.runtime.train_loop import load_pretrained
    from apollo_vision_net_tpu_torch.tools import create_data
    from apollo_vision_net_tpu_torch.tools import test as test_cli
    from apollo_vision_net_tpu_torch.tools import train as train_cli

    cfg = bev_tiny_det_map_apollo()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        root, out, work = tmp / "nuscenes", tmp / "infos", tmp / "work"
        t0 = time.perf_counter()
        write_fake_nuscenes(root)
        write_s = time.perf_counter() - t0
        train_pkl = str(out / "nuscenes_infos_temporal_train.pkl")
        val_pkl = str(out / "nuscenes_infos_temporal_val.pkl")
        create_data.main(["nuscenes", "--root-path", str(root), "--version",
                          "v1.0-mini", "--out-dir", str(out)])
        create_data.main(["nuscenes-map-gt", "--root-path", str(root), "--infos",
                          train_pkl, "--map-version", "1"])
        infos = {}
        for split, path in (("train", train_pkl), ("val", val_pkl)):
            with open(path, "rb") as f:
                infos[split] = pickle.load(f)["infos"]
        ckpt = str(tmp / "dla34.pth")
        want_trunk = fake_dla34_checkpoint(ckpt)
        # the import alone, on the card: every trunk tensor as saved
        model = build_model(dataclasses.replace(cfg, pretrained_path=ckpt), device=dev)
        load_pretrained(model, dataclasses.replace(cfg, pretrained_path=ckpt))
        import_ok = all(torch.equal(v.cpu(), want_trunk[k])
                        for k, v in model.img_backbone.state_dict().items())
        del model

        logged = []
        handler = logging.Handler()
        handler.emit = lambda rec: logged.append(rec.getMessage())
        logging.getLogger("avnet").addHandler(handler)
        argv = ["bev_tiny_det_map_apollo", "--data", "nuscenes", "--infos", train_pkl,
                "--data-root", str(root), "--img-scale", "0.5", "--num-workers", "2",
                "--pretrained", ckpt, "--work-dir", str(work), "--log-interval", "1"]
        per_step = train_launches_per_step(cfg)
        try:
            for name, steps, extra in (("train", CLI_TRAIN_STEPS, []),
                                       ("resume", CLI_RESUME_STEPS, ["--resume"])):
                reset_launch_counts()
                t0 = time.perf_counter()
                train_cli.main(argv + ["--steps", str(steps)] + extra)
                torch.cuda.synchronize()
                launches[name] = (read_launch_counts(), time.perf_counter() - t0)
        finally:
            logging.getLogger("avnet").removeHandler(handler)
        metrics_path, results_path = tmp / "metrics.json", tmp / "results.json"
        reset_launch_counts()
        t0 = time.perf_counter()
        test_cli.main(["bev_tiny_det_map_apollo", "--data", "nuscenes", "--infos",
                       val_pkl, "--data-root", str(root), "--img-scale", "0.5",
                       "--checkpoint", str(work), "--eval", "bbox", "chamfer",
                       "--num-frames", "0", "--dump-results", str(results_path),
                       "--out", str(metrics_path)])
        torch.cuda.synchronize()
        launches["test"] = (read_launch_counts(), time.perf_counter() - t0)
        metrics = json.loads(metrics_path.read_text())
        results = load_results_json(str(results_path))
        records = read_metrics(str(work))
        mgr = CheckpointManager(str(work))
        ckpt_steps = mgr.steps()
        saved = torch.load(mgr.path(CLI_RESUME_STEPS), map_location="cpu",
                           weights_only=True)["model"]
        frozen_ok = all(torch.equal(saved[f"img_backbone.{k}"], v)
                        for k, v in want_trunk.items() if "_bn" in k or ".bn" in k)

        # the streaming eval's frames/s on the val scene (frames decoded
        # and on the host; a warm pass, then CLI_EVAL_PASSES timed ones,
        # each from a scene reset as the test CLI runs it)
        frames, _ = test_cli.nuscenes_frames(cfg, types.SimpleNamespace(
            infos=val_pkl, data_root=str(root), img_scale=0.5, num_frames=0), False)
        model = build_model(cfg, device=dev)
        mgr.restore(model, cfg=cfg)
        run_streaming_eval(cfg, model, frames)
        torch.cuda.synchronize()
        eval_fps = []
        for _ in range(CLI_EVAL_PASSES):
            t0 = time.perf_counter()
            run_streaming_eval(cfg, model, frames)
            eval_fps.append(len(frames) / (time.perf_counter() - t0))
        loader = loader_seconds(cfg, train_pkl, str(root))
        del model

    train_recs = [r for r in records if r["kind"] == "train"]
    steady = [r for r in train_recs if r["step"] not in (1, CLI_TRAIN_STEPS + 1)]
    n_val = len(infos["val"])
    expect = {"train": {k: v * CLI_TRAIN_STEPS for k, v in per_step.items()},
              "resume": {k: v * (CLI_RESUME_STEPS - CLI_TRAIN_STEPS)
                         for k, v in per_step.items()},
              "test": {k: v * n_val for k, v in stream_launches_per_frame(cfg).items()}}
    checks = {
        "infos_map_vectors": all(i["map_vectors"] for s in infos.values() for i in s),
        "pretrained_import": import_ok, "frozen_bn_kept": frozen_ok,
        "resumed": f"resumed from step {CLI_TRAIN_STEPS}" in logged,
        "train_records": [r["step"] for r in train_recs] == list(
            range(1, CLI_RESUME_STEPS + 1)),
        "checkpoints": ckpt_steps == [CLI_TRAIN_STEPS, CLI_RESUME_STEPS],
        "finite_nds_chamfer": all(math.isfinite(metrics[k]) for k in (
            "NDS", "NuscMap_chamfer/mAP")),
        "results_json": len(results["det"]) == len(results["map"]) == n_val,
        **{f"launches_{k}": launches[k][0] == expect[k] for k in expect}}
    emit({"phase": "cli_nuscenes", "config": cfg.name, "nvidia_smi": nvidia_smi_line(),
          "samples": {k: len(v) for k, v in infos.items()},
          "map_vectors_per_sample": statistics.mean(
              len(i["map_vectors"]) for i in infos["train"]),
          "write_tree_s": write_s, "loader": loader,
          "step_s": [r["step_s"] for r in train_recs],
          "data_wait_s": [r["data_wait_s"] for r in train_recs],
          "steady_step_s": spread([r["step_s"] for r in steady]),
          "steady_data_wait_s": spread([r["data_wait_s"] for r in steady]),
          "loss_total": [r["loss_total"] for r in train_recs],
          "eval_frames_per_s": spread(eval_fps), "eval_frames": len(frames),
          "cli_s": {k: v[1] for k, v in launches.items()},
          "launches": {k: v[0] for k, v in launches.items()},
          "metrics": {k: metrics[k] for k in ("NDS", "mean_ap", "NuscMap_chamfer/mAP")},
          "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cli_nuscenes: failed {failed}; launches "
                             f"{ {k: v[0] for k, v in launches.items()} } expected {expect}")
    total = {}
    for counts, _ in launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# the V-99-eSE trunk in TF32 against f32 at a frame's images: largest
# absolute difference over the f32 output's largest magnitude. TF32 keeps
# 10 of f32's 23 mantissa bits and bf16 7, so the TF32 trunk must also sit
# below the bf16 trunk's difference
VOVNET_TF32_LIMIT = 2e-2


def phase_stream_vovnet(dev):
    """``stream_vovnet`` (``phase_stream_model``; the model's f32
    convolutions in TF32, ``models.detector.conv_tf32``), then the
    V-99-eSE trunk alone at the frame's shape (six 480x800 images, forward,
    CUDA events) in f32 with TF32 off, f32 with TF32 and bf16, with the
    kernels a forward launches, the TF32 and bf16 outputs held to the f32
    one (VOVNET_TF32_LIMIT). Without TF32 cuDNN runs V-99's f32 3x3
    convolutions as FFTs (~26,000 kernels a forward), ten times slower; the
    f32 frame against plain versions runs the same convolutions on both
    sides."""
    from apollo_vision_net_tpu_torch import set_f32_precision
    from apollo_vision_net_tpu_torch.models.detector import conv_tf32
    from apollo_vision_net_tpu_torch.models.vovnet import VoVNet

    cfg = vovnet_det()
    launches = phase_stream_model(dev, cfg, "stream_vovnet", n_fps=5)
    trunk = VoVNet(out_indices=(3,)).to(dev).eval()
    x = torch.randn((6, 3) + tuple(cfg.model.img_shape), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    rows, outs = {}, {}
    for name, dtype, tf32 in (("f32", torch.float32, False),
                              ("f32_tf32", torch.float32, True),
                              ("bf16", torch.bfloat16, False)):
        set_f32_precision(tf32)
        xx = x.to(dtype)
        try:
            with torch.inference_mode():
                outs[name] = trunk(xx)[-1].float()
                ms = time_ms(lambda: trunk(xx), warmup=2, iters=3)
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    trunk(xx)
                    torch.cuda.synchronize()
        finally:
            set_f32_precision(conv_tf32(cfg))
        kern, _ = profile_step.profile_kernels(prof)
        by_name = {}
        for kname, us in kern:
            by_name[kname[:60]] = by_name.get(kname[:60], 0.0) + us
        rows[name] = {"ms": ms, "kernels": len(kern),
                      "top": sorted(by_name, key=lambda k: -by_name[k])[:3]}
    ref = outs["f32"]
    scale = ref.abs().max().item()
    for name in ("f32_tf32", "bf16"):
        rows[name]["rel_err_vs_f32"] = (outs[name] - ref).abs().max().item() / scale
    emit({"phase": "stream_vovnet_trunk", "images": list(x.shape),
          "out_shape": list(ref.shape), "out_max_abs": scale,
          "limit": VOVNET_TF32_LIMIT, "forward": rows})
    tf32_err = rows["f32_tf32"]["rel_err_vs_f32"]
    if not (math.isfinite(tf32_err) and tf32_err <= VOVNET_TF32_LIMIT
            and tf32_err < rows["bf16"]["rel_err_vs_f32"]):
        raise AssertionError(f"stream_vovnet_trunk: TF32 vs f32 {tf32_err} (limit "
                             f"{VOVNET_TF32_LIMIT}, bf16 {rows['bf16']['rel_err_vs_f32']})")
    del trunk, outs
    return launches


def phase_train_vovnet(dev):
    """``train_vovnet``: ``phase_train`` at 1 + 2 layers for the f32
    comparison (TF32 convolutions, as ``phase_stream_vovnet``)."""
    return phase_train(dev, vovnet_det(), "train_vovnet", cmp_sizes=BASE_CMP_SIZES)


def vovnet_det():
    """bev_tiny_det on VoVNet V-99-eSE (DD3D's pretrained trunk): stage 3,
    1024 channels at 15x25, into the one FPN level (f32, as configured)."""
    cfg = bev_tiny_det()
    return dataclasses.replace(cfg, name="bev_tiny_det_vovnet", model=dataclasses.replace(
        cfg.model, backbone_type="vovnet"))


# ------------------------------------------------------------ kitti_files

KITTI_IMG_WH = (1241, 376)
KITTI_POINTS = 120_000
# KITTI odometry sequence 00's P2 and velodyne-to-camera Tr (calib.txt)
KITTI_P2 = ((718.856, 0.0, 607.1928, 45.38225),
            (0.0, 718.856, 185.2157, -0.1130887),
            (0.0, 0.0, 1.0, 0.003779761))
KITTI_TR = ((4.276802e-04, -9.999672e-01, -8.084491e-03, -1.198459e-02),
            (-7.210626e-03, 8.081198e-03, -9.999413e-01, -5.403984e-02),
            (9.999738e-01, 4.859485e-04, -7.206933e-03, -2.921968e-01))
# raw SemanticKITTI ids of the scan's surfaces and objects (ground rings by
# lateral distance; boxes of objects: id, (length, width, height), count)
KITTI_GROUND = (40, 48, 72)
KITTI_OBJECTS = ((10, (4.2, 1.8, 1.5), 14), (252, (4.2, 1.8, 1.5), 3),
                 (50, (12.0, 1.0, 6.0), 8), (70, (3.0, 3.0, 4.0), 10),
                 (80, (0.3, 0.3, 5.0), 8), (30, (0.6, 0.6, 1.8), 5))
# the fused eval pipeline against the numpy one (tests/test_native.py's)
NATIVE_PIPE_RTOL, NATIVE_PIPE_ATOL = 2e-4, 2e-3


def kitti_scan(rng, n=KITTI_POINTS):
    """One labeled velodyne sweep: ground points out to 70 m around the car
    (road, sidewalk, terrain by lateral distance; denser near), the rest on
    boxes of cars, moving cars, buildings, vegetation, poles and people
    ahead and beside it: (n, 3) float32 xyz, raw semantic ids, instance
    ids."""
    import numpy as np

    n_g = n * 11 // 20
    r = 3.0 + 67.0 * rng.random(n_g) ** 2
    az = rng.uniform(-math.pi, math.pi, n_g)
    y = r * np.sin(az)
    xyz = [np.stack([r * np.cos(az), y, -1.73 + 0.03 * rng.standard_normal(n_g)], 1)]
    sem = [np.asarray(KITTI_GROUND)[(np.abs(y) >= 4.0).astype(int)
                                    + (np.abs(y) >= 7.0).astype(int)]]
    inst = [np.zeros(n_g, np.int64)]
    boxes = [(sid, size, k) for sid, size, count in KITTI_OBJECTS for k in range(count)]
    for b, (sid, size, k) in enumerate(boxes):
        m = (n - n_g) // len(boxes) + (b < (n - n_g) % len(boxes))
        lo = np.array([*rng.uniform((-10.0, -30.0), (60.0, 30.0)), -1.73])
        lo[:2] -= np.asarray(size[:2]) / 2
        xyz.append(lo + rng.random((m, 3)) * size)
        sem.append(np.full(m, sid))
        inst.append(np.full(m, k + 1 if sid in (10, 252, 30) else 0))
    return (np.concatenate(xyz).astype(np.float32), np.concatenate(sem),
            np.concatenate(inst))


def write_fake_kitti(root, seed: int = 0, n_frames: int = 3):
    """One SemanticKITTI sequence ("00") in the dataset's own formats under
    ``root``, from ``seed``: per frame a 1241x376 PNG (image_2), a sweep of
    KITTI_POINTS points (velodyne .bin) with its .label, and the
    256x256x32 voxel files (.label: raw ids by majority of the sweep's
    points, the native voxelizer's vote; .bin: occupancy bits; .invalid:
    ~2% of the voxels), calib.txt (KITTI_P2, KITTI_TR) and poses.txt
    (1 m forward a frame). Returns (sequence dir, the frames' points with
    learning ids)."""
    import numpy as np
    from PIL import Image

    from apollo_vision_net_tpu_torch.data import native
    from apollo_vision_net_tpu_torch.data import semantic_kitti as sk

    rng = np.random.default_rng(seed)
    seq = root / "sequences" / "00"
    for sub in ("image_2", "velodyne", "labels", "voxels"):
        (seq / sub).mkdir(parents=True, exist_ok=True)
    flat = lambda a: " ".join(repr(float(v)) for v in np.asarray(a).reshape(-1))  # noqa: E731
    (seq / "calib.txt").write_text("".join(
        f"{k}: {flat(v)}\n" for k, v in (("P0", np.zeros((3, 4))), ("P1", np.zeros((3, 4))),
                                          ("P2", KITTI_P2), ("P3", KITTI_P2),
                                          ("Tr", KITTI_TR))))
    (seq / "poses.txt").write_text("".join(
        flat(np.hstack([np.eye(3), [[0.0], [0.0], [float(f)]]])) + "\n"
        for f in range(n_frames)))
    lut = sk.build_learning_map_array()
    raw_of = np.zeros(sk.OCCUPANCY_CLASSES + 1, np.uint16)
    for raw_id in sorted(sk.LEARNING_MAP, reverse=True):
        raw_of[sk.LEARNING_MAP[raw_id]] = raw_id  # the smallest raw id of each
    W, H = KITTI_IMG_WH
    scans = []
    for f in range(n_frames):
        name = f"{f:06d}"
        img = rng.integers(0, 256, (H, W, 3), np.uint8)
        img[:, :, 0] = np.linspace(0, 255, W, dtype=np.uint8)[None]
        Image.fromarray(img).save(seq / "image_2" / f"{name}.png")
        xyz, sem, inst = kitti_scan(rng)
        pts = np.concatenate([xyz, rng.random((len(xyz), 1), np.float32)], 1)
        pts.astype(np.float32).tofile(seq / "velodyne" / f"{name}.bin")
        (sem.astype(np.uint32) | (inst.astype(np.uint32) << 16)).tofile(
            seq / "labels" / f"{name}.label")
        ids = np.concatenate([xyz, lut[sem][:, None]], 1).astype(np.float32)
        dense = native.voxelize_points(
            ids, sk.PC_RANGE, sk.OCCUPANCY_SIZE,
            (sk.OCC_XDIM, sk.OCC_YDIM, sk.OCC_ZDIM), sk.OCCUPANCY_CLASSES + 1, 0)
        vox = raw_of[dense.reshape(sk.OCC_ZDIM, sk.OCC_YDIM, sk.OCC_XDIM)
                     .transpose(2, 1, 0)]                     # (x, y, z) order
        vox.reshape(-1).tofile(seq / "voxels" / f"{name}.label")
        np.packbits((vox > 0).reshape(-1)).tofile(seq / "voxels" / f"{name}.bin")
        np.packbits((rng.random(vox.shape) < 0.02).reshape(-1)).tofile(
            seq / "voxels" / f"{name}.invalid")
        scans.append(ids)
    return seq, scans


def host_seconds(fn, n=3):
    """``fn``'s result and the spread of its host seconds over ``n`` calls."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, spread(times)


def kitti_frame(info, cfg, rng):
    """One queue frame read from the SemanticKITTI files: image_2 through
    the port's training pipeline at the scale that fits its width to the
    config's (1241 -> 800 columns), onto the config's zero canvas (480x800:
    the geometry's pixel frame is unchanged), lidar2img from the infos
    scaled with it, and the dense GT as training labels."""
    import numpy as np
    from PIL import Image

    from apollo_vision_net_tpu_torch.data import pipeline as pipe
    from apollo_vision_net_tpu_torch.data.semantic_kitti import dense_gt_to_training_labels

    cam = info["cams"]["image_2"]
    img = np.asarray(Image.open(cam["data_path"]).convert("RGB"))[None]
    H, W = cfg.model.img_shape
    out, l2i = pipe.preprocess_frame(img, cam["lidar2img"][None].astype(np.float32),
                                     scale=W / img.shape[2], training=True, rng=rng)
    canvas = np.zeros((1, H, W, 3), np.float32)
    canvas[:, :out.shape[1], :out.shape[2]] = out[:, :H, :W]
    labels = dense_gt_to_training_labels(np.load(info["occ_gt_path"]))
    return canvas, l2i.astype(np.float32), labels


def phase_kitti_files(dev):
    """semantic_kitti_occ's train step fed from a SemanticKITTI tree (see the
    module docstring): the tree, ``tools.create_data semantic-kitti``, a
    queue batch read from its files, 3 bf16 train steps with the launch
    counts of ``train_kitti``; the host readings."""
    import pickle
    import pathlib
    import tempfile

    import numpy as np

    from apollo_vision_net_tpu_torch.data import native
    from apollo_vision_net_tpu_torch.data import pipeline as pipe
    from apollo_vision_net_tpu_torch.data import semantic_kitti as sk
    from apollo_vision_net_tpu_torch.tools import create_data
    from apollo_vision_net_tpu_torch.tools.convert_lidar_to_occ import voxelize_numpy

    cfg = semantic_kitti_occ()
    m = cfg.model
    T = m.queue_length
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        t0 = time.perf_counter()
        _, scans = write_fake_kitti(root, seed=0, n_frames=T)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        infos_path = create_data.create_semantic_kitti(str(root), str(root / "out"))
        t_create = time.perf_counter() - t0
        with open(infos_path, "rb") as f:
            infos = pickle.load(f)["infos"]
        rng = np.random.default_rng(0)
        frames, read_s = [], []
        for info in infos[:T]:
            t0 = time.perf_counter()
            frames.append(kitti_frame(info, cfg, rng))
            read_s.append(time.perf_counter() - t0)
        # the native voxelizer and its plain version on a full scan
        grid = dict(pc_range=sk.PC_RANGE, voxel_size=sk.OCCUPANCY_SIZE,
                    dims=(sk.OCC_XDIM, sk.OCC_YDIM, sk.OCC_ZDIM),
                    num_classes=sk.OCCUPANCY_CLASSES + 1, empty_label=0)
        vox_native, vox_native_s = host_seconds(
            lambda: native.voxelize_points(scans[0], **grid))
        vox_numpy, vox_numpy_s = host_seconds(lambda: voxelize_numpy(scans[0], **grid))
    # the eval pipeline on a 1600x900 six-camera ring, native and numpy
    ring = np.random.default_rng(1).integers(0, 256, (6, 900, 1600, 3), np.uint8)
    pipe_native, pipe_native_s = host_seconds(lambda: native.resize_normalize_pad(
        ring, 0.5, pipe.IMG_MEAN, pipe.IMG_STD, 32))
    pipe_numpy, pipe_numpy_s = host_seconds(
        lambda: pipe.plain_resize_normalize_pad(ring, 0.5))
    pipe_ok = pipe_native.shape == pipe_numpy.shape and np.allclose(
        pipe_native, pipe_numpy, rtol=NATIVE_PIPE_RTOL, atol=NATIVE_PIPE_ATOL)
    vox_equal = bool(np.array_equal(vox_native, vox_numpy))

    batch = make_batch(cfg, 1, seed=0, paint_gt=True)
    batch["img"] = np.stack([f[0] for f in frames])[None]
    batch["lidar2img"] = np.stack([f[1] for f in frames])[None]
    batch["can_bus"] = np.stack([i["can_bus"] for i in infos[:T]])[None]
    batch["gt_occupancy"] = frames[-1][2][None].astype(np.int32)
    labels = frames[-1][2]
    batch = train_lib.batch_to_device(batch, dev)
    torch.cuda.reset_peak_memory_stats()
    model = new_model(cfg, dev).train()
    optimizer = make_optimizer(model, cfg.optim)
    gen = torch.Generator(device=dev)
    reset_launch_counts()
    history = []
    t0 = time.perf_counter()
    for i in range(3):
        losses = train_steps(cfg, model, optimizer, batch, gen, i, 1)
        history.append({k: float(v) for k, v in losses.items()})
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launch_counts()
    expect = {k: v * 3 for k, v in train_launches_per_step(cfg).items()}
    finite = all(math.isfinite(v) for h in history for v in h.values())
    emit({"phase": "kitti_files", "config": cfg.name, "frames": len(infos),
          "image_wh": list(KITTI_IMG_WH), "points_per_scan": int(len(scans[0])),
          "img": list(batch["img"].shape), "seconds_write_tree": t_write,
          "seconds_create_data": t_create, "read_frame_s": spread(read_s),
          "gt_voxels": {"classes": int((labels < 19).sum()),
                        "empty": int((labels == 19).sum()),
                        "ignore": int((labels == 255).sum())},
          "voxelizer": {"native_s": vox_native_s, "numpy_s": vox_numpy_s,
                        "equal": vox_equal,
                        "occupied": int((vox_native != 0).sum())},
          "eval_pipeline_1600x900x6": {
              "native_s": pipe_native_s, "numpy_s": pipe_numpy_s,
              "max_abs_diff": float(np.abs(pipe_native - pipe_numpy).max()),
              "rtol": NATIVE_PIPE_RTOL, "atol": NATIVE_PIPE_ATOL,
              "within": bool(pipe_ok)},
          "steps": 3, "seconds_steps": seconds, "launches": launches,
          "finite": finite, "loss_total": [h["loss_total"] for h in history],
          "terms_last": history[-1],
          "peak_mem_gb_steps": torch.cuda.max_memory_allocated() / 1e9})
    if launches != expect:
        raise AssertionError(f"kitti_files: launches {launches} != train_kitti's {expect}")
    if not finite:
        raise AssertionError(f"kitti_files: non-finite loss terms {history}")
    if not vox_equal or not pipe_ok:
        raise AssertionError("kitti_files: native host library disagrees with numpy "
                             f"(voxelizer equal {vox_equal}, pipeline {pipe_ok})")
    del model, optimizer, batch
    return launches


# ------------------------------------------------------------ multi-GPU

# train_dp's one-card world: two gloo ranks on cuda:0 (NCCL refuses two
# ranks on one device), a global batch of 2; DP_STEPS bf16 steps on the main
# path, DP_TIMED_STEPS more timed against the one process's
DP_STEPS = 2
DP_TIMED_STEPS = 3


def mesh_grad_step(mesh, model, cfg, batch, seed, indices=None):
    """``grad_step`` over a mesh: this rank's rows, the loss of the global
    batch, the gradients averaged over the world -> (loss terms, {name:
    gradient}, indices)."""
    model.zero_grad(set_to_none=True)
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    with use_generator(gen):
        total, losses, indices = train_lib.loss_fn(model, batch, cfg, indices,
                                                   mesh=mesh)
    total.backward()
    train_lib.average_gradients(mesh, model)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v.detach()) for k, v in losses.items()}, grads, indices


def step_vs_one_process(mesh, cfg32, batch, dev, model32=None):
    """The f32 step on the mesh against the one process on the global batch
    (rank 0, same weights, generator seed and assignment), with ``train``'s
    limits: {"losses", "loss_rel_err", "grad_worst_rel_err",
    "grad_worst_norm_rel_err", "ok"} on rank 0, {"losses"} elsewhere."""
    model32 = model32 or replicate(mesh, new_model(cfg32, dev)).train()
    local = train_lib.batch_to_device(shard_batch(mesh, batch), dev)
    seed = step_seed(0, 0)
    got_l, got_g, indices = mesh_grad_step(mesh, model32, cfg32, local, seed)
    out = {"losses": got_l}
    if mesh.rank == 0:
        gen = torch.Generator(device=dev)
        want_l, want_g, _ = grad_step(
            model32, cfg32, train_lib.batch_to_device(batch, dev), gen, seed,
            indices)
        loss_err = {k: abs(got_l[k] - w) / max(abs(w), 1e-12)
                    for k, w in want_l.items()}
        floor = TRAIN_GRAD_FLOOR * max(float(g.abs().max()) for g in want_g.values())
        rel = {k: max(0.0, float((got_g[k] - w).abs().max()) - floor)
               / max(float(w.abs().max()), floor) for k, w in want_g.items()}
        norm = {k: float((got_g[k] - w).norm()) / float(w.norm())
                for k, w in want_g.items() if float(w.abs().max()) > 100 * floor}
        out.update(
            loss_rel_err=max(loss_err.values()),
            grad_worst_rel_err=sorted(rel.items(), key=lambda kv: -kv[1])[:5],
            grad_worst_norm_rel_err=sorted(norm.items(), key=lambda kv: -kv[1])[:5],
            params_with_grad=len(want_g),
            ok=bool(max(loss_err.values()) <= TRAIN_REL_TOL
                    and max(rel.values()) <= TRAIN_GRAD_REL_TOL
                    and max(norm.values()) <= TRAIN_GRAD_NORM_TOL
                    and set(got_g) == set(want_g)))
    del got_g
    return out


def params_equal_on_ranks(mesh, model) -> float:
    """The largest difference between this rank's parameters and any other
    rank's (0.0: bit-equal)."""
    flat = torch.cat([p.detach().float().reshape(-1) for p in model.parameters()])
    parts = [torch.empty_like(flat) for _ in range(mesh.world)]
    torch.distributed.all_gather(parts, flat)
    return max(float((p - flat).abs().max()) for p in parts)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def peak_gb(dev) -> float:
    return torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0


def timed_steps(step, cfg, model, optimizer, batch, gen, first, n):
    """Host clock over ``n`` steps after a synchronize, ending in one
    -> ms a step."""
    sync(batch["img"].device)
    t0 = time.perf_counter()
    for i in range(first, first + n):
        gen.manual_seed(step_seed(0, i))
        step(model, optimizer, batch, gen)
    sync(batch["img"].device)
    return (time.perf_counter() - t0) / n * 1e3


def dp_rank(config=bev_tiny_det_map_apollo, device="cuda"):
    """One rank of train_dp (two gloo ranks on cuda:0): the ``config``'s
    f32 step against the one process, then DP_STEPS training-mode steps in
    its dtype on the main path (launch counts reset just before, read just
    after), the ranks' parameters compared, DP_TIMED_STEPS timed; rank 0
    then times the one process on the global batch while rank 1 waits."""
    mesh = make_mesh(device=device)
    dev = mesh.device
    cfg = config()
    batch = make_batch(cfg, mesh.dp, seed=0, paint_gt=True)
    out = {"rank": mesh.rank,
           "f32": step_vs_one_process(mesh, f32_config(cfg), batch, dev)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    model = replicate(mesh, new_model(cfg, dev)).train()
    optimizer = make_optimizer(model, cfg.optim)
    step = train_lib.make_train_step(mesh, cfg)
    local = train_lib.batch_to_device(shard_batch(mesh, batch), dev)
    gen = torch.Generator(device=dev)
    torch.distributed.barrier()
    reset_launch_counts()
    t0 = time.perf_counter()
    history = []
    for i in range(DP_STEPS):
        gen.manual_seed(step_seed(0, i))
        losses = step(model, optimizer, local, gen)
        history.append({k: float(v) for k, v in losses.items()})
    sync(dev)
    out.update(seconds_steps=time.perf_counter() - t0,
               launches=read_launch_counts(), history=history,
               rank_param_diff=params_equal_on_ranks(mesh, model))
    out["world_step_ms"] = timed_steps(step, cfg, model, optimizer, local,
                                       gen, 100, DP_TIMED_STEPS)
    torch.distributed.barrier()
    if mesh.rank == 0:
        one = train_lib.make_train_step(None, cfg)
        whole = train_lib.batch_to_device(batch, dev)
        timed_steps(one, cfg, model, optimizer, whole, gen, 200, 1)
        out["one_process_step_ms"] = timed_steps(one, cfg, model, optimizer,
                                                 whole, gen, 201, DP_TIMED_STEPS)
    out["peak_mem_gb"] = peak_gb(dev)
    torch.distributed.barrier()
    return out


def nccl_world_one(dev, tmp):
    """A world of one over NCCL on the card: the flagship's f32 step with
    every collective of the mesh step (gathers over one-rank groups, the
    average) against the non-distributed step of the same batch."""
    init_distributed(dev, 0, 1, "file://" + os.path.join(tmp, "nccl_init"))
    try:
        mesh = make_mesh(device=dev)
        out = step_vs_one_process(mesh, f32_config(bev_tiny_det_map_apollo()),
                                  make_batch(bev_tiny_det_map_apollo(), 1, seed=0,
                                             paint_gt=True), dev)
        out["backend"] = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    return out


def phase_train_dp(dev):
    """train_dp (see the module docstring): two gloo ranks on cuda:0, then a
    world of one over NCCL -> the ranks' launch counts summed."""
    ranks = spawn_world(2, dp_rank, device="cuda", backend="gloo", threads=2,
                        timeout=600)
    with tempfile.TemporaryDirectory() as tmp:
        nccl = nccl_world_one(dev, tmp)
    cfg = bev_tiny_det_map_apollo()
    expect = {k: v * DP_STEPS for k, v in train_launches_per_step(cfg).items()}
    r0 = ranks[0]
    finite = all(math.isfinite(v) for r in ranks for h in r["history"]
                 for v in h.values())
    emit({"phase": "train_dp", "config": cfg.name, "world": 2,
          "backend": "gloo", "device": "cuda:0",
          "global_batch": 2, "steps": DP_STEPS,
          "launches_per_rank": [r["launches"] for r in ranks],
          "expected_per_rank": expect,
          "seconds_steps_per_rank": [r["seconds_steps"] for r in ranks],
          "loss_total": [h["loss_total"] for h in r0["history"]],
          "finite": finite,
          "rank_param_diff": [r["rank_param_diff"] for r in ranks],
          "f32_vs_one_process": r0["f32"],
          "world2_step_ms": [r["world_step_ms"] for r in ranks],
          "one_process_step_ms": r0["one_process_step_ms"],
          "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks],
          "nccl_world1_vs_one_process": nccl,
          "loss_tol": TRAIN_REL_TOL, "grad_tol": TRAIN_GRAD_REL_TOL,
          "grad_norm_tol": TRAIN_GRAD_NORM_TOL})
    bad = [f"rank {r['rank']}: launches {r['launches']}" for r in ranks
           if r["launches"] != expect]
    if any(r["history"] != r0["history"] for r in ranks):
        bad.append("the ranks' loss terms differ")
    if any(r["rank_param_diff"] != 0.0 for r in ranks):
        bad.append("the ranks' parameters differ")
    if not finite:
        bad.append("non-finite loss terms")
    if not r0["f32"]["ok"]:
        bad.append("the world-2 f32 step disagrees with one process")
    if not nccl["ok"] or nccl["backend"] != "nccl":
        bad.append("the NCCL world-1 step disagrees with one process")
    if bad:
        raise AssertionError(f"train_dp: {bad}")
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


def sp_rank(cmp_sizes, config=bev_base_det_map, device="cuda"):
    """One rank of train_sp: the ``config`` (bev_base_det_map) at
    ``cmp_sizes`` depth with the BEV partition, dp1 x sp2 on cuda:0, one
    f32 training-mode step (the main path: launch counts reset just before,
    read just after), held against the one process on rank 0."""
    mesh = make_mesh(dp=1, sp=2, device=device)
    dev = mesh.device
    cfg = f32_config(config())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bev_partition=("dp", "sp", None), **cmp_sizes))
    model = replicate(mesh, new_model(cfg, dev)).train()
    batch = make_batch(cfg, 1, seed=0, paint_gt=True)
    torch.distributed.barrier()
    reset_launch_counts()
    t0 = time.perf_counter()
    local = train_lib.batch_to_device(shard_batch(mesh, batch), dev)
    got_l, _, _ = mesh_grad_step(mesh, model, cfg, local, step_seed(0, 0))
    sync(dev)
    out = {"rank": mesh.rank, "seconds_step": time.perf_counter() - t0,
           "launches": read_launch_counts(), "losses": got_l,
           "expected": train_launches_per_step(cfg)}
    out["f32"] = step_vs_one_process(mesh, cfg, batch, dev, model)
    out["peak_mem_gb"] = peak_gb(dev)
    torch.distributed.barrier()
    return out


def phase_train_sp(dev):
    """train_sp (see the module docstring) -> the ranks' launch counts
    summed."""
    ranks = spawn_world(2, sp_rank, BASE_CMP_SIZES, device="cuda",
                        backend="gloo", threads=2, timeout=600)
    r0 = ranks[0]
    emit({"phase": "train_sp", "config": bev_base_det_map().name,
          "layers": BASE_CMP_SIZES, "mesh": {"dp": 1, "sp": 2},
          "bev_partition": ["dp", "sp", None], "backend": "gloo",
          "device": "cuda:0",
          "launches_per_rank": [r["launches"] for r in ranks],
          "expected_per_rank": r0["expected"],
          "seconds_step_per_rank": [r["seconds_step"] for r in ranks],
          "losses": r0["losses"], "f32_vs_one_process": r0["f32"],
          "peak_mem_gb_per_rank": [r["peak_mem_gb"] for r in ranks],
          "loss_tol": TRAIN_REL_TOL, "grad_tol": TRAIN_GRAD_REL_TOL,
          "grad_norm_tol": TRAIN_GRAD_NORM_TOL})
    bad = [f"rank {r['rank']}: launches {r['launches']}" for r in ranks
           if r["launches"] != r["expected"]]
    if any(r["losses"] != r0["losses"] for r in ranks):
        bad.append("the ranks' loss terms differ")
    if not all(math.isfinite(v) for v in r0["losses"].values()):
        bad.append("non-finite loss terms")
    if not r0["f32"]["ok"]:
        bad.append("the dp1 x sp2 f32 step disagrees with one process")
    if bad:
        raise AssertionError(f"train_sp: {bad}")
    return {k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}


# ----------------------------------------------------------- converters

KITTI_CALIB = ("P0: 700 0 320 0 0 700 240 0 0 0 1 0\n"
               "P1: 700 0 320 0 0 700 240 0 0 0 1 0\n"
               "P2: 700 0 320 44.8 0 700 240 0.2 0 0 1 0.003\n"
               "P3: 700 0 320 0 0 700 240 0 0 0 1 0\n"
               "R0_rect: 1 0 0 0 1 0 0 0 1\n"
               "Tr_velo_to_cam: 0 -1 0 0 0 0 -1 -0.08 1 0 0 -0.27\n"
               "Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0\n")
# a Car 10 m ahead (velodyne x = 10), a Pedestrian, a DontCare
KITTI_LABELS = ("Car 0.00 0 1.57 300 180 360 260 1.60 1.70 4.00 0.10 1.57 9.73 1.57\n"
                "Pedestrian 0.00 0 0.2 400 170 420 230 1.75 0.60 0.80 -2.0 1.60 14.73 0.2\n"
                "DontCare -1 -1 -10 500 170 590 190 -1 -1 -1 -1000 -1000 -1000 -10\n")


def write_kitti_3d(root, seed: int = 0, n: int = 4):
    """A KITTI 3D-detection tree of ``n`` frames from ``seed``: 640x480
    PNGs, calib and label files, 20,000-point scans with 200 points in the
    Car and 80 in the Pedestrian, and ImageSets (train: even frames, val:
    odd, test: all)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split in ("training", "testing"):
        for sub in ("image_2", "velodyne", "calib", "label_2"):
            os.makedirs(os.path.join(root, split, sub), exist_ok=True)
    os.makedirs(os.path.join(root, "ImageSets"), exist_ok=True)
    for i in range(n):
        s = f"{i:06d}"
        pts = np.concatenate([
            np.column_stack([rng.uniform(9.0, 10.9, 200), rng.uniform(-0.75, 0.55, 200),
                             rng.uniform(-1.55, -0.2, 200), rng.random(200)]),
            np.column_stack([rng.uniform(14.85, 15.15, 80), rng.uniform(1.85, 2.15, 80),
                             rng.uniform(-1.6, 0.0, 80), rng.random(80)]),
            # the rest of the scan, clear of both boxes
            np.column_stack([rng.uniform(20, 70, 19_720), rng.uniform(-40, 40, 19_720),
                             rng.uniform(-2, 2, 19_720), rng.random(19_720)]),
        ]).astype(np.float32)
        for split in ("training", "testing"):
            Image.fromarray(rng.integers(0, 255, (480, 640, 3), dtype=np.uint8)).save(
                os.path.join(root, split, "image_2", s + ".png"))
            with open(os.path.join(root, split, "calib", s + ".txt"), "w") as f:
                f.write(KITTI_CALIB)
            pts.tofile(os.path.join(root, split, "velodyne", s + ".bin"))
        with open(os.path.join(root, "training", "label_2", s + ".txt"), "w") as f:
            f.write(KITTI_LABELS)
    for name, idx in (("train", range(0, n, 2)), ("val", range(1, n, 2)),
                      ("test", range(n))):
        with open(os.path.join(root, "ImageSets", name + ".txt"), "w") as f:
            f.write("\n".join(str(i) for i in idx) + "\n")


def write_scannet(root, seed: int = 0, n_scans: int = 2, n_points: int = 50_000):
    """A ScanNet export tree (the upstream scripts' .npy files) of
    ``n_scans`` scans from ``seed``."""
    inst, meta = (os.path.join(root, d) for d in ("scannet_instance_data", "meta_data"))
    os.makedirs(inst)
    os.makedirs(meta)
    rng = np.random.default_rng(seed)
    scans = [f"scene{i:04d}_00" for i in range(n_scans)]
    for scan in scans:
        np.save(os.path.join(inst, f"{scan}_vert.npy"),
                rng.normal(size=(n_points, 6)).astype(np.float32))
        np.save(os.path.join(inst, f"{scan}_ins_label.npy"), rng.integers(0, 8, n_points))
        np.save(os.path.join(inst, f"{scan}_sem_label.npy"),
                rng.choice([1, 3, 4, 5, 39], n_points))
        boxes = np.array([[0, 0, 0.5, 2.0, 1.5, 0.6, 4], [1, 1, 0.2, 0.4, 0.4, 0.5, 39],
                          [-1, 2, 0.4, 1.0, 1.0, 0.8, 5]], np.float64)
        np.save(os.path.join(inst, f"{scan}_aligned_bbox.npy"), boxes)
        np.save(os.path.join(inst, f"{scan}_unaligned_bbox.npy"), boxes)
        np.save(os.path.join(inst, f"{scan}_axis_align_matrix.npy"), np.eye(4))
    for split, names in (("train", scans[:1]), ("val", scans[1:])):
        with open(os.path.join(meta, f"scannetv2_{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")


class FakeLyft:
    """The lyft devkit's table API over one scene of two samples, one
    camera (the duck type ``data.lyft.fill_trainval_infos`` reads)."""

    class Box:
        def __init__(self, center, wlh, yaw, name):
            self.center, self.wlh, self.name = np.asarray(center), np.asarray(wlh), name
            self.orientation = type("O", (), {"yaw_pitch_roll": (yaw, 0.0, 0.0)})()

    def __init__(self, root):
        q = [1.0, 0.0, 0.0, 0.0]
        self.root = root
        self.tables = {
            ("calibrated_sensor", "cs_lidar"): {"translation": [0, 0, 1.8],
                                                "rotation": q, "camera_intrinsic": []},
            ("calibrated_sensor", "cs_cam"): {
                "translation": [1.5, 0, 1.6], "rotation": q,
                "camera_intrinsic": [[700, 0, 320], [0, 700, 240], [0, 0, 1]]},
            ("ego_pose", "ep0"): {"translation": [100, 50, 0], "rotation": q,
                                  "timestamp": 1000},
            ("sample_annotation", "ann0"): {"num_lidar_pts": 12, "num_radar_pts": 3},
        }
        for i in range(2):
            self.tables[("sample_data", f"sd_lidar{i}")] = {
                "calibrated_sensor_token": "cs_lidar", "ego_pose_token": "ep0",
                "timestamp": 1000 + 100 * i, "prev": f"sd_lidar{i - 1}" if i else ""}
            self.tables[("sample_data", f"sd_cam{i}")] = {
                "calibrated_sensor_token": "cs_cam", "ego_pose_token": "ep0",
                "timestamp": 1001 + 100 * i, "prev": ""}
        self.sample = [{"token": f"s{i}", "scene_token": "sc0", "timestamp": 1000 + 100 * i,
                        "data": {"LIDAR_TOP": f"sd_lidar{i}", "CAM_FRONT": f"sd_cam{i}"},
                        "anns": ["ann0"]} for i in range(2)]
        self.scene = [{"token": "sc0"}]

    def get(self, table, token):
        if table == "scene":
            return {"name": "scene-0001", "token": token}
        return self.tables[(table, token)]

    def get_sample_data_path(self, token):
        return os.path.join(self.root, token + ".bin")

    def get_sample_data(self, token):
        boxes = [self.Box([5.0, 1.0, 0.5], [2.0, 4.5, 1.7], 0.3, "car")]
        cam = np.array([[700, 0, 320], [0, 700, 240], [0, 0, 1]]) if "cam" in token else None
        return self.get_sample_data_path(token), boxes, cam


def waymo_frame(seed: int = 0) -> dict:
    """One Waymo frame as ``data.waymo.convert_frame`` reads it: five
    cameras, 150,000 points, a vehicle, a pedestrian and a sign."""
    import io

    from PIL import Image

    rng = np.random.default_rng(seed)
    images, calibs = {}, {}
    for cam in range(5):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 255, (64, 96, 3), dtype=np.uint8)).save(buf, "PNG")
        images[cam] = buf.getvalue()
        ext = np.eye(4)
        ext[:3, 3] = [1.5, 0.1 * cam, 2.0]
        calibs[cam] = {"extrinsic": ext, "intrinsic": [2000.0, 2000.0, 960.0, 640.0]}
    labels = [
        {"id": "v", "type": 1, "center": (10.0, 2.0, 1.0), "size": (4.5, 2.0, 1.8),
         "heading": 0.5, "num_lidar_points_in_box": 50, "camera_name": 0,
         "bbox": (100.0, 200.0, 300.0, 400.0)},
        {"id": "p", "type": 2, "center": (6.0, -1.0, 0.9), "size": (0.6, 0.6, 1.7),
         "heading": 0.1, "num_lidar_points_in_box": 20, "camera_name": 1,
         "bbox": (10.0, 20.0, 30.0, 60.0)},
        {"id": "s", "type": 3, "center": (5.0, 0.0, 2.0), "size": (0.5, 0.5, 1.0),
         "heading": 0.0, "num_lidar_points_in_box": 5, "camera_name": None, "bbox": None},
    ]
    return {"timestamp_micros": 123456, "pose": np.eye(4), "images": images,
            "camera_calibs": calibs,
            "points": rng.normal(0, 10, (150_000, 6)).astype(np.float32),
            "laser_labels": labels}


def phase_converters(dev):
    """converters (host only; see the module docstring): the five
    ``create_data`` choices that the port added, on trees written from a
    seed; fails unless each writes what it must."""
    import pickle

    from apollo_vision_net_tpu_torch.data import lyft, waymo
    from apollo_vision_net_tpu_torch.data.kitti import parse_label_file
    from apollo_vision_net_tpu_torch.tools import create_data

    seconds, checks = {}, {}

    def run(name, argv):
        t0 = time.perf_counter()
        create_data.main(argv)
        seconds[name] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        kitti = os.path.join(tmp, "kitti")
        write_kitti_3d(kitti)
        run("kitti", ["kitti", "--root-path", kitti])
        with open(os.path.join(kitti, "kitti_infos_train.pkl"), "rb") as f:
            infos = pickle.load(f)
        with open(os.path.join(kitti, "kitti_dbinfos_train.pkl"), "rb") as f:
            db = pickle.load(f)
        checks["kitti"] = {
            "train_infos": len(infos),
            "num_points_in_gt": infos[0]["annos"]["num_points_in_gt"].tolist(),
            "reduced_clouds": len(os.listdir(os.path.join(kitti, "training", "velodyne_reduced"))),
            "gt_database": {k: len(v) for k, v in db.items()}}
        ok = (len(infos) == 2 and checks["kitti"]["num_points_in_gt"] == [200, 80, -1]
              and set(db) == {"Car", "Pedestrian"} and checks["kitti"]["reduced_clouds"] == 4)
        run("gt-database", ["gt-database", "--root-path", kitti, "--prefix", "kitti_val",
                            "--infos", os.path.join(kitti, "kitti_infos_val.pkl")])
        with open(os.path.join(kitti, "kitti_val_dbinfos_train.pkl"), "rb") as f:
            val_db = pickle.load(f)
        checks["gt-database"] = {k: [r["num_points_in_gt"] for r in v]
                                 for k, v in val_db.items()}
        ok = ok and checks["gt-database"] == {"Car": [200, 200], "Pedestrian": [80, 80]}
        scannet = os.path.join(tmp, "scannet")
        write_scannet(scannet)
        run("scannet", ["scannet", "--root-path", scannet, "--workers", "2"])
        with open(os.path.join(scannet, "scannet_infos_train.pkl"), "rb") as f:
            sc = pickle.load(f)
        checks["scannet"] = {"train_infos": len(sc), "gt_num": sc[0]["annos"]["gt_num"],
                             "names": sc[0]["annos"]["name"].tolist()}
        ok = ok and checks["scannet"] == {"train_infos": 1, "gt_num": 3,
                                          "names": ["bed", "garbagebin", "chair"]}
        # the devkit-gated choices: their gates, and their conversion code
        # on the devkit's duck type and a frame dict
        gates = {}
        for name, argv in (("lyft", ["lyft", "--root-path", tmp]),
                           ("waymo", ["waymo", "--root-path", tmp, "--out-dir",
                                      os.path.join(tmp, "waymo_out"), "--workers", "1"])):
            if name == "waymo":
                open(os.path.join(tmp, "segment-0.tfrecord"), "wb").close()
            try:
                create_data.main(argv)
                gates[name] = "ran"
            except SystemExit as e:
                gates[name] = str(e)
        checks["gates"] = gates
        ok = ok and "lyft_dataset_sdk" in gates["lyft"] and "tensorflow" in gates["waymo"]
        train, val = lyft.fill_trainval_infos(FakeLyft(tmp), {"sc0"}, set(), max_sweeps=2)
        checks["lyft"] = {"train": len(train), "val": len(val),
                          "sweeps": len(train[1]["sweeps"]),
                          "gt_names": train[0]["gt_names"].tolist()}
        ok = ok and checks["lyft"] == {"train": 2, "val": 0, "sweeps": 1, "gt_names": ["car"]}
        t0 = time.perf_counter()
        files = waymo.convert_frame(waymo_frame(), os.path.join(tmp, "waymo_kitti"), 0, 0, 0)
        seconds["waymo_frame"] = time.perf_counter() - t0
        annos = parse_label_file(files["label_all"])
        checks["waymo"] = {"files": sorted(files), "labels": annos["name"].tolist()}
        ok = ok and annos["name"].tolist() == ["Car", "Pedestrian"]
    emit({"phase": "converters", "seconds": seconds, "checks": checks, "ok": ok})
    if not ok:
        raise AssertionError(f"converters: {checks}")
    return None


def kernels_line(rows, launches_by_path):
    """One entry per kernel entry point. Times are per-frame (per train
    step for the backward) sums, in bf16 (the configured dtype), of the
    entry's calls in one frame or step named by ``frame`` (FRAME_CALLS);
    ``launches`` sums the main paths' runs, ``launches_by_path`` splits
    them."""
    out = []
    for name, (frame, mix) in FRAME_CALLS.items():
        sel = [r for r in rows if r["case"] in mix]
        bf = [r for r in sel if r["dtype"] == "bfloat16"]
        by_path = {p: c[name] for p, c in launches_by_path.items()}
        by_variant = {k.split(".")[1]: sum(c[k] for c in launches_by_path.values())
                      for k in variant_counts() if k.startswith(name + ".")}
        entry = {"name": name, "route": "cuda",
                 "source": f"{CSRC}/{ENTRY_SOURCE[name]}",
                 "replaces": REPLACES[name],
                 "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 "max_abs_err": max(r["max_abs_err"] for r in bf),
                 "max_abs_err_f32": max(r["max_abs_err"] for r in sel
                                        if r["dtype"] == "float32")}
        for key in ("ms", "plain_ms", "bound_ms", "call_ms"):
            entry[key] = sum(r[key] * mix[r["case"]] for r in bf)
        entry["bound_by"] = "bytes" if all(
            r["bound_by"] == "bytes" for r in bf) else "operations"
        # every measured shape of the entry, per call in bf16
        entry["rows"] = [
            {"case": r["case"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "share": r["bound_ms"] / r["ms"]}
            for r in rows if r.get("entry") == name and "ms" in r
            and r["dtype"] == "bfloat16"]
        entry["library_ms"] = None
        entry["frame"] = frame
        entry["per_frame_calls"] = mix
        if by_variant:
            entry["launches_by_variant"] = by_variant
        if name == "dcn_fwd":
            entry["conv3x3_cudnn_ms"] = sum(
                r["conv3x3_cudnn_ms"] * mix[r["case"]] for r in bf)
        out.append(entry)
    return {"kernels": out}


# the chamfer bar alone in train_overfit_mapv2: the JAX package's own
# 800-step run of smoke_det_mapv2 reached chamfer mAP 0.7315 but det mAP
# 0.041 (artifacts/overfit_r5/smoke_det_mapv2_metrics.json)
OVERFITS = {
    "train_overfit_mapv2": lambda dev: phase_train_overfit(
        dev, smoke_det_mapv2(), "train_overfit_mapv2", "loss_total",
        OVERFIT_SHARE, steps=MAPV2_OVERFIT_STEPS,
        bars={"NuscMap_chamfer/mAP": BARS["NuscMap_chamfer/mAP"]}),
    "train_overfit": lambda dev: phase_train_overfit(
        dev, bev_smoke_det_map(), "train_overfit", "loss_total",
        OVERFIT_SHARE),
    "train_overfit_occ": lambda dev: phase_train_overfit(
        dev, bev_smoke_det_occ(), "train_overfit_occ", "loss_occupancy",
        OCC_OVERFIT_SHARE),
    **{f"train_overfit_voxel_s{seed}": lambda dev, seed=seed: phase_train_overfit(
        dev, smoke_voxel_occ(), f"train_overfit_voxel_s{seed}", "loss_occupancy",
        OCC_OVERFIT_SHARE, steps=VOXEL_OVERFIT_STEPS, lr=VOXEL_OVERFIT_LR,
        seed=seed) for seed in VOXEL_OVERFIT_SEEDS},
}


# the overfits' processes: the four 1,500-step voxel runs, the 800-step
# mapv2 run, and the two 300-step runs one after the other (each step is
# host-bound: on the card's 8-core host a voxel step took 0.103 s alone,
# 0.12 s beside three more and 0.153 s beside six)
OVERFIT_GROUPS = (*((f"train_overfit_voxel_s{seed}",) for seed in VOXEL_OVERFIT_SEEDS),
                  ("train_overfit_mapv2",), ("train_overfit", "train_overfit_occ"))


def run_overfits(names):
    """Overfit phases (OVERFITS) one after another in a process of their
    own, on the kernels the parent built, torch on one CPU thread (the
    processes share the host's cores) -> {name: (launch counts, metrics)}."""
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {name: OVERFITS[name](torch.device("cuda")) for name in names}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device": torch.cuda.get_device_name(0),
          "python": sys.version.split()[0]})
    ptxas = []
    for src, (seconds, report) in _build.build_many(list(SOURCES)).items():
        kernels = ptxas_kernels(report)
        ptxas += kernels
        emit({"phase": "build", "source": SOURCES[src], "seconds": seconds,
              "ptxas": kernels})
    check_vector_kernels(ptxas)
    t0 = time.perf_counter()
    rows = phase_kernels(dev)
    emit({"phase": "seconds", "of": "kernels", "seconds": time.perf_counter() - t0})
    phases = [
        ("stream", lambda: phase_stream(dev)),
        ("stream_base", lambda: phase_stream_base(dev)),
        ("project_pv", lambda: phase_project_pv(dev)),
        ("train", lambda: phase_train(dev, bev_tiny_det_map_apollo(), "train")),
        ("stream_occ", lambda: phase_stream_model(
            dev, bev_tiny_det_occ_apollo(), "stream_occ")),
        ("train_occ", lambda: phase_train(dev, bev_tiny_det_occ_apollo(),
                                          "train_occ")),
        ("stream_occ_tsa", lambda: phase_stream_model(
            dev, bev_tiny_det_occ_tsa_apollo(), "stream_occ_tsa", n_fps=10)),
        ("train_occ_tsa", lambda: phase_train(
            dev, bev_tiny_det_occ_tsa_apollo(), "train_occ_tsa")),
        ("stream_occ_flow", lambda: phase_stream_model(
            dev, bev_tiny_det_occ_flow(), "stream_occ_flow", n_fps=10)),
        ("train_occ_flow", lambda: phase_train(
            dev, bev_tiny_det_occ_flow(), "train_occ_flow", compare=False)),
        ("stream_occ_aggr", lambda: phase_stream_occ_aggr(dev)),
        ("train_occ_aggr", lambda: phase_train(
            dev, bev_smoke_det_occ_flow(), "train_occ_aggr")),
        ("train_base", lambda: phase_train(dev, bev_base_det_map(), "train_base",
                                           cmp_sizes=BASE_CMP_SIZES)),
        (("base_occ", "base_occ_train"), lambda: phase_base_occ(dev)),
        ("stream_mapv2", lambda: phase_stream_model(
            dev, bev_tiny_det_mapv2(), "stream_mapv2")),
        ("train_mapv2", lambda: phase_train(dev, bev_tiny_det_mapv2(),
                                            "train_mapv2")),
        ("stream_intern_s", lambda: phase_stream_model(
            dev, bev_tiny_occ_intern_s(), "stream_intern_s", n_fps=10)),
        ("train_intern_s", lambda: phase_train(
            dev, bev_tiny_occ_intern_s(), "train_intern_s",
            cmp_sizes=BASE_CMP_SIZES)),
        ("stream_tiny_det", lambda: phase_stream_model(
            dev, bev_tiny_det(), "stream_tiny_det", n_fps=10)),
        ("train_tiny_det", lambda: phase_train(
            dev, bev_tiny_det(), "train_tiny_det", cmp_sizes=BASE_CMP_SIZES)),
        ("stream_kitti", lambda: phase_stream_model(
            dev, semantic_kitti_occ(), "stream_kitti", n_fps=10, f32=False)),
        ("train_kitti", lambda: phase_train(
            dev, semantic_kitti_occ(), "train_kitti", f32=False, compare=False)),
        (("stream_base_intern_s", "train_base_intern_s"), lambda: phase_base_occ(
            dev, bev_base_occ_intern_s(), "stream_base_intern_s",
            train_phase="train_base_intern_s", cmp_sizes=BASE_CMP_SIZES)),
        ("stream_voxel", lambda: phase_stream_model(
            dev, voxel_tiny_occ(), "stream_voxel", n_fps=10)),
        ("train_voxel", lambda: phase_train(dev, voxel_tiny_occ(), "train_voxel")),
        ("stream_hybrid", lambda: phase_stream_model(
            dev, hybrid_tiny_occ(), "stream_hybrid", n_fps=10)),
        ("train_hybrid", lambda: phase_train(dev, hybrid_tiny_occ(),
                                             "train_hybrid")),
        *((name, lambda name=name, cfg=cfg: phase_stream_model(
            dev, cfg, name, n_fps=10, f32=False))
          for name, cfg in (("stream_voxel_base", voxel_base_occ()),
                            ("stream_hybrid_base", hybrid_base_occ()),
                            ("stream_hybrid_intern_s", hybrid_tiny_occ_intern_s()))),
        # the hybrids' D = 2 stage runs the general variant, as in
        # train_hybrid, whose f32 step is split by kernel for it
        *((name, lambda name=name, cfg=cfg: phase_train(
            dev, cfg, name, cmp_sizes=BASE_CMP_SIZES, f32=False,
            split_on_general=False))
          for name, cfg in (("train_voxel_base", voxel_base_occ()),
                            ("train_hybrid_base", hybrid_base_occ()),
                            ("train_hybrid_intern_s", hybrid_tiny_occ_intern_s()))),
        ("kitti_files", lambda: phase_kitti_files(dev)),
        ("stream_vovnet", lambda: phase_stream_vovnet(dev)),
        ("train_vovnet", lambda: phase_train_vovnet(dev)),
        ("cli_nuscenes", lambda: phase_cli_nuscenes(dev)),
        ("train_dp", lambda: phase_train_dp(dev)),
        ("train_sp", lambda: phase_train_sp(dev)),
        ("converters", lambda: phase_converters(dev)),
    ]
    launches = {}
    for names, run in phases:
        t0 = time.perf_counter()
        out = run()
        if isinstance(names, tuple):
            launches.update(zip(names, out))
        elif out is not None:  # a host-only phase launches nothing
            launches[names] = out
        emit({"phase": "seconds", "of": names, "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    # the overfits are host-bound loops of small steps: side by side in
    # OVERFIT_GROUPS processes, after the timed phases
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            len(OVERFIT_GROUPS), mp_context=multiprocessing.get_context("spawn")) as pool:
        runs = [pool.submit(run_overfits, names) for names in OVERFIT_GROUPS]
        results = {name: r for run in runs for name, r in run.result().items()}
    launches.update({name: r[0] for name, r in results.items()})
    voxel_overfit_parity({seed: results[f"train_overfit_voxel_s{seed}"][1]
                          for seed in VOXEL_OVERFIT_SEEDS})
    emit({"phase": "seconds", "of": list(OVERFITS),
          "seconds": time.perf_counter() - t0})
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit(kernels_line(rows, launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
