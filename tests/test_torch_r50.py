"""The R50 BEVFormer configs of the port against the JAX package.

- A small copy of ``bev_tiny_det`` (the reference's BEVFormer-tiny: R50
  stage 4 + one FPN level, the det head alone; here 8x8 BEV, embed_dims 32,
  2 cams at 64x96, a depth-18 Bottleneck ResNet, all f32) runs three
  streaming frames with one scene reset through both
  ``forward_test_frame`` implementations on the same bridged weights
  (``strict=True``) and numpy inputs, within 1e-3 max abs on every output
  (the two sides differ in the order of f32 sums).
- The seven configs (``semantic_kitti_occ``: one camera, 128x128 BEV, a
  256x256x32 grid of 20 classes, CE loss; ``bev_tiny_det_occ``,
  ``bev_base_occ_intern_s``, ``bev_tiny_det``, ``bev_smoke_det``,
  ``bev_tiny_occ``, ``bev_tiny_occ_intern_s``) build on the CPU at full
  size with as many parameters as JAX's ``jax.eval_shape`` of the same
  config (nothing computed), and the flax tree loads into each with
  ``strict=True``.
- A small ``semantic_kitti_occ`` copy takes one train step on the CPU
  through ``parallel.train.train_step`` with a finite CE loss.
- The voxel and hybrid head families build on the R50 det config, and so
  does the VoVNet trunk (tests/test_torch_vovnet.py holds it against
  flax).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import base as jax_configs
from apollo_vision_net_tpu.data.temporal import StreamingState as JaxState
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch import configs as port_configs
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.data.synthetic import make_batch, make_stream
from apollo_vision_net_tpu_torch.models import detector
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.models.hybrid import HybridFormerOccupancyHead
from apollo_vision_net_tpu_torch.models.voxel import VoxelFormerOccupancyHead
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.parallel.optim import make_optimizer
from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner
from test_torch_occ import one_torch_thread  # noqa: F401

# torch on one thread (see test_torch_occ.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(bev_h=8, bev_w=8, embed_dims=32, num_cams=2, img_shape=(64, 96),
             encoder_layers=2, decoder_layers=2, feedforward_channels=64,
             num_query=12, queue_length=2, backbone_depth=18,
             transformer_dtype="float32", msda_impl="auto")
STREAM_TOL = 1e-3


def small(cfg, **sizes):
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        model=dataclasses.replace(cfg.model, **dict(SMALL, **sizes)),
        data=dataclasses.replace(cfg.data, max_gt_boxes=8))


def perturbed_params(params, seed, scale=0.05):
    """flax init plus noise, so that zero-initialized kernels (sampling
    offsets, attention weights, DCNv3 offsets and masks) take part; BN
    variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return x * np.exp(0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x + scale * rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, params)


def _frame_args(m, frame):
    Q = m.bev_h * m.bev_w
    return (frame["img"][None], frame["can_bus"][None], frame["lidar2img"][None],
            jnp.zeros((1, Q, m.embed_dims)), jnp.zeros((1,)))


def init_params(jcfg, frame, seed=0):
    jmodel = jax_build_model(jcfg)
    return jmodel, jax.jit(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame))(
        {"params": jax.random.PRNGKey(seed)},
        *_frame_args(jcfg.model, frame))["params"]


def stream_against_jax(jcfg, tcfg, params=None, tol=STREAM_TOL):
    """Three frames with a scene reset at frame 2 through JAX's
    ``forward_test_frame`` and the port's ``StreamingRunner`` on bridged
    weights (JAX's init plus noise unless ``params`` is given); every
    output within ``tol`` max abs. Returns the largest error per output."""
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    m = tcfg.model
    frames = make_stream(tcfg, 3, seed=3, scene_change_at=(2,))
    jmodel, init = init_params(jcfg, frames[0])
    if params is None:
        params = perturbed_params(init, seed=1)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)

    step = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=JaxBEVFormer.forward_test_frame))
    state = JaxState()
    prev = jnp.zeros((1, m.bev_h * m.bev_w, m.embed_dims), jnp.float32)
    runner = StreamingRunner(tcfg, tmodel)
    worst = {}
    for t, frame in enumerate(frames):
        cb, hp = state.prepare_frame(frame["can_bus"], frame["scene_token"])
        outs, prev = step(params, frame["img"][None], cb[None],
                          frame["lidar2img"][None], prev,
                          jnp.full((1,), hp, jnp.float32))
        state.update(prev)
        got = runner.step(frame)
        assert got["has_prev"] == hp == (0.0 if t in (0, 2) else 1.0)
        want = {"cls_scores": outs["all_cls_scores"][-1],
                "bbox_preds": outs["all_bbox_preds"][-1],
                "bev_embed": outs["bev_embed"]}
        if m.with_occupancy:
            want["occupancy_preds"] = outs["occupancy_preds"]
        assert set(got["outs"]) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got["outs"][k].numpy()
            assert g.shape == w.shape, (k, g.shape, w.shape)
            err = float(np.abs(g - w).max())
            worst[k] = max(worst.get(k, 0.0), err)
            assert err <= tol, (t, k, err)
    return worst


def test_small_bev_tiny_det_streaming_frames_match_jax():
    """bev_tiny_det at a small size: one FPN level over R18-Bottleneck
    stage 4, the det head without map or occupancy."""
    tcfg = small(port_configs.bev_tiny_det())
    m = tcfg.model
    assert (m.backbone_type, m.neck_type, m.num_feature_levels) == ("resnet", "fpn", 1)
    assert not (m.with_map or m.with_occupancy)
    stream_against_jax(small(jax_configs.bev_tiny_det()), tcfg)


def _jax_leaves(cfg):
    """JAX's param tree of ``cfg`` at full size as ShapeDtypeStructs
    (``jax.eval_shape``: traced, not computed)."""
    m = cfg.model
    H, W = m.img_shape
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        (1, m.num_cams, H, W, 3), (1, 18), (1, m.num_cams, 4, 4),
        (1, m.bev_h * m.bev_w, m.embed_dims), (1,))]
    return jax.eval_shape(functools.partial(
        jax_build_model(cfg).init, method=JaxBEVFormer.forward_test_frame),
        {"params": jax.random.PRNGKey(0)}, *args)["params"]


@pytest.mark.parametrize("name", ["semantic_kitti_occ", "bev_tiny_det_occ",
                                  "bev_base_occ_intern_s", "bev_tiny_det",
                                  "bev_smoke_det", "bev_tiny_occ",
                                  "bev_tiny_occ_intern_s"])
def test_full_size_models_have_the_jax_parameter_count(name):
    tcfg = getattr(port_configs, name)()
    params = _jax_leaves(getattr(jax_configs, name)())
    leaves = jax.tree.leaves(params)
    model = build_model(tcfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in leaves)
    # every leaf lands once, on a parameter of its shape
    state = state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), params))
    with torch.device("meta"):
        meta = detector.BEVFormer(detector.build_head(tcfg),
                                  *detector.build_trunk(tcfg))
    meta.load_state_dict(state, strict=True, assign=True)


def test_semantic_kitti_geometry_and_train_step():
    """semantic_kitti_occ's single camera, asymmetric pc_range (x from 0 to
    51.2 m) and 2x CNN upsampling (a 16x16 BEV to a 32x32x4 grid here, the
    full config's 128 -> 256) through ``train_step`` on the CPU: the CE
    loss is finite and the occupancy predictions cover every voxel."""
    cfg = port_configs.semantic_kitti_occ()
    m = cfg.model
    assert m.num_cams == 1 and m.pc_range[0] == 0.0 and m.occ_loss_type == "ce_loss"
    assert (m.occ_xdim // m.bev_w, m.occ_ydim // m.bev_h) == (2, 2)
    tcfg = dataclasses.replace(small(cfg, bev_h=16, bev_w=16, num_cams=1,
                                     occ_xdim=32, occ_ydim=32, occ_zdim=4,
                                     occ_dims=16),
                               pretrained_path="")
    torch.manual_seed(0)
    model = build_model(tcfg, device="cpu").train()
    optimizer = make_optimizer(model, tcfg.optim)
    batch = train_lib.batch_to_device(make_batch(tcfg, 1, seed=0), "cpu")
    gen = torch.Generator().manual_seed(0)
    losses = train_lib.train_step(model, optimizer, batch, gen, cfg=tcfg)
    assert "loss_occupancy" in losses
    assert all(np.isfinite(float(v)) for v in losses.values())
    with torch.no_grad():
        frame = make_stream(tcfg, 1, seed=2)[0]
        got = StreamingRunner(tcfg, model.eval()).step(frame)
    assert got["outs"]["occupancy_preds"].shape == (1, 4 * 32 * 32, 20)


@pytest.mark.parametrize("key, fields", [
    ("vovnet", {"backbone_type": "vovnet"}),
    ("head_family", {"head_family": "voxel"}),
    ("head_family", {"head_family": "hybrid"}),
])
def test_unported_trunks_and_head_families_are_refused(key, fields):
    """Every trunk and head family is ported now, so none is refused: the
    R50 det config with ``head_family`` voxel or hybrid builds that head,
    and with ``backbone_type="vovnet"`` the VoVNet V-99-eSE trunk with the
    FPN's input width its stage 3's 1024 channels (on the meta device: the
    shapes alone)."""
    cfg = port_configs.bev_tiny_det()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **fields))
    detector._check_supported(cfg)
    if key == "vovnet":
        from apollo_vision_net_tpu_torch.models.vovnet import VoVNet

        with torch.device("meta"):
            trunk, neck = detector.build_trunk(cfg)
        assert isinstance(trunk, VoVNet) and trunk.out_channels() == [1024]
        assert neck.lateral_0.in_channels == 1024
        assert neck.lateral_0.out_channels == cfg.model.embed_dims
        return
    heads = {"voxel": VoxelFormerOccupancyHead, "hybrid": HybridFormerOccupancyHead}
    with torch.device("meta"):
        head = detector.build_head(cfg)
    assert type(head) is heads[fields["head_family"]]
    assert head.prev_tokens > cfg.model.bev_h * cfg.model.bev_w


def test_ce_loss_at_twenty_classes_matches_jax():
    """semantic_kitti_occ's CE over 20 classes against JAX: the class
    weights are the 17 nuScenes ones, and labels 17-19 take the last (JAX's
    gather clamps the index)."""
    from apollo_vision_net_tpu.losses import occ_loss as jol
    from apollo_vision_net_tpu_torch.losses import occ_loss as tol

    rng = np.random.default_rng(4)
    logits = rng.standard_normal((600, 20)).astype(np.float32)
    labels = rng.integers(0, 21, 600).astype(np.int32)
    labels[:40] = 255
    valid = (labels != 255) & (labels < 20)
    w = tol.balanced_class_weights(20)
    assert w.shape == (17,) and (labels[valid] >= 17).any()
    want = jol.ce_ssc_loss(jnp.asarray(logits), jnp.asarray(labels),
                           jnp.asarray(valid), jnp.asarray(w))
    got = tol.ce_ssc_loss(torch.as_tensor(logits), torch.as_tensor(labels),
                          torch.as_tensor(valid), torch.as_tensor(w))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
