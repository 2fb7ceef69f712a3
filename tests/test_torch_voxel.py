"""The port's VoxelFormer family against the JAX package.

- ``ops.msda3d.ms_deform_attn_3d`` against JAX's on samples inside, on the
  faces of and outside the volumes (two levels): values within 1e-5 and
  the gradients of value, locations and weights within 1e-5 of the largest
  of ``jax.vjp``'s (f32 sums in other orders). No sample sits on a cell
  centre, where the location gradient jumps and either side is right.
- ``VoxelTemporalSelfAttention`` and one ``VoxelFormerLayer`` against flax
  on bridged weights and random inputs: 1e-4.
- ``smoke_voxel_occ`` as configured (R50 + FPN, a 2x6x6 voxel grid, 2
  cams at 64x96, f32) streamed 3 frames with a scene reset at frame 2
  through the port's ``StreamingRunner`` against a loop over JAX's
  ``forward_test_frame`` carrying the voxel features: every output, the
  carry included, within 1e-3.
- Its train step (grid mask off, dropout at rate 0 against JAX's
  ``deterministic=True``; one Group-DETR group), in one JAX compile: loss
  terms within 1e-4 relative and the Hungarian indices equal to JAX's
  solver's at the images and six witness images 1e-7 away, and every
  gradient within 1e-4 of its largest element at one image at least and
  within 5e-2 at all (tests/test_torch_occ_options.py's protocol: JAX's
  own gradients jump between the images at the trunk's ReLU kinks).
- The bf16 ``voxel_tiny_occ`` at a small size: the head computes in f32
  (JAX builds it without a dtype), its outputs within 1e-4 of JAX's bf16
  config's head on the same image features.
- ``smoke_voxel_occ``'s head initializes as flax does: every parameter
  that flax sets to a constant equal, and every other one of 512 elements
  or more with the standard deviation within 15%, the largest magnitude
  over the standard deviation within 15% (a truncated normal's 2.27
  against a uniform's 1.73) and the mean within 0.2 standard deviations of
  flax's draw (``init_statistics_match_jax``).
- ``voxel_tiny_occ``, ``voxel_base_occ`` and ``smoke_voxel_occ`` build at
  full size with JAX's parameter count (``jax.eval_shape``), and the flax
  tree loads into each with ``strict=True``.
- The overfit tool trains ``smoke_voxel_occ`` on the CPU: two steps, finite
  terms, the metrics of its batch.
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
from apollo_vision_net_tpu.losses import det_loss as jdet
from apollo_vision_net_tpu.losses import multitask as jmt
from apollo_vision_net_tpu.models import voxel as jvox
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer
from apollo_vision_net_tpu.ops.msda3d import ms_deform_attn_3d as jax_msda3d
from apollo_vision_net_tpu.parallel.train import build_head as jax_build_head
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch import configs as port_configs
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.data.synthetic import (
    camera_ring_lidar2img,
    make_batch,
    make_stream,
)
from apollo_vision_net_tpu_torch.models import detector
from apollo_vision_net_tpu_torch.models import voxel as tvox
from apollo_vision_net_tpu_torch.models.detector import build_head, build_model
from apollo_vision_net_tpu_torch.ops.msda3d import ms_deform_attn_3d
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner
from apollo_vision_net_tpu_torch.tools.overfit_check import (
    evaluate_overfit,
    overfit,
    overfit_config,
)
from test_torch_occ import _jax_det_indices, one_torch_thread, perturbed_params  # noqa: F401
from test_torch_occ_options import (
    AGREEING,
    KINK_GRAD_REL_TOL,
    WITNESS_EPS,
    WITNESS_SEEDS,
    _grad_err,
)

MSDA3D_TOL = 1e-5
MODULE_TOL = 1e-4
STREAM_TOL = 1e-3
STEP_LOSS_REL_TOL = 1e-4
GRAD_REL_TOL = 1e-4
# init statistics against flax's draw (init_statistics_match_jax): the
# port's draws come within 9.3% and 0.09 std at seed 0; xavier-uniform
# kernels where flax's default lecun-normal applies differ by 26%
INIT_STAT_TOL = 0.15
INIT_MEAN_TOL = 0.2
# the train step's painted batch (check_train_runs). Of batch seeds 0-30,
# seed 20 alone leaves JAX's own gradients agreeing among all 7 images
# within GRAD_REL_TOL (within 4.6e-6, with XLA on all threads as on one);
# at the others they jump by up to 0.13 between images 1e-7 apart
BATCH_SEED = 20

# torch on one thread (see test_torch_occ.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err)
    return err


def no_grid_mask(cfg):
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_grid_mask=False))


def jax_params(jcfg, frame, seed=0):
    """JAX's model of ``jcfg`` and its params (init at PRNGKey(seed) through
    ``forward_test_frame`` with a zero carry of the head's token count, plus
    noise so that zero-initialized kernels take part)."""
    jmodel = jax_build_model(jcfg)
    m = jcfg.model
    args = (frame["img"][None], frame["can_bus"][None], frame["lidar2img"][None],
            jnp.zeros((1, jmodel.prev_tokens, m.embed_dims)), jnp.zeros((1,)))
    params = jax.jit(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame))(
        {"params": jax.random.PRNGKey(seed)}, *args)["params"]
    return jmodel, perturbed_params(params, seed=1)


def stream_against_jax(jcfg, tcfg):
    """3 frames with a scene reset at frame 2: the port's runner against a
    loop over JAX's ``forward_test_frame`` that carries ``bev_embed`` (the
    JAX package's own runner allocates bev_h·bev_w tokens, which a voxel or
    hybrid head does not carry). Every output within STREAM_TOL; returns the
    largest error per output."""
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    frames = make_stream(tcfg, 3, seed=3, scene_change_at=(2,))
    jmodel, params = jax_params(jcfg, frames[0])
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    assert model.prev_tokens == jmodel.prev_tokens
    step = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=JaxBEVFormer.forward_test_frame))
    state = JaxState()
    prev = jnp.zeros((1, jmodel.prev_tokens, tcfg.model.embed_dims), jnp.float32)
    runner = StreamingRunner(tcfg, model)
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
                "occupancy_preds": outs["occupancy_preds"],
                "bev_embed": outs["bev_embed"]}
        assert set(got["outs"]) == set(want)
        for k, w in want.items():
            err = _close(got["outs"][k].numpy(), w, STREAM_TOL, (t, k))
            worst[k] = max(worst.get(k, 0.0), err)
    return worst


def train_runs(jcfg, tcfg, seed):
    """One train step of both sides on a painted batch of 2 (seed ``seed``)
    at the same weights, at the images and at each witness image (images *
    (1 + WITNESS_EPS * noise), noise seeds WITNESS_SEEDS), each side at the
    same image, in one JAX compile; the port on JAX's assignment. Per image:
    both sides' loss terms, the port's own indices and JAX's, and both
    sides' gradients (JAX's as a state_dict)."""
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    batch = make_batch(tcfg, 2, seed=seed, paint_gt=True)
    jmodel, params = jax_params(jcfg, {k: batch[k][0, -1] for k in (
        "img", "can_bus", "lidar2img")})
    m = tcfg.model
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])

    def jloss(p, img):
        outs = jmodel.apply({"params": p}, img, batch["can_bus"],
                            batch["lidar2img"], batch["has_prev"],
                            deterministic=True)
        losses = jmt.det_occ_loss(
            outs, jdet.DetGT(*gt), batch["gt_occupancy"],
            occupancy_classes=m.occupancy_classes, group_detr=m.group_detr,
            num_classes=m.num_classes, occ_loss_type=m.occ_loss_type,
            occ_grid_hw=(m.occ_ydim, m.occ_xdim), occ_zdim=m.occ_zdim)
        return losses["loss_total"], (losses, outs)

    step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.train()
    for mod in model.modules():
        if hasattr(mod, "rate"):
            mod.rate = 0.0
    images = [batch["img"]] + [
        (batch["img"] * (1 + WITNESS_EPS * np.random.default_rng(s).standard_normal(
            batch["img"].shape))).astype(np.float32) for s in WITNESS_SEEDS]
    runs = []
    for img in images:
        (_, (jlosses, jouts)), jgrads = step(params, img)
        tbatch = train_lib.batch_to_device(dict(batch, img=img), "cpu")
        with torch.no_grad():
            outs = model(tbatch["img"], tbatch["can_bus"], tbatch["lidar2img"],
                         tbatch["has_prev"])
            indices = train_lib.match(outs, *train_lib.ground_truth(tbatch), tcfg)
        jindices = _jax_det_indices(np.asarray(jouts["all_cls_scores"]),
                                    np.asarray(jouts["all_bbox_preds"]), gt,
                                    m.group_detr)
        model.zero_grad(set_to_none=True)
        total, losses, _ = train_lib.loss_fn(
            model, tbatch, tcfg, indices=(np.array(sorted(jindices), np.int64), None))
        total.backward()
        runs.append(dict(
            indices=indices, jindices=jindices,
            jlosses={k: float(v) for k, v in jlosses.items()},
            losses={k: float(v.detach()) for k, v in losses.items()},
            jgrads=state_dict_from_flax(jax.tree.map(np.asarray, jgrads)),
            grads={k: p.grad for k, p in model.named_parameters()}))
    return dict(cfg=tcfg, batch=batch, runs=runs)


def check_train_runs(s):
    """At every image: each loss term within STEP_LOSS_REL_TOL relative and
    the indices equal to JAX's solver's. The port's gradients are within
    KINK_GRAD_REL_TOL of JAX's at every image and within GRAD_REL_TOL at
    AGREEING of them (see tests/test_torch_occ_options.py's WITNESS_EPS):
    the R50 trunk at 64x96 holds ReLU inputs so near zero that JAX's own
    gradients jump by up to 0.13 between the images at most batch seeds
    (smoke_voxel_occ), in the trunk's BN and conv parameters. Returns the
    port's error at each image."""
    m = s["cfg"].model
    n_gt = int(s["batch"]["gt_mask"].sum())
    for run in s["runs"]:
        assert set(run["losses"]) == set(run["jlosses"])
        assert "loss_occupancy" in run["losses"]
        for k, w in run["jlosses"].items():
            assert abs(run["losses"][k] - w) <= STEP_LOSS_REL_TOL * max(abs(w), 1e-6), k
        det, _ = run["indices"]
        assert {tuple(int(x) for x in r) for r in det} == run["jindices"]
        assert len(det) == m.decoder_layers * n_gt
    errs = [_grad_err(run["jgrads"], run["grads"], set()) for run in s["runs"]]
    assert max(errs) <= KINK_GRAD_REL_TOL, errs
    assert sum(e <= GRAD_REL_TOL for e in errs) >= AGREEING, errs
    return errs


def init_statistics_match_jax(name):
    """The port's init of the config's head (``build_model``) against
    flax's (the head's ``init`` on zero inputs), parameter by parameter
    through the bridge: constants equal, and the standard deviation, the
    largest magnitude over it and the mean of every tensor of 512 elements
    or more within INIT_STAT_TOL (see the module docstring)."""
    jcfg, tcfg = getattr(jax_configs, name)(), getattr(port_configs, name)()
    m = tcfg.model
    head = build_model(tcfg, device="cpu").head
    feats = [np.zeros((1, m.num_cams, 4, 6, m.embed_dims), np.float32)]
    kwargs = dict(
        can_bus=np.zeros((1, 18), np.float32),
        lidar2img=camera_ring_lidar2img(m.num_cams, *m.img_shape)[None],
        prev_bev=np.zeros((1, head.prev_tokens, m.embed_dims), np.float32),
        has_prev=np.zeros((1,), np.float32))
    jhead = jax_build_head(jcfg)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jax.jit(
        lambda r: jhead.init(r, feats, **kwargs))(jax.random.PRNGKey(0))["params"]))
    got = head.state_dict()
    assert set(got) == set(want)
    checked = 0
    for k, w in want.items():
        w, g = w.double(), got[k].double()
        if bool((w == w.flatten()[0]).all()):
            assert torch.equal(g, w), k
        elif w.numel() >= 512:
            ws, gs = float(w.std()), float(g.std())
            assert abs(gs / ws - 1) <= INIT_STAT_TOL, (k, gs, ws)
            shape_w, shape_g = float(w.abs().max()) / ws, float(g.abs().max()) / gs
            assert abs(shape_g / shape_w - 1) <= INIT_STAT_TOL, (k, shape_g, shape_w)
            assert abs(float(g.mean() - w.mean())) <= INIT_MEAN_TOL * ws, k
            checked += 1
    return checked


def full_size_parameters(name):
    """The config built at full size on the CPU has JAX's parameter count
    (``jax.eval_shape``: traced, not computed), and every flax leaf lands
    once on a parameter of its shape (``strict=True``)."""
    jcfg, tcfg = getattr(jax_configs, name)(), getattr(port_configs, name)()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jmodel = jax_build_model(jcfg)
    m = jcfg.model
    H, W = m.img_shape
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        (1, m.num_cams, H, W, 3), (1, 18), (1, m.num_cams, 4, 4),
        (1, jmodel.prev_tokens, m.embed_dims), (1,))]
    params = jax.eval_shape(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame),
        {"params": jax.random.PRNGKey(0)}, *args)["params"]
    state = state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), params))
    with torch.device("meta"):
        meta = detector.BEVFormer(detector.build_head(tcfg),
                                  *detector.build_trunk(tcfg))
    assert sum(p.numel() for p in meta.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(params))
    meta.load_state_dict(state, strict=True, assign=True)
    return meta


# ------------------------------------------------------------------ msda3d

def test_msda3d_values_and_gradients_match_jax():
    rng = np.random.default_rng(0)
    shapes = ((3, 5, 7), (2, 3, 4))
    B, H, D, Q, P = 2, 2, 4, 13, 3
    V = sum(d * h * w for d, h, w in shapes)
    value = rng.standard_normal((B, V, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, 2, P, 3)).astype(np.float32)
    loc[0, 0] = 0.0                      # on the low faces
    loc[0, 1] = 1.0                      # on the high faces
    loc[1, 1] = -0.5                     # outside every corner
    attn = rng.uniform(0.0, 1.0, (B, Q, H, 2, P)).astype(np.float32)
    inside = ((loc >= 0) & (loc <= 1)).all(-1)
    assert 0.2 < inside.mean() < 0.9 and (~inside).any()
    want, vjp = jax.vjp(lambda v, l, a: jax_msda3d(v, shapes, l, a),
                        jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    g = rng.standard_normal(want.shape).astype(np.float32)
    jg = vjp(jnp.asarray(g))
    tv, tl, ta = (torch.tensor(a, requires_grad=True) for a in (value, loc, attn))
    got = ms_deform_attn_3d(tv, shapes, tl, ta)
    got.backward(torch.from_numpy(g))
    _close(got.detach().numpy(), want, MSDA3D_TOL, "msda3d")
    assert float(np.abs(np.asarray(want)[1, 1]).max()) == 0.0  # sampled outside
    for what, t, j in (("value", tv, jg[0]), ("loc", tl, jg[1]), ("attn", ta, jg[2])):
        _close(t.grad.numpy(), j, MSDA3D_TOL * max(1.0, float(np.abs(j).max())),
               "d " + what)
        assert float(np.abs(np.asarray(j)).max()) > 0.1, what


# ------------------------------------------------------------------ modules

def test_voxel_temporal_self_attention_matches_flax():
    rng = np.random.default_rng(1)
    B, C, shape = 2, 32, (2, 5, 6)
    Q = int(np.prod(shape))
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    value = rng.standard_normal((B, 2, Q, C)).astype(np.float32)
    pos = rng.standard_normal((B, Q, C)).astype(np.float32)
    refs = rng.uniform(0.0, 1.0, (B, 2, Q, 1, 3)).astype(np.float32)
    jmod = jvox.VoxelTemporalSelfAttention(embed_dims=C)
    params = jax.jit(lambda r: jmod.init(
        r, query, value, query_pos=pos, reference_points=refs,
        spatial_shape=shape))(jax.random.PRNGKey(2))["params"]
    params = perturbed_params(params, seed=3)
    want = jmod.apply({"params": params}, query, value, query_pos=pos,
                      reference_points=refs, spatial_shape=shape)
    tmod = tvox.VoxelTemporalSelfAttention(C).eval()
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(query), torch.from_numpy(value),
                   query_pos=torch.from_numpy(pos),
                   reference_points=torch.from_numpy(refs), spatial_shape=shape)
    _close(got.numpy(), want, MODULE_TOL, "voxel TSA")
    assert float(np.abs(np.asarray(want) - query).max()) > 0.1


def test_voxel_former_layer_matches_flax():
    """TSA -> LN -> SCA (2 cams, one projected point a voxel, some voxels
    seen by no camera) -> LN -> FFN -> LN."""
    rng = np.random.default_rng(4)
    B, C, N, shape, img = 2, 32, 2, (2, 4, 5), ((6, 8),)
    Q = int(np.prod(shape))
    q = rng.standard_normal((B, Q, C)).astype(np.float32)
    img_value = rng.standard_normal((B, N, 48, C)).astype(np.float32)
    pos = rng.standard_normal((B, Q, C)).astype(np.float32)
    tsa_value = rng.standard_normal((B, 2, Q, C)).astype(np.float32)
    refs = rng.uniform(0.0, 1.0, (B, 2, Q, 1, 3)).astype(np.float32)
    ref_cam = rng.uniform(-0.1, 1.1, (N, B, Q, 1, 2)).astype(np.float32)
    mask = ((ref_cam > 0) & (ref_cam < 1)).all(-1)
    assert 0.3 < mask.mean() < 0.95
    kw = dict(query_pos=pos, tsa_value=tsa_value, tsa_refs=refs,
              spatial_shape=shape, img_spatial_shapes=img,
              reference_points_cam=ref_cam, bev_mask=mask)
    jmod = jvox.VoxelFormerLayer(embed_dims=C, num_cams=N, feedforward_channels=64)
    params = jax.jit(lambda r: jmod.init(r, q, img_value, **kw))(
        jax.random.PRNGKey(5))["params"]
    params = perturbed_params(params, seed=6)
    want = jmod.apply({"params": params}, q, img_value, **kw)
    tmod = tvox.VoxelFormerLayer(C, num_cams=N, feedforward_channels=64).eval()
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(q), torch.from_numpy(img_value),
                   **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                      for k, v in kw.items()})
    _close(got.numpy(), want, MODULE_TOL, "VoxelFormerLayer")


def test_voxel_reference_points_and_positional_encoding_equal_jax():
    for args in ((2, 3, 4, 1), (3, 2, 5, 4)):
        np.testing.assert_array_equal(tvox.voxel_reference_points_3d(*args),
                                      jvox.voxel_reference_points_3d(*args))
    jmod = jvox.VoxelLearnedPositionalEncoding(num_feats=(12, 10, 10), z_num=2,
                                               row_num=3, col_num=4)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(7))["params"]
    tmod = tvox.VoxelLearnedPositionalEncoding((12, 10, 10), 2, 3, 4)
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    assert tvox.VoxelLearnedPositionalEncoding.feats(32) == (12, 10, 10)
    with torch.no_grad():
        np.testing.assert_array_equal(tmod().numpy(), np.asarray(jmod.apply(
            {"params": params})))


# ------------------------------------------------------- smoke_voxel_occ

def test_smoke_voxel_streaming_frames_match_jax():
    jcfg, tcfg = jax_configs.smoke_voxel_occ(), port_configs.smoke_voxel_occ()
    m = tcfg.model
    assert (m.head_family, m.bev_z, m.backbone_type) == ("voxel", 2, "resnet")
    worst = stream_against_jax(jcfg, tcfg)
    assert set(worst) == {"cls_scores", "bbox_preds", "occupancy_preds", "bev_embed"}


@pytest.fixture(scope="module")
def voxel_step():
    return train_runs(no_grid_mask(jax_configs.smoke_voxel_occ()),
                      no_grid_mask(port_configs.smoke_voxel_occ()),
                      seed=BATCH_SEED)


def test_smoke_voxel_train_step_matches_jax(voxel_step):
    check_train_runs(voxel_step)
    got = voxel_step["runs"][0]["grads"]
    for k in ("head.encoder_layer0.tsa.sampling_offsets.weight",
              "head.voxel_pos.z_embed", "head.voxel2bev.weight",
              "head.occ_proj.weight", "img_backbone.layer4_0.conv2.weight"):
        assert float(got[k].abs().max()) > 0, k


# -------------------------------------------------------------- bf16 head

def test_bf16_voxel_head_computes_in_f32_as_jax():
    """voxel_tiny_occ as configured (bf16) at a small size: the head's
    modules compute in f32 whatever the config's dtype, as the JAX
    package's do; on the same f32 image features its outputs match JAX's
    bf16 config's head within 1e-4 (a bf16 head rounds its activations at
    2^-8)."""
    kw = dict(bev_h=5, bev_w=6, bev_z=2, embed_dims=32, num_cams=2,
              img_shape=(64, 96), encoder_layers=1, decoder_layers=2,
              feedforward_channels=64, num_query=12, occ_xdim=12, occ_ydim=10,
              occ_zdim=4, occ_dims=16)
    jcfg = dataclasses.replace(jax_configs.voxel_tiny_occ(), model=dataclasses.replace(
        jax_configs.voxel_tiny_occ().model, **kw))
    port_cfg = dataclasses.replace(port_configs.voxel_tiny_occ(), model=dataclasses.replace(
        port_configs.voxel_tiny_occ().model, **kw))
    assert port_cfg.compute_dtype == "bfloat16" and port_cfg.model.transformer_dtype is None
    rng = np.random.default_rng(8)
    m = port_cfg.model
    B, Q = 2, m.bev_z * m.bev_h * m.bev_w
    feats = [rng.standard_normal((B, m.num_cams, 4, 6, m.embed_dims)).astype(np.float32)]
    l2i = np.broadcast_to(camera_ring_lidar2img(m.num_cams, *m.img_shape),
                          (B, m.num_cams, 4, 4)).copy()
    can_bus = rng.standard_normal((B, 18)).astype(np.float32)
    prev = rng.standard_normal((B, Q, m.embed_dims)).astype(np.float32)
    has_prev = np.array([1.0, 0.0], np.float32)
    jhead = jax_build_head(jcfg)
    args = (feats,)
    kwargs = dict(can_bus=can_bus, lidar2img=l2i, prev_bev=prev, has_prev=has_prev)
    params = jax.jit(lambda r: jhead.init(r, *args, **kwargs))(
        jax.random.PRNGKey(9))["params"]
    params = perturbed_params(params, seed=10)
    want = jax.jit(lambda p: jhead.apply({"params": p}, *args, **kwargs))(params)
    head = build_head(port_cfg).eval()
    head.load_state_dict(state_dict_from_flax(params), strict=True)
    assert all(p.dtype == torch.float32 for p in head.parameters())
    with torch.no_grad():
        got = head([torch.from_numpy(f) for f in feats],
                   **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    for k in ("all_cls_scores", "all_bbox_preds", "occupancy_preds", "bev_embed"):
        assert got[k].dtype == torch.float32, k
        _close(got[k].numpy(), want[k], MODULE_TOL, k)


# ------------------------------------------------------------------- init

def test_voxel_head_initializes_as_flax():
    assert init_statistics_match_jax("smoke_voxel_occ") >= 20


# ------------------------------------------------------------- full size

@pytest.mark.parametrize("name", ["voxel_tiny_occ", "voxel_base_occ",
                                  "smoke_voxel_occ"])
def test_full_size_voxel_models_have_the_jax_parameter_count(name):
    meta = full_size_parameters(name)
    m = getattr(port_configs, name)().model
    assert isinstance(meta.head, tvox.VoxelFormerOccupancyHead)
    assert meta.prev_tokens == m.bev_z * m.bev_h * m.bev_w


def test_overfit_tool_trains_smoke_voxel_on_the_cpu():
    cfg = overfit_config(port_configs.smoke_voxel_occ(), steps=2)
    model, batch, curve = overfit(cfg, steps=2, batch_size=2, device="cpu")
    assert len(curve) == 2 and all(np.isfinite(v) for r in curve for v in r.values())
    metrics = evaluate_overfit(cfg, model, batch)
    assert {"mean_ap", "occ_iou", "occ_miou"} <= set(metrics)


# ------------------------------------------------------ batch-seed scan

def scan_batch_seeds(name, seeds):
    """The scan that chose BATCH_SEED here and in tests/test_torch_hybrid.py:
    for each painted batch seed, the train step of both sides at the 7
    images (``train_runs``); prints JAX's largest gradient difference
    against itself between the images, how many of the 6 witness images
    agree with the first within GRAD_REL_TOL, and the port's error against
    JAX at each image. Run from the repository root, with the torch and
    XLA thread counts to try:
    ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_voxel.py
    smoke_voxel_occ 0 30 [THREADS]``."""
    for seed in seeds:
        s = train_runs(no_grid_mask(getattr(jax_configs, name)()),
                       no_grid_mask(getattr(port_configs, name)()), seed=seed)
        first = s["runs"][0]["jgrads"]
        jax_self = [_grad_err(first, run["jgrads"], set()) for run in s["runs"][1:]]
        port = [_grad_err(run["jgrads"], run["grads"], set()) for run in s["runs"]]
        print(name, "seed", seed, "jax_self_max", f"{max(jax_self):.3g}",
              "agree", sum(e <= GRAD_REL_TOL for e in jax_self),
              "port", [f"{e:.2g}" for e in port], flush=True)


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 4:
        torch.set_num_threads(int(sys.argv[4]))
    scan_batch_seeds(sys.argv[1], range(int(sys.argv[2]), int(sys.argv[3]) + 1))
