"""Base-scale training of the PyTorch port against the JAX package.

- The plain factored MSDA's gradients (autograd through
  ``materialize_factored`` + ``ms_deform_attn_ref``, with a tile mask and a
  tail tile) against ``jax.vjp`` of ``_materialize_factored`` ->
  ``ms_deform_attn_xla``, the function whose VJP is the JAX package's
  ``_factored_bwd``. JAX's XLA path ignores the mask (its callers mask the
  outputs), so its cotangent is the port's with the masked queries zeroed.
  1e-5 of each gradient's largest magnitude: f32, sums in other orders.
- The plain DCN's gradients against ``jax.vjp`` of ``_dcn_xla_ref``, the
  function whose VJP is the JAX package's ``_dense_bwd``. JAX takes the
  sampling locations normalized to the input grid, loc = (pos + 0.5) /
  (W, H), the port pixel offsets, so d offset = d loc / (W, H); the mask is
  JAX's attention weight. 1e-5 as above.
- The port's R101 (DCN in stages 3-4) parameter labels against JAX
  ``_is_frozen`` on the flax tree at depth 101 (``jax.eval_shape``).
- ``bev_base_occ``'s config copy equal to the original; at full size its
  MLP occupancy head passes ``_check_supported`` and the bridged flax tree
  (shapes from ``jax.eval_shape``) loads with ``strict=True``.
- A small copy of ``bev_base_det_map`` (``SMALL_BASE`` of
  tests/test_torch_slice.py: a depth-18 Bottleneck ResNet, DCN in stages
  3-4, a 4-level FPN and 4-level SCA on factored operands; 8x8 BEV, 2 cams
  at 64x96, queue 2, f32) takes one train step against
  ``jax.value_and_grad``, as tests/test_torch_train.py does for the
  flagship: loss terms within 1e-4 relative, match indices equal, every
  gradient within 1e-4 of its largest JAX magnitude (plus 1e-7 of the
  model's largest). The JAX DCN projects first and samples after, the port
  samples first; the two orders differ in f32 rounding only. The DCN
  offset convs (zero at init) are damped to 0.01 of their perturbed
  weights (``damp_dcn_offsets``), as a choice of realistic offsets:
  perturbed in full they predict offsets of 40-110 px on maps of 4x6 to
  8x12 pixels, so that 0-18.5% of the samples land inside the image, and
  there the JAX package's positions, formed as ((pos + 0.5) / W) * W -
  0.5, sit up to an ulp of 64-128 px (7.6e-6 px) off the port's. Damped,
  the offsets reach 0.4-2.9 px, 51-95% of the samples land inside, and
  every gradient agrees within 4.1e-6. The same step undamped is held too,
  its gradients at UNDAMPED_GRAD_REL_TOL: the trunk's gradients below the
  first DCN block differ there by up to 3.4e-4 (both JAX DCN orders
  alike).
- A small copy of ``bev_base_occ`` (the same trunk, an 8x8x4 grid of
  16-wide voxels from the MLP head): three streamed frames with one scene
  reset against JAX ``forward_test_frame`` within 1e-3, and one train step
  with dropout the identity on both sides and the grid mask off (as
  tests/test_torch_occ.py), at the images and at eight witness images a
  relative 1e-7 away, each side at the same image: loss terms and
  assignment as above at every image; the gradients within 1e-4 at two of
  the nine and within 5e-2 at all, since ReLU kinks in the trunk move
  JAX's own gradients by up to 2.84% between these images (see
  WITNESS_EPS).
- On the kernel branch (forced on the CPU, the kernel entries replaced by
  the plain versions and their autograd) the factored MSDA and DCN front
  ends route their backwards to ``msda_bwd_factored`` (asking for d ref
  only when autograd does) and ``dcn_bwd``; the ctypes signatures of the
  new C entries match their C parameters.
"""
import ctypes
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_abi import c_entries
from test_torch_occ import _identity_dropout, _jax_det_indices, one_torch_thread  # noqa: F401
from test_torch_train import SIZES, _jax_gt, _jax_indices, perturbed_params

from apollo_vision_net_tpu.configs import bev_base_det_map as jax_base
from apollo_vision_net_tpu.configs import bev_base_occ as jax_base_occ
from apollo_vision_net_tpu.data.temporal import StreamingState as JaxState
from apollo_vision_net_tpu.losses import det_loss as jdet
from apollo_vision_net_tpu.losses import map_loss as jmap
from apollo_vision_net_tpu.losses import multitask as jmt
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer
from apollo_vision_net_tpu.models.resnet import ResNet as JaxResNet
from apollo_vision_net_tpu.ops.dcn_pallas import _dcn_xla_ref
from apollo_vision_net_tpu.ops.dcnv3 import _kernel_grid
from apollo_vision_net_tpu.ops.msda import ms_deform_attn_xla
from apollo_vision_net_tpu.ops.msda_pallas import _materialize_factored
from apollo_vision_net_tpu.parallel import optim as jopt
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.configs import bev_base_det_map, bev_base_occ
from apollo_vision_net_tpu_torch.data.synthetic import make_batch, make_stream
from apollo_vision_net_tpu_torch.models import detector
from apollo_vision_net_tpu_torch.models.resnet import ResNet
from apollo_vision_net_tpu_torch.ops import dcn as dcn_mod
from apollo_vision_net_tpu_torch.ops import dcn_cuda, msda_cuda
from apollo_vision_net_tpu_torch.ops import msda as msda_mod
from apollo_vision_net_tpu_torch.ops.dcn import modulated_deform_conv_ref
from apollo_vision_net_tpu_torch.ops.msda import (
    materialize_factored,
    ms_deform_attn_ref,
)
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.parallel.optim import param_label
from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner

KERNEL_GRAD_TOL = 1e-5
LOSS_REL_TOL = 1e-4
GRAD_REL_TOL = 1e-4
STREAM_TOL = 1e-3
# The undamped small base step (see the module docstring): the trunk's
# gradients below the first DCN block differ from JAX's by up to 3.4e-4 of
# their largest magnitude, from the JAX package's normalized sampling
# positions; the limit is about 1.5x that reading.
UNDAMPED_GRAD_REL_TOL = 5e-4
# The small bev_base_occ step runs at the images and at eight witness
# images, images * (1 + WITNESS_EPS * noise) with noise from seeds 0-7, each
# side at the same image. Its trunk holds ReLU inputs so near zero that the
# two frameworks' summation orders put some on different sides: JAX against
# itself at the witness images moves the trunk's gradients by up to 2.84%
# of their largest magnitude. The port's gradients (torch on one thread,
# as the module runs) agree with JAX's at the same image within 7.7e-6 at
# the images of seeds 0, 3 and 5 and differ by 0.62-2.84% at the other six
# (the images included), always in trunk tensors below such a ReLU (on
# eight threads: within 1.4e-5 at seeds 0 and 5). So every image is held
# within KINK_GRAD_REL_TOL (about 1.8x the largest reading) and
# OCC_AGREEING of the nine within GRAD_REL_TOL.
WITNESS_EPS = 1e-7
WITNESS_SEEDS = range(8)
KINK_GRAD_REL_TOL = 5e-2
OCC_AGREEING = 2
pytestmark = pytest.mark.usefixtures("one_torch_thread")
# the base trunk at the size of the ResNet test: two Bottlenecks a stage
SMALL_BASE = dict(SIZES, backbone_depth=18)
# the same trunk with bev_base_occ's MLP head on the 8x8 BEV (4 z-cells of
# 16-wide voxels); 12 det queries, no map head
SMALL_BASE_OCC = dict(
    bev_h=8, bev_w=8, embed_dims=32, num_cams=2, img_shape=(64, 96),
    encoder_layers=2, decoder_layers=2, feedforward_channels=64,
    num_query=12, queue_length=2, backbone_depth=18, occ_xdim=8, occ_ydim=8,
    occ_zdim=4, occ_dims=16, transformer_dtype="float32", msda_impl="auto")


def damp_dcn_offsets(params):
    """The DCN offset convs' kernels at 0.01 of their perturbed values, so
    that the offsets are a few pixels (see the module docstring)."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: x * 0.01 if "conv2_offset" in jax.tree_util.keystr(path)
        and jax.tree_util.keystr(path).endswith("['kernel']") else x, params)


def small(cfg, sizes, **kw):
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        model=dataclasses.replace(cfg.model, **dict(sizes, **kw)),
        data=dataclasses.replace(cfg.data, max_gt_boxes=8))


def _rel_close(name, got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert scale > 0 and err <= tol * scale, (name, err, scale)


# ------------------------------------------------------- kernel functions

@pytest.mark.parametrize("q_tile", [32, 16])
def test_plain_factored_gradients_match_jax_vjp(q_tile):
    """Q = 70 leaves a tail tile at both tile sizes; a random mask over
    (camera, tile) with 2 samples of 3 cameras."""
    rng = np.random.default_rng(20 + q_tile)
    Bs, N, H, D, Q, P = 2, 3, 2, 8, 70, 4
    shapes = ((6, 9), (3, 5))
    B, L, V = Bs * N, len(shapes), sum(h * w for h, w in shapes)
    value = rng.standard_normal((B, V, H, D)).astype(np.float32)
    ref = rng.uniform(-0.1, 1.1, (B, Q, P * 2)).astype(np.float32)
    off = rng.uniform(-3.0, 3.0, (Bs, Q, H * L * P * 2)).astype(np.float32)
    attn = rng.random((Bs, Q, H, L * P)).astype(np.float32)
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(Bs, Q, H * L * P)
    n_tiles = (Q + q_tile - 1) // q_tile
    tile_mask = (rng.random((B, n_tiles)) > 0.4).astype(np.int32)
    tile_mask[0, -1] = 1  # the tail tile takes part somewhere
    g = rng.standard_normal((B, Q, H * D)).astype(np.float32)
    keep = np.repeat(tile_mask, q_tile, axis=1)[:, :Q].astype(np.float32)

    def f(v, r, o, a):
        loc, at = _materialize_factored(r, o, a, shapes, H, P)
        return ms_deform_attn_xla(v, shapes, loc.reshape(B, Q, H, L, P, 2),
                                  at.reshape(B, Q, H, L, P))

    _, vjp = jax.vjp(f, value, ref, off, attn)
    want = vjp(g * keep[..., None])

    ins = [torch.from_numpy(a).requires_grad_() for a in (value, ref, off, attn)]
    loc, at = materialize_factored(ins[1], ins[2], ins[3], shapes, H, P)
    out = ms_deform_attn_ref(ins[0], shapes, loc.reshape(B, Q, H, L, P, 2),
                             at.reshape(B, Q, H, L, P),
                             tile_mask=torch.from_numpy(tile_mask), q_tile=q_tile)
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, a, w in zip(("value", "ref", "off", "attn"), got, want):
        _rel_close(name, a.numpy(), w, KERNEL_GRAD_TOL)
    # a masked (camera, tile) gets no reference-point gradient
    cam, tile = np.argwhere(tile_mask == 0)[0]
    rows = slice(tile * q_tile, min(Q, (tile + 1) * q_tile))
    assert float(got[1][cam, rows].abs().max()) == 0.0


def _dcn_case(seed, stride, off_std, H, W, B=2, C=8, O=6):
    rng = np.random.default_rng(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    offset = rng.normal(0, off_std, (B, Ho, Wo, 9, 2)).astype(np.float32)
    mask = rng.random((B, Ho, Wo, 9)).astype(np.float32)
    weight = rng.standard_normal((9, C, O)).astype(np.float32)
    g = rng.standard_normal((B, Ho, Wo, O)).astype(np.float32)
    return x, offset, mask, weight, g


@pytest.mark.parametrize("stride,off_std,H,W", [(1, 1.0, 9, 11), (2, 1.0, 10, 12),
                                                (2, 6.0, 9, 13)])
def test_plain_dcn_gradients_match_jax_vjp(stride, off_std, H, W):
    """Stride 1 and 2, odd sizes, far offsets (samples outside the image)."""
    x, offset, mask, weight, g = _dcn_case(30 + stride, stride, off_std, H, W)
    B, Ho, Wo = offset.shape[:3]
    Q = Ho * Wo
    py, px = np.meshgrid(np.arange(Ho) * stride, np.arange(Wo) * stride,
                         indexing="ij")
    base = np.stack([px.reshape(-1), py.reshape(-1)], -1)
    pos = (base[None, :, None, :] + _kernel_grid(3, 3, 1, 1)[None, None]
           + offset.reshape(B, Q, 9, 2))
    wh = np.array([W, H], np.float32)
    loc = ((pos + 0.5) / wh).astype(np.float32).reshape(B, Q, 18)
    _, vjp = jax.vjp(_dcn_xla_ref, x, loc, mask.reshape(B, Q, 9), weight)
    dx, dloc, dattn, dw = vjp(g.reshape(B, Q, -1))
    want = {"x": dx, "offset": np.asarray(dloc).reshape(B, Q, 9, 2) / wh,
            "mask": dattn, "weight": dw}

    ins = [torch.from_numpy(a).requires_grad_() for a in (x, offset, mask, weight)]
    out = modulated_deform_conv_ref(*ins, stride)
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for (name, w), a in zip(want.items(), got):
        _rel_close(name, a.numpy().reshape(np.shape(w)), w, KERNEL_GRAD_TOL)


# ------------------------------------------------------------- labels

def test_r101_parameter_labels_follow_the_jax_rule():
    """Every parameter of R101 with DCN in stages 3-4 (the stem, all
    FrozenBatchNorms, downsample_bn, layer1_* frozen; the rest of the
    backbone, the offset convs and DCN weights included, at the backbone's
    rate) labelled as JAX ``_is_frozen`` labels the flax leaf it is
    bridged from."""
    m = bev_base_det_map().model
    jres = JaxResNet(depth=101, out_indices=m.backbone_out_indices,
                     dcn_stages=m.backbone_dcn_stages)
    shapes = jax.eval_shape(jres.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"img_backbone": shapes["params"]})[0]:
        s = jopt._path_str(path)
        label = ("frozen" if jopt._is_frozen(s)
                 else "backbone" if jopt._is_backbone(s) else "main")
        one = node = {}
        keys = [getattr(k, "key", k) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.zeros(leaf.shape, np.float32)
        for name in state_dict_from_flax(one):
            want[name] = label
    with torch.device("meta"):
        tres = ResNet(101, m.backbone_out_indices, m.backbone_dcn_stages)
    names = {f"img_backbone.{k}" for k, _ in tres.named_parameters()}
    assert set(want) == names
    for name, label in want.items():
        assert param_label(name) == label, name
    frozen = {n for n, lb in want.items() if lb == "frozen"}
    assert all(".stem_" in n or ".layer1_" in n or "bn" in n for n in frozen)
    assert {n for n in names if "_bn" in n or ".bn" in n or ".stem_" in n
            or ".layer1_" in n} == frozen
    assert sum("conv2_dcn_weight" in n for n in names) == 23 + 3
    assert all(want[n] == "backbone" for n in names
               if "conv2_offset" in n or "conv2_dcn_weight" in n)


# ------------------------------------------------------------- configs

def test_base_occ_config_equals_the_jax_one_and_loads_at_full_size():
    jcfg, tcfg = jax_base_occ(), bev_base_occ()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    m = tcfg.model
    assert (m.occ_head_type, m.occ_xdim, m.occ_ydim) == ("mlp", 200, 200)
    detector._check_supported(tcfg)
    Q = m.bev_h * m.bev_w
    H, W = m.img_shape
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        (1, m.num_cams, H, W, 3), (1, 18), (1, m.num_cams, 4, 4),
        (1, Q, m.embed_dims), (1,))]
    params = jax.eval_shape(functools.partial(
        jax_build_model(jcfg).init, method=JaxBEVFormer.forward_test_frame),
        {"params": jax.random.PRNGKey(0)}, *args)["params"]
    state = state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), params))
    with torch.device("meta"):
        model = detector.BEVFormer(detector.build_head(tcfg),
                                   *detector.build_trunk(tcfg))
    model.load_state_dict(state, strict=True, assign=True)
    assert tuple(model.head.occ_proj.weight.shape) == (
        m.occ_zdim * m.occ_dims, m.embed_dims)
    assert tuple(model.head.occ_branches.Dense_2.weight.shape) == (
        m.occupancy_classes, m.occ_dims)


# ------------------------------------------------- small base train step

def _gradient_errors(want, got):
    """Each gradient's max abs error beyond the floor (1e-7 of the model's
    largest JAX gradient), over its largest JAX magnitude."""
    floor = 1e-7 * max(float(w.abs().max()) for w in want.values())
    return {k: max(0.0, float((got[k] - w).abs().max()) - floor)
            / max(float(w.abs().max()), 1e-30) for k, w in want.items()}


# the DCN of stages 3 and 4, an offset conv and the SCA value path
LIVE = ("img_backbone.layer3_0.conv2_dcn_weight",
        "img_backbone.layer3_0.conv2_offset.weight",
        "img_backbone.layer4_1.conv2_dcn_weight",
        "head.transformer.encoder.layers.0.sca.deformable_attention"
        ".value_proj.weight",
        "head.transformer.encoder.layers.0.sca.deformable_attention"
        ".sampling_offsets.weight")


def _check_gradients(want, got, live=LIVE):
    """Every parameter has a gradient, and those of ``live`` take part;
    returns the worst of ``_gradient_errors``."""
    assert set(got) == set(want)
    assert all(g is not None for g in got.values())
    for k in live:
        assert float(got[k].abs().max()) > 0, k
    errs = _gradient_errors(want, got)
    return max(errs.values())


def _assert_losses(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_REL_TOL * max(abs(w), 1e-6), (k, got[k], w)


@pytest.fixture(scope="module")
def base_setup():
    """The small base config, its batch, the perturbed JAX weights and the
    jitted JAX step."""
    jcfg = small(jax_base(), SMALL_BASE)
    tcfg = small(bev_base_det_map(), SMALL_BASE)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    m = tcfg.model
    assert m.num_feature_levels == 4 and m.backbone_dcn_stages[2:] == (True, True)
    batch = make_batch(tcfg, 2, seed=4)
    jmodel = jax_build_model(jcfg)
    args = (batch["img"], batch["can_bus"], batch["lidar2img"], batch["has_prev"])
    params = jax.jit(lambda r: jmodel.init(
        {"params": r}, *[a[:1] for a in args], deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    params = perturbed_params(params, seed=1)
    # map reference points near the BEV centre, as tests/test_torch_train.py
    for dense in (params["head"]["map_reference_points_fc"],
                  params["head"]["map_decoder"]["layers"]["reg_branch"]["Dense_2"]):
        dense["kernel"] = dense["kernel"] * 0.01
        dense["bias"] = np.zeros_like(dense["bias"])

    def jloss(p):
        outs = jmodel.apply({"params": p}, *args, deterministic=True)
        gt, mgt = _jax_gt(batch)
        losses = jdet.det_loss(outs["all_cls_scores"], outs["all_bbox_preds"],
                               gt, num_classes=m.num_classes)
        mlosses = jmap.map_loss(outs["map_all_cls_scores"],
                                outs["map_all_pts_preds"], mgt,
                                pc_range=m.pc_range,
                                num_classes=m.map_num_classes)
        total = losses.pop("loss_total") + mlosses.pop("loss_map_total")
        losses.update(mlosses)
        losses["loss_total"] = total
        return total, (losses, outs)

    return dict(tcfg=tcfg, batch=batch, params=params,
                step=jax.jit(jax.value_and_grad(jloss, has_aux=True)))


@pytest.fixture(scope="module", params=["damped", "undamped"])
def base_step(request, base_setup):
    """One step of each side, with the DCN offset convs damped (see the
    module docstring) or as perturbed."""
    tcfg, batch = base_setup["tcfg"], base_setup["batch"]
    m = tcfg.model
    params = base_setup["params"]
    if request.param == "damped":
        params = damp_dcn_offsets(params)
    (_, (jlosses, jouts)), jgrads = base_setup["step"](params)

    model = detector.build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.eval()  # dropout and grid mask off, as deterministic=True
    tbatch = train_lib.batch_to_device(batch, "cpu")
    with torch.no_grad():
        outs = model(tbatch["img"], tbatch["can_bus"], tbatch["lidar2img"],
                     tbatch["has_prev"])
        indices = train_lib.match(outs, *train_lib.ground_truth(tbatch), tcfg)
    jindices = _jax_indices(jouts, batch, m)
    total, losses, _ = train_lib.loss_fn(
        model, tbatch, tcfg, indices=tuple(np.array(sorted(j), np.int64)
                                           for j in jindices))
    total.backward()
    return dict(
        batch=batch, model=model, indices=indices, jindices=jindices,
        grad_tol=(GRAD_REL_TOL if request.param == "damped"
                  else UNDAMPED_GRAD_REL_TOL),
        # undamped, every sample of layer4_1's DCN lands outside its map
        live=LIVE if request.param == "damped" else LIVE[:2] + LIVE[3:],
        jlosses={k: float(v) for k, v in jlosses.items()},
        losses={k: float(v) for k, v in losses.items()},
        jgrads=state_dict_from_flax(jax.tree.map(np.asarray, jgrads)))


def test_base_train_step_loss_terms_match_jax(base_step):
    _assert_losses(base_step["losses"], base_step["jlosses"])
    assert len(base_step["losses"]) == 2 * 2 + 3 * 2 + 1
    assert base_step["jlosses"]["loss_total"] > 1.0


def test_base_train_step_indices_equal_jax(base_step):
    det, mp = base_step["indices"]
    want_det, want_map = base_step["jindices"]
    assert {tuple(int(x) for x in r) for r in det} == want_det
    assert {tuple(int(x) for x in r) for r in mp} == want_map
    b = base_step["batch"]
    assert len(want_det) == 2 * int(b["gt_mask"].sum()) > 0
    assert len(want_map) == 2 * int(b["map_mask"].sum()) > 0


def test_base_train_step_gradients_match_jax(base_step):
    got = {k: p.grad for k, p in base_step["model"].named_parameters()}
    err = _check_gradients(base_step["jgrads"], got, base_step["live"])
    assert err <= base_step["grad_tol"], err


# ---------------------------------------------------- small bev_base_occ

def _jax_occ_params(jmodel, batch):
    args = (batch["img"], batch["can_bus"], batch["lidar2img"], batch["has_prev"])
    params = jax.jit(lambda r: jmodel.init(
        {"params": r}, *[a[:1] for a in args], deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    return damp_dcn_offsets(perturbed_params(params, seed=1))


@pytest.fixture(scope="module")
def occ_setup():
    jcfg = small(jax_base_occ(), SMALL_BASE_OCC, use_grid_mask=False)
    tcfg = small(bev_base_occ(), SMALL_BASE_OCC, use_grid_mask=False)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    batch = make_batch(tcfg, 2, seed=4, paint_gt=True)
    jmodel = jax_build_model(jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, jmodel=jmodel,
                params=_jax_occ_params(jmodel, batch))


def test_base_occ_streaming_frames_match_jax(occ_setup):
    tcfg, jmodel, params = occ_setup["tcfg"], occ_setup["jmodel"], occ_setup["params"]
    m = tcfg.model
    Q = m.bev_h * m.bev_w
    frames = make_stream(tcfg, 3, seed=3, scene_change_at=(2,))
    tmodel = detector.build_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    step = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=JaxBEVFormer.forward_test_frame))
    state = JaxState()
    prev = jnp.zeros((1, Q, m.embed_dims), jnp.float32)
    runner = StreamingRunner(tcfg, tmodel)
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
        assert want["occupancy_preds"].shape[1] == m.occ_zdim * Q
        for k, w in want.items():
            w = np.asarray(w)
            g = got["outs"][k].numpy()
            assert g.shape == w.shape, (k, g.shape, w.shape)
            err = float(np.abs(g - w).max())
            assert err <= STREAM_TOL, (t, k, err)


@pytest.fixture(scope="module")
def occ_step(occ_setup):
    mp = pytest.MonkeyPatch()
    _identity_dropout(mp)
    try:
        return _occ_step(**occ_setup)
    finally:
        mp.undo()


def _occ_step(jcfg, tcfg, batch, jmodel, params):
    """JAX's and the port's step at the images and at each witness image
    (see WITNESS_EPS), the port on JAX's assignment at the same image."""
    m = tcfg.model
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])

    def jloss(p, img):
        outs = jmodel.apply({"params": p}, img, batch["can_bus"],
                            batch["lidar2img"], batch["has_prev"],
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1),
                                  "grid_mask": jax.random.PRNGKey(2)})
        losses = jmt.det_occ_loss(
            outs, jdet.DetGT(*gt), batch["gt_occupancy"],
            occupancy_classes=m.occupancy_classes, group_detr=m.group_detr,
            num_classes=m.num_classes, occ_loss_type=m.occ_loss_type,
            occ_grid_hw=(m.occ_ydim, m.occ_xdim), occ_zdim=m.occ_zdim)
        return losses["loss_total"], (losses, outs)

    step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    model = detector.build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.train()
    for mod in model.modules():
        if hasattr(mod, "rate"):
            mod.rate = 0.0
    images = [batch["img"]] + [
        (batch["img"] * (1 + WITNESS_EPS * np.random.default_rng(seed)
                         .standard_normal(batch["img"].shape))).astype(np.float32)
        for seed in WITNESS_SEEDS]
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
            model, tbatch, tcfg,
            indices=(np.array(sorted(jindices), np.int64), None))
        total.backward()
        runs.append(dict(
            indices=indices, jindices=jindices,
            jlosses={k: float(v) for k, v in jlosses.items()},
            losses={k: float(v.detach()) for k, v in losses.items()},
            jgrads=state_dict_from_flax(jax.tree.map(np.asarray, jgrads)),
            grads={k: p.grad for k, p in model.named_parameters()}))
    return dict(batch=batch, model=model, runs=runs)


def test_base_occ_train_step_matches_jax(occ_step):
    """Loss terms, the det assignment and every gradient (the MLP
    occupancy head's included) against jax.value_and_grad, at the images
    and at each witness image, each side at the same image; the gradients
    within KINK_GRAD_REL_TOL at all nine images and within GRAD_REL_TOL at
    OCC_AGREEING of them (see WITNESS_EPS)."""
    errs = []
    for run in occ_step["runs"]:
        _assert_losses(run["losses"], run["jlosses"])
        assert "loss_occupancy" in run["losses"]
        det, _ = run["indices"]
        assert {tuple(int(x) for x in r) for r in det} == run["jindices"]
        assert len(det) == 2 * int(occ_step["batch"]["gt_mask"].sum()) > 0
        errs.append(_check_gradients(run["jgrads"], run["grads"]))
    assert max(errs) <= KINK_GRAD_REL_TOL, errs
    assert sum(e <= GRAD_REL_TOL for e in errs) >= OCC_AGREEING, errs
    grads = occ_step["runs"][0]["grads"]
    assert float(grads["head.occ_branches.Dense_2.weight"].abs().max()) > 0


# ------------------------------------------------ kernel branch routing

def _factored_case(seed, Q=40):
    rng = np.random.default_rng(seed)
    Bs, N, H, D, P = 1, 2, 2, 8, 4
    shapes = ((6, 9), (3, 5))
    B, L, V = Bs * N, len(shapes), sum(h * w for h, w in shapes)
    arrays = (rng.standard_normal((B, V, H, D)),
              rng.uniform(0.0, 1.0, (B, Q, P * 2)),
              rng.uniform(-2.0, 2.0, (Bs, Q, H * L * P * 2)),
              rng.random((Bs, Q, H * L * P)))
    return [torch.from_numpy(a.astype(np.float32)) for a in arrays], shapes


@pytest.mark.parametrize("ref_grad", [False, True])
def test_factored_function_routes_backward_to_the_kernel_entry(
        monkeypatch, ref_grad):
    """On CUDA tensors ms_deform_attn_factored runs FactoredMSDAFunction:
    forward through msda_cuda.msda_fwd_factored, backward through
    msda_cuda.msda_bwd_factored with the saved operands and tile mask,
    asking for d ref only when autograd does. Checked on the CPU with the
    kernel branch forced and both entries replaced by the plain version
    and its autograd: the gradients equal the plain version's."""
    calls = []

    def plain(value, shapes, ref, off, attn, tile_mask, q_tile):
        B, Q, H, L, P = value.shape[0], ref.shape[1], value.shape[2], 2, 4
        loc, at = materialize_factored(ref, off, attn, shapes, H, P)
        return ms_deform_attn_ref(value, shapes, loc.reshape(B, Q, H, L, P, 2),
                                  at.reshape(B, Q, H, L, P),
                                  tile_mask=tile_mask, q_tile=q_tile)

    def fake_fwd(value, shapes, ref, off, attn, *, tile_mask=None, q_tile=128):
        calls.append("fwd")
        return plain(value, shapes, ref, off, attn, tile_mask, q_tile)

    def fake_bwd(value, shapes, ref, off, attn, grad_out, *, tile_mask=None,
                 q_tile=128, need_ref=True):
        calls.append(("bwd", q_tile, tile_mask is not None, need_ref))
        assert grad_out.dtype == value.dtype and grad_out.is_contiguous()
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (value, ref, off, attn)]
            out = plain(*ins[:1], shapes, *ins[1:], tile_mask, q_tile)
            g = torch.autograd.grad(out, ins, grad_out)
        return g[0], g[1] if need_ref else None, g[2], g[3]

    monkeypatch.setattr(msda_mod, "use_plain", lambda t: False)
    monkeypatch.setattr(msda_cuda, "msda_fwd_factored", fake_fwd)
    monkeypatch.setattr(msda_cuda, "msda_bwd_factored", fake_bwd)
    (value, ref, off, attn), shapes = _factored_case(40)
    tm = torch.tensor([[1, 0, 1], [0, 1, 1]], dtype=torch.int32)
    g = torch.from_numpy(np.random.default_rng(41).standard_normal(
        (2, 40, 16)).astype(np.float32))
    grads = []
    for forced in (True, False):
        monkeypatch.setattr(msda_mod, "use_plain", lambda t, f=forced: not f)
        ins = [t.clone().requires_grad_(i != 1 or ref_grad)
               for i, t in enumerate((value, ref, off, attn))]
        out = msda_mod.ms_deform_attn_factored(ins[0], shapes, *ins[1:],
                                               tile_mask=tm, q_tile=16)
        wanted = [t for t in ins if t.requires_grad]
        grads.append(torch.autograd.grad(out, wanted, g))
    assert calls == ["fwd", ("bwd", 16, True, ref_grad)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dcn_function_routes_backward_to_the_kernel_entry(monkeypatch):
    """On CUDA tensors modulated_deform_conv runs DCNFunction: forward
    through dcn_cuda.dcn_fwd, backward through dcn_cuda.dcn_bwd with the
    saved inputs and the stride (checked on the CPU as above)."""
    calls = []

    def fake_fwd(x, offset, mask, weight, stride=1):
        calls.append(("fwd", stride))
        return modulated_deform_conv_ref(x, offset, mask, weight, stride)

    def fake_bwd(x, offset, mask, weight, grad_out, stride=1):
        calls.append(("bwd", stride))
        assert grad_out.dtype == x.dtype and grad_out.is_contiguous()
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (x, offset, mask, weight)]
            out = modulated_deform_conv_ref(*ins, stride)
            return torch.autograd.grad(out, ins, grad_out)

    monkeypatch.setattr(dcn_cuda, "dcn_fwd", fake_fwd)
    monkeypatch.setattr(dcn_cuda, "dcn_bwd", fake_bwd)
    x, offset, mask, weight, g = _dcn_case(50, 2, 1.5, 9, 11)
    grads = []
    for forced in (True, False):
        monkeypatch.setattr(dcn_mod, "use_plain", lambda t, f=forced: not f)
        ins = [torch.from_numpy(a).requires_grad_() for a in (x, offset, mask, weight)]
        out = dcn_mod.modulated_deform_conv(*ins, 2)
        grads.append(torch.autograd.grad(out, ins, torch.from_numpy(g)))
    assert calls == [("fwd", 2), ("bwd", 2)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("source,name,module", [
    ("msda_bwd.cu", "msda_bwd_factored", msda_cuda),
    ("dcn_fwd.cu", "dcn_bwd_im2col", dcn_cuda),
    ("dcn_fwd.cu", "dcn_bwd_col2im", dcn_cuda),
])
def test_backward_entry_argtypes_match_the_c_parameters(source, name, module):
    params = c_entries(source)[name]
    argtypes = module.ARGTYPES[name]
    assert len(argtypes) == len(params), (params, argtypes)
    for param, argtype in zip(params, argtypes):
        assert argtype is (ctypes.c_void_p if "*" in param else ctypes.c_int), param


def test_backward_wrappers_refuse_cpu_tensors():
    (value, ref, off, attn), shapes = _factored_case(42)
    with pytest.raises(ValueError, match="msda_bwd_factored launches on CUDA"):
        msda_cuda.msda_bwd_factored(value, shapes, ref, off, attn,
                                    torch.zeros((2, 40, 16)))
    x, offset, mask, weight, g = _dcn_case(43, 1, 1.0, 6, 7)
    with pytest.raises(ValueError, match="dcn_bwd launches on CUDA"):
        dcn_cuda.dcn_bwd(*[torch.from_numpy(a) for a in (x, offset, mask, weight, g)])
