"""The port's det+occ options against the JAX package: the refinement pass
at occupancy resolution (``occ_tsa``), the flow branch (``predict_flow``)
and the multi-frame supervision with flow warping (``with_occupancy_flow``).

Small square copies (test_torch_occ.py's SMALL with 1 encoder layer: 8x8
BEV, embed_dims 32, 2 cams at 64x96, 3 groups of 12 queries, a 32x32x4 grid
of 16-wide voxels, f32), with the grid mask off:
- ``grid_sample_3d`` against JAX on points inside and outside the volume:
  1e-5;
- the occ_tsa head on one BEV (upsampling, the refinement layer at 32x32
  over the cameras, ``occ_tsa_head``, the classifier): 1e-4; and the head
  of the bf16 config, whose refinement pass runs in f32 as JAX's, on JAX's
  upsampled tokens: 1e-4;
- three streamed frames of the occ_tsa model with one scene reset against
  JAX ``forward_test_frame``: 1e-3;
- the train steps of the occ_tsa model and of the det+occ+flow model with
  ``with_occupancy_flow`` (the flow branch, every queue frame lifted and
  supervised, the volumes warped across the queue), at the images and at
  six witness images 1e-7 away, each side at the same image: loss terms
  (``loss_flow`` included) 1e-4 relative and indices equal to JAX's at
  every image; every gradient within 1e-4 of its largest element at one
  image at least and within 5e-2 at all (see WITNESS_EPS). The port runs in training
  mode with dropout at rate 0. The occ_tsa step is JAX's
  ``deterministic=False`` with dropout made the identity (as
  test_torch_occ.py), over all 3 groups. The flow step pins the mixing
  weights to 0.5 on both sides: JAX runs ``deterministic=True``, which
  also serves the first Group-DETR group alone, so this copy has one group
  of 12 queries, and the port's mixing draw is patched to 0.5.
One JAX init and one compile of each function per config, shared through
module fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import base as jax_configs
from apollo_vision_net_tpu.data.temporal import StreamingState as JaxState
from apollo_vision_net_tpu.losses import det_loss as jdet
from apollo_vision_net_tpu.losses import multitask as jmt
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer
from apollo_vision_net_tpu.ops.grid_sample import grid_sample_3d as jax_grid_sample_3d
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch import configs as port_configs
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.data.synthetic import (
    camera_ring_lidar2img,
    make_batch,
    make_stream,
)
from apollo_vision_net_tpu_torch.models.detector import build_head, build_model
from apollo_vision_net_tpu_torch.models.heads import occ_head as tocc
from apollo_vision_net_tpu_torch.ops.grid_sample import grid_sample_3d
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner
from test_torch_occ import (
    GRAD_REL_TOL,
    HEAD_TOL,
    STEP_LOSS_REL_TOL,
    STREAM_TOL,
    _close,
    _identity_dropout,
    _jax_det_indices,
    one_torch_thread,  # noqa: F401
    perturbed_params,
    small,
)

# torch on one thread (see test_torch_occ.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

GRID_SAMPLE_TOL = 1e-5
# The train steps run at the images and at six witness images, images *
# (1 + WITNESS_EPS * noise) with noise from seeds 0-5, each side at the same
# image. Both steps hold inputs so near a kink that the two frameworks'
# rounding puts some on different sides: ReLUs in the DLA trunk, and
# deformable samples (the refinement layer's 131,072 a step over the 32x32
# grid, the trilinear warps) within ~1e-6 cell of a cell edge, where the
# gradient of a bilinear weight jumps. JAX against itself moves: its occ_tsa
# head's BEV gradient jumps by 0.283 (of 29.3) between images 1e-7 apart.
# The port's gradients agree with JAX's within 2.7e-6 of their largest
# magnitude at 2 of the 7 images in the occ_tsa step and differ by
# 0.30-2.9% at the others, always in trunk or upsampling tensors. So every
# image is held within KINK_GRAD_REL_TOL (the limit of
# tests/test_torch_train_base.py's bev_base_occ step, 1.7x the largest
# reading) and AGREEING of them within GRAD_REL_TOL.
# Which side of a kink each framework's rounding lands on changes with the
# machine (CPU features, thread counts, the XLA executables a cache holds).
# At the flow step's first batch (seed 4) JAX's own gradients jumped by
# 2.3-2.9% between the images, in the DLA trunk's BN and conv parameters
# (single elements of its 4x6 and 2x3 maps at ReLU and max-pool kinks), and
# the port's agreed with JAX's at none of the 7 images on one machine while
# they agreed at 1 on another. Of batch seeds 0-24, four left JAX's
# gradients agreeing among all 7 images within GRAD_REL_TOL on this
# package's test machine (1, 16, 21, 22; the others jumped by up to 0.2), and
# at seed 22 (within 3.5e-5; BATCH_SEEDS) the port's agree with JAX's at 5
# of the 7 (the other two 1.6e-4 and 7.1e-3, at the flow warps). With both
# frameworks on one CPU thread JAX's own gradients jump by 7e-3 at one
# witness, and the port agrees with JAX at 5 of the 7 again.
WITNESS_EPS = 1e-7
WITNESS_SEEDS = range(6)
KINK_GRAD_REL_TOL = 5e-2
AGREEING = 1
# the painted batch of each step (see above)
BATCH_SEEDS = {"occ_tsa": 4, "occ_flow": 22}
CONFIGS = {
    "occ_tsa": ("bev_tiny_det_occ_tsa_apollo", {}),
    "occ_flow": ("bev_tiny_det_occ_flow", {"with_occupancy_flow": True,
                                           "num_query": 12, "group_detr": 1}),
}


def _configs(key):
    name, kw = CONFIGS[key]
    kw = dict(kw, encoder_layers=1, use_grid_mask=False)
    jcfg = small(getattr(jax_configs, name)(), **kw)
    tcfg = small(getattr(port_configs, name)(), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _setup(key):
    """JAX model, perturbed params and the port's model on the CPU with the
    bridged weights (strict loading), and a painted batch of 2."""
    jcfg, tcfg = _configs(key)
    batch = make_batch(tcfg, 2, seed=BATCH_SEEDS[key], paint_gt=True)
    jmodel = jax_build_model(jcfg)
    args = (batch["img"], batch["can_bus"], batch["lidar2img"], batch["has_prev"])
    params = jax.jit(lambda r: jmodel.init(
        {"params": r}, *[a[:1] for a in args], deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    params = perturbed_params(params, seed=1)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return dict(jcfg=jcfg, cfg=tcfg, batch=batch, jmodel=jmodel, params=params,
                model=model)


@pytest.fixture(scope="module")
def occ_tsa():
    return _setup("occ_tsa")


@pytest.fixture(scope="module")
def occ_flow():
    return _setup("occ_flow")


# ---------------------------------------------------------- grid_sample_3d

def test_grid_sample_3d_matches_jax_inside_and_outside_the_volume():
    rng = np.random.default_rng(0)
    vol = rng.standard_normal((2, 3, 5, 6, 4)).astype(np.float32)
    grid = rng.uniform(-1.5, 1.5, (2, 4, 5, 6, 3)).astype(np.float32)
    grid[0, 0, 0, 0] = (-1.0, 1.0, 0.0)  # on the faces
    want = np.asarray(jax.vmap(jax_grid_sample_3d)(jnp.asarray(vol),
                                                   jnp.asarray(grid)))
    got = grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(grid)).numpy()
    _close(got, want, GRID_SAMPLE_TOL, "grid_sample_3d")
    outside = (np.abs(grid) > 1.0 + 1.0 / 3).any(-1)  # beyond every corner
    assert outside.mean() > 0.3 and (want[outside] == 0).all()
    assert float(np.abs(want[~outside]).max()) > 0.5


# ------------------------------------------------------------- occ_tsa head

@pytest.fixture(scope="module")
def occ_tsa_head(occ_tsa):
    """JAX's occ_tsa head on one BEV and random image features, in one
    compile: the upsampled tokens (B, y, x, C), the refinement pass's
    output on them (B, y, x, z·d) and the classifier's logits."""
    m = occ_tsa["cfg"].model
    rng = np.random.default_rng(3)
    B = 2
    bev = rng.standard_normal((B, m.bev_h * m.bev_w, m.embed_dims)).astype(np.float32)
    feats = [rng.standard_normal((B, m.num_cams, 4, 6, m.embed_dims)).astype(np.float32)]
    l2i = np.broadcast_to(camera_ring_lidar2img(m.num_cams, *m.img_shape),
                          (B, m.num_cams, 4, 4)).copy()

    def lift(mdl, b, f, l):
        up = mdl.upsample_layer(b.reshape(B, m.bev_h, m.bev_w, m.embed_dims))
        return (up, mdl._occ_tsa_pass(up, f, l, True),
                mdl.occ_branches(mdl._occ_from_bev(b, f, l, True)))

    jhead = occ_tsa["jmodel"].head
    hparams = occ_tsa["params"]["head"]
    up, refined, logits = jax.jit(lambda p, *a: jhead.apply(
        {"params": p}, *a, method=lift))(hparams, bev, feats, l2i)
    return dict(bev=bev, feats=feats, l2i=l2i, params=hparams,
                up=np.asarray(up), refined=np.asarray(refined),
                logits=np.asarray(logits))


def test_occ_tsa_head_matches_flax(occ_tsa, occ_tsa_head):
    """Upsampling to embed_dims, the refinement layer over the 32x32 tokens
    (TSA on themselves, SCA through the occupancy-resolution pillars over
    both cameras), occ_tsa_head's token-major (z, d) channels and the
    classifier, on one BEV and random image features."""
    m = occ_tsa["cfg"].model
    jh = occ_tsa_head
    B = jh["bev"].shape[0]
    want = jh["logits"]
    head = build_head(occ_tsa["cfg"]).eval()
    head.load_state_dict(state_dict_from_flax(jh["params"]), strict=True)
    assert hasattr(head, "occ_tsa_layer0") and head.upsample_layer.Conv_0.out_channels == m.embed_dims
    with torch.no_grad():
        got = head.occ_branches(head._occ_from_bev(
            torch.from_numpy(jh["bev"]), [torch.from_numpy(f) for f in jh["feats"]],
            torch.from_numpy(jh["l2i"])))
    assert want.shape == (B, m.occ_zdim * m.occ_ydim * m.occ_xdim, 16)
    _close(got.numpy(), want, HEAD_TOL, "occ_tsa head")
    assert float(np.abs(want).max()) > 0.1


def test_occ_tsa_refinement_runs_in_f32_in_the_bf16_config(occ_tsa, occ_tsa_head):
    """The head of the config as configured (bf16 activations): the
    refinement layer and occ_tsa_head compute in f32, as the JAX package's
    (built without a dtype, whatever the config's dtype) do. Given JAX's
    upsampled tokens, the pass's output matches JAX's within HEAD_TOL,
    which a bf16 pass misses by ~100x (its activations round at 2^-8);
    and the bf16 head's own upsampled tokens enter the pass as f32."""
    cfg = occ_tsa["cfg"]
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16", model=dataclasses.replace(
        cfg.model, transformer_dtype=None))
    jh = occ_tsa_head
    head = build_head(bf16).eval()
    head.load_state_dict(state_dict_from_flax(jh["params"]), strict=True)
    assert head.dtype == torch.bfloat16
    B, oy, ox, C = jh["up"].shape
    feats = [torch.from_numpy(f) for f in jh["feats"]]
    l2i = torch.from_numpy(jh["l2i"])
    with torch.no_grad():
        got = head._occ_tsa_pass(torch.tensor(jh["up"]).permute(0, 3, 1, 2),
                                 feats, l2i)
        lifted = head._occ_from_bev(torch.from_numpy(jh["bev"]), feats, l2i)
    want = jh["refined"].reshape(B, oy * ox, -1)
    _close(got.float().numpy(), want, HEAD_TOL, "occ_tsa refinement, bf16 config")
    assert got.dtype == torch.float32 and lifted.dtype == torch.float32
    assert float(np.abs(want).max()) > 0.5


def test_occ_tsa_streaming_frames_match_jax(occ_tsa):
    jmodel, params, tcfg = occ_tsa["jmodel"], occ_tsa["params"], occ_tsa["cfg"]
    m = tcfg.model
    Q = m.bev_h * m.bev_w
    frames = make_stream(tcfg, 3, seed=3, scene_change_at=(2,))
    step = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=JaxBEVFormer.forward_test_frame))
    state = JaxState()
    prev = jnp.zeros((1, Q, m.embed_dims), jnp.float32)
    runner = StreamingRunner(tcfg, occ_tsa["model"].eval())
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
            _close(got["outs"][k].numpy(), w, STREAM_TOL, (t, k))


def test_smoke_flow_queue_forward_matches_jax():
    """bev_smoke_det_occ_flow as configured (ResNet-50 + FPN, the mlp
    lift on its 8x8x4 grid, flow branch, warping across a queue of 2): the
    training forward in eval mode (mixing weights 0.5) against JAX's
    ``deterministic=True`` forward, every queue frame's occupancy logits
    and flows within 1e-3; bridged weights load strictly."""
    jcfg, tcfg = jax_configs.bev_smoke_det_occ_flow(), port_configs.bev_smoke_det_occ_flow()
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    batch = make_batch(tcfg, 2, seed=6)
    args = (batch["img"], batch["can_bus"], batch["lidar2img"], batch["has_prev"])
    jmodel = jax_build_model(jcfg)
    params = jax.jit(lambda r: jmodel.init(
        {"params": r}, *[a[:1] for a in args], deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    params = perturbed_params(params, seed=2)
    want = jax.jit(lambda p: jmodel.apply({"params": p}, *args,
                                          deterministic=True))(params)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in args))
    m = tcfg.model
    vox = m.occ_zdim * m.occ_ydim * m.occ_xdim
    S = m.queue_length
    assert got["occupancy_preds"].shape == (2 * S, vox, 16)
    assert got["flow_preds"].shape == (2 * S, vox, 2)
    for k in ("occupancy_preds", "flow_preds", "all_cls_scores", "bev_embed"):
        _close(got[k].numpy(), want[k], STREAM_TOL, k)


# ------------------------------------------------------------- train steps

def _train_runs(setup, monkeypatch, deterministic):
    """Both sides' losses, indices and gradients of one train step at the
    images and at each witness image (see WITNESS_EPS), each side at the
    same image, the port on JAX's assignment; JAX with ``deterministic``
    as given, the port in training mode."""
    tcfg, batch = setup["cfg"], setup["batch"]
    jmodel, params, model = setup["jmodel"], setup["params"], setup["model"]
    m = tcfg.model
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])

    def jloss(p, img):
        outs = jmodel.apply({"params": p}, img, batch["can_bus"],
                            batch["lidar2img"], batch["has_prev"],
                            deterministic=deterministic,
                            rngs={"dropout": jax.random.PRNGKey(1),
                                  "grid_mask": jax.random.PRNGKey(2)})
        losses = jmt.det_occ_loss(
            outs, jdet.DetGT(*gt), batch["gt_occupancy"],
            occupancy_classes=m.occupancy_classes, group_detr=m.group_detr,
            num_classes=m.num_classes, occ_loss_type=m.occ_loss_type,
            occ_grid_hw=(m.occ_ydim, m.occ_xdim), occ_zdim=m.occ_zdim,
            flow_preds=outs.get("flow_preds"), gt_flow=batch.get("gt_flow"))
        return losses["loss_total"], (losses, outs)

    step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    monkeypatch.setattr(tocc, "flow_mix_weight",
                        lambda device: torch.tensor(0.5, device=device))
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
            outs=outs, jouts=jouts, indices=indices, jindices=jindices,
            jlosses={k: float(v) for k, v in jlosses.items()},
            losses={k: float(v.detach()) for k, v in losses.items()},
            jgrads=state_dict_from_flax(jax.tree.map(np.asarray, jgrads)),
            grads={k: p.grad for k, p in model.named_parameters()}))
    return dict(cfg=tcfg, batch=batch, model=model, runs=runs)


@pytest.fixture(scope="module")
def tsa_step(occ_tsa):
    mp = pytest.MonkeyPatch()
    _identity_dropout(mp)
    try:
        yield _train_runs(occ_tsa, mp, deterministic=False)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def flow_step(occ_flow):
    mp = pytest.MonkeyPatch()
    try:
        yield _train_runs(occ_flow, mp, deterministic=True)
    finally:
        mp.undo()


STEPS = ["tsa_step", "flow_step"]


@pytest.mark.parametrize("step", STEPS)
def test_train_step_loss_terms_match_jax(step, request):
    """At every image: each loss term (``loss_flow`` in the flow step)
    within 1e-4 relative, and the flow predictions of every queue frame
    within 1e-3."""
    s = request.getfixturevalue(step)
    flow = step == "flow_step"
    m = s["cfg"].model
    vox = m.occ_zdim * m.occ_ydim * m.occ_xdim
    S = m.queue_length if flow else 1
    assert s["batch"]["gt_occupancy"].shape == ((2, S, vox) if flow else (2, vox))
    for run in s["runs"]:
        want, got = run["jlosses"], run["losses"]
        assert set(got) == set(want) and ("loss_flow" in got) == flow
        for k, w in want.items():
            assert abs(got[k] - w) <= STEP_LOSS_REL_TOL * max(abs(w), 1e-6), (k, got[k], w)
        assert run["outs"]["occupancy_preds"].shape == (2 * S, vox, 16)
        if flow:
            assert run["outs"]["flow_preds"].shape == (2 * S, vox, 2)
            assert s["batch"]["gt_flow"].shape == (2, S, vox, 2)
            assert got["loss_flow"] > 0
            _close(run["outs"]["flow_preds"].numpy(), run["jouts"]["flow_preds"],
                   STREAM_TOL, "flow_preds")


@pytest.mark.parametrize("step", STEPS)
def test_train_step_indices_equal_jax(step, request):
    s = request.getfixturevalue(step)
    m = s["cfg"].model
    for run in s["runs"]:
        det, _ = run["indices"]
        assert {tuple(int(x) for x in r) for r in det} == run["jindices"]
        assert len(det) == (m.decoder_layers * m.group_detr
                            * int(s["batch"]["gt_mask"].sum()))


def _cancelled_biases(model):
    """The upsampling convolutions' biases that the GroupNorm after each
    removes exactly (one channel a group, as at embed_dims = 32 channels in
    32 groups): their gradients are zero in exact arithmetic."""
    up = model.head.upsample_layer
    pairs = (("ConvTranspose_0", up.GroupNorm_0), ("Conv_0", up.GroupNorm_1),
             ("ConvTranspose_1", up.GroupNorm_2))
    return {f"head.upsample_layer.{conv}.bias" for conv, norm in pairs
            if norm.num_channels == norm.num_groups}


def _grad_err(want, got, cancelled):
    """The largest gradient error over the parameters, each beyond a floor
    of 1e-7 of the model's largest gradient and relative to its own largest
    JAX magnitude; the biases a GroupNorm cancels are rounding noise on
    both sides, held below 1e-6 of the model's largest gradient instead."""
    assert set(got) == set(want)
    largest = max(float(w.abs().max()) for w in want.values())
    floor = 1e-7 * largest
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g is not None, k
        if k in cancelled:
            assert max(float(g.abs().max()), float(w.abs().max())) <= 1e-6 * largest, k
            continue
        err = max(0.0, float((g - w).abs().max()) - floor)
        worst = max(worst, err / max(float(w.abs().max()), floor))
    return worst


@pytest.mark.parametrize("step", STEPS)
def test_train_step_gradients_match_jax(step, request):
    """Every parameter's gradient, at the images and at each witness image,
    within KINK_GRAD_REL_TOL, and within GRAD_REL_TOL at AGREEING of them
    (see WITNESS_EPS); the new modules' gradients are not zero."""
    s = request.getfixturevalue(step)
    cancelled = _cancelled_biases(s["model"])
    assert len(cancelled) == (3 if step == "tsa_step" else 1)
    errs = [_grad_err(run["jgrads"], run["grads"], cancelled) for run in s["runs"]]
    assert max(errs) <= KINK_GRAD_REL_TOL, errs
    assert sum(e <= GRAD_REL_TOL for e in errs) >= AGREEING, errs
    new = (["head.occ_tsa_layer0.sca.deformable_attention.value_proj.weight",
            "head.occ_tsa_layer0.tsa.sampling_offsets.weight",
            "head.occ_tsa_head.weight"] if step == "tsa_step" else
           ["head.flow_branches.Dense_2.weight", "head.forward_flow.weight",
            "head.backward_flow.weight", "head.flow_fc.LayerNorm_1.weight"])
    got = s["runs"][0]["grads"]
    for k in new + ["img_backbone.level5.tree2.conv2.weight"]:
        assert float(got[k].abs().max()) > 0, k
