"""The PyTorch port's det+occupancy model against the JAX package.

- The occupancy lift (CNNUpsample at x4, x2 and x1, and the mlp head) and
  the per-voxel classifier against flax on bridged weights: 1e-4 max abs
  (f32 on both sides, the transposed convolutions' sums in other orders).
- Each occupancy loss against JAX on random logits whose labels hold free
  (16) and ignored (255) voxels: 1e-5 relative.
- det_loss with 1 and 3 Group-DETR groups: the assignment of every group
  equal to JAX's solver's, the terms within 1e-5 relative; det_occ_loss of
  each occupancy loss type within 1e-5 relative.
- A small copy of bev_tiny_det_occ_apollo (DLA-34 + SECONDFPNV2 kept, 8x8
  BEV, embed_dims 32, 2 cams at 64x96, 2 encoder and 2 decoder layers, 3
  groups of 12 queries, a 32x32x4 grid of 16-wide voxels, f32): three
  streamed frames with one scene reset against JAX ``forward_test_frame``
  within 1e-3 (as tests/test_torch_slice.py); its train step over all
  groups (loss terms 1e-4 relative, indices equal, every gradient within
  1e-4 of its largest element, as tests/test_torch_train.py), with dropout
  made the identity on both sides and the grid mask off, so that JAX's
  ``deterministic=False`` and the port's training mode compute the same
  function.
- ``_check_supported`` refuses by name what the det+occ model still does
  not run (tests/test_torch_occ_options.py holds the ported options, and
  tests/test_torch_voxel.py and test_torch_hybrid.py the voxel and hybrid
  head families).
"""
import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import bev_tiny_det_occ_apollo as jax_occ
from apollo_vision_net_tpu.data.temporal import StreamingState as JaxState
from apollo_vision_net_tpu.losses import det_loss as jdet
from apollo_vision_net_tpu.losses import multitask as jmt
from apollo_vision_net_tpu.losses import occ_loss as jol
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer
from apollo_vision_net_tpu.models.heads import occ_head as jocc
from apollo_vision_net_tpu.parallel.train import build_head as jax_build_head
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.configs import bev_tiny_det_occ_apollo
from apollo_vision_net_tpu_torch.data.synthetic import make_batch, make_stream
from apollo_vision_net_tpu_torch.losses import det_loss as tdet
from apollo_vision_net_tpu_torch.losses import multitask as tmt
from apollo_vision_net_tpu_torch.losses import occ_loss as tol
from apollo_vision_net_tpu_torch.models.detector import build_head, build_model
from apollo_vision_net_tpu_torch.models.heads.occ_head import (
    CNNUpsample,
    occupancy_prediction,
)
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner

SMALL = dict(bev_h=8, bev_w=8, embed_dims=32, num_cams=2, img_shape=(64, 96),
             encoder_layers=2, decoder_layers=2, feedforward_channels=64,
             num_query=36, group_detr=3, queue_length=2, occ_xdim=32,
             occ_ydim=32, occ_zdim=4, occ_dims=16,
             transformer_dtype="float32", msda_impl="auto")
HEAD_TOL = 1e-4
LOSS_REL_TOL = 1e-5
STREAM_TOL = 1e-3
STEP_LOSS_REL_TOL = 1e-4
GRAD_REL_TOL = 1e-4


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a module's tests (modules opt in
    with ``pytestmark``). The suite runs several pytest workers on the
    machine's cores, and torch's parallel regions spin while they wait for
    their threads, so under that load small ops run tens of times slower:
    the CPU overfit test of tests/test_torch_eval.py took 4 s alone, 28 s at
    one thread and ~290 s at eight beside five busy processes. Every limit
    of the modules that opt in holds at one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(cfg, **kw):
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        model=dataclasses.replace(cfg.model, **dict(SMALL, **kw)),
        data=dataclasses.replace(cfg.data, max_gt_boxes=8))


def perturbed_params(params, seed):
    """flax init plus noise, so that zero-initialized kernels (sampling
    offsets, attention weights) take part; BN variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return x * np.exp(0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, params)


def _close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol, (what, err)


# ------------------------------------------------------------------ head

@pytest.mark.parametrize("factor", [4, 2, 1])
def test_cnn_upsample_matches_flax(factor):
    """flax ConvTranspose pads the dilated input (2, 1) at stride 2 and
    does not flip its kernel; the port's transposed convolution with the
    bridged (flipped) kernel, cropped, gives the same grid."""
    rng = np.random.default_rng(factor)
    x = rng.standard_normal((2, 5, 7, 32)).astype(np.float32)
    mod = jocc.CNNUpsample(embed_dims=32, out_channels=64, upsample_factor=factor)
    params = perturbed_params(mod.init(jax.random.PRNGKey(0), x)["params"], 1)
    want = np.asarray(mod.apply({"params": params}, x))
    port = CNNUpsample(32, 64, upsample_factor=factor)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert want.shape == (2, 5 * factor, 7 * factor, 64)
    _close(got.numpy(), want, HEAD_TOL, "upsample")
    assert float(np.abs(want).max()) > 0.1


@pytest.mark.parametrize("head_type", ["cnn", "mlp"])
def test_occupancy_lift_and_classifier_match_flax(head_type):
    """The head's BEV -> voxel features -> per-voxel logits path on bridged
    weights, voxels in (z, y, x) order with x minor."""
    kw = {} if head_type == "cnn" else dict(occ_head_type="mlp", occ_xdim=8,
                                            occ_ydim=8)
    cfg = small(bev_tiny_det_occ_apollo(), **kw)
    m = cfg.model
    jhead = jax_build_head(small(jax_occ(), **kw))
    bev = np.random.default_rng(3).standard_normal(
        (2, m.bev_h * m.bev_w, m.embed_dims)).astype(np.float32)

    def lift(mdl, b):
        return mdl.occ_branches(mdl._occ_from_bev(b))

    params = jhead.init(jax.random.PRNGKey(0), bev, method=lift)["params"]
    params = perturbed_params(params, 2)
    want = np.asarray(jhead.apply({"params": params}, bev, method=lift))
    head = build_head(cfg)
    occ = ("upsample_layer.", "occ_branches.", "occ_proj.")
    sd = {k: v for k, v in state_dict_from_flax(params).items() if k.startswith(occ)}
    missing, unexpected = head.load_state_dict(sd, strict=False)
    assert not unexpected and not [k for k in missing if k.startswith(occ)]
    with torch.no_grad():
        got = head.occ_branches(head._occ_from_bev(torch.from_numpy(bev)))
    assert want.shape == (2, m.occ_zdim * m.occ_ydim * m.occ_xdim, 16)
    _close(got.numpy(), want, HEAD_TOL, head_type)


def test_occupancy_prediction_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((2, 300, 16)).astype(np.float32) * 2 - 2
    for rule in ("focal_loss", "ce_loss"):
        want = np.asarray(jocc.occupancy_prediction(jnp.asarray(logits), rule))
        got = occupancy_prediction(torch.from_numpy(logits), rule).numpy()
        np.testing.assert_array_equal(got, want)
        assert (want == 16).any() == (rule == "focal_loss")


# ---------------------------------------------------------------- losses

def _occ_inputs(seed, M=700, C=16):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((M, C)) * 2).astype(np.float32)
    labels = rng.integers(0, C, M).astype(np.int32)
    labels[rng.uniform(size=M) < 0.5] = C            # free
    labels[rng.uniform(size=M) < 0.1] = 255          # ignored
    probs = np.array(jax.nn.softmax(jnp.asarray(logits), -1))
    return logits, labels, labels != 255, probs


LOSS_CASES = {
    "focal_visible_mean": lambda lib, a: lib.occupancy_focal_loss(
        a["logits"], a["labels"], a["valid"], class_weights=a["class_w"],
        spatial_weight=a["spatial"], loss_weight=100.0),
    "focal_factor": lambda lib, a: lib.occupancy_focal_loss(
        a["logits"], a["labels"], a["valid"], avg_mode="factor",
        avg_factor=a["num_pos"], loss_weight=100.0),
    "ce_ssc": lambda lib, a: lib.ce_ssc_loss(
        a["logits"], a["labels"], a["valid"] & (a["labels"] < 16), a["class_w"]),
    "lovasz": lambda lib, a: lib.lovasz_softmax(a["probs"], a["labels"], a["valid"]),
    "geo_scal": lambda lib, a: lib.geo_scal_loss(
        a["probs"], a["labels"], a["valid"], empty_idx=15),
    "sem_scal": lambda lib, a: lib.sem_scal_loss(a["probs"], a["labels"], a["valid"]),
    "flow_l1": lambda lib, a: lib.flow_l1_loss(
        a["flow"], a["gt_flow"], a["valid"] & (a["labels"] < 10)),
}


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_occupancy_losses_match_jax(name):
    logits, labels, valid, probs = _occ_inputs(5)
    rng = np.random.default_rng(6)
    arrays = dict(logits=logits, labels=labels, valid=valid, probs=probs,
                  class_w=jol.balanced_class_weights(16),
                  spatial=rng.uniform(1, 2, len(labels)).astype(np.float32),
                  num_pos=np.float32((labels < 16).sum()),
                  flow=rng.standard_normal((len(labels), 2)).astype(np.float32),
                  gt_flow=rng.standard_normal((len(labels), 2)).astype(np.float32))
    want = float(LOSS_CASES[name](jol, {k: jnp.asarray(v) for k, v in arrays.items()}))
    got = float(LOSS_CASES[name](tol, {k: torch.as_tensor(v) for k, v in arrays.items()}))
    assert abs(got - want) <= LOSS_REL_TOL * abs(want), (name, got, want)
    assert want > 0
    np.testing.assert_array_equal(tol.balanced_class_weights(16),
                                  jol.balanced_class_weights(16))
    np.testing.assert_array_equal(tol.radial_bev_weight(6, 9), jol.radial_bev_weight(6, 9))


def _det_outputs(seed, n_layers=2, B=2, G=1, q=12, C=10):
    rng = np.random.default_rng(seed)
    cls = rng.standard_normal((n_layers, B, G * q, C)).astype(np.float32)
    box = rng.standard_normal((n_layers, B, G * q, 10)).astype(np.float32) * 0.5
    batch = make_batch(small(bev_tiny_det_occ_apollo()), B, seed=seed)
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    return cls, box, gt, batch


_JAX_MATCH = jax.jit(jax.vmap(lambda c, b, gn, gl, gm: jdet._match_single(
    c, b, gn, gl, gm, 2.0, 0.25)))


def _jax_det_indices(cls, box, gt, G):
    """Real-row (layer, batch, query, gt row) assignments of JAX's solver,
    each group matched against the full GT."""
    boxes, labels, mask = (jnp.asarray(a) for a in gt)
    gt_norm = jdet.normalize_bbox(boxes)
    gt_norm = jnp.where(mask[..., None],
                        jnp.nan_to_num(gt_norm, posinf=0.0, neginf=0.0), 0.0)
    n_layers, B, Q, _ = cls.shape
    q = Q // G
    out = set()
    for lyr in range(n_layers):
        for g in range(G):
            aq = _JAX_MATCH(cls[lyr, :, g * q:(g + 1) * q],
                            box[lyr, :, g * q:(g + 1) * q], gt_norm, labels, mask)
            for b, r in zip(*np.nonzero(np.asarray(mask))):
                out.add((lyr, int(b), g * q + int(aq[b, r]), int(r)))
    return out


def _port_det_indices(cls, box, gt, G):
    gtt = tdet.DetGT(*(torch.as_tensor(a) for a in gt))
    costs = tdet.match_costs(torch.as_tensor(cls), torch.as_tensor(box), gtt,
                             num_groups=G)
    return tdet.solve(costs.numpy(), gt[2]), gtt, costs


@pytest.mark.parametrize("groups", [1, 3])
def test_det_loss_groups_match_jax(groups):
    cls, box, gt, _ = _det_outputs(7, G=groups)
    idx, gtt, costs = _port_det_indices(cls, box, gt, groups)
    assert {tuple(int(x) for x in r) for r in idx} == _jax_det_indices(cls, box, gt, groups)
    assert len(idx) == 2 * groups * int(gt[2].sum())
    # each group's costs are the single-group costs of its query slice
    q = cls.shape[2] // groups
    for g in range(groups):
        one = tdet.match_costs(torch.as_tensor(cls[:, :, g * q:(g + 1) * q]),
                               torch.as_tensor(box[:, :, g * q:(g + 1) * q]), gtt)
        assert torch.equal(one[:, :, 0], costs[:, :, g])
    want = jax.jit(functools.partial(jdet.det_loss, num_classes=10,
                                     num_groups=groups))(
        jnp.asarray(cls), jnp.asarray(box), jdet.DetGT(*(jnp.asarray(a) for a in gt)))
    got = tdet.det_loss(torch.as_tensor(cls), torch.as_tensor(box), gtt, idx,
                        num_classes=10, num_groups=groups)
    assert set(got) == set(want)
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= LOSS_REL_TOL * abs(float(w)), k


@pytest.mark.parametrize("occ_loss_type", ["CustomFocalLoss", "focal_loss", "ce_loss"])
def test_det_occ_loss_matches_jax(occ_loss_type):
    G = 3
    cls, box, gt, _ = _det_outputs(8, G=G)
    cfg = small(bev_tiny_det_occ_apollo())
    m = cfg.model
    vox = m.occ_zdim * m.occ_ydim * m.occ_xdim
    rng = np.random.default_rng(9)
    occ = (rng.standard_normal((2, vox, 16)) * 2).astype(np.float32)
    gt_occ = np.where(rng.uniform(size=(2, vox)) < 0.7, 16,
                      rng.integers(0, 16, (2, vox))).astype(np.int32)
    gt_occ[rng.uniform(size=(2, vox)) < 0.05] = 255
    kw = dict(occupancy_classes=16, group_detr=G, num_classes=10,
              occ_loss_type=occ_loss_type, occ_grid_hw=(m.occ_ydim, m.occ_xdim),
              occ_zdim=m.occ_zdim)
    want = jax.jit(functools.partial(jmt.det_occ_loss, **kw))(
        {"all_cls_scores": jnp.asarray(cls), "all_bbox_preds": jnp.asarray(box),
         "occupancy_preds": jnp.asarray(occ)},
        jdet.DetGT(*(jnp.asarray(a) for a in gt)), jnp.asarray(gt_occ))
    idx, gtt, _ = _port_det_indices(cls, box, gt, G)
    got = tmt.det_occ_loss(
        {"all_cls_scores": torch.as_tensor(cls), "all_bbox_preds": torch.as_tensor(box),
         "occupancy_preds": torch.as_tensor(occ)},
        gtt, torch.as_tensor(gt_occ), idx, **kw)
    assert set(got) == set(want) and "loss_geo_scal" in got
    for k, w in want.items():
        assert abs(float(got[k]) - float(w)) <= LOSS_REL_TOL * abs(float(w)), (k, got[k], w)


# ----------------------------------------------------- stream and train

def test_streaming_frames_match_jax():
    jcfg, tcfg = small(jax_occ()), small(bev_tiny_det_occ_apollo())
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    m = tcfg.model
    frames = make_stream(tcfg, 3, seed=3, scene_change_at=(2,))
    jmodel = jax_build_model(jcfg)
    Q = m.bev_h * m.bev_w
    f0 = frames[0]
    params = jax.jit(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame))(
        {"params": jax.random.PRNGKey(0)}, f0["img"][None], f0["can_bus"][None],
        f0["lidar2img"][None], jnp.zeros((1, Q, m.embed_dims)),
        jnp.zeros((1,)))["params"]
    params = perturbed_params(params, seed=1)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)

    step = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=JaxBEVFormer.forward_test_frame))
    state = JaxState()
    prev = jnp.zeros((1, Q, m.embed_dims), jnp.float32)
    runner = StreamingRunner(tcfg, tmodel)
    decided = 0
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
        assert want["cls_scores"].shape[1] == m.num_query // m.group_detr
        for k, w in want.items():
            _close(got["outs"][k].numpy(), w, STREAM_TOL, (t, k))
        # the class grid, where JAX's decision is not within the tolerance
        # of the threshold or of the runner-up class
        p = np.sort(np.asarray(jax.nn.sigmoid(outs["occupancy_preds"][0])), -1)
        clear = (np.abs(p[:, -1] - 0.25) > 1e-4) & (p[:, -1] - p[:, -2] > 1e-4)
        jgrid = np.asarray(jocc.occupancy_prediction(outs["occupancy_preds"]))[0]
        np.testing.assert_array_equal(got["occ"].numpy()[clear], jgrid[clear])
        decided += int(clear.sum())
    assert decided > 0.99 * 3 * m.occ_zdim * m.occ_ydim * m.occ_xdim


def _identity_dropout(monkeypatch):
    """JAX's dropout (flax nn.Dropout and the attention-weight dropout)
    becomes the identity for the rest of the test."""
    monkeypatch.setattr(fnn.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None: inputs)
    real = fnn.attention.dot_product_attention_weights

    def weights(*args, **kw):
        args = list(args)
        if len(args) > 7:
            args[7] = True
        else:
            kw["deterministic"] = True
        return real(*args, **kw)

    monkeypatch.setattr(fnn.attention, "dot_product_attention_weights", weights)


@pytest.fixture(scope="module")
def train_step():
    mp = pytest.MonkeyPatch()
    _identity_dropout(mp)
    try:
        yield _train_step()
    finally:
        mp.undo()


def _train_step():
    jcfg = small(jax_occ(), use_grid_mask=False)
    tcfg = small(bev_tiny_det_occ_apollo(), use_grid_mask=False)
    m = tcfg.model
    batch = make_batch(tcfg, 2, seed=4, paint_gt=True)
    assert batch["gt_occupancy"].shape == (2, m.occ_zdim * m.occ_ydim * m.occ_xdim)
    jmodel = jax_build_model(jcfg)
    args = (batch["img"], batch["can_bus"], batch["lidar2img"], batch["has_prev"])
    params = jax.jit(lambda r: jmodel.init(
        {"params": r}, *[a[:1] for a in args], deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    params = perturbed_params(params, seed=1)
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])

    def jloss(p):
        outs = jmodel.apply({"params": p}, *args, deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1),
                                  "grid_mask": jax.random.PRNGKey(2)})
        losses = jmt.det_occ_loss(
            outs, jdet.DetGT(*gt), batch["gt_occupancy"],
            occupancy_classes=m.occupancy_classes, group_detr=m.group_detr,
            num_classes=m.num_classes, occ_loss_type=m.occ_loss_type,
            occ_grid_hw=(m.occ_ydim, m.occ_xdim), occ_zdim=m.occ_zdim)
        return losses["loss_total"], (losses, outs)

    (_, (jlosses, jouts)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.train()
    for mod in model.modules():
        if hasattr(mod, "rate"):
            mod.rate = 0.0
    tbatch = train_lib.batch_to_device(batch, "cpu")
    with torch.no_grad():
        outs = model(tbatch["img"], tbatch["can_bus"], tbatch["lidar2img"],
                     tbatch["has_prev"])
        indices = train_lib.match(outs, *train_lib.ground_truth(tbatch), tcfg)
    jindices = _jax_det_indices(np.asarray(jouts["all_cls_scores"]),
                                np.asarray(jouts["all_bbox_preds"]), gt,
                                m.group_detr)
    total, losses, _ = train_lib.loss_fn(
        model, tbatch, tcfg, indices=(np.array(sorted(jindices), np.int64), None))
    total.backward()
    return dict(
        cfg=tcfg, batch=batch, model=model, outs=outs,
        jlosses={k: float(v) for k, v in jlosses.items()},
        losses={k: float(v.detach()) for k, v in losses.items()},
        jindices=jindices, indices=indices,
        jgrads=state_dict_from_flax(jax.tree.map(np.asarray, jgrads)))


def test_train_step_loss_terms_match_jax_over_all_groups(train_step):
    want, got = train_step["jlosses"], train_step["losses"]
    assert set(got) == set(want) and len(got) == 2 * 2 + 4 + 1
    for k, w in want.items():
        assert abs(got[k] - w) <= STEP_LOSS_REL_TOL * max(abs(w), 1e-6), (k, got[k], w)
    m = train_step["cfg"].model
    assert train_step["outs"]["all_cls_scores"].shape[2] == m.num_query


def test_train_step_indices_equal_jax_in_every_group(train_step):
    det, _ = train_step["indices"]
    assert {tuple(int(x) for x in r) for r in det} == train_step["jindices"]
    m = train_step["cfg"].model
    n_gt = int(train_step["batch"]["gt_mask"].sum())
    assert len(det) == m.decoder_layers * m.group_detr * n_gt
    q = m.num_query // m.group_detr
    assert {int(r[2]) // q for r in det} == set(range(m.group_detr))


def test_train_step_gradients_match_jax(train_step):
    """Every parameter's gradient, the occupancy head's, the queries of
    every group and the trunk's included, within 1e-4 of its largest JAX
    magnitude (plus 1e-7 of the model's largest, for gradients that are
    zero in exact arithmetic)."""
    want = train_step["jgrads"]
    got = {k: p.grad for k, p in train_step["model"].named_parameters()}
    assert set(got) == set(want)
    floor = 1e-7 * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g = got[k]
        assert g is not None, k
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_REL_TOL * scale + floor, (k, err, scale)
    m = train_step["cfg"].model
    q = m.num_query // m.group_detr
    qgrad = got["head.query_embedding"].abs().reshape(m.group_detr, q, -1).amax((1, 2))
    assert bool((qgrad > 0).all())
    for k in ("head.upsample_layer.ConvTranspose_1.weight",
              "head.occ_branches.Dense_2.weight",
              "img_backbone.level5.tree2.conv2.weight"):
        assert float(got[k].abs().max()) > 0, k


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("key, fields", [
    ("with_map", {"with_map": True}),
    ("head_family", {"head_family": "voxel", "with_map": True}),
    ("head_family", {"head_family": "hybrid", "with_map": True}),
    ("with_map", {"with_map": True, "map_version": 2}),
    ("occ_tsa", {"occ_tsa": True, "keep_bev_history": True}),
])
def test_unported_occupancy_options_are_refused_by_name(key, fields):
    """What the det+occ model still refuses: a map head beside it (MapTR v1
    or v2), a map head on the voxel and hybrid head families (which the
    port builds otherwise: tests/test_torch_voxel.py, test_torch_hybrid.py),
    and the refinement pass together with multi-frame supervision (the JAX
    package asserts it)."""
    cfg = bev_tiny_det_occ_apollo()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **fields))
    with pytest.raises(NotImplementedError, match=key):
        build_model(cfg, device="cpu")
