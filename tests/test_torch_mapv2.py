"""The port's MapTRv2 (det + decoupled map decoder, one2one and one2many
vectors, aux BEV/PV segmentation, map_loss_v2) against the JAX package.

The model is smoke_det_mapv2 (ResNet-50 stage 4 + FPN, 8x8 BEV, embed_dims
32, 2 cams at 64x96, queue 2; 4 one2one and 8 one2many vectors of 4
points, k = 2, 2 map layers) with f32 pinned, and the grid mask off for
the train step. Tolerances and why:
- the rasterize copy and make_batch's ``gt_bev_seg`` / ``gt_pv_seg``:
  equal, byte for byte (the same numpy code);
- masked MHA against the JAX package's MultiheadAttention (flax's
  MultiHeadDotProductAttention with a keep-mask): 1e-5; one decoupled
  decoder layer: 1e-5 (f32, sums in other orders);
- the v2 head on one BEV history and random image features in eval mode
  (the 4 one2one vectors) and in training mode (all 12, the inter-vector
  self-attention under the block-diagonal mask; JAX ``deterministic=False``
  with dropout made the identity, the port's dropout at rate 0): 1e-4 of
  each output's largest magnitude (at least 1);
- three streamed frames with one scene reset against JAX
  ``forward_test_frame``: 1e-3, as above;
- one train step in training mode: loss terms (the ``_one2many`` and
  segmentation terms included) 1e-4 relative at JAX's assignment; the
  port's own assignment equal to JAX's, the one2many rows compared modulo
  V (the tiled GT rows are equal copies, and which copy a query takes is a
  free tie); every gradient within 1e-4 of its largest JAX magnitude (plus
  1e-7 of the model's largest).
The map head's reference and regression layers are damped, as in
tests/test_torch_train.py, so that the matching is not all ties. One JAX
init and one compile of each function, shared through module fixtures.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import base as jax_configs
from apollo_vision_net_tpu.data import rasterize as jras
from apollo_vision_net_tpu.data import synthetic as jsyn
from apollo_vision_net_tpu.data.temporal import StreamingState as JaxState
from apollo_vision_net_tpu.losses import det_loss as jdet
from apollo_vision_net_tpu.losses import map_loss as jmap
from apollo_vision_net_tpu.models import attention as jattn
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer
from apollo_vision_net_tpu.models.heads import map_head_v2 as jv2
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch import configs as port_configs
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.data import rasterize as tras
from apollo_vision_net_tpu_torch.data import synthetic as tsyn
from apollo_vision_net_tpu_torch.data.synthetic import camera_ring_lidar2img
from apollo_vision_net_tpu_torch.models.attention import MultiheadAttention
from apollo_vision_net_tpu_torch.models.detector import build_head, build_model
from apollo_vision_net_tpu_torch.models.heads.map_head_v2 import (
    BEVFormerDetMapHeadV2,
    DecoupledMapDecoderLayer,
)
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner
from test_torch_occ import _identity_dropout, perturbed_params

MODULE_TOL = 1e-5
HEAD_TOL = 1e-4
STREAM_TOL = 1e-3
LOSS_REL_TOL = 1e-4
GRAD_REL_TOL = 1e-4


def _configs():
    def pin(cfg):
        return dataclasses.replace(cfg, compute_dtype="float32", model=dataclasses.replace(
            cfg.model, transformer_dtype="float32", use_grid_mask=False))

    jcfg, tcfg = pin(jax_configs.smoke_det_mapv2()), pin(port_configs.smoke_det_mapv2())
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def _close(got, want, tol, what):
    """Max abs error within ``tol`` of the larger of 1 and want's largest
    magnitude."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


@pytest.fixture(scope="module")
def setup():
    """JAX model and perturbed params (the map head's reference and
    regression layers damped), the port's model on the CPU with the bridged
    weights (strict loading), and a painted batch of 2."""
    jcfg, tcfg = _configs()
    batch = tsyn.make_batch(tcfg, 2, seed=4, paint_gt=True)
    jmodel = jax_build_model(jcfg)
    args = (batch["img"], batch["can_bus"], batch["lidar2img"], batch["has_prev"])
    params = jax.jit(lambda r: jmodel.init(
        {"params": r}, *[a[:1] for a in args], deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    params = perturbed_params(params, seed=1)
    head = params["head"]
    m = tcfg.model
    for dense in [head["map_reference_points_fc"]] + [
            head[f"map_reg_branch{i}"]["Dense_2"] for i in range(m.map_decoder_layers)]:
        dense["kernel"] = dense["kernel"] * 0.01
        dense["bias"] = np.zeros_like(dense["bias"])
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    assert isinstance(model.head, BEVFormerDetMapHeadV2)
    return dict(jcfg=jcfg, cfg=tcfg, batch=batch, jmodel=jmodel, params=params,
                model=model)


def _no_dropout(model):
    model.train()
    for mod in model.modules():
        if hasattr(mod, "rate"):
            mod.rate = 0.0
    return model


# ------------------------------------------------------------------ data

def test_rasterize_copy_equals_the_jax_one():
    """BEV and PV masks of vectors inside the patch, reaching off the grid
    (clipped), a single point, a vector with a non-finite point and an
    empty one, at radii 0-2; the PV masks through the camera ring, where
    some cameras see the first vector partly behind them (depth <= 0,
    dropped)."""
    rng = np.random.default_rng(2)
    line = np.cumsum(rng.uniform(-3, 3, (12, 2)), 0).astype(np.float32)
    far = np.array([[-80.0, 10.0], [5.0, 3.0], [70.0, -90.0]], np.float32)
    nan = np.array([[1.0, 2.0], [np.nan, 0.0], [4.0, -6.0]], np.float32)
    vecs = [line, far, np.array([[3.0, -2.0]], np.float32), nan,
            np.zeros((0, 2), np.float32)]
    l2i = camera_ring_lidar2img(6, 480, 800)
    for radius in (0, 1, 2):
        for hw, patch in (((50, 50), (100.0, 100.0)), ((20, 30), (60.0, 30.0))):
            want = jras.rasterize_lines_bev(vecs, *hw, patch, radius=radius)
            got = tras.rasterize_lines_bev(vecs, *hw, patch, radius=radius)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            assert 0 < got.mean() < 1
        for feat in ((30, 50), (7, 11)):
            want = jras.rasterize_lines_pv(vecs, l2i, (480, 800), feat, radius=radius)
            got = tras.rasterize_lines_pv(vecs, l2i, (480, 800), feat, radius=radius)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
            assert got.shape == (6,) + feat and got.any() and not got.all()
    # cameras that see the line partly in front and partly behind them
    pts = np.concatenate([line, np.zeros((12, 1)), np.ones((12, 1))], 1)
    depth = np.einsum("nij,pj->npi", l2i, pts)[..., 2]
    assert ((depth <= 0).any(1) & (depth > 0).any(1)).sum() >= 2


@pytest.mark.parametrize("paint", [False, True])
def test_make_batch_seg_gt_equals_the_jax_one(paint):
    """gt_bev_seg (B, bev_h, bev_w) and gt_pv_seg (B, N, H/16, W/16) of the
    smoke config and of bev_tiny_det_mapv2 (at 96x160 images), with every
    other key of the batch, byte-equal to the JAX package's make_batch."""
    def smaller(cfg):
        return dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, img_shape=(96, 160)))

    for jcfg in (jax_configs.smoke_det_mapv2(), smaller(jax_configs.bev_tiny_det_mapv2())):
        want = jsyn.make_batch(jcfg, batch_size=2, seed=7, paint_gt=paint)
        got = tsyn.make_batch(port_configs.ExperimentConfig(
            **{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}),
            batch_size=2, seed=7, paint_gt=paint)
        assert set(got) == set(want) and {"gt_bev_seg", "gt_pv_seg"} <= set(got)
        for k, v in got.items():
            assert v.dtype == want[k].dtype and v.tobytes() == want[k].tobytes(), k
        m = jcfg.model
        H, W = m.img_shape
        assert got["gt_bev_seg"].shape == (2, m.bev_h, m.bev_w)
        assert got["gt_pv_seg"].shape == (2, m.num_cams, H // 16, W // 16)
        assert got["gt_bev_seg"].any() and got["gt_pv_seg"].any()


# --------------------------------------------------------------- modules

def _vec_mask(nv, o1):
    is_o1 = np.arange(nv) < o1
    return is_o1[:, None] == is_o1[None, :]


@pytest.mark.parametrize("mask", ["block_diagonal", "random_with_empty_row", "none"])
def test_masked_mha_matches_flax(mask):
    """The port's MultiheadAttention with a (Lq, Lk) keep-mask against the
    JAX package's (flax MultiHeadDotProductAttention, mask (1, 1, Lq, Lk)):
    masked logits at finfo(f32).min before the softmax, so that a row with
    no key kept attends uniformly, as in flax."""
    rng = np.random.default_rng(5)
    B, L, C = 3, 12, 32
    q = rng.standard_normal((B, L, C)).astype(np.float32)
    pos = rng.standard_normal((B, L, C)).astype(np.float32)
    keep = {"block_diagonal": _vec_mask(L, 4),
            "random_with_empty_row": rng.uniform(size=(L, L)) < 0.5,
            "none": None}[mask]
    if mask == "random_with_empty_row":
        keep[3] = False
    jm = jattn.MultiheadAttention(embed_dims=C, num_heads=8)
    jmask = None if keep is None else jnp.asarray(keep)[None, None]
    params = perturbed_params(jm.init(jax.random.PRNGKey(0), q, query_pos=pos,
                                      attn_mask=jmask)["params"], 2)
    want = np.asarray(jm.apply({"params": params}, q, query_pos=pos, attn_mask=jmask))
    port = MultiheadAttention(C, 8).eval()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(q), query_pos=torch.from_numpy(pos),
                   attn_mask=None if keep is None else torch.from_numpy(keep))
    _close(got.numpy(), want, MODULE_TOL, mask)


def test_decoupled_decoder_layer_matches_flax():
    """One DecoupledMapDecoderLayer: 12 vectors of 4 points (4 one2one, 8
    one2many, under the block-diagonal mask) over an 8x8 BEV."""
    rng = np.random.default_rng(6)
    B, NV, P, C = 2, 12, 4, 32
    Q = NV * P
    q, pos = (rng.standard_normal((B, Q, C)).astype(np.float32) for _ in range(2))
    mem = rng.standard_normal((B, 64, C)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (B, Q, 2)).astype(np.float32)
    keep = _vec_mask(NV, 4)
    jl = jv2.DecoupledMapDecoderLayer(embed_dims=C, feedforward_channels=64,
                                      num_pts_per_vec=P)
    kw = dict(query_pos=pos, reference_points=ref, spatial_shapes=((8, 8),),
              vec_attn_mask=jnp.asarray(keep))
    params = perturbed_params(jl.init(jax.random.PRNGKey(0), q, mem, **kw)["params"], 3)
    want = np.asarray(jax.jit(lambda p: jl.apply({"params": p}, q, mem, **kw))(params))
    port = DecoupledMapDecoderLayer(C, feedforward_channels=64, num_pts_per_vec=P).eval()
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(q), torch.from_numpy(mem),
                   query_pos=torch.from_numpy(pos), reference_points=torch.from_numpy(ref),
                   spatial_shapes=((8, 8),), vec_attn_mask=torch.from_numpy(keep))
    _close(got.numpy(), want, MODULE_TOL, "decoupled layer")


@pytest.mark.parametrize("training", [False, True])
def test_v2_head_matches_flax(setup, training, monkeypatch):
    """The det + v2 map head on a BEV history and random image features:
    eval mode runs the one2one vectors alone, training mode all of them
    (JAX ``deterministic=False``, dropout the identity on both sides);
    every output, both segmentation heads' logits included."""
    _identity_dropout(monkeypatch)
    m = setup["cfg"].model
    rng = np.random.default_rng(8)
    B = 2
    feats = [rng.standard_normal((B, m.num_cams, 2, 3, m.embed_dims)).astype(np.float32)]
    prev = rng.standard_normal((B, m.bev_h * m.bev_w, m.embed_dims)).astype(np.float32)
    can_bus = setup["batch"]["can_bus"][:, -1]
    l2i = setup["batch"]["lidar2img"][:, -1]
    has_prev = np.ones((B,), np.float32)
    jhead = setup["jmodel"].head
    want = jax.jit(lambda p: jhead.apply(
        {"params": p}, feats, can_bus=can_bus, lidar2img=l2i, prev_bev=prev,
        has_prev=has_prev, deterministic=not training,
        rngs={"dropout": jax.random.PRNGKey(1)}))(setup["params"]["head"])
    head = build_head(setup["cfg"])
    head.load_state_dict(state_dict_from_flax(setup["params"]["head"]), strict=True)
    head = _no_dropout(head) if training else head.eval()
    with torch.no_grad():
        got = head([torch.from_numpy(f) for f in feats],
                   can_bus=torch.from_numpy(can_bus), lidar2img=torch.from_numpy(l2i),
                   prev_bev=torch.from_numpy(prev), has_prev=torch.from_numpy(has_prev))
    assert set(got) == set(want)
    nv = m.num_map_vec + (m.num_vec_one2many if training else 0)
    assert got["map_all_pts_preds"].shape == (m.map_decoder_layers, B, nv, m.map_num_pts, 2)
    assert got["pv_seg_logits"].shape == (B, m.num_cams, 2, 3)
    for k, w in want.items():
        _close(got[k].numpy(), w, HEAD_TOL, k)


# -------------------------------------------------------------- serving

def test_streaming_frames_match_jax(setup):
    jmodel, params, tcfg = setup["jmodel"], setup["params"], setup["cfg"]
    m = tcfg.model
    frames = tsyn.make_stream(tcfg, 3, seed=3, scene_change_at=(2,))
    step = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=JaxBEVFormer.forward_test_frame))
    state = JaxState()
    prev = jnp.zeros((1, m.bev_h * m.bev_w, m.embed_dims), jnp.float32)
    runner = StreamingRunner(tcfg, setup["model"].eval())
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
                "map_cls_scores": outs["map_all_cls_scores"][-1],
                "map_pts_preds": outs["map_all_pts_preds"][-1],
                "bev_seg_logits": outs["bev_seg_logits"],
                "pv_seg_logits": outs["pv_seg_logits"],
                "bev_embed": outs["bev_embed"]}
        assert set(got["outs"]) == set(want)
        assert want["map_cls_scores"].shape[1] == m.num_map_vec
        for k, w in want.items():
            _close(got["outs"][k].numpy(), w, STREAM_TOL, (t, k))
        assert got["map"]["vectors"].shape == (1, m.num_map_vec, m.map_num_pts, 2)


# -------------------------------------------------------------- training

def _jax_map_indices(outs, batch, m):
    """JAX's own assignment of the one2one vectors to the GT and of the
    one2many ones to the GT tiled k times, as (layer, batch, query, gt row,
    order) rows on the real GT rows; one2many queries after the one2one."""
    mgt = jmap.MapGT(batch["map_shift_pts"], batch["map_labels"],
                     batch["map_mask"], batch["map_order_mask"])
    k, o1 = m.map_k_one2many, m.num_map_vec
    many = jmap.MapGT(np.tile(mgt.shift_pts, (1, k, 1, 1, 1)),
                      np.tile(mgt.labels, (1, k)), np.tile(mgt.mask, (1, k)),
                      np.tile(mgt.order_mask, (1, k, 1)))
    rows = set()
    for g, lo, hi in ((mgt, 0, o1), (many, o1, None)):
        gt01 = jmap.normalize_pts(g.shift_pts, m.pc_range)
        for lyr in range(outs["map_all_cls_scores"].shape[0]):
            aq, order = jax.vmap(lambda c, p, g1, gl, gm, om: jmap._match_single(
                c, p, g1, gl, gm, om, 2.0, 5.0))(
                outs["map_all_cls_scores"][lyr, :, lo:hi],
                outs["map_all_pts_preds"][lyr, :, lo:hi],
                gt01, g.labels, g.mask, g.order_mask)
            for b, v in zip(*np.nonzero(np.asarray(g.mask))):
                rows.add((lyr, int(b), lo + int(aq[b, v]), int(v), int(order[b, v])))
    return rows


@pytest.fixture(scope="module")
def train_step(setup):
    mp = pytest.MonkeyPatch()
    _identity_dropout(mp)
    try:
        yield _train_step(setup)
    finally:
        mp.undo()


def _train_step(setup):
    tcfg, batch = setup["cfg"], setup["batch"]
    jmodel, params = setup["jmodel"], setup["params"]
    m = tcfg.model
    gt = jdet.DetGT(batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    mgt = jmap.MapGT(batch["map_shift_pts"], batch["map_labels"],
                     batch["map_mask"], batch["map_order_mask"])

    def jloss(p):
        outs = jmodel.apply({"params": p}, batch["img"], batch["can_bus"],
                            batch["lidar2img"], batch["has_prev"],
                            deterministic=False,
                            rngs={"dropout": jax.random.PRNGKey(1),
                                  "grid_mask": jax.random.PRNGKey(2)})
        losses = jdet.det_loss(outs["all_cls_scores"], outs["all_bbox_preds"],
                               gt, num_classes=m.num_classes)
        mlosses = jmap.map_loss_v2(
            outs["map_all_cls_scores"], outs["map_all_pts_preds"], mgt,
            pc_range=m.pc_range, num_vec_one2one=m.num_map_vec,
            k_one2many=m.map_k_one2many, lambda_one2many=m.map_lambda_one2many,
            num_classes=m.map_num_classes,
            bev_seg_logits=outs["bev_seg_logits"], gt_bev_seg=batch["gt_bev_seg"],
            pv_seg_logits=outs["pv_seg_logits"], gt_pv_seg=batch["gt_pv_seg"])
        total = losses.pop("loss_total") + mlosses.pop("loss_map_total")
        losses.update(mlosses)
        losses["loss_total"] = total
        return total, (losses, outs)

    (_, (jlosses, jouts)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)
    model = _no_dropout(setup["model"])
    tbatch = train_lib.batch_to_device(batch, "cpu")
    with torch.no_grad():  # the port's own matching of its own outputs
        outs = model(tbatch["img"], tbatch["can_bus"], tbatch["lidar2img"],
                     tbatch["has_prev"])
        indices = train_lib.match(outs, *train_lib.ground_truth(tbatch), tcfg)
    jdet_idx = set()
    gt_norm = jdet.normalize_bbox(gt.boxes)
    gt_norm = jnp.where(gt.mask[..., None],
                        jnp.nan_to_num(gt_norm, posinf=0.0, neginf=0.0), 0.0)
    for lyr in range(jouts["all_cls_scores"].shape[0]):
        aq = jax.vmap(lambda c, b, gn, gl, gm: jdet._match_single(
            c, b, gn, gl, gm, 2.0, 0.25))(
            jouts["all_cls_scores"][lyr], jouts["all_bbox_preds"][lyr], gt_norm,
            gt.labels, gt.mask)
        for b, r in zip(*np.nonzero(np.asarray(gt.mask))):
            jdet_idx.add((lyr, int(b), int(aq[b, r]), int(r)))
    jmap_idx = _jax_map_indices(jouts, batch, m)
    model.zero_grad(set_to_none=True)
    total, losses, _ = train_lib.loss_fn(
        model, tbatch, tcfg, indices=tuple(np.array(sorted(j), np.int64)
                                           for j in (jdet_idx, jmap_idx)))
    total.backward()
    return dict(
        cfg=tcfg, batch=batch, model=model, outs=outs, indices=indices,
        jindices=(jdet_idx, jmap_idx),
        jlosses={k: float(v) for k, v in jlosses.items()},
        losses={k: float(v.detach()) for k, v in losses.items()},
        jgrads=state_dict_from_flax(jax.tree.map(np.asarray, jgrads)))


def test_train_step_loss_terms_match_jax(train_step):
    want, got = train_step["jlosses"], train_step["losses"]
    m = train_step["cfg"].model
    L = m.map_decoder_layers
    # det cls, bbox per layer; map cls, pts, dir per layer, one2one and
    # one2many; the two segmentation terms; the total
    assert set(got) == set(want) and len(got) == 2 * 2 + 3 * L * 2 + 2 + 1
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_REL_TOL * max(abs(w), 1e-6), (k, got[k], w)
    for k in ("loss_map_pts_one2many", "loss_map_bev_seg", "loss_map_pv_seg"):
        assert want[k] > 0, k
    assert train_step["outs"]["map_all_cls_scores"].shape[2] == (
        m.num_map_vec + m.num_vec_one2many)


def test_train_step_indices_equal_jax(train_step):
    """The one2one rows equal JAX's; the one2many rows equal JAX's with
    the tiled GT row taken modulo V."""
    det, mp = train_step["indices"]
    want_det, want_map = train_step["jindices"]
    assert {tuple(int(x) for x in r) for r in det} == want_det
    b = train_step["batch"]
    V = b["map_mask"].shape[1]
    m = train_step["cfg"].model

    def modulo(rows):
        return {(lyr, bb, q, v % V, o) for lyr, bb, q, v, o in rows}

    got = {tuple(int(x) for x in r) for r in mp}
    assert modulo(got) == modulo(want_map)
    o1, k = m.num_map_vec, m.map_k_one2many
    n_real = int(b["map_mask"].sum())
    assert len(got) == m.map_decoder_layers * n_real * (1 + k)
    assert sum(r[2] >= o1 for r in got) == m.map_decoder_layers * n_real * k
    assert all(r[3] < V for r in got if r[2] < o1)
    assert any(r[3] >= V for r in got if r[2] >= o1)


def test_train_step_gradients_match_jax(train_step):
    """Every parameter's gradient within 1e-4 of its largest JAX magnitude
    (plus 1e-7 of the model's largest): the decoupled layers' inter-vector
    attention, both segmentation heads and the one2many rows of the
    instance embedding among them, each nonzero."""
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
    for k in ("head.map_layers.0.self_attn_vec.attn.query.weight",
              "head.map_layers.1.self_attn_pts.attn.value.weight",
              "head.bev_seg_head.Conv_0.weight", "head.pv_seg_head.Conv_1.weight",
              "head.map_reg_branches.0.Dense_2.weight"):
        assert float(got[k].abs().max()) > 0, k
    inst = got["head.map_instance_embedding"].abs().amax(-1)
    assert bool((inst[m.num_map_vec:] > 0).all()) and bool((inst[:m.num_map_vec] > 0).all())
