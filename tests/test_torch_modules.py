"""Each module of the port's streaming slice against its JAX counterpart.

Every flax module is initialized, its params are perturbed with numpy noise
(so zero-initialized kernels take part), bridged with
``state_dict_from_flax`` and loaded into the port's module with
strict=True; both run on the same numpy inputs in f32. Tolerances: 1e-5
absolute for single ops (summation order only), 1e-4 for stacks of layers
with LayerNorms (errors compound to ~1e-6..1e-5), 1e-3 relative for box
centres in meters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.models import attention as jatt
from apollo_vision_net_tpu.models.decoder import (
    DetectionTransformerDecoder as JaxDecoder,
)
from apollo_vision_net_tpu.models.encoder import BEVFormerEncoder as JaxEncoder
from apollo_vision_net_tpu.models.heads.map_head import (
    BEVFormerDetMapHead as JaxMapHead,
    get_map_results as jax_get_map_results,
)
from apollo_vision_net_tpu.models.pos_encoding import (
    LearnedPositionalEncoding as JaxPos,
)
from apollo_vision_net_tpu.ops import grid_sample as jgs
from apollo_vision_net_tpu.utils import box_coder as jbc
from apollo_vision_net_tpu.utils import geometry as jgeo
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.data.synthetic import camera_ring_lidar2img
from apollo_vision_net_tpu_torch.models import attention as tatt
from apollo_vision_net_tpu_torch.models.decoder import DetectionTransformerDecoder
from apollo_vision_net_tpu_torch.models.encoder import BEVFormerEncoder
from apollo_vision_net_tpu_torch.models.heads.map_head import (
    BEVFormerDetMapHead,
    get_map_results,
)
from apollo_vision_net_tpu_torch.models.pos_encoding import LearnedPositionalEncoding
from apollo_vision_net_tpu_torch.ops import grid_sample as tgs
from apollo_vision_net_tpu_torch.utils import box_coder as tbc
from apollo_vision_net_tpu_torch.utils import geometry as tgeo

C, H = 32, 4


def T(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def perturb(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x, np.float32)
        + 0.05 * rng.standard_normal(np.shape(x)).astype(np.float32), params)


def bridge(flax_mod, torch_mod, *args, seed=0, jit=False, **kwargs):
    """Init + perturb the flax module, load its params into the torch module
    (strict). Returns (params, torch_mod). ``jit`` compiles the init as one
    graph (all arguments must then be arrays)."""
    init = jax.jit(flax_mod.init) if jit else flax_mod.init
    params = init(jax.random.PRNGKey(seed), *args, **kwargs)["params"]
    params = perturb(params, seed)
    torch_mod.load_state_dict(state_dict_from_flax(params), strict=True)
    return params, torch_mod.eval()


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------- small ops

def test_grid_sample_and_rotate_match_jax():
    rng = np.random.default_rng(0)
    img = rng.standard_normal((2, 6, 7, 5)).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 3, 2)).astype(np.float32)
    want = jax.vmap(jgs.grid_sample_2d)(img, grid)
    close(tgs.grid_sample_2d(T(img), T(grid)), want, 1e-5)
    angles = np.array([17.0, -3.5], np.float32)
    close(tgs.rotate_2d(T(img), T(angles)), jax.vmap(jgs.rotate_2d)(img, angles), 1e-5)


def test_geometry_matches_jax():
    np.testing.assert_array_equal(tgeo.bev_reference_points_3d(5, 6, 8.0, 4),
                                  jgeo.bev_reference_points_3d(5, 6, 8.0, 4))
    np.testing.assert_array_equal(tgeo.bev_reference_points_2d(5, 6),
                                  jgeo.bev_reference_points_2d(5, 6))
    for args in ((50, 50, 8, 4), (7, 9, 8, 16)):
        for a, b in zip(tgeo.spatial_block_order(*args),
                        jgeo.spatial_block_order(*args)):
            np.testing.assert_array_equal(a, b)
    pc = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    ref3d = jgeo.bev_reference_points_3d(10, 10, 8.0, 4)
    l2i = camera_ring_lidar2img(6, 48, 80)
    want_ref, want_mask = jgeo.point_sampling(ref3d, pc, l2i, (48, 80))
    got_ref, got_mask = tgeo.point_sampling(T(ref3d), pc, T(l2i)[None], (48, 80))
    # points behind a camera project far out (depth clamped at 1e-5)
    close(got_ref[0], want_ref, 1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got_mask[0].numpy(), np.asarray(want_mask))
    assert 0 < int(got_mask.sum()) < got_mask.numel()
    rng = np.random.default_rng(1)
    can_bus = rng.normal(0, 1, (3, 18)).astype(np.float32)
    want = jax.vmap(lambda cb: jgeo.bev_shift_from_can_bus(cb, (2.0, 2.0), 50, 50))(can_bus)
    close(tgeo.bev_shift_from_can_bus(T(can_bus), (2.0, 2.0), 50, 50), want, 1e-6)


def test_box_coder_matches_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 2, (30, 10)).astype(np.float32)
    boxes = rng.normal(0, 20, (30, 10)).astype(np.float32)
    boxes[:, [2, 3, 5]] = rng.normal(0, 0.5, (30, 3))  # log sizes
    want = jbc.nms_free_decode(logits, boxes, (-30, -30, -10, 30, 30, 10), max_num=20)
    got = tbc.nms_free_decode(T(logits), T(boxes), (-30, -30, -10, 30, 30, 10), max_num=20)
    close(got.scores, want.scores, 1e-6)
    close(got.boxes, want.boxes, 1e-5, rtol=1e-5)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert 0 < int(got.valid.sum()) < 20
    x = rng.uniform(-0.1, 1.1, (50,)).astype(np.float32)
    close(tbc.inverse_sigmoid(T(x)), jbc.inverse_sigmoid(x), 1e-5)


def test_grid_offset_bias_and_pos_encoding_match_jax():
    np.testing.assert_array_equal(tatt.grid_offset_bias(8, 2, 4),
                                  jatt.grid_offset_bias(8, 2, 4))
    jmod = JaxPos(num_feats=8, row_num_embed=5, col_num_embed=6)
    params, tmod = bridge(jmod, LearnedPositionalEncoding(8, 5, 6), 5, 6)
    close(tmod(5, 6), jmod.apply({"params": params}, 5, 6), 0)


# ---------------------------------------------------------- attention modules

def test_temporal_self_attention_matches_jax():
    rng = np.random.default_rng(3)
    B, h, w = 2, 6, 5
    Q = h * w
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    value = rng.standard_normal((B, 2, Q, C)).astype(np.float32)
    pos = rng.standard_normal((B, Q, C)).astype(np.float32)
    refs = rng.uniform(0, 1, (B, 2, Q, 1, 2)).astype(np.float32)
    jmod = jatt.TemporalSelfAttention(embed_dims=C, num_heads=H)
    kw = dict(query_pos=pos, reference_points=refs, spatial_shapes=((h, w),))
    params, tmod = bridge(jmod, tatt.TemporalSelfAttention(C, H), query, value, **kw)
    want = jmod.apply({"params": params}, query, value, **kw)
    got = tmod(T(query), T(value), query_pos=T(pos), reference_points=T(refs),
               spatial_shapes=((h, w),))
    close(got, want, 1e-5)


@pytest.mark.parametrize("bev_hw", [(6, 5), None])
def test_spatial_cross_attention_matches_jax(bev_hw):
    """With bev_hw: 8x4 block permutation + per-(camera, tile) mask; without:
    row-major queries, no mask. Both equal the JAX module."""
    rng = np.random.default_rng(4)
    B, N, Q, Dz, fh, fw = 2, 2, 30, 4, 4, 6
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    value = rng.standard_normal((B, N, fh * fw, C)).astype(np.float32)
    ref_cam = rng.uniform(-0.1, 1.1, (N, B, Q, Dz, 2)).astype(np.float32)
    bev_mask = rng.random((N, B, Q, Dz)) > 0.6
    bev_mask[:, :, :8] = False  # queries no camera sees: hit count 0
    jmod = jatt.SpatialCrossAttention(embed_dims=C, num_cams=N, num_heads=H,
                                      bev_hw=bev_hw)
    kw = dict(query_pos=None, reference_points_cam=ref_cam, bev_mask=bev_mask,
              spatial_shapes=((fh, fw),))
    params, tmod = bridge(jmod, tatt.SpatialCrossAttention(
        C, N, H, bev_hw=bev_hw), query, value, **kw)
    want = jmod.apply({"params": params}, query, value, **kw)
    got = tmod(T(query), T(value), query_pos=None,
               reference_points_cam=T(ref_cam), bev_mask=T(bev_mask),
               spatial_shapes=((fh, fw),))
    close(got, want, 1e-5)


def test_decoder_cross_attention_mha_and_ffn_match_jax():
    rng = np.random.default_rng(5)
    B, Q, h, w = 2, 9, 5, 6
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    pos = rng.standard_normal((B, Q, C)).astype(np.float32)
    memory = rng.standard_normal((B, h * w, C)).astype(np.float32)
    ref = rng.uniform(0, 1, (B, Q, 2)).astype(np.float32)
    jmod = jatt.CustomMSDeformableAttention(embed_dims=C, num_heads=H)
    kw = dict(query_pos=pos, reference_points=ref, spatial_shapes=((h, w),))
    params, tmod = bridge(jmod, tatt.CustomMSDeformableAttention(C, H),
                          query, memory, **kw)
    got = tmod(T(query), T(memory), query_pos=T(pos), reference_points=T(ref),
               spatial_shapes=((h, w),))
    close(got, jmod.apply({"params": params}, query, memory, **kw), 1e-5)

    jmha = jatt.MultiheadAttention(embed_dims=C, num_heads=H)
    params, tmha = bridge(jmha, tatt.MultiheadAttention(C, H), query, query_pos=pos)
    close(tmha(T(query), query_pos=T(pos)),
          jmha.apply({"params": params}, query, query_pos=pos), 1e-5)

    jffn = jatt.FFN(embed_dims=C, feedforward_channels=48)
    params, tffn = bridge(jffn, tatt.FFN(C, 48), query)
    close(tffn(T(query)), jffn.apply({"params": params}, query), 1e-5)


# ------------------------------------------------------ encoder, decoder, head

def test_encoder_matches_jax():
    """Two samples, one with history and one without (the has_prev blend),
    shifted refs aliased into the current stream."""
    rng = np.random.default_rng(6)
    B, N, bh, bw, fh, fw, Dz = 2, 2, 6, 5, 4, 6, 4
    Q = bh * bw
    args = dict(
        bev_pos=rng.standard_normal((B, Q, C)).astype(np.float32),
        prev_bev=rng.standard_normal((B, Q, C)).astype(np.float32),
        has_prev=np.array([1.0, 0.0], np.float32),
        shift=rng.normal(0, 0.05, (B, 2)).astype(np.float32),
        ref_2d=jgeo.bev_reference_points_2d(bh, bw),
        reference_points_cam=rng.uniform(-0.1, 1.1, (N, B, Q, Dz, 2)).astype(np.float32),
        bev_mask=rng.random((N, B, Q, Dz)) > 0.5,
    )
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    img = rng.standard_normal((B, N, fh * fw, C)).astype(np.float32)
    static = dict(bev_h=bh, bev_w=bw, img_spatial_shapes=((fh, fw),))
    jmod = JaxEncoder(num_layers=2, embed_dims=C, num_cams=N, feedforward_channels=48)
    tmod = BEVFormerEncoder(2, C, num_cams=N, feedforward_channels=48, bev_hw=(bh, bw))
    jargs = {k: jnp.asarray(v) for k, v in args.items()}
    params, tmod = bridge(jmod, tmod, query, img, **jargs, **static)
    want = jmod.apply({"params": params}, query, img, **jargs, **static)
    got = tmod(T(query), T(img), **{k: T(v) for k, v in args.items()}, **static)
    close(got, want, 1e-4)


@pytest.mark.parametrize("ref_mode,code_size,R,groups", [
    ("det3d", 10, 3, 1), ("map2d", 2, 2, 1), ("det3d", 10, 3, 3)])
def test_decoder_matches_jax(ref_mode, code_size, R, groups):
    """Both refinement modes; Group-DETR self-attention in 3 groups."""
    rng = np.random.default_rng(7)
    B, Q, h, w = 1, 12, 5, 6
    query = rng.standard_normal((B, Q, C)).astype(np.float32)
    memory = rng.standard_normal((B, h * w, C)).astype(np.float32)
    pos = rng.standard_normal((B, Q, C)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (B, Q, R)).astype(np.float32)
    kw = dict(query_pos=pos, reference_points=ref, spatial_shapes=((h, w),))
    jmod = JaxDecoder(num_layers=2, embed_dims=C, feedforward_channels=48,
                      code_size=code_size, ref_mode=ref_mode,
                      self_attn_groups=groups)
    tmod = DetectionTransformerDecoder(2, C, feedforward_channels=48,
                                       self_attn_groups=groups,
                                       code_size=code_size, ref_mode=ref_mode)
    params, tmod = bridge(jmod, tmod, query, memory, **kw)
    want = jmod.apply({"params": params}, query, memory, **kw)
    got = tmod(T(query), T(memory), query_pos=T(pos), reference_points=T(ref),
               spatial_shapes=((h, w),))
    for g, wnt in zip(got, want):
        close(g, wnt, 1e-4)


def test_det_map_head_matches_jax():
    """Transformer (can_bus MLP, prev_bev rotation, cam/level embeds,
    encoder, det decoder) + det head box decoding + map branch, all layers;
    then get_map_results on the last layer."""
    rng = np.random.default_rng(8)
    B, N, bh, bw, fh, fw = 1, 2, 6, 6, 4, 6
    img_shape = (64, 96)
    cfg = dict(bev_h=bh, bev_w=bw, num_query=10, embed_dims=C,
               img_shape=img_shape, num_cams=N, encoder_layers=1,
               decoder_layers=2, feedforward_channels=48)
    feats = [rng.standard_normal((B, N, fh, fw, C)).astype(np.float32)]
    can_bus = rng.normal(0, 0.5, (B, 18)).astype(np.float32)
    can_bus[:, -1] = 7.0  # yaw delta (deg): a visible prev_bev rotation
    l2i = camera_ring_lidar2img(N, *img_shape)[None]
    prev = rng.standard_normal((B, bh * bw, C)).astype(np.float32)
    hp = np.ones((B,), np.float32)
    jmod = JaxMapHead(num_map_vec=3, map_num_pts=4, map_decoder_layers=2,
                      transformer_dtype="float32", **cfg)
    tmod = BEVFormerDetMapHead(num_map_vec=3, map_num_pts=4,
                               map_decoder_layers=2, **cfg)
    kw = dict(can_bus=can_bus, lidar2img=l2i, prev_bev=prev, has_prev=hp)
    params, tmod = bridge(jmod, tmod, feats, jit=True, **kw)
    want = jax.jit(jmod.apply)({"params": params}, feats, **kw)
    with torch.no_grad():
        got = tmod([T(feats[0])], **{k: T(v) for k, v in kw.items()})
    assert set(got) == set(want)
    for k in want:
        scale = float(np.abs(want[k]).max()) if k == "all_bbox_preds" else 1.0
        close(got[k], want[k], 1e-4 * max(scale, 1.0))
    pc = (-50.0, -50.0, -5.0, 50.0, 50.0, 3.0)
    jr = jax_get_map_results(want["map_all_cls_scores"][-1],
                             want["map_all_pts_preds"][-1], pc)
    tr = get_map_results(got["map_all_cls_scores"][-1],
                         got["map_all_pts_preds"][-1], pc)
    close(tr["vectors"], jr["vectors"], 1e-3)
    close(tr["scores"], jr["scores"], 1e-5)
    np.testing.assert_array_equal(tr["labels"].numpy(), np.asarray(jr["labels"]))
