"""The PyTorch port's streaming inference step against the JAX package.

A small copy of the flagship bev_tiny_det_map_apollo (DLA-34 + SECONDFPNV2
kept, 8×8 BEV, embed_dims 32, 2 cams at 64×96, 2 encoder and 2+2 decoder
layers, all f32) runs three streaming frames with one scene reset through
both ``BEVFormer.forward_test_frame`` implementations on the same bridged
weights (loaded with strict=True) and the same numpy inputs. On the CPU the
JAX package takes its exact XLA MSDA path and its space-to-depth DLA stem;
the port takes the plain PyTorch MSDA and the plain-conv stem. A small copy
of bev_base_det_map (the same sizes, with a depth-18 Bottleneck ResNet, DCN
in stages 3-4, a 4-level FPN and 4-level SCA on factored operands) runs the
same way; there the JAX DCN projects first and samples after, the port
samples first.

Tolerance 1e-3 max abs on every f32 output: the two sides differ only in
the order of f32 sums through ~30 layers (observed errors are at most
~2e-5, on the box outputs, whose centres are in meters).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import bev_base_det_map as jax_base
from apollo_vision_net_tpu.configs import bev_tiny_det_map_apollo as jax_flagship
from apollo_vision_net_tpu.data.temporal import StreamingState as JaxState
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.configs import (
    bev_base_det_map,
    bev_tiny_det_map_apollo,
)
from apollo_vision_net_tpu_torch.data.synthetic import make_stream
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.runtime.inference import (
    StreamingRunner,
    last_layer,
)

from test_torch_occ import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(bev_h=8, bev_w=8, embed_dims=32, num_cams=2, img_shape=(64, 96),
             encoder_layers=2, decoder_layers=2, map_decoder_layers=2,
             feedforward_channels=64, num_query=12, num_map_vec=5,
             map_num_pts=4, queue_length=2, transformer_dtype="float32",
             msda_impl="auto")
# the base trunk at the size of the ResNet test: two Bottlenecks a stage
SMALL_BASE = dict(SMALL, backbone_depth=18)
TOL = 1e-3


def small(cfg, sizes=SMALL):
    return dataclasses.replace(cfg, compute_dtype="float32",
                               model=dataclasses.replace(cfg.model, **sizes))


def perturbed_params(params, seed):
    """Random params: flax init plus noise, so that zero-initialized
    kernels (sampling offsets, attention weights) take part."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']"):
            return x * np.exp(0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, params)


def test_streaming_frames_match_jax():
    stream_against_jax(small(jax_flagship()), small(bev_tiny_det_map_apollo()))


def test_base_streaming_frames_match_jax():
    tcfg = small(bev_base_det_map(), SMALL_BASE)
    assert tcfg.model.num_feature_levels == 4
    assert tcfg.model.backbone_dcn_stages == (False, False, True, True)
    stream_against_jax(small(jax_base(), SMALL_BASE), tcfg)


def stream_against_jax(jcfg, tcfg):
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    m = tcfg.model
    frames = make_stream(tcfg, 3, seed=3, scene_change_at=(2,))

    jmodel = jax_build_model(jcfg)
    Q = m.bev_h * m.bev_w
    f0 = frames[0]
    init = jax.jit(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame))
    params = init(
        {"params": jax.random.PRNGKey(0)}, f0["img"][None],
        f0["can_bus"][None], f0["lidar2img"][None],
        jnp.zeros((1, Q, m.embed_dims)), jnp.zeros((1,)))["params"]
    params = perturbed_params(params, seed=1)

    tmodel = build_model(tcfg, device="cpu")
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
                "map_cls_scores": outs["map_all_cls_scores"][-1],
                "map_pts_preds": outs["map_all_pts_preds"][-1],
                "bev_embed": outs["bev_embed"]}
        assert set(got["outs"]) == set(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got["outs"][k].numpy()
            assert g.shape == w.shape, (k, g.shape, w.shape)
            err = float(np.abs(g - w).max())
            assert err <= TOL, (t, k, err)


def test_forward_test_frame_returns_outputs_and_carry():
    cfg = small(bev_tiny_det_map_apollo())
    m = cfg.model
    model = build_model(cfg, device="cpu", seed=2)
    f = make_stream(cfg, 1, seed=4)[0]
    with torch.no_grad():
        outs, new_prev = model.forward_test_frame(
            torch.as_tensor(f["img"])[None], torch.zeros((1, 18)),
            torch.as_tensor(f["lidar2img"])[None],
            torch.zeros((1, m.bev_h * m.bev_w, m.embed_dims)), torch.zeros(1))
    res = last_layer(outs)
    assert new_prev is outs["bev_embed"]
    assert res["cls_scores"].shape == (1, m.num_query, m.num_classes)
    assert res["bbox_preds"].shape == (1, m.num_query, m.code_size)
    assert res["map_pts_preds"].shape == (1, m.num_map_vec, m.map_num_pts, 2)
    assert all(bool(torch.isfinite(v).all()) for v in res.values())
