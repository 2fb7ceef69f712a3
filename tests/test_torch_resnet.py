"""The port's ResNet (with DCN stages) and FPN against the JAX package.

The base configs' trunk at a small size: the JAX table's depth 18 (two
Bottlenecks a stage), DCN in stages 3-4, outputs of stages 2-4 into an FPN
with 4 outputs (one extra stride-2 conv, no ReLU before it). Weights are
the flax init plus noise (so the zero-initialized offset convs predict
fractional offsets), bridged into the port with strict=True. All f32;
tolerance 1e-4 relative to each output's largest magnitude (~30 conv layers
of f32 sums in different orders).
"""
import jax
import numpy as np
import torch

from apollo_vision_net_tpu.models.fpn import FPN as JaxFPN
from apollo_vision_net_tpu.models.resnet import ResNet as JaxResNet
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.models.fpn import FPN
from apollo_vision_net_tpu_torch.models.resnet import CHANNELS, ResNet
from test_torch_backbone import assert_rel_close, nchw, perturbed

DCN = (False, False, True, True)
OUT = (1, 2, 3)


def test_resnet_dcn_and_fpn_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 64, 96, 3)).astype(np.float32)
    jres = JaxResNet(depth=18, out_indices=OUT, dcn_stages=DCN)
    rparams = perturbed(jax.jit(jres.init)(jax.random.PRNGKey(0), x)["params"], 1)
    jfeats = jax.jit(jres.apply)({"params": rparams}, x)
    jfpn = JaxFPN(out_channels=32, num_outs=4)
    fparams = perturbed(jax.jit(jfpn.init)(jax.random.PRNGKey(1), jfeats)["params"], 2)
    jouts = jax.jit(jfpn.apply)({"params": fparams}, jfeats)

    tres = ResNet(18, OUT, DCN)
    tres.load_state_dict(state_dict_from_flax(rparams), strict=True)
    tfpn = FPN([CHANNELS[i] for i in OUT], 32, num_outs=4)
    tfpn.load_state_dict(state_dict_from_flax(fparams), strict=True)
    assert "extra_conv_3.weight" in tfpn.state_dict()
    with torch.no_grad():
        tfeats = tres(nchw(x))
        touts = tfpn(tfeats)
    assert [tuple(f.shape) for f in tfeats] == [(2, 512, 8, 12), (2, 1024, 4, 6),
                                                (2, 2048, 2, 3)]
    assert [tuple(o.shape[2:]) for o in touts] == [(8, 12), (4, 6), (2, 3), (1, 2)]
    for g, w in zip(tfeats, jfeats):
        assert_rel_close(g, w)
    for g, w in zip(touts, jouts):
        assert_rel_close(g, w)


def test_fpn_relu_only_before_later_extra_convs():
    """With 2 laterals and 4 outputs, the first extra conv takes the last
    output as it is and the second its ReLU (the JAX condition
    ``len(outs) > len(laterals)``)."""
    rng = np.random.default_rng(3)
    feats = [rng.standard_normal(s).astype(np.float32)
             for s in ((1, 8, 10, 6), (1, 4, 5, 12))]
    jfpn = JaxFPN(out_channels=8, num_outs=4)
    params = perturbed(jax.jit(jfpn.init)(jax.random.PRNGKey(0), feats)["params"], 4)
    want = jax.jit(jfpn.apply)({"params": params}, feats)
    tfpn = FPN([6, 12], 8, num_outs=4)
    tfpn.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tfpn([nchw(f) for f in feats])
    assert [tuple(o.shape[2:]) for o in got] == [(8, 10), (4, 5), (2, 3), (1, 2)]
    for g, w in zip(got, want):
        assert_rel_close(g, w)


def test_base_model_init_and_sca_tiles():
    """build_model on a small bev_base_det_map: zero offset convs and conv
    biases, the DCN weight's truncated normal (variance scaling 2.0 over
    fan_out = 9·O), and SCA tiles of 128 over 4 levels (32 over one)."""
    import dataclasses
    import math

    from apollo_vision_net_tpu_torch.configs import bev_base_det_map
    from apollo_vision_net_tpu_torch.models.attention import SpatialCrossAttention
    from apollo_vision_net_tpu_torch.models.detector import build_model

    cfg = bev_base_det_map()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, bev_h=8, bev_w=8, embed_dims=32, encoder_layers=1,
        decoder_layers=1, map_decoder_layers=1, num_query=12, num_map_vec=5,
        map_num_pts=4, backbone_depth=18))
    model = build_model(cfg, device="cpu", seed=0)
    res = model.img_backbone
    dcn_blocks = [m for n, m in res.named_children() if n.startswith(("layer3", "layer4"))]
    assert len(dcn_blocks) == 4 and all(b.with_dcn for b in dcn_blocks)
    assert not any(b.with_dcn for n, b in res.named_children()
                   if n.startswith(("layer1", "layer2")))
    for b in dcn_blocks:
        assert not b.conv2_offset.weight.any() and not b.conv2_offset.bias.any()
        w = b.conv2_dcn_weight.detach()
        std = math.sqrt(2.0 / (9 * w.shape[2]))
        assert float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6
        assert abs(float(w.std()) / std - 1.0) < 0.1
    for name, mod in model.img_neck.named_children():
        assert not mod.bias.any(), name
    sca = model.head.transformer.encoder.layers[0].sca
    assert sca.q_tile == 128
    assert SpatialCrossAttention(32, num_levels=1).q_tile == 32
