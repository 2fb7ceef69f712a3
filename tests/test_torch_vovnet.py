"""VoVNet and the pretrained-backbone import of the port against the JAX
package.

- VoVNet V-39-eSE and V-99-eSE (stages 1-3) on a 64x96 input, f32: every
  stage's output and the gradients of every parameter and of the input
  under one cotangent (``jax.vjp`` of the trunk alone) within 1e-4 of
  their largest magnitude, on bridged weights (the trunk's flax tree drawn
  from a seed with numpy on ``jax.eval_shape``'s shapes: no init compile).
  The stride-2 max-pool with its partial last window matches flax's
  bottom/right -inf padding at odd and even sizes.
- ``bev_tiny_det`` with ``backbone_type="vovnet"`` (V-99, stage 3: 1024
  channels into one FPN level) has JAX's parameter count at full size, and
  a small copy (one encoder and one decoder layer) streams two frames (the second on the first's BEV) within
  1e-3 of JAX's ``forward_test_frame``.
- The import of mmdet/torch checkpoints (the JAX tests' torch modules in
  the reference naming: ResNet-50, ResNet with DCNv2 stages, DLA-34,
  VoVNet-39, FPN, and a full detector's ``img_backbone.`` / ``img_neck.``
  routing): the port's import gives tensors identical to JAX's import
  bridged by ``state_dict_from_flax``, the port's trunk then matches the
  torch module within 5e-4 (DCN: 1e-3, as the JAX test holds its own), a
  missing key raises with the list, and InternImage has no importer.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from apollo_vision_net_tpu.configs import base as jax_configs  # noqa: E402
from apollo_vision_net_tpu.data.temporal import StreamingState as JaxState  # noqa: E402
from apollo_vision_net_tpu.models import vovnet as jvov  # noqa: E402
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer  # noqa: E402
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model  # noqa: E402
from apollo_vision_net_tpu.utils import torch_import as jti  # noqa: E402
from apollo_vision_net_tpu_torch import configs as port_configs  # noqa: E402
from apollo_vision_net_tpu_torch import set_f32_precision  # noqa: E402
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from apollo_vision_net_tpu_torch.data.synthetic import make_stream  # noqa: E402
from apollo_vision_net_tpu_torch.models import detector  # noqa: E402
from apollo_vision_net_tpu_torch.models import vovnet as tvov  # noqa: E402
from apollo_vision_net_tpu_torch.models.detector import build_model  # noqa: E402
from apollo_vision_net_tpu_torch.runtime.inference import StreamingRunner  # noqa: E402
from apollo_vision_net_tpu_torch.utils import torch_import as tti  # noqa: E402
from test_import_weights import (  # noqa: E402
    TDla34,
    TFPN,
    TResNet,
    TVoVNet39,
    _randomize_bn,
)
from test_torch_occ import one_torch_thread  # noqa: E402,F401
from test_torch_r50 import SMALL, _jax_leaves  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_TOL = 1e-4
STREAM_TOL = 1e-3
IMPORT_TOL = 5e-4
PARAM_SEED = 2


def _rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def drawn_params(shapes, seed):
    """A flax param tree of ``shapes`` (ShapeDtypeStructs) drawn with numpy:
    kernels lecun-normal-like and moved by 10%, norm scales and BN
    variances exp(0.2 N), biases and means 0.1 N, other leaves N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        n = rng.standard_normal(s.shape).astype(np.float32)
        if name.endswith("['kernel']"):
            fan_in = int(np.prod(s.shape[:-1]))
            return n / np.sqrt(fan_in)
        if name.endswith("['scale']") or name.endswith("['var']"):
            return np.exp(0.2 * n)
        if name.endswith("['bias']") or name.endswith("['mean']"):
            return 0.1 * n
        return n

    return jax.tree_util.tree_map_with_path(draw, shapes)


# ---------------------------------------------------------------- VoVNet

@pytest.mark.parametrize("arch", ["V-39-eSE", "V-99-eSE"])
def test_vovnet_forward_and_gradients_match_flax(arch):
    """The weights are the draw at PARAM_SEED, where JAX's own gradients
    move by less than REL_TOL when the image moves by 1e-7 (checked here):
    at seed 1, V-39's stage-3 block 0 sits on a ReLU kink, and JAX's own
    gradient there jumps far beyond REL_TOL between the image and one
    1e-7 away."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 64, 96, 3)).astype(np.float32)
    fm = jvov.VoVNet(arch=arch, out_indices=(1, 2, 3))
    params = drawn_params(jax.eval_shape(fm.init, jax.random.PRNGKey(0), x)["params"],
                          seed=PARAM_SEED)
    shapes = jax.eval_shape(lambda p, xx: fm.apply({"params": p}, xx), params, x)
    cots = tuple(rng.standard_normal(o.shape).astype(np.float32) for o in shapes)

    @jax.jit
    def fwd_bwd(p, xx):
        outs, vjp = jax.vjp(lambda pp, x2: fm.apply({"params": pp}, x2), p, xx)
        return outs, vjp(cots)

    outs, (gp, gx) = fwd_bwd(params, x)
    want = state_dict_from_flax(jax.tree.map(np.asarray, gp))
    witness = x * (1 + 1e-7 * rng.standard_normal(x.shape)).astype(np.float32)
    moved = state_dict_from_flax(jax.tree.map(np.asarray, fwd_bwd(params, witness)[1][0]))
    assert max(_rel_err(moved[k], w) for k, w in want.items()) <= REL_TOL

    tm = tvov.VoVNet(arch=arch, out_indices=(1, 2, 3))
    tm.load_state_dict(state_dict_from_flax(params), strict=True)
    assert tm.out_channels() == [512, 768, 1024]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    touts = tm(xt)
    for o, t in zip(outs, touts):
        assert _rel_err(t.detach().permute(0, 2, 3, 1), o) <= REL_TOL
    torch.autograd.backward(touts, [torch.from_numpy(c).permute(0, 3, 1, 2)
                                    for c in cots])
    for name, p in tm.named_parameters():
        assert _rel_err(p.grad, want[name]) <= REL_TOL, name
    assert _rel_err(xt.grad.permute(0, 2, 3, 1), gx) <= REL_TOL


@pytest.mark.parametrize("hw", [(7, 9), (8, 10), (15, 25), (30, 50)])
def test_stride2_max_pool_matches_flax_padding(hw):
    x = np.random.default_rng(2).standard_normal((2, *hw, 3)).astype(np.float32)
    want = jax.jit(lambda v: jax.lax.reduce_window(  # flax's nn.max_pool
        v, -jnp.inf, jax.lax.max, (1, 3, 3, 1), (1, 2, 2, 1),
        ((0, 0), (0, 1), (0, 1), (0, 0))))(x)
    got = F.max_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, ceil_mode=True)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def vovnet_cfg(cfg, **sizes):
    """``bev_tiny_det`` on VoVNet V-99-eSE (JAX builds the V-99 trunk for
    ``backbone_type="vovnet"``), optionally at smaller sizes, f32."""
    m = dict(backbone_type="vovnet", **sizes)
    return dataclasses.replace(cfg, compute_dtype="float32" if sizes else cfg.compute_dtype,
                               model=dataclasses.replace(cfg.model, **m))


def test_full_size_vovnet_model_has_the_jax_parameter_count():
    tcfg = vovnet_cfg(port_configs.bev_tiny_det())
    params = _jax_leaves(vovnet_cfg(jax_configs.bev_tiny_det()))
    with torch.device("meta"):
        trunk, neck = detector.build_trunk(tcfg)
        meta = detector.BEVFormer(detector.build_head(tcfg), trunk, neck)
    assert isinstance(trunk, tvov.VoVNet) and trunk.out_channels() == [1024]
    assert sum(p.numel() for p in meta.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(params))
    state = state_dict_from_flax(jax.tree.map(
        lambda s: np.zeros(s.shape, np.float32), params))
    meta.load_state_dict(state, strict=True, assign=True)


def test_f32_precision_is_the_ports_own():
    """The card's f32 setting comes from the port: TF32 convolutions for a
    VoVNet model only, matmuls in full f32 always (PyTorch's default of
    TF32 convolutions is not kept)."""
    assert detector.conv_tf32(vovnet_cfg(port_configs.bev_tiny_det()))
    for cfg in (port_configs.bev_tiny_det(), port_configs.bev_tiny_det_map_apollo()):
        assert not detector.conv_tf32(cfg)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for tf32 in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = True
            set_f32_precision(tf32)
            assert torch.backends.cudnn.allow_tf32 is tf32
            assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_small_vovnet_bev_tiny_det_streams_as_jax():
    small = dict(SMALL, backbone_out_indices=(3,), encoder_layers=1,
                 decoder_layers=1)
    jcfg = vovnet_cfg(jax_configs.bev_tiny_det(), **small)
    tcfg = vovnet_cfg(port_configs.bev_tiny_det(), **small)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    m = tcfg.model
    frames = make_stream(tcfg, 2, seed=3)
    jmodel = jax_build_model(jcfg)
    Q = m.bev_h * m.bev_w
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        (1, m.num_cams, *m.img_shape, 3), (1, 18), (1, m.num_cams, 4, 4),
        (1, Q, m.embed_dims), (1,))]
    params = drawn_params(jax.eval_shape(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame),
        {"params": jax.random.PRNGKey(0)}, *args)["params"], seed=4)
    tmodel = build_model(tcfg, device="cpu")
    tmodel.load_state_dict(state_dict_from_flax(params), strict=True)
    step = jax.jit(lambda p, *a: jmodel.apply(
        {"params": p}, *a, method=JaxBEVFormer.forward_test_frame))
    state, prev = JaxState(), jnp.zeros((1, Q, m.embed_dims), jnp.float32)
    runner = StreamingRunner(tcfg, tmodel)
    for t, frame in enumerate(frames):
        cb, hp = state.prepare_frame(frame["can_bus"], frame["scene_token"])
        outs, prev = step(params, frame["img"][None], cb[None],
                          frame["lidar2img"][None], prev,
                          jnp.full((1,), hp, jnp.float32))
        state.update(prev)
        res = runner.step(frame)
        assert res["has_prev"] == hp == float(t)
        got = res["outs"]
        for k, w in (("cls_scores", outs["all_cls_scores"][-1]),
                     ("bbox_preds", outs["all_bbox_preds"][-1]),
                     ("bev_embed", outs["bev_embed"])):
            err = float(np.abs(got[k].numpy() - np.asarray(w)).max())
            assert err <= STREAM_TOL, (t, k, err)


# ----------------------------------------------------- pretrained import

def _jax_imported(fm, x, sd, kind):
    """JAX's import of ``sd`` into ``fm``'s tree (shapes from
    ``jax.eval_shape``), bridged to a torch state dict."""
    shapes = jax.eval_shape(fm.init, jax.random.PRNGKey(0), x)["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    tree, unused = jti.import_module_params(zeros, sd, kind)
    return state_dict_from_flax(tree), unused


def _import_case(name):
    """(torch reference module, port module, flax module, kind, input)."""
    from apollo_vision_net_tpu.models import dla as jdla
    from apollo_vision_net_tpu.models import fpn as jfpn
    from apollo_vision_net_tpu.models import resnet as jrn
    from apollo_vision_net_tpu_torch.models import dla as tdla
    from apollo_vision_net_tpu_torch.models import fpn as tfpn
    from apollo_vision_net_tpu_torch.models import resnet as trn

    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((1, 3, 64, 64)).astype(np.float32)
    if name == "resnet50":
        return TResNet(), trn.ResNet(50, (1, 2, 3)), jrn.ResNet(
            depth=50, out_indices=(1, 2, 3)), "resnet", x
    if name == "resnet_dcn":
        dcn = (False, False, True, True)
        return (TResNet(blocks=(1, 1, 1, 1), dcn_stages=(0, 0, 1, 1)),
                trn.ResNet(50, (1, 2, 3), dcn), jrn.ResNet(
                    depth=50, out_indices=(1, 2, 3), dcn_stages=dcn), "resnet", x)
    if name == "dla34":
        return TDla34(), tdla.DLA(out_indices=(3, 4, 5)), jdla.DLA(
            out_indices=(3, 4, 5)), "dla", x
    if name == "vovnet39":
        return (TVoVNet39(), tvov.VoVNet("V-39-eSE", (1, 2, 3)),
                jvov.VoVNet(arch="V-39-eSE", out_indices=(1, 2, 3)), "vovnet", x)
    feats = [rng.standard_normal((1, 32, 16, 16)).astype(np.float32),
             rng.standard_normal((1, 48, 8, 8)).astype(np.float32)]
    return (TFPN([32, 48], 64, 4), tfpn.FPN([32, 48], 64, num_outs=4),
            jfpn.FPN(out_channels=64, num_outs=4), "fpn", feats)


@pytest.mark.parametrize("name", ["resnet50", "resnet_dcn", "dla34", "vovnet39", "fpn"])
def test_import_equals_jax_import_bridged(name, monkeypatch):
    from apollo_vision_net_tpu.models import resnet as jrn
    from apollo_vision_net_tpu_torch.models import resnet as trn

    if name == "resnet_dcn":  # R50 block table cut to one block a stage
        monkeypatch.setitem(jrn._STAGE_BLOCKS, 50, (1, 1, 1, 1))
        monkeypatch.setitem(trn.STAGE_BLOCKS, 50, (1, 1, 1, 1))
    tm, pm, fm, kind, x = _import_case(name)
    _randomize_bn(tm)
    tm.eval()
    sd = tm.state_dict()
    if name == "fpn":
        xj = [jnp.asarray(f.transpose(0, 2, 3, 1)) for f in x]
    else:
        xj = jnp.asarray(x.transpose(0, 2, 3, 1))
    want, junused = _jax_imported(fm, xj, {k: v.numpy() for k, v in sd.items()}, kind)
    unused = tti.import_module_params(pm, sd, kind)
    assert unused == junused == []
    got = pm.state_dict()
    assert set(got) == set(want)
    for k, v in got.items():
        assert torch.equal(v, want[k]), k
    tol = 1e-3 if name == "resnet_dcn" else IMPORT_TOL
    with torch.no_grad():
        if name == "fpn":
            ref, out = tm([torch.from_numpy(f) for f in x]), pm([torch.from_numpy(f) for f in x])
        else:
            ref, out = tm(torch.from_numpy(x)), pm(torch.from_numpy(x))
    assert len(ref) == len(out)
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=tol, atol=tol)


def test_full_checkpoint_routing_and_strictness(tmp_path):
    """A full detector's checkpoint (``module.``-prefixed, in a
    ``state_dict`` container) into the port's DLA-34 + SECONDFPN model
    through ``apply_pretrained``: the backbone as JAX's import gives it; a
    bare dump's extra keys are returned unused; a ResNet-FPN model takes its neck from
    ``img_neck.``; a missing key raises with the list; InternImage has no
    importer."""
    from apollo_vision_net_tpu.models import dla as jdla

    tm = TDla34()
    _randomize_bn(tm)
    full = {f"module.img_backbone.{k}": v for k, v in tm.state_dict().items()}
    full["module.pts_bbox_head.query.weight"] = torch.zeros(4, 4)
    torch.save({"state_dict": full, "meta": {}}, tmp_path / "dla.pth")
    sd = tti.load_torch_state_dict(str(tmp_path / "dla.pth"))
    assert set(sd) == {k.removeprefix("module.") for k in full}
    jsd = jti.load_torch_state_dict(str(tmp_path / "dla.pth"))
    assert sd.keys() == jsd.keys()

    cfg = port_configs.bev_smoke_det_map()
    dla_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, backbone_type="dla", neck_type="secondfpn",
        backbone_out_indices=(3, 4, 5)))
    model = build_model(dla_cfg, device="cpu")
    logs = []
    tti.apply_pretrained(model, sd, "dla", log=logs.append)
    assert logs == []  # the head keys are outside the backbone's prefix
    bare = dict(tti.split_prefix(sd, "img_backbone"), **{"fc.weight": torch.zeros(2)})
    assert tti.import_module_params(model.img_backbone, bare, "dla") == ["fc.weight"]
    want, _ = _jax_imported(
        jdla.DLA(out_indices=(3, 4, 5)), jnp.zeros((1, 64, 64, 3)),
        jti.split_prefix(jsd, "img_backbone"), "dla")
    for k, v in model.img_backbone.state_dict().items():
        assert torch.equal(v, want[k]), k

    # ResNet + FPN: the neck from img_neck.
    tr, tn = TResNet(), TFPN([2048], cfg.model.embed_dims, 1)
    _randomize_bn(tr)
    res_sd = {f"img_backbone.{k}": v for k, v in tr.state_dict().items()}
    res_sd.update({f"img_neck.{k}": v for k, v in tn.state_dict().items()})
    res_model = build_model(cfg, device="cpu")
    tti.apply_pretrained(res_model, res_sd, "resnet", log=None)
    assert torch.equal(res_model.img_neck.lateral_0.weight,
                       tn.lateral_convs[0].conv.weight)
    assert torch.equal(res_model.img_backbone.layer4_2.bn3.running_var,
                       tr.layer4[2].bn3.running_var)

    del sd["img_backbone.level5.root.conv.weight"]
    with pytest.raises(KeyError, match="level5.root.conv.weight"):
        tti.apply_pretrained(model, sd, "dla", log=None)
    with pytest.raises(KeyError):
        tti.apply_pretrained(model, sd, "internimage", log=None)
