"""The port's model tools (``apollo_vision_net_tpu_torch/utils/debug.py``,
``tools/debug_shapes.py``, ``get_params.py``, ``profile_step.py``) against
the JAX package's (``apollo_vision_net_tpu/utils/debug.py``, root
``tools/``), on the CPU.

- Probes: ``bev_smoke_det_map`` on the same weights (drawn with numpy at
  flax's shapes, bridged) and inputs: the port's records are
  ``backbone.0``, ``neck.0``, ``encoder.bev_embed`` in the forward's order,
  JAX's the same names (its probes are unordered host callbacks of a
  jitted function, so they are matched by name), ``finite_ratio`` equal,
  ``max_abs`` and ``mean`` within 1e-4 relative. Disabled probes record
  nothing and the frame's outputs are bit-equal with and without them.
- ``debug_shapes``: inputs, parameter count and output names, shapes and
  dtypes of the queue forward on meta tensors equal JAX's ``eval_shape``
  of the same forward, for ``bev_smoke_det`` and the flagship at full width,
  in the JAX tool's (sorted) order.
- ``get_params``: the totals equal JAX's (``eval_shape`` of ``init``) for
  the flagship and ``bev_base_det_map`` at full width; the depth-1 groups
  equal JAX's tree mapped through the bridge at smoke size; the FLOPs of
  one encoder layer at smoke size equal a hand count of its dense products
  and its MSDA samples, exactly.
- ``profile_step`` on the CPU: the profiled smoke frame's plain MSDA calls
  equal the config's TSA + SCA + decoder layers; each of the four stages
  runs and returns its key.

tests/test_torch_tools_io.py holds the tools that run no model or only a
served frame: the weight import, the map evaluation, the log tools and the
visualizers.
"""
import contextlib
import functools
import io
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import base as jax_configs  # noqa: E402
from apollo_vision_net_tpu.data.synthetic import make_batch as jax_make_batch  # noqa: E402
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer  # noqa: E402
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model  # noqa: E402
from apollo_vision_net_tpu.utils import debug as jdebug  # noqa: E402
from apollo_vision_net_tpu_torch import configs as port_configs  # noqa: E402
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax  # noqa: E402
from apollo_vision_net_tpu_torch.data.synthetic import make_stream  # noqa: E402
from apollo_vision_net_tpu_torch.models.detector import (  # noqa: E402
    build_model,
    meta_model,
)
from apollo_vision_net_tpu_torch.models.encoder import BEVFormerLayer  # noqa: E402
from apollo_vision_net_tpu_torch.ops import cost  # noqa: E402
from apollo_vision_net_tpu_torch.tools import (  # noqa: E402
    debug_shapes,
    get_params,
    profile_step,
)
from apollo_vision_net_tpu_torch.utils import debug as tdebug  # noqa: E402
from test_torch_occ import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PROBE_REL_TOL = 1e-4


def port_tool_output(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(argv) == 0
    return out.getvalue()


def drawn_params(shapes, seed):
    """Weights at flax's shapes drawn with numpy: kernels at 1/sqrt(fan in),
    vectors at 0.1, BN variances and scales exp(0.1 N(0, 1)), so that a
    50-layer trunk keeps its activations near one."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['var']") or name.endswith("['scale']"):
            return np.exp(0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if len(s.shape) > 1:
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / math.sqrt(fan_in)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def frame_args(cfg, prev_tokens, seed=5):
    m = cfg.model
    f = make_stream(cfg, 1, seed=seed)[0]
    return (f["img"][None].astype(np.float32), np.zeros((1, 18), np.float32),
            f["lidar2img"][None].astype(np.float32),
            np.zeros((1, prev_tokens, m.embed_dims), np.float32),
            np.zeros((1,), np.float32))


@functools.lru_cache(maxsize=None)
def jax_frame_param_shapes(name):
    """flax's parameter shapes of the config's streaming step
    (``jax.eval_shape`` of ``init``)."""
    jcfg = getattr(jax_configs, name)()
    jmodel = jax_build_model(jcfg)
    m = jcfg.model
    H, W = m.img_shape
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in (
        (1, m.num_cams, H, W, 3), (1, 18), (1, m.num_cams, 4, 4),
        (1, jmodel.prev_tokens, m.embed_dims), (1,))]
    return jax.eval_shape(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame),
        {"params": jax.random.PRNGKey(0)}, *args)["params"]


def n_params(tree):
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(tree))


# ------------------------------------------------------------------ probes

def test_probe_records_equal_jax(monkeypatch):
    jcfg, tcfg = jax_configs.bev_smoke_det_map(), port_configs.bev_smoke_det_map()
    params = drawn_params(jax_frame_param_shapes("bev_smoke_det_map"), seed=1)
    jmodel = jax_build_model(jcfg)
    args = frame_args(tcfg, jmodel.prev_tokens)
    # JAX's probe sink is thread-local and its callbacks run on XLA's
    # threads: one shared state object lets capture_probes see them
    monkeypatch.setattr(jdebug, "_state", types.SimpleNamespace())
    with jdebug.capture_probes() as jrec:
        jax.block_until_ready(jax.jit(lambda p, *a: jmodel.apply(
            {"params": p}, *a, method=JaxBEVFormer.forward_test_frame))(params, *args))
        jax.effects_barrier()

    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    targs = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        plain, _ = model.forward_test_frame(*targs)
        with tdebug.capture_probes() as off:
            tdebug.enable_probes(False)
            quiet, _ = model.forward_test_frame(*targs)
        with tdebug.capture_probes() as trec:
            probed, _ = model.forward_test_frame(*targs)
    assert off.records == []
    for k in plain:
        assert torch.equal(plain[k], quiet[k]) and torch.equal(plain[k], probed[k]), k

    names = [r["name"] for r in trec.records]
    assert names == ["backbone.0", "neck.0", "encoder.bev_embed"]
    want = {r["name"]: r for r in jrec.records}
    assert sorted(want) == sorted(names) and len(jrec.records) == len(names)
    for r in trec.records:
        w = want[r["name"]]
        assert r["finite_ratio"] == w["finite_ratio"] == 1.0, r
        for k in ("max_abs", "mean"):
            assert abs(r[k] - w[k]) <= PROBE_REL_TOL * max(abs(w[k]), 1e-6), (r, w)


def test_probe_helpers():
    x = torch.tensor([1.0, -3.0, float("nan"), float("inf")])
    ratio, max_abs, mean = tdebug.finite_stats(x)
    assert (float(ratio), float(max_abs), float(mean)) == (0.5, 3.0, -1.0)
    assert tdebug.probe("x", x) is x
    with tdebug.capture_probes() as c:
        tdebug.probe("x", x)
    assert c.records == [{"name": "x", "finite_ratio": 0.5, "max_abs": 3.0, "mean": -1.0}]
    assert torch.equal(tdebug.sanitize(x, 10.0), torch.tensor([1.0, -3.0, 0.0, 10.0]))
    fn = tdebug.assert_all_finite(lambda t: {"a": [t, torch.ones(1)]})
    with pytest.raises(FloatingPointError, match=r"\['a'\]\[0\]"):
        fn(x)
    assert fn(torch.ones(2))["a"][1].item() == 1.0


# ------------------------------------------------------------ debug_shapes

@pytest.mark.parametrize("name", ["bev_smoke_det", "bev_tiny_det_map_apollo"])
def test_debug_shapes_equal_jax_eval_shape(name):
    cfg = getattr(jax_configs, name)()
    batch = jax.tree.map(jnp.asarray, jax_make_batch(cfg, 1, seed=0))
    jmodel = jax_build_model(cfg)
    fwd = (batch["img"], batch["can_bus"], batch["lidar2img"], batch["has_prev"])
    variables = {"params": jax_frame_param_shapes(name)}
    outs = jax.eval_shape(lambda v: jmodel.apply(v, *fwd, deterministic=True), variables)

    got = debug_shapes.trace_shapes(getattr(port_configs, name)())
    assert got["inputs"] == {k: (tuple(v.shape), str(v.dtype)) for k, v in batch.items()}
    assert got["params"] == n_params(variables["params"])
    assert got["outputs"] == {k: (tuple(v.shape), str(v.dtype))
                              for k, v in outs.items() if v is not None}
    # in the JAX tool's order: its pytrees sort the keys
    assert list(got["inputs"]) == sorted(batch) and list(got["outputs"]) == sorted(got["outputs"])
    if name == "bev_smoke_det":
        lines = port_tool_output(debug_shapes, [name]).splitlines()
        assert lines[0] == f"== {name} =="
        assert lines[1] == f"input {'can_bus':16s} {tuple(batch['can_bus'].shape)} float32"
        assert f"params: {got['params'] / 1e6:.2f} M" in lines
        assert lines[-1] == f"output {'bev_embed':22s} {got['outputs']['bev_embed'][0]} float32"


# -------------------------------------------------------------- get_params

@pytest.mark.parametrize("name", ["bev_tiny_det_map_apollo", "bev_base_det_map"])
def test_get_params_totals_equal_jax(name):
    total, _ = get_params.parameter_groups(meta_model(getattr(port_configs, name)()), 1)
    assert total == n_params(jax_frame_param_shapes(name))


def test_get_params_groups_equal_jax_bridged():
    want = {}
    for k, v in state_dict_from_flax(jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype),
            jax_frame_param_shapes("bev_smoke_det_map"))).items():
        g = k.split(".")[0]
        want[g] = want.get(g, 0) + v.numel()
    total, groups = get_params.parameter_groups(
        meta_model(port_configs.bev_smoke_det_map()), 1)
    assert groups == want and total == sum(want.values())
    assert set(groups) == {"img_backbone", "img_neck", "head"}


def test_encoder_layer_flops_equal_a_hand_count():
    m = port_configs.bev_smoke_det_map().model
    B, C, N, Q = 1, m.embed_dims, m.num_cams, m.bev_h * m.bev_w
    H, Pt, Ps, Dz, FF = 8, 4, 8, m.num_points_in_pillar, m.feedforward_channels
    h, w = m.img_shape[0] // 32, m.img_shape[1] // 32
    V = h * w
    with torch.device("meta"):
        layer = BEVFormerLayer(C, H, 1, Ps, Pt, N, FF,
                               bev_hw=(m.bev_h, m.bev_w)).requires_grad_(False)

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, device="meta", dtype=dtype)

    flops = get_params.count_flops(lambda: layer(
        meta(B, Q, C), meta(B, N, V, C), bev_pos=meta(B, Q, C),
        tsa_value=meta(B, 2, Q, C), tsa_refs=meta(B, 2, Q, 1, 2),
        bev_spatial_shapes=((m.bev_h, m.bev_w),), img_spatial_shapes=((h, w),),
        reference_points_cam=meta(N, B, Q, Dz, 2),
        bev_mask=meta(N, B, Q, Dz, dtype=torch.bool)))

    def dense(rows, k, n):
        return 2 * rows * k * n

    tsa = (dense(2 * B * Q, C, C) + dense(B * Q, 2 * C, 2 * H * Pt * 2)
           + dense(B * Q, 2 * C, 2 * H * Pt) + dense(B * Q, C, C))
    sca = (dense(B * N * V, C, C) + dense(B * Q, C, H * Ps * 2)
           + dense(B * Q, C, H * Ps) + dense(B * Q, C, C))
    ffn = dense(B * Q, C, FF) + dense(B * Q, FF, C)
    D = C // H
    assert flops["aten"] == tsa + sca + ffn
    # f32 over the 8x8 BEV and the 2x3 map: both calls on the map-resident
    # entry (msda_cuda.takes_resident)
    assert flops["kernels"] == {
        "msda_fwd_resident": (2 * B * Q) * H * 1 * Pt * 8 * D
        + (B * N * Q) * H * 1 * Ps * 8 * D}
    assert flops["kernels"]["msda_fwd_resident"] == (
        cost.msda_operations(2 * B * Q, H, 1, Pt, D)
        + cost.msda_operations(B * N * Q, H, 1, Ps, D))
    assert flops["total"] == flops["aten"] + sum(flops["kernels"].values())


def test_frame_flops_count_every_kernel_call():
    cfg = port_configs.bev_smoke_det_map()
    m = cfg.model
    flops = get_params.frame_flops(cfg)
    # f32 over the 8x8 BEV and the 2x3 map: every call on the map-resident
    # entry (msda_cuda.takes_resident)
    assert set(flops["kernels"]) == {"msda_fwd_resident"}
    assert flops["aten"] > 0
    # the decoders' cross-attention and TSA: one level, 4 points a head;
    # SCA: 8 points a head over every camera
    decoder = m.decoder_layers * m.num_query + m.map_decoder_layers * m.num_map_vec * m.map_num_pts
    tsa = m.encoder_layers * 2 * m.bev_h * m.bev_w
    sca = m.encoder_layers * m.num_cams * m.bev_h * m.bev_w
    D = m.embed_dims // 8
    assert flops["kernels"]["msda_fwd_resident"] == (
        cost.msda_operations(tsa + decoder, 8, 1, 4, D)
        + cost.msda_operations(sca, 8, 1, 8, D))


# ------------------------------------------------------------ profile_step

def test_profile_step_counts_the_plain_msda_calls_on_the_cpu():
    cfg = port_configs.bev_smoke_det_map()
    m = cfg.model
    model = build_model(cfg, device="cpu")
    frames = make_stream(cfg, 4, seed=2)
    got = profile_step.profile_frames(cfg, model, frames, n=2, top=5)
    assert "device_busy_ms_per_frame" not in got and got["cpu_self_ms_per_frame"] > 0
    assert got["plain_calls_per_frame"] == {
        "ms_deform_attn.plain": 2 * m.encoder_layers + m.decoder_layers + m.map_decoder_layers,
        "ms_deform_attn_factored.plain": 0, "modulated_deform_conv.plain": 0}
    assert len(got["top_cpu_self"]) == 5
    split = profile_step.stage_split(model, frames[0], frames=1)
    assert split["clock"] == "host (CPU run)"
    assert set(split["ms_per_frame"]) == set(profile_step.STAGES)
    assert all(t > 0 for t in split["ms_per_frame"].values())
    assert "residual_ms" in split
    # the CPU runs the plain versions: no kernel launches
    assert all(v == 0 for s in split["launches_per_frame"].values() for v in s.values())
    with pytest.raises(ValueError):
        profile_step.stage_split(model, frames[0], ["decoder"])


def test_profile_step_cli_on_the_cpu():
    out = port_tool_output(profile_step, [
        "bev_smoke_det", "--device", "cpu", "--frames", "1", "--top", "3",
        "--stages", "bb"])
    assert "frame (CPU run, host clock)" in out and "ms_deform_attn.plain 4" in out
    assert "backbone+neck" in out and "encoder+decoders" not in out
    assert "device busy" not in out
