"""InternImage and DCNv3 of the port against the JAX package (CPU, where JAX
takes its exact XLA MSDA path and the port the plain PyTorch MSDA).

- ``dcnv3_core`` and its gradients (value, offset, mask) against
  ``jax.vjp`` at three shapes, G >= 2, offsets of 1-3 px that cross the
  borders: output within 1e-5 max abs, each gradient within 1e-5 of its
  largest element; the tap grid equal to JAX's ``_kernel_grid``, the
  locations equal to JAX's expression, and the per-size grids cached
  outside inference mode.
- One ``InternImageLayer`` and a small ``InternImage`` (channels 16, depths
  (1, 1, 2, 1), groups (1, 2, 4, 8): 16 channels a group as InternImage-S
  has; 64x96 images) on flax weights bridged with ``strict=True``, with
  seeded noise on every weight and ~1-2 px of offsets from the
  zero-initialized ``offset`` and ``mask`` layers: f32 features within 1e-4
  of each output's largest magnitude (stem, 5 blocks of DCNv3 + MLP, 3
  downsamplings; f32 sums in other orders).
- The same small InternImage in bf16 on both sides: the features are f32
  (the LayerNorms promote to their f32 params), within BF16_REL_TOL.
- Zero stem biases and a blanked stripe: the gradient overflows in the
  port where it overflows in JAX.
- The bridge at full InternImage-S size (``jax.eval_shape`` leaves filled
  with numpy randoms, nothing computed), ``strict=True``, the depthwise
  kernel's layout, and every parameter's optimizer label equal to the JAX
  rule's label of its flax leaf.
- A small ``bev_tiny_occ_intern_s`` (InternImage-S at full depth on 2 cams
  at 64x96, 8x8 BEV, a 32x32x4 grid, f32): three streamed frames with a
  scene reset against ``forward_test_frame`` within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import base as jax_configs
from apollo_vision_net_tpu.models import internimage as jii
from apollo_vision_net_tpu.ops import dcnv3 as jdcn
from apollo_vision_net_tpu.parallel import optim as jopt
from apollo_vision_net_tpu_torch import configs as port_configs
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.models import internimage as tii
from apollo_vision_net_tpu_torch.ops import dcnv3 as tdcn
from apollo_vision_net_tpu_torch.parallel.optim import param_label
from test_torch_occ import one_torch_thread  # noqa: F401
from test_torch_r50 import small, stream_against_jax

# torch on one thread (see test_torch_occ.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

DCN_TOL = 1e-5
REL_TOL = 1e-4
# bf16 against bf16: the same bf16 roundings of the convs' and projections'
# inputs and outputs, but XLA's and PyTorch's bf16 GEMMs, GELUs and
# reductions round at other points, and a rounding moves a value by 2^-8 of
# itself; after 5 blocks and 3 downsamplings the features read 1.6e-2,
# 2.0e-2 and 1.7e-2 of their largest magnitude (f32: 0.9-1.3e-6)
BF16_REL_TOL = 5e-2
SMALL_II = dict(channels=16, depths=(1, 1, 2, 1), groups=(1, 2, 4, 8),
                out_indices=(1, 2, 3))


def _np(x):
    return np.asarray(x, np.float32)


def noised(params, seed, scale=0.05):
    """flax init plus noise; the zero-initialized ``offset`` and ``mask``
    kernels get N(0, 1.5 / fan_in) (1-2 px offsets on the unit-scale
    ``dw_norm`` output) and their biases N(0, 0.5)."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = _np(x)
        keys = [str(getattr(k, "key", k)) for k in path]
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if len(keys) >= 2 and keys[-2] in ("offset", "mask"):
            s = 1.5 / np.sqrt(x.shape[0]) if keys[-1] == "kernel" else 0.5
            return x + s * noise
        return x + scale * noise

    return jax.tree_util.tree_map_with_path(f, params)


def _rel_err(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


# ------------------------------------------------------------------ DCNv3

def test_kernel_grid_equals_jax():
    """The port's tap grid, formed on the device, is JAX's 3x3 grid at
    dilation 1, the only one InternImage uses."""
    np.testing.assert_array_equal(tdcn.tap_grid("cpu").numpy(),
                                  jdcn._kernel_grid(3, 3, 1, 1))


@pytest.mark.parametrize("H, W", [(5, 7), (6, 4)])
def test_sampling_locations_equal_jax_formula(H, W):
    """Locations from the cached grids equal JAX's f32 expression
    ``p0 + (grid + offset) / [W, H]`` bit for bit, the same association."""
    off = np.random.default_rng(H).standard_normal((2, H, W, 3, 9, 2)).astype(np.float32)
    ys = (np.arange(H, dtype=np.float32) + 0.5) / np.float32(H)
    xs = (np.arange(W, dtype=np.float32) + 0.5) / np.float32(W)
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    p0 = np.stack([gx.reshape(-1), gy.reshape(-1)], -1)
    norm = np.asarray([W, H], np.float32)
    want = (p0[None, :, None, None] + (jdcn._kernel_grid(3, 3, 1, 1)
                                       + off.reshape(2, H * W, 3, 9, 2)) / norm)
    got = tdcn.sampling_locations(torch.from_numpy(off))
    assert got.shape == (2, H * W, 3, 1, 9, 2) and got.is_contiguous()
    np.testing.assert_array_equal(got[:, :, :, 0].numpy(), want)


def test_grids_cached_in_inference_mode_serve_a_later_backward():
    """A served frame (inference mode) caches a size's grids; a training
    step at that size then saves them for its backward."""
    rng = np.random.default_rng(7)
    H, W = 4, 3
    v = rng.standard_normal((1, H, W, 2, 4)).astype(np.float32)
    off = rng.standard_normal((1, H, W, 2, 9, 2)).astype(np.float32)
    m = np.full((1, H, W, 2, 9), 1 / 9, np.float32)
    tdcn._GRIDS.pop((H, W, torch.device("cpu")), None)
    with torch.inference_mode():
        served = tdcn.dcnv3_core(*map(torch.from_numpy, (v, off, m)))
    cached = tdcn._GRIDS[(H, W, torch.device("cpu"))]
    ins = [torch.tensor(a, requires_grad=True) for a in (v, off, m)]
    out = tdcn.dcnv3_core(*ins)
    assert tdcn._GRIDS[(H, W, torch.device("cpu"))] is cached
    np.testing.assert_array_equal(out.detach().numpy(), served.numpy())
    grads = torch.autograd.grad(out.square().sum(), ins)
    assert all(bool(torch.isfinite(g).all()) and g.abs().sum() > 0 for g in grads)


@pytest.mark.parametrize("B, H, W, G, Dg, off_px", [
    (2, 5, 7, 2, 4, 1.0), (1, 6, 4, 3, 16, 3.0), (3, 3, 9, 5, 8, 2.0)])
def test_dcnv3_core_and_gradients_match_jax(B, H, W, G, Dg, off_px):
    rng = np.random.default_rng(H * W + G)
    K = 9
    v = rng.standard_normal((B, H, W, G, Dg)).astype(np.float32)
    off = (rng.standard_normal((B, H, W, G, K, 2)) * off_px).astype(np.float32)
    m = rng.random((B, H, W, G, K)).astype(np.float32)
    m = m / m.sum(-1, keepdims=True)
    # some taps of border pixels land outside the image
    assert np.abs(off).max() > 2.0

    want, vjp = jax.vjp(lambda *a: jdcn.dcnv3_core(*a), v, off, m)
    ins = [torch.tensor(a, requires_grad=True) for a in (v, off, m)]
    got = tdcn.dcnv3_core(*ins)
    assert got.shape == (B, H, W, G * Dg)
    assert float(np.abs(got.detach().numpy() - _np(want)).max()) <= DCN_TOL
    g = rng.standard_normal(got.shape).astype(np.float32)
    for name, a, b in zip(("value", "offset", "mask"),
                          torch.autograd.grad(got, ins, torch.from_numpy(g)),
                          vjp(g)):
        assert _rel_err(a, b) <= DCN_TOL, name


# ------------------------------------------------------- layer and trunk

def test_internimage_layer_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 6, 9, 32)).astype(np.float32)
    jmod = jii.InternImageLayer(channels=32, groups=2)
    params = noised(jax.jit(jmod.init)(jax.random.PRNGKey(0), x)["params"], 1)
    want = jax.jit(jmod.apply)({"params": params}, x)
    tmod = tii.InternImageLayer(32, 2)
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert _rel_err(got, want) <= REL_TOL


@pytest.fixture(scope="module")
def small_trunk():
    """The small InternImage's noised flax params and a 2-image input."""
    x = np.random.default_rng(2).standard_normal((2, 64, 96, 3)).astype(np.float32)
    jmod = jii.InternImage(**SMALL_II)
    params = noised(jax.jit(jmod.init)(jax.random.PRNGKey(0), x)["params"], 3)
    return x, params


def _trunks(params, x, jdtype, tdtype):
    want = jax.jit(jii.InternImage(**SMALL_II, dtype=jdtype).apply)(
        {"params": params}, x)
    tmod = tii.InternImage(**SMALL_II, dtype=tdtype)
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    return got, want


def test_small_internimage_matches_jax(small_trunk):
    x, params = small_trunk
    got, want = _trunks(params, x, jnp.float32, torch.float32)
    assert [tuple(g.shape) for g in got] == [(2, 32, 8, 12), (2, 64, 4, 6),
                                             (2, 128, 2, 3)]
    for g, w in zip(got, want):
        assert _rel_err(g.permute(0, 2, 3, 1), w) <= REL_TOL


def test_small_internimage_bf16_features_are_f32_as_in_jax(small_trunk):
    """In the bf16 config the features stay f32 on both sides: every
    LayerNorm promotes to its f32 params, so the residual stream is f32
    from the stem on; only the convs and projections compute in bf16."""
    x, params = small_trunk
    got, want = _trunks(params, x, jnp.bfloat16, torch.bfloat16)
    for g, w in zip(got, want):
        assert w.dtype == jnp.float32 and g.dtype == torch.float32
        assert _rel_err(g.permute(0, 2, 3, 1), w) <= BF16_REL_TOL


def test_zero_stem_biases_over_a_blanked_stripe_overflow_as_in_jax():
    """flax's zero conv biases and a blanked (grid-masked) stripe: every
    LayerNorm inside the stripe normalizes a zero vector, whose backward
    gain is 1/sqrt(1e-6) = 1,000, and the gradient overflows. JAX's trunk
    does so too: the same parameters get non-finite gradients on both
    sides, the stem convs' among them. Without the stripe both are finite
    and agree."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 64, 192, 3)).astype(np.float32)
    jmod = jii.InternImage(**SMALL_II)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), x)["params"]
    tmod = tii.InternImage(**SMALL_II)
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    names = [n for n, _ in tmod.named_parameters()]
    cots = [rng.standard_normal((1, 64 // s, 192 // s, 16 * s // 4)).astype(np.float32)
            for s in (8, 16, 32)]
    jax_grads = jax.jit(lambda xx: jax.vjp(
        lambda p: jmod.apply({"params": p}, xx), params)[1](tuple(cots))[0])
    for blank in (False, True):
        if blank:
            x[:, :, :160] = 0.0  # 5 of stage 3's 6 columns
        want = state_dict_from_flax(jax_grads(x))
        tgrads = torch.autograd.grad(
            tmod(torch.from_numpy(x).permute(0, 3, 1, 2)), list(tmod.parameters()),
            [torch.from_numpy(c).permute(0, 3, 1, 2) for c in cots])
        bad = {n for n, g in zip(names, tgrads) if not bool(torch.isfinite(g).all())}
        assert bad == {n for n in names if not np.isfinite(want[n].numpy()).all()}
        if blank:
            assert {f"stem{i}.{p}" for i in (1, 2) for p in ("weight", "bias")} <= bad
        else:
            assert not bad
            for n, g in zip(names, tgrads):
                assert _rel_err(g, want[n]) <= REL_TOL, n


# --------------------------------------------- full-size bridge and labels

@pytest.fixture(scope="module")
def intern_s_leaves():
    """InternImage-S's flax leaves (``jax.eval_shape``; the parameter shapes
    do not depend on the image size) filled with numpy randoms."""
    shapes = jax.eval_shape(jii.InternImage(out_indices=(1, 2, 3)).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32),
        shapes["params"])


def test_bridge_loads_internimage_s_at_full_size(intern_s_leaves):
    tmod = tii.InternImage(out_indices=(1, 2, 3))
    state = state_dict_from_flax(intern_s_leaves)
    tmod.load_state_dict(state, strict=True)
    assert sum(k.endswith("dcn.offset.weight") for k in state) == 4 + 4 + 21 + 4
    # depthwise HWIO (3, 3, 1, C) -> (C, 1, 3, 3); layer scales keep their name
    dw = intern_s_leaves["stage2_block7"]["dcn"]["dw_conv"]["kernel"]
    assert dw.shape == (3, 3, 1, 320)
    np.testing.assert_array_equal(
        tmod.stage2_block7.dcn.dw_conv.weight.detach().numpy(),
        dw.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tmod.stage3_block3.gamma2.detach().numpy(),
                                  intern_s_leaves["stage3_block3"]["gamma2"])
    assert tuple(tmod.out_channels()) == (160, 320, 640)


def test_parameter_labels_follow_the_jax_rule(intern_s_leaves):
    """The port's label of every InternImage parameter equals the JAX
    rule's label of the flax leaf it is bridged from: ``stem_ln1`` and
    ``stem_ln2`` frozen (the rule's ``stem_``), the ``stem1``/``stem2``
    convs and every block at the backbone's rate."""
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"img_backbone": intern_s_leaves})[0]:
        s = jopt._path_str(path)
        label = ("frozen" if jopt._is_frozen(s)
                 else "backbone" if jopt._is_backbone(s) else "main")
        one = node = {}
        keys = [getattr(k, "key", k) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
        (name,) = state_dict_from_flax(one)
        want[name] = label
    with torch.device("meta"):
        tmod = tii.InternImage(out_indices=(1, 2, 3))
    assert set(want) == {f"img_backbone.{k}" for k, _ in tmod.named_parameters()}
    for name, label in want.items():
        assert param_label(name) == label, name
    assert {n for n, lb in want.items() if lb == "frozen"} == {
        f"img_backbone.stem_ln{i}.{p}" for i in (1, 2) for p in ("weight", "bias")}


# --------------------------------------------------- the config, streamed

def test_small_bev_tiny_occ_intern_s_streaming_frames_match_jax():
    sizes = dict(occ_xdim=32, occ_ydim=32, occ_zdim=4, occ_dims=16,
                 backbone_depth=50)
    tcfg = small(port_configs.bev_tiny_occ_intern_s(), **sizes)
    m = tcfg.model
    assert (m.backbone_type, m.backbone_out_indices) == ("internimage", (3,))
    worst = stream_against_jax(
        small(jax_configs.bev_tiny_occ_intern_s(), **sizes), tcfg)
    assert set(worst) == {"cls_scores", "bbox_preds", "bev_embed",
                          "occupancy_preds"}
