"""The port's conv trunk (DLA-34, SECONDFPNV2) against the JAX package.

The JAX DLA runs its space-to-depth stem (ops/s2d.py) on even image sizes;
the port runs the plain convolutions with the same HWIO weights bridged to
OIHW, so this also holds the s2d rewrite and the plain stem to each other.
SECONDFPNV2 exercises the ConvTranspose spatial flip of the bridge. All f32;
tolerance 1e-4 relative to each output's largest magnitude (~20 conv layers
of f32 sums in different orders, observed ~1e-6).
"""
import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.models.dla import DLA as JaxDLA
from apollo_vision_net_tpu.models.second_fpn import SECONDFPNV2 as JaxNeck
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.models.dla import DLA
from apollo_vision_net_tpu_torch.models.layers import Conv2d
from apollo_vision_net_tpu_torch.models.second_fpn import SECONDFPNV2

REL_TOL = 1e-4


def perturbed(params, seed):
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return x * np.exp(0.1 * noise)
        return x + 0.05 * noise

    return jax.tree_util.tree_map_with_path(f, params)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def assert_rel_close(got, want):
    got = got.permute(0, 2, 3, 1).detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= REL_TOL * scale


def test_dla34_matches_jax_s2d_stem():
    x = np.random.default_rng(0).standard_normal((2, 64, 96, 3)).astype(np.float32)
    jmod = JaxDLA(out_indices=(3, 4, 5))
    params = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), x)["params"], 1)
    want = jax.jit(jmod.apply)({"params": params}, x)
    tmod = DLA(out_indices=(3, 4, 5))
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod(nchw(x))
    assert [tuple(g.shape) for g in got] == [(2, 128, 8, 12), (2, 256, 4, 6),
                                              (2, 512, 2, 3)]
    for g, w in zip(got, want):
        assert_rel_close(g, w)


def test_second_fpn_matches_jax_and_needs_the_flip():
    rng = np.random.default_rng(2)
    feats = [rng.standard_normal(s).astype(np.float32) for s in
             ((2, 8, 12, 128), (2, 4, 6, 256), (2, 2, 3, 512))]
    jmod = JaxNeck(fuse_channels=32)
    params = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), feats)["params"], 3)
    (want,) = jax.jit(jmod.apply)({"params": params}, feats)
    tmod = SECONDFPNV2(fuse_channels=32)
    sd = state_dict_from_flax(params)
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        (got,) = tmod([nchw(f) for f in feats])
    assert_rel_close(got, want)

    # without the spatial flip the transposed conv is wrong
    unflipped = np.asarray(params["deblock2_up"]["kernel"]).transpose(2, 3, 0, 1)
    sd["deblock2_up.weight"] = torch.from_numpy(np.ascontiguousarray(unflipped))
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        (bad,) = tmod([nchw(f) for f in feats])
    assert float((bad.permute(0, 2, 3, 1) - torch.from_numpy(np.array(want))).abs().max()) > 1e-2


@pytest.mark.parametrize("k,s,hw", [(2, 2, (7, 9)), (3, 2, (7, 8)), (1, 1, (5, 6))])
def test_conv_same_padding_matches_flax(k, s, hw):
    """flax nn.Conv's default 'SAME' padding (also on odd sizes)."""
    x = np.random.default_rng(4).standard_normal((1, *hw, 4)).astype(np.float32)
    jmod = fnn.Conv(6, (k, k), strides=(s, s), use_bias=False)
    params = jmod.init(jax.random.PRNGKey(0), x)["params"]
    want = jmod.apply({"params": params}, x)
    tmod = Conv2d(4, 6, k, stride=s)
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    with torch.no_grad():
        assert_rel_close(tmod(nchw(x)), want)
