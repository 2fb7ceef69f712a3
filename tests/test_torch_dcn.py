"""The port's modulated deformable conv (DCNv2) against the JAX package.

The plain version ``modulated_deform_conv_ref`` is what the CPU runs and what
the CUDA kernel (csrc/dcn_fwd.cu) is held against on the GPU. Here it is
held against three JAX computations of the same function: the JAX
package's ``modulated_deform_conv`` on the CPU (it projects first, then
samples), ``_dcn_xla_ref`` (samples first, then projects) and the Pallas
``_dcn_kernel`` in interpret mode. Cases: stride 1 and 2, odd sizes, far
offsets (samples outside the image; the Pallas kernel's full-height
fallback) and a tail tile (Q not a multiple of the kernel's q_tile). All
f32: the sides differ only in summation order, so 1e-4 absolute on outputs
of magnitude ~10. One DCN Bottleneck with bridged weights is held against
the JAX package's.
"""
import jax
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.models.resnet import Bottleneck as JaxBottleneck
from apollo_vision_net_tpu.ops.dcn_pallas import _dcn_dense_fwd_impl, _dcn_xla_ref
from apollo_vision_net_tpu.ops.dcnv3 import _kernel_grid
from apollo_vision_net_tpu.ops.dcnv3 import modulated_deform_conv as jax_mdc
from apollo_vision_net_tpu_torch import ops
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.models.resnet import Bottleneck
from apollo_vision_net_tpu_torch.ops import dcn_cuda
from apollo_vision_net_tpu_torch.ops.dcn import (
    modulated_deform_conv,
    modulated_deform_conv_ref,
)

from test_torch_occ import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-4
# (stride, offset std in pixels, H, W): stride 1 and 2, odd sizes at
# stride 2, far offsets
CASES = [(1, 1.0, 9, 11), (2, 1.0, 10, 12), (2, 6.0, 9, 13), (1, 6.0, 10, 12)]


def make_case(seed, stride, off_std, H, W, B=2, C=8, O=8):
    rng = np.random.default_rng(seed)
    Ho, Wo = (H - 1) // stride + 1, (W - 1) // stride + 1
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    offset = rng.normal(0, off_std, (B, Ho, Wo, 9, 2)).astype(np.float32)
    mask = rng.random((B, Ho, Wo, 9)).astype(np.float32)
    weight = rng.standard_normal((9, C, O)).astype(np.float32)
    return x, offset, mask, weight


def loc_flat(offset, stride, H, W):
    """The JAX kernels' normalized (B, Q, 9·2) sampling locations."""
    B, Ho, Wo = offset.shape[:3]
    py, px = np.meshgrid(np.arange(Ho) * stride, np.arange(Wo) * stride,
                         indexing="ij")
    base = np.stack([px.reshape(-1), py.reshape(-1)], -1)
    pos = base[None, :, None, :] + _kernel_grid(3, 3, 1, 1)[None, None] \
        + offset.reshape(B, Ho * Wo, 9, 2)
    return ((pos + 0.5) / np.array([W, H], np.float32)).astype(
        np.float32).reshape(B, Ho * Wo, 18)


def plain(x, offset, mask, weight, stride):
    return modulated_deform_conv_ref(
        *[torch.from_numpy(a) for a in (x, offset, mask, weight)], stride).numpy()


@pytest.mark.parametrize("reference", ["jax_cpu", "xla_ref", "pallas_interpret"])
@pytest.mark.parametrize("stride,off_std,H,W", CASES)
def test_plain_dcn_matches_jax(reference, stride, off_std, H, W):
    x, offset, mask, weight = make_case(7, stride, off_std, H, W)
    B, Ho, Wo = offset.shape[:3]
    got = plain(x, offset, mask, weight, stride)
    assert got.shape == (B, Ho, Wo, weight.shape[-1])
    if reference == "jax_cpu":
        want = jax_mdc(x, offset, mask, weight, stride=stride)
    elif reference == "xla_ref":
        want = _dcn_xla_ref(x, loc_flat(offset, stride, H, W),
                            mask.reshape(B, Ho * Wo, 9), weight)
    else:
        want = _dcn_dense_fwd_impl(
            x, loc_flat(offset, stride, H, W), mask.reshape(B, Ho * Wo, 9),
            weight, fast=False, slab_rows=5, q_tile=32, interpret=True)
    want = np.asarray(want).reshape(got.shape)
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_plain_dcn_bf16_rounds_samples_and_output():
    """bf16 x: the samples and the output are rounded to bf16 around an f32
    product, as ``_dcn_xla_ref`` does in bf16."""
    x, offset, mask, weight = make_case(8, 2, 1.0, 10, 12)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(weight).to(torch.bfloat16)
    got = modulated_deform_conv_ref(xb, torch.from_numpy(offset),
                                    torch.from_numpy(mask), wb, 2)
    assert got.dtype == torch.bfloat16
    B, Ho, Wo = offset.shape[:3]
    want = np.asarray(_dcn_xla_ref(
        jax.numpy.asarray(xb.float().numpy(), jax.numpy.bfloat16),
        loc_flat(offset, 2, 10, 12), mask.reshape(B, Ho * Wo, 9),
        jax.numpy.asarray(wb.float().numpy(), jax.numpy.bfloat16)),
        np.float32).reshape(got.shape)
    # one bf16 rounding of the output (|out| < 16: 2^-4), plus samples that
    # round to neighbouring bf16 values from f32 sums taken in another order
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -3)


def test_front_end_runs_plain_version_on_cpu():
    x, offset, mask, weight = make_case(9, 1, 1.0, 9, 11)
    args = [torch.from_numpy(a) for a in (x, offset, mask, weight)]
    before = dcn_cuda.launches
    with ops.plain_versions():
        inside = modulated_deform_conv(*args, 1)
    torch.testing.assert_close(modulated_deform_conv(*args, 1),
                               modulated_deform_conv_ref(*args, 1),
                               rtol=0, atol=0)
    torch.testing.assert_close(inside, modulated_deform_conv_ref(*args, 1),
                               rtol=0, atol=0)
    assert dcn_cuda.launches == before
    with pytest.raises(ValueError, match="3x3"):
        modulated_deform_conv(args[0], args[1][..., :4, :], args[2][..., :4],
                              args[3][:4], 1)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, offset, mask, weight = make_case(10, 1, 1.0, 9, 11)
    with pytest.raises(ValueError, match="CUDA"):
        dcn_cuda.dcn_fwd(*[torch.from_numpy(a) for a in (x, offset, mask, weight)])


@pytest.mark.parametrize("stride,downsample", [(2, True), (1, False)])
def test_dcn_bottleneck_matches_jax(stride, downsample):
    """Offsets from the bridged ``conv2_offset`` (perturbed away from its
    zero init), (x, y) per tap and a sigmoid mask, as the JAX block."""
    from test_torch_backbone import assert_rel_close, nchw, perturbed

    planes = 8
    cin = 16 if downsample else planes * 4
    x = np.random.default_rng(11).standard_normal((2, 9, 12, cin)).astype(np.float32)
    jmod = JaxBottleneck(planes=planes, stride=stride, downsample=downsample,
                         with_dcn=True)
    params = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), x)["params"], 2)
    want = jax.jit(jmod.apply)({"params": params}, x)
    tmod = Bottleneck(cin, planes, stride, downsample=downsample, with_dcn=True)
    tmod.load_state_dict(state_dict_from_flax(params), strict=True)
    assert tuple(tmod.conv2_dcn_weight.shape) == (9, planes, planes)
    with torch.no_grad():
        got = tmod(nchw(x))
    assert_rel_close(got, want)
