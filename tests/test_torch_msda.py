"""The port's MSDA plain version against the JAX package's MSDA.

The plain version ``ms_deform_attn_ref`` is what the CPU runs and what the
CUDA kernel is held against on the GPU. Here it is held against
``ms_deform_attn_xla`` (multi-level, locations outside the grid), the
Pallas kernels in interpret mode (plain ``_msda_kernel``, and the slab
kernel with a tile mask: masked tiles are zero) and
``_materialize_factored``. All f32: the sides differ only in summation
order, so 1e-5 absolute on O(1) outputs.
"""
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.ops.msda import ms_deform_attn_xla
from apollo_vision_net_tpu.ops.msda_pallas import (
    _materialize_factored,
    _msda_pallas_fwd_impl,
)
from apollo_vision_net_tpu_torch.ops import msda_cuda
from apollo_vision_net_tpu_torch.ops.msda import (
    materialize_factored,
    ms_deform_attn,
    ms_deform_attn_ref,
)

TOL = 1e-5


def make_inputs(seed, B=2, H=4, D=8, Q=37, P=5, shapes=((6, 9), (3, 5))):
    rng = np.random.default_rng(seed)
    V = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, V, H, D)).astype(np.float32)
    # locations outside [0, 1] exercise the zero padding
    locs = rng.uniform(-0.2, 1.2, (B, Q, H, L, P, 2)).astype(np.float32)
    attn = rng.random((B, Q, H, L, P)).astype(np.float32)
    attn /= attn.reshape(B, Q, H, -1).sum(-1).reshape(B, Q, H, 1, 1)
    return value, shapes, locs, attn


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shapes", [((6, 9), (3, 5)), ((7, 5),)])
def test_ref_matches_xla(shapes):
    value, shapes, locs, attn = make_inputs(0, shapes=shapes)
    want = np.asarray(ms_deform_attn_xla(value, shapes, locs, attn))
    v, l, a = _torch(value, locs, attn)
    got = ms_deform_attn_ref(v, shapes, l, a).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_ref_bf16_value_keeps_dtype():
    """bf16 value: f32 accumulation, output rounded to bf16 as the XLA path
    does (one bf16 rounding of the same f32 sum: 1 ulp, 2^-7 at |x| < 2)."""
    value, shapes, locs, attn = make_inputs(1)
    vb = torch.from_numpy(value).to(torch.bfloat16)
    want = np.asarray(ms_deform_attn_xla(
        vb.float().numpy(), shapes, locs, attn))
    got = ms_deform_attn_ref(vb, shapes, *_torch(locs, attn))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -7)


def test_ref_matches_pallas_plain_kernel_interpret():
    value, shapes, locs, attn = make_inputs(2, B=1, Q=140)
    want = np.asarray(_msda_pallas_fwd_impl(value, shapes, locs, attn,
                                            interpret=True))
    got = ms_deform_attn_ref(*_torch(value), shapes, *_torch(locs, attn)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_tile_mask_matches_pallas_slab_interpret():
    """The masked entry's contract: tiles of q_tile queries whose mask is 0
    are zero, the others exact — as the Pallas slab kernel computes them."""
    value, shapes, locs, attn = make_inputs(3, B=2, H=2, D=8, Q=80, P=4,
                                            shapes=((12, 10),))
    tile_mask = np.array([[1, 0, 1], [0, 1, 1]], np.int32)  # ceil(80/32) = 3
    want = np.asarray(_msda_pallas_fwd_impl(
        value, shapes, locs, attn, interpret=True, slab_rows=6, q_tile=32,
        tile_mask=tile_mask))
    got = ms_deform_attn_ref(*_torch(value), shapes, *_torch(locs, attn),
                             tile_mask=torch.from_numpy(tile_mask),
                             q_tile=32).numpy()
    assert np.all(got[0, 32:64] == 0) and np.all(got[1, :32] == 0)
    assert np.abs(got[0, :32]).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_materialize_factored_matches_jax():
    rng = np.random.default_rng(4)
    Bs, N, Q, H, P = 2, 3, 10, 4, 8
    shapes = ((5, 7), (2, 3))
    L = len(shapes)
    ref_flat = rng.random((Bs * N, Q, P * 2)).astype(np.float32)
    off = rng.standard_normal((Bs, Q, H * L * P * 2)).astype(np.float32)
    attn = rng.random((Bs, Q, H * L * P)).astype(np.float32)
    want_l, want_a = _materialize_factored(ref_flat, off, attn, shapes, H, P)
    got_l, got_a = materialize_factored(*_torch(ref_flat, off, attn), shapes, H, P)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))


def test_dispatcher_runs_plain_version_on_cpu():
    value, shapes, locs, attn = make_inputs(5)
    args = (torch.from_numpy(value), shapes, *_torch(locs, attn))
    tm = torch.tensor([[1, 0], [1, 1]], dtype=torch.int32)
    before = (msda_cuda.launches_plain, msda_cuda.launches_masked)
    torch.testing.assert_close(ms_deform_attn(*args, tile_mask=tm),
                               ms_deform_attn_ref(*args, tile_mask=tm),
                               rtol=0, atol=0)
    assert (msda_cuda.launches_plain, msda_cuda.launches_masked) == before


def test_kernel_wrapper_refuses_cpu_tensors():
    value, shapes, locs, attn = make_inputs(6)
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_fwd(torch.from_numpy(value), shapes, *_torch(locs, attn))
