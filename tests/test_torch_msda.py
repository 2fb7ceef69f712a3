"""The port's MSDA plain version against the JAX package's MSDA.

The plain version ``ms_deform_attn_ref`` is what the CPU runs and what the
CUDA kernel is held against on the GPU. Here it is held against
``ms_deform_attn_xla`` (multi-level, locations outside the grid), the
Pallas kernels in interpret mode (plain ``_msda_kernel``, and with a tile
mask the slab kernel and ``_msda_kernel_masked``, over one and two levels:
masked tiles are zero) and
``_materialize_factored``. The factored front end (multi-level SCA) is held
against the Pallas pt2d kernel in interpret mode, with and without a tile
mask, the materialized non-pt2d Pallas paths and XLA; TSA over a large
single-level grid against the window kernel where its window holds every
sample, and against XLA everywhere. All f32: the sides differ only in
summation order, so 1e-5 absolute on O(1) outputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.ops.msda import ms_deform_attn_xla
from apollo_vision_net_tpu.ops.msda_pallas import (
    _materialize_factored,
    _msda_pallas_fwd_impl,
    _msda_pallas_window_impl,
)
from apollo_vision_net_tpu_torch import ops
from apollo_vision_net_tpu_torch.ops import msda_cuda
from apollo_vision_net_tpu_torch.ops.msda import (
    materialize_factored,
    ms_deform_attn,
    ms_deform_attn_factored,
    ms_deform_attn_ref,
)

from test_torch_occ import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

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


@pytest.mark.parametrize("slab_rows,shapes", [
    (6, ((12, 10),)),            # _msda_kernel_slab with a tile mask
    (None, ((12, 10),)),         # _msda_kernel_masked
    (None, ((12, 10), (5, 6))),  # _msda_kernel_masked over two levels
])
def test_tile_mask_matches_pallas_slab_interpret(slab_rows, shapes):
    """The masked entry's contract: tiles of q_tile queries whose mask is 0
    are zero, the others exact — as the Pallas slab kernel (kernel 2) and
    the masked kernel without a slab (kernel 3) compute them."""
    value, shapes, locs, attn = make_inputs(3, B=2, H=2, D=8, Q=80, P=4,
                                            shapes=shapes)
    tile_mask = np.array([[1, 0, 1], [0, 1, 1]], np.int32)  # ceil(80/32) = 3
    want = np.asarray(_msda_pallas_fwd_impl(
        value, shapes, locs, attn, interpret=True, slab_rows=slab_rows,
        q_tile=32, tile_mask=tile_mask))
    got = ms_deform_attn_ref(*_torch(value), shapes, *_torch(locs, attn),
                             tile_mask=torch.from_numpy(tile_mask),
                             q_tile=32).numpy()
    assert np.all(got[0, 32:64] == 0) and np.all(got[1, :32] == 0)
    assert np.abs(got[0, :32]).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("D", [2, 1])
def test_narrow_heads_match_pallas_slab_interpret(D, masked):
    """The hybrids' D = 2 stage and D = 1 (the widths of the CUDA forward's
    narrow variant): one 15x25 level, 8 heads, L·P = 8, with and without a
    tile mask, against the Pallas slab kernel in interpret mode."""
    value, shapes, locs, attn = make_inputs(13, B=2, H=8, D=D, Q=40, P=8,
                                            shapes=((15, 25),))
    tile_mask = np.array([[1, 0, 1], [0, 1, 1]], np.int32) if masked else None
    want = np.asarray(_msda_pallas_fwd_impl(
        value, shapes, locs, attn, interpret=True, slab_rows=5, q_tile=16,
        tile_mask=tile_mask))
    got = ms_deform_attn_ref(
        *_torch(value), shapes, *_torch(locs, attn),
        tile_mask=None if tile_mask is None else torch.from_numpy(tile_mask),
        q_tile=16).numpy()
    assert got.shape == (2, 40, 8 * D)
    if masked:
        assert np.all(got[0, 16:32] == 0) and np.all(got[1, :16] == 0)
    assert np.abs(got[0, :16]).max() > 0
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


def make_factored_inputs(seed, B=6, Bs=2, H=3, D=8, Q=300, P=4, Dz=2,
                         shapes=((14, 10), (7, 5), (4, 3), (2, 2))):
    """SCA-style operands: per-camera refs (B = Bs·N, camera axis fast),
    raw-cell offsets and softmaxed weights shared by a sample's cameras."""
    rng = np.random.default_rng(seed)
    V = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = rng.standard_normal((B, V, H, D)).astype(np.float32)
    ref = rng.uniform(-0.1, 1.1, (B, Q, Dz, 2)).astype(np.float32)
    off = rng.uniform(-3.0, 3.0, (Bs, Q, H * L * P * 2)).astype(np.float32)
    attn = rng.random((Bs, Q, H, L * P)).astype(np.float32)
    attn = (attn / attn.sum(-1, keepdims=True)).reshape(Bs, Q, H * L * P)
    ref_flat = np.tile(ref.reshape(B, Q, Dz * 2), (1, 1, P // Dz))
    return value, shapes, ref_flat, off, attn


def factored_plain(value, shapes, ref_flat, off, attn, tile_mask=None):
    tm = None if tile_mask is None else torch.from_numpy(tile_mask.astype(np.int32))
    return ms_deform_attn_factored(
        *_torch(value), shapes, *_torch(ref_flat, off, attn), tile_mask=tm,
        q_tile=128).numpy()


@pytest.mark.parametrize("masked", [False, True])
def test_factored_matches_pallas_pt2d_interpret(monkeypatch, masked):
    """The pt2d kernel (kernel 4) on the factored operands, Bs < B, a tail
    tile; with a tile mask, masked tiles are zero and the rest exact."""
    monkeypatch.setenv("MSDA_ML_KERNEL", "pt2d")
    value, shapes, ref_flat, off, attn = make_factored_inputs(17)
    B = value.shape[0]
    tile_mask = None
    if masked:
        tile_mask = np.ones((B, 3), bool)
        tile_mask[0, 1] = False
        tile_mask[3, 2] = False
    want = np.asarray(_msda_pallas_fwd_impl(
        value, shapes, None, None, interpret=True, q_tile=128,
        slab_rows=(6, 4, 3, 2),
        tile_mask=None if tile_mask is None else jnp.asarray(tile_mask),
        factored=(jnp.asarray(ref_flat), jnp.asarray(off), jnp.asarray(attn))))
    got = factored_plain(value, shapes, ref_flat, off, attn, tile_mask)
    if masked:
        assert np.all(got[0, 128:256] == 0) and np.all(got[3, 256:] == 0)
        keep = np.repeat(tile_mask, 128, axis=1)[:, :got.shape[1]]
        want = want * keep[:, :, None]
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("path", ["chunk", "slab_single_level", "xla"])
def test_factored_matches_materialized_paths(monkeypatch, path):
    """The materialized routes: the multi-level chunk kernel (kernel 5, the
    masked entry's contract at L = 4), the single-level slab kernel, and
    XLA on ``_materialize_factored``'s operands."""
    shapes = ((12, 9),) if path == "slab_single_level" else ((14, 10), (7, 5), (4, 3), (2, 2))
    value, shapes, ref_flat, off, attn = make_factored_inputs(
        19, B=6, Bs=3, Q=150, shapes=shapes)
    got = factored_plain(value, shapes, ref_flat, off, attn)
    factored = (jnp.asarray(ref_flat), jnp.asarray(off), jnp.asarray(attn))
    if path == "chunk":
        monkeypatch.setenv("MSDA_ML_KERNEL", "chunk")
        want = _msda_pallas_fwd_impl(value, shapes, None, None, interpret=True,
                                     q_tile=64, slab_rows=(6, 4, 3, 2),
                                     factored=factored)
    elif path == "slab_single_level":
        want = _msda_pallas_fwd_impl(value, shapes, None, None, interpret=True,
                                     q_tile=32, slab_rows=8, factored=factored)
    else:
        B, Q, H, L, P = value.shape[0], ref_flat.shape[1], value.shape[2], 4, 4
        loc, aw = _materialize_factored(*factored, shapes, H, P)
        want = ms_deform_attn_xla(value, shapes, np.asarray(loc).reshape(
            B, Q, H, L, P, 2), np.asarray(aw).reshape(B, Q, H, L, P))
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=TOL)


def test_factored_front_end_on_cpu_counts_no_launch():
    value, shapes, ref_flat, off, attn = make_factored_inputs(20, Q=40)
    before = msda_cuda.launches_factored
    with ops.plain_versions():
        inside = factored_plain(value, shapes, ref_flat, off, attn)
    np.testing.assert_array_equal(
        inside, factored_plain(value, shapes, ref_flat, off, attn))
    assert msda_cuda.launches_factored == before
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_fwd_factored(torch.from_numpy(value), shapes,
                                    *_torch(ref_flat, off, attn))


def _tsa_inputs(seed, spread):
    """TSA over a 40×36 single-level grid (the 200×200 base TSA's kernel at
    a small size): B = 2 queue slots, tiles of 32 queries sampling around a
    centre, ``spread`` wide in normalized units."""
    rng = np.random.default_rng(seed)
    B, H, D, Q, P = 2, 2, 8, 128, 4
    h, w = 40, 36
    value = rng.standard_normal((B, h * w, H, D)).astype(np.float32)
    nt = Q // 32
    centers = rng.uniform(0.25, 0.75, (B, nt, 1, 1, 1, 1, 2))
    locs = centers + rng.uniform(-spread, spread, (B, nt, 32, H, 1, P, 2))
    locs = np.clip(locs.reshape(B, Q, H, 1, P, 2), 0, 1).astype(np.float32)
    attn = rng.random((B, Q, H, 1, P)).astype(np.float32)
    return value, ((h, w),), locs, attn


@pytest.mark.parametrize("reference", ["window_kernel", "xla"])
def test_large_grid_tsa_is_exact(reference):
    """Where the window kernel's 24×32-cell window holds every sample it
    agrees with the plain version; the plain version never clamps, so it
    agrees with XLA on samples spread over the whole grid."""
    value, shapes, locs, attn = _tsa_inputs(7, 0.1 if reference == "window_kernel" else 0.5)
    got = ms_deform_attn_ref(*_torch(value), shapes, *_torch(locs, attn)).numpy()
    if reference == "window_kernel":
        want = _msda_pallas_window_impl(jnp.asarray(value), shapes,
                                        jnp.asarray(locs), jnp.asarray(attn),
                                        interpret=True, q_tile=32)
    else:
        want = ms_deform_attn_xla(value, shapes, locs, attn)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=2e-5)


# ------------------------------------------------------------- backward

def _tsa_grid_inputs(seed, B=2, H=2, D=8, P=4, hw=(20, 20), hot=False):
    """msda_bwd's main geometry on a small grid: one query per cell
    sampling ~2 cells around its own (TSA), or every sample of every query
    at the centre of one cell (a hot row: the whole weight on one corner
    row)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    Q = h * w
    value = rng.standard_normal((B, Q, H, D)).astype(np.float32)
    ys, xs = np.divmod(np.arange(Q), w)
    centre = np.stack([(xs + 0.5) / w, (ys + 0.5) / h], -1)
    if hot:
        centre[:] = [(3 + 0.5) / w, (5 + 0.5) / h]
        locs = np.broadcast_to(centre[None, :, None, None, None],
                               (B, Q, H, 1, P, 2))
    else:
        off = rng.standard_normal((B, Q, H, 1, P, 2)) * 2.0 / np.array([w, h])
        locs = centre[None, :, None, None, None] + off
    attn = rng.random((B, Q, H, 1, P)).astype(np.float32)
    return value, ((h, w),), np.ascontiguousarray(locs, np.float32), attn


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shapes", [((7, 5),), ((6, 9), (3, 5)),
                                    pytest.param("tsa_20x20", id="tsa_20x20"),
                                    pytest.param("hot_row", id="hot_row"),
                                    pytest.param("narrow_D2", id="narrow_D2"),
                                    pytest.param("narrow_D1", id="narrow_D1")])
def test_plain_backward_matches_jax_vjp(shapes, masked):
    """Autograd through ms_deform_attn_ref (the plain version of msda_bwd)
    against jax.vjp of ms_deform_attn_xla, which is the backward of every
    Pallas MSDA kernel (msda_pallas.py:1468-1484), on random locations over
    one and two levels, on the TSA geometry the kernel is shaped for (L·P =
    4 on a 20x20 grid, B = 2, a query per cell), on a hot row (every
    sample on one corner of one cell) and at the narrow head widths of the
    private plan (D = 2 and 1, 8 heads, one 15x25 level, L·P = 8: the
    hybrids' last stage). With a tile mask the JAX backward
    runs unmasked on a cotangent zeroed on the masked queries, as the
    caller's zeroed output gives it. f32 sums in other orders: 1e-5
    relative to each gradient's largest magnitude (locations scale by the
    level's w and h)."""
    import jax

    if isinstance(shapes, str) and shapes.startswith("narrow_D"):
        D = int(shapes[-1])
        value, shapes, locs, attn = make_inputs(14, B=2, H=8, D=D, Q=70, P=8,
                                                shapes=((15, 25),))
        B, Q = 2, 70
        g = np.random.default_rng(15).standard_normal(
            (B, Q, 8 * D)).astype(np.float32)
        tile_mask = np.array([[1, 0, 1], [0, 1, 1]], np.int32)
    elif isinstance(shapes, str):
        value, shapes, locs, attn = _tsa_grid_inputs(
            11, hot=shapes == "hot_row")
        B, Q = locs.shape[:2]
        rng = np.random.default_rng(12)
        g = rng.standard_normal((B, Q, 16)).astype(np.float32)
        tile_mask = (rng.random((B, (Q + 31) // 32)) > 0.4).astype(np.int32)
        tile_mask[0, 1] = tile_mask[1, 0] = 0  # checked below
        tile_mask[0, 0] = tile_mask[1, 1] = 1
    else:
        value, shapes, locs, attn = make_inputs(7, B=2, H=2, D=8, Q=70, P=4,
                                                shapes=shapes)
        B, Q = 2, 70
        g = np.random.default_rng(8).standard_normal((2, 70, 16)).astype(np.float32)
        tile_mask = np.array([[1, 0, 1], [0, 1, 1]], np.int32)
    tile_mask = tile_mask if masked else None
    g_jax = g
    if masked:
        keep = np.repeat(tile_mask.astype(bool), 32, axis=1)[:, :Q]
        g_jax = g * keep[..., None]
    _, vjp = jax.vjp(lambda v, s, a: ms_deform_attn_xla(v, shapes, s, a),
                     value, locs, attn)
    want = [np.asarray(w) for w in vjp(g_jax)]
    ins = [t.requires_grad_() for t in _torch(value, locs, attn)]
    out = ms_deform_attn_ref(ins[0], shapes, ins[1], ins[2],
                             tile_mask=None if tile_mask is None
                             else torch.from_numpy(tile_mask), q_tile=32)
    got = torch.autograd.grad(out, ins, torch.from_numpy(g))
    for name, a, w in zip(("value", "loc", "attn"), got, want):
        err = np.abs(a.numpy() - w).max() / np.abs(w).max()
        assert err <= 1e-5, (name, err)
    if masked:  # masked queries get no gradient
        assert float(got[1][0, 32:64].abs().max()) == 0.0
        assert float(got[2][1, :32].abs().max()) == 0.0


def test_msda_function_routes_backward_to_the_kernel_entry(monkeypatch):
    """On CUDA tensors ms_deform_attn runs MSDAFunction: forward through
    msda_cuda.msda_fwd, backward through msda_cuda.msda_bwd with the saved
    value, locations, weights and tile mask. Checked on the CPU with the
    kernel branch forced and both entries replaced by the plain version
    (forward) and its autograd (backward): the gradients equal the plain
    version's."""
    from apollo_vision_net_tpu_torch.ops import msda as msda_mod

    calls = []

    def fake_fwd(value, shapes, loc, attn, *, tile_mask=None, q_tile=32):
        calls.append("fwd")
        return ms_deform_attn_ref(value, shapes, loc, attn,
                                  tile_mask=tile_mask, q_tile=q_tile)

    def fake_bwd(value, shapes, loc, attn, grad_out, *, tile_mask=None,
                 q_tile=32):
        calls.append(("bwd", tuple(map(tuple, shapes)), q_tile,
                      tile_mask is not None))
        assert grad_out.dtype == value.dtype and grad_out.is_contiguous()
        with torch.enable_grad():  # a backward runs without grad mode
            ins = [t.detach().requires_grad_() for t in (value, loc, attn)]
            out = ms_deform_attn_ref(ins[0], shapes, ins[1], ins[2],
                                     tile_mask=tile_mask, q_tile=q_tile)
            return torch.autograd.grad(out, ins, grad_out)

    monkeypatch.setattr(msda_mod, "use_plain", lambda t: False)
    monkeypatch.setattr(msda_cuda, "msda_fwd", fake_fwd)
    monkeypatch.setattr(msda_cuda, "msda_bwd", fake_bwd)
    value, shapes, locs, attn = make_inputs(9, Q=40)
    tm = torch.tensor([[1, 0], [0, 1]], dtype=torch.int32)
    g = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 40, 32)).astype(np.float32))
    grads = []
    for fn in (ms_deform_attn, ms_deform_attn_ref):
        ins = [t.requires_grad_() for t in _torch(value, locs, attn)]
        out = fn(ins[0], shapes, ins[1], ins[2], tile_mask=tm, q_tile=32)
        grads.append(torch.autograd.grad(out, ins, g))
    assert calls == ["fwd", ("bwd", tuple(map(tuple, shapes)), 32, True)]
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_backward_wrapper_refuses_cpu_tensors():
    value, shapes, locs, attn = make_inputs(11)
    g = torch.zeros((2, 37, 32))
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_bwd(torch.from_numpy(value), shapes,
                           *_torch(locs, attn), g)


@pytest.mark.parametrize("front_end", ["msda_factored", "dcn"])
def test_front_ends_without_a_backward_refuse_grad_on_the_kernel_branch(
        monkeypatch, front_end):
    """On the kernel branch (forced here on the CPU) the factored MSDA and
    the DCN front ends pass inputs that require a gradient through their
    autograd Functions to the forward kernel's wrapper, which refuses CPU
    tensors; without grad mode the call reaches the same wrapper. (The
    name dates from when these front ends refused such inputs; the routing
    of their backwards is held in tests/test_torch_train_base.py.)"""
    from apollo_vision_net_tpu_torch.ops import dcn as dcn_mod
    from apollo_vision_net_tpu_torch.ops import msda as msda_mod

    if front_end == "dcn":
        monkeypatch.setattr(dcn_mod, "use_plain", lambda t: False)
        rng = np.random.default_rng(12)
        args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((1, 5, 6, 4), (1, 5, 6, 9, 2), (1, 5, 6, 9), (9, 4, 3))]
        fn, name = dcn_mod.modulated_deform_conv, "dcn_fwd"
    else:
        monkeypatch.setattr(msda_mod, "use_plain", lambda t: False)
        value, shapes, ref_flat, off, attn = make_factored_inputs(13, Q=40)
        args = [torch.from_numpy(value), shapes,
                *_torch(ref_flat, off, attn)]
        fn, name = msda_mod.ms_deform_attn_factored, "msda_fwd_factored"
    args[0].requires_grad_()
    with pytest.raises(ValueError, match=f"{name} launches on CUDA"):
        fn(*args)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        fn(*args)
