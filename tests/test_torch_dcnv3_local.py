"""The tile-local MSDA entry of the port (``ops.msda.ms_deform_attn_local``,
which ``ops.dcnv3.dcnv3_core`` runs) against the JAX package on the CPU,
and its host-side rules (the kernels run only on the card; chip_smoke.py
holds them against the plain version there).

- ``ms_deform_attn_local`` and its gradients (value, locations, weights)
  against JAX's ``dcnv3_core`` path (``ms_deform_attn`` at one level, the
  pixel centres plus the taps and offsets over [W, H]) through ``jax.vjp``,
  f32, within 1e-4 of each output's and gradient's largest magnitude: a map
  smaller than one tile, maps whose width no tile divides, offsets of
  N(0, 4) px that leave any halo, D = 4, 12, 16 and 32.
- ``dcnv3_core`` takes the local entry; on the kernel branch (forced
  here, the kernels replaced by the plain version and its autograd)
  ``LocalMSDAFunction`` runs msda_fwd_local forward and msda_bwd_local
  backward, and the gradients equal JAX's. A forward whose gradients will
  be taken refuses, before it launches, samples that the backward's block
  cannot hold.
- The tile helpers: every cell in one tile, each halo inside the map and
  around its tile, a block's shared memory within 227 KB, and the Python
  constants equal to csrc/msda_common.cuh's.
- ``msda_cuda.check_local`` (which both wrappers run before they touch a
  device) refuses L > 1, Q != V, bf16 and widths outside LOCAL_WIDTHS;
  ``ms_deform_attn_local`` refuses L > 1 and Q != V on every device.
- chip_smoke.py's local cases: the DCNv3 shapes in f32 beside their vector
  rows, the edge cases (every corner outside the halo, corners off the
  image, 15x25, ragged widths), and the share of corners outside the halo.
- ``tools.dryrun_multichip`` runs on the card unless asked for the CPU.
"""
import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from apollo_vision_net_tpu.ops import dcnv3 as jdcn
from apollo_vision_net_tpu.ops.msda import ms_deform_attn as jax_msda
from apollo_vision_net_tpu_torch.ops import dcnv3 as tdcn
from apollo_vision_net_tpu_torch.ops import msda as tmsda
from apollo_vision_net_tpu_torch.ops import msda_cuda

from test_torch_occ import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REL_TOL = 1e-4
CSRC = Path(msda_cuda.__file__).resolve().parent.parent / "csrc"


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _inputs(B, H, W, G, Dg, off_px, seed):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((B, H, W, G, Dg)).astype(np.float32)
    off = (rng.standard_normal((B, H, W, G, 9, 2)) * off_px).astype(np.float32)
    m = rng.random((B, H, W, G, 9)).astype(np.float32)
    return v, off, m / m.sum(-1, keepdims=True)


def _jax_locations(off, H, W):
    """JAX's dcnv3_core locations (B, H·W, G, 1, 9, 2), as it forms them."""
    B, G = off.shape[0], off.shape[3]
    ys = (np.arange(H, dtype=np.float32) + 0.5) / H
    xs = (np.arange(W, dtype=np.float32) + 0.5) / W
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    p0 = jnp.asarray(np.stack([gx.reshape(-1), gy.reshape(-1)], -1))
    norm = jnp.asarray([W, H], jnp.float32)
    grid = jnp.asarray(jdcn._kernel_grid(3, 3, 1, 1))
    locs = p0[None, :, None, None, :] + (
        grid[None, None, None] + off.reshape(B, H * W, G, 9, 2)) / norm
    return locs[:, :, :, None]


# (B, H, W, G, Dg, off_px): one map smaller than any tile; widths that no
# tile (32 or 16 columns) divides and heights that no tile (8 rows)
# divides; offsets of N(0, 4) px, past any halo of 3 cells
SHAPES = [(1, 5, 7, 2, 16, 1.0), (2, 11, 37, 3, 8, 1.5),
          (1, 12, 20, 2, 16, 4.0), (1, 9, 50, 2, 4, 1.0),
          (1, 6, 19, 1, 12, 2.0), (1, 10, 33, 2, 32, 4.0)]


@pytest.mark.parametrize("B, H, W, G, Dg, off_px", SHAPES)
def test_local_entry_and_gradients_match_jax_dcnv3_path(B, H, W, G, Dg, off_px):
    v, off, m = _inputs(B, H, W, G, Dg, off_px, seed=H * W + G)
    if off_px >= 4.0:  # some taps of every row leave a halo of 3 cells
        assert np.abs(off).max() > 2 * msda_cuda.LOCAL_HALO + 2

    def jax_fn(v, locs, m):
        return jax_msda(v.reshape(B, H * W, G, Dg), ((H, W),), locs,
                        m.reshape(B, H * W, G, 1, 9))

    locs = np.asarray(_jax_locations(off, H, W))
    want, vjp = jax.vjp(jax_fn, v, locs, m)
    ins = [torch.tensor(a, requires_grad=True) for a in (v, locs, m)]
    got = tmsda.ms_deform_attn_local(
        ins[0].reshape(B, H * W, G, Dg), ((H, W),), ins[1],
        ins[2].reshape(B, H * W, G, 1, 9))
    assert got.shape == (B, H * W, G * Dg)
    assert _rel_err(got.detach().numpy(), want) <= REL_TOL
    g = np.random.default_rng(1).standard_normal(got.shape).astype(np.float32)
    for name, a, b in zip(("value", "locations", "weights"),
                          torch.autograd.grad(got, ins, torch.from_numpy(g)),
                          vjp(g)):
        assert _rel_err(a.numpy(), b) <= REL_TOL, name


@pytest.mark.parametrize("B, H, W, G, Dg, off_px", SHAPES[:3])
def test_dcnv3_core_on_the_local_kernels_matches_jax(monkeypatch, B, H, W, G,
                                                      Dg, off_px):
    """dcnv3_core in f32 goes through ms_deform_attn_local; with the kernel
    branch forced and the local wrappers replaced by the plain version
    (forward) and its autograd (backward), its output and its gradients of
    value, offsets and mask equal JAX's dcnv3_core's."""
    calls = []

    def fake_fwd(value, shapes, loc, attn):
        calls.append("fwd")
        msda_cuda.check_local(value, shapes, loc, attn)
        return tmsda.ms_deform_attn_ref(value, shapes, loc, attn)

    def fake_bwd(value, shapes, loc, attn, grad_out):
        calls.append("bwd")
        msda_cuda.check_local(value, shapes, loc, attn, grad_out)
        assert grad_out.is_contiguous()
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (value, loc, attn)]
            out = tmsda.ms_deform_attn_ref(ins[0], shapes, ins[1], ins[2])
            return torch.autograd.grad(out, ins, grad_out)

    monkeypatch.setattr(tmsda, "use_plain", lambda t: False)
    monkeypatch.setattr(msda_cuda, "msda_fwd_local", fake_fwd)
    monkeypatch.setattr(msda_cuda, "msda_bwd_local", fake_bwd)
    v, off, m = _inputs(B, H, W, G, Dg, off_px, seed=7 + H)
    want, vjp = jax.vjp(lambda *a: jdcn.dcnv3_core(*a), v, off, m)
    ins = [torch.tensor(a, requires_grad=True) for a in (v, off, m)]
    got = tdcn.dcnv3_core(*ins)
    assert _rel_err(got.detach().numpy(), want) <= REL_TOL
    g = np.random.default_rng(2).standard_normal(got.shape).astype(np.float32)
    for name, a, b in zip(("value", "offset", "mask"),
                          torch.autograd.grad(got, ins, torch.from_numpy(g)),
                          vjp(g)):
        assert _rel_err(a.numpy(), b) <= REL_TOL, name
    assert calls == ["fwd", "bwd"]


# ------------------------------------------------------------ tile rules

def c_const(name):
    """A constexpr int of csrc/msda_common.cuh (a literal or a product)."""
    text = (CSRC / "msda_common.cuh").read_text()
    m = re.search(rf"\b{name} = ([^,;]+)[,;]", text)
    return eval(m.group(1), {})


def test_python_tile_constants_equal_the_c_ones():
    assert msda_cuda.LOCAL_HALO == c_const("kLocalHalo")
    assert msda_cuda.LOCAL_THREADS == c_const("kLocalThreads")
    assert msda_cuda.LOCAL_FWD_TILE == (c_const("kLocalFwdTileY"),
                                        c_const("kLocalFwdTileX"))
    assert msda_cuda.LOCAL_BWD_TILE == (c_const("kLocalBwdTileY"),
                                        c_const("kLocalBwdTileX"))
    assert msda_cuda.LOCAL_MAX_SMEM == c_const("kLocalMaxSmem") == 227 * 1024
    bwd = (CSRC / "msda_bwd.cu").read_text()
    # the C entry's slot bound and shared-memory formula, as mirrored
    assert "(int64_t)TY * TX * P * 4 > 65536" in bwd
    assert msda_cuda.LOCAL_BWD_MAX_SLOTS == 65536
    fwd = (CSRC / "msda_fwd.cu").read_text()
    # the C shared-memory layouts, as mirrored
    assert ("return (local_halo_rows(kLocalFwdTileY, kLocalFwdTileX) + 1) * D * 4 +\n"
            "         (kLocalThreads / 32) * (32 / local_lanes(D)) * P * (16 + 16 + 2 * 12);"
            in fwd)
    assert ("const int64_t region = ((slots * 2 > all * 16 ? slots * 2 : all * 16)"
            " + 15) / 16 * 16;" in bwd)
    for line in ("m.xy = m.scratch + region;", "m.a = m.xy + 2 * all * 8;",
                 "m.start = m.a + 2 * all * 4;", "m.total = m.key + slots * 2;"):
        assert line in bwd
    for D in (4, 8, 16, 32):
        assert msda_cuda.local_lanes(D) == (1, 2, 4, 8)[(4, 8, 16, 32).index(D)]


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 70), w=st.integers(1, 130),
       tile=st.sampled_from([msda_cuda.LOCAL_FWD_TILE, msda_cuda.LOCAL_BWD_TILE,
                             (16, 32), (8, 8)]))
def test_tiles_cover_every_cell_once_and_halos_hold_their_tiles(h, w, tile):
    ty, tx = msda_cuda.local_tiles(h, w, tile)
    seen = np.zeros((h, w), np.int64)
    R = msda_cuda.LOCAL_HALO
    for i in range(ty):
        for j in range(tx):
            ((y0, y1), (x0, x1)), ((hy0, hy1), (hx0, hx1)) = (
                msda_cuda.local_tile_cells(h, w, tile, i, j))
            assert y0 < y1 and x0 < x1, "an empty tile"
            seen[y0:y1, x0:x1] += 1
            assert 0 <= hy0 <= y0 and y1 <= hy1 <= h
            assert 0 <= hx0 <= x0 and x1 <= hx1 <= w
            assert hy0 == max(0, y0 - R) and hy1 == min(h, y1 + R)
            assert hx0 == max(0, x0 - R) and hx1 == min(w, x1 + R)
            assert (hy1 - hy0) * (hx1 - hx0) <= msda_cuda.local_halo_rows(tile)
    assert (seen == 1).all()


def test_a_map_within_one_tile_and_its_halo_is_staged_whole():
    """InternImage-S's last stage, 15x25, under a 16x32 tile: the one tile's
    halo is the whole map, so no corner in the grid is read outside it."""
    (cells, halo) = msda_cuda.local_tile_cells(15, 25, (16, 32), 0, 0)
    assert halo == ((0, 15), (0, 25)) and msda_cuda.local_tiles(15, 25, (16, 32)) == (1, 1)


@pytest.mark.parametrize("D", msda_cuda.LOCAL_WIDTHS)
def test_block_shared_memory_fits_at_every_width(D):
    assert msda_cuda.local_fwd_smem(D, 9) <= msda_cuda.LOCAL_MAX_SMEM
    assert msda_cuda.local_bwd_smem(D, 9) <= msda_cuda.LOCAL_MAX_SMEM
    # three backward blocks an SM at InternImage-S's D = 16, 9 taps
    if D == 16:
        assert 3 * msda_cuda.local_bwd_smem(D, 9) <= msda_cuda.LOCAL_MAX_SMEM
    nq = msda_cuda.LOCAL_BWD_TILE[0] * msda_cuda.LOCAL_BWD_TILE[1]
    assert nq * 9 * 4 <= msda_cuda.LOCAL_BWD_MAX_SLOTS


# ---------------------------------------------------------------- refusals

def _local_args(B=1, h=4, w=5, H=2, D=16, P=9, L=1, Q=None, dtype=torch.float32):
    V, Q = h * w, (h * w if Q is None else Q)
    return (torch.zeros((B, V, H, D), dtype=dtype), ((h, w),) * L,
            torch.zeros((B, Q, H, L, P, 2)), torch.zeros((B, Q, H, L, P)))


@pytest.mark.parametrize("kw, err, match", [
    (dict(L=2), ValueError, "one level"),
    (dict(Q=7), ValueError, "queries"),
    (dict(dtype=torch.bfloat16), TypeError, "f32"),
    (dict(D=2), ValueError, "D in"),
    (dict(D=36), ValueError, "D in"),
    (dict(D=64), ValueError, "D in"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(kw, err, match):
    value, shapes, loc, attn = _local_args(**kw)
    with pytest.raises(err, match=match):
        msda_cuda.check_local(value, shapes, loc, attn)
    with pytest.raises(err, match=match):
        msda_cuda.msda_fwd_local(value, shapes, loc, attn)
    g = torch.zeros((value.shape[0], loc.shape[1], value.shape[2] * value.shape[3]))
    with pytest.raises(err, match=match):
        msda_cuda.msda_bwd_local(value, shapes, loc, attn, g)


def test_blocks_refuse_more_samples_than_their_shared_memory_holds():
    # 40 samples a query: the forward's block holds them, the backward's
    # does not; 64: neither
    value, shapes, loc, attn = _local_args(P=40)
    g = torch.zeros((1, 20, 32))
    assert msda_cuda.local_fwd_smem(16, 40) <= msda_cuda.LOCAL_MAX_SMEM
    assert msda_cuda.local_bwd_smem(16, 40) > msda_cuda.LOCAL_MAX_SMEM
    msda_cuda.check_local(value, shapes, loc, attn)
    with pytest.raises(ValueError, match="bytes a block"):
        msda_cuda.check_local(value, shapes, loc, attn, g)
    value, shapes, loc, attn = _local_args(P=64)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        msda_cuda.check_local(value, shapes, loc, attn)


@pytest.mark.parametrize("grad", [False, True])
def test_a_forward_refuses_before_any_work_what_its_backward_cannot_take(
        monkeypatch, grad):
    # 40 samples a query fit the forward's block, not the backward's: a
    # forward whose gradients will be taken raises before its launch
    launched = []
    monkeypatch.setattr(tmsda, "use_plain", lambda t: False)
    monkeypatch.setattr(msda_cuda, "msda_fwd_local",
                        lambda *a: launched.append(1) or tmsda.ms_deform_attn_ref(*a))
    value, shapes, loc, attn = _local_args(P=40)
    value.requires_grad_(grad)
    if grad:
        with pytest.raises(ValueError, match="bytes a block"):
            tmsda.ms_deform_attn_local(value, shapes, loc, attn)
        assert launched == []
    else:
        out = tmsda.ms_deform_attn_local(value, shapes, loc, attn)
        assert launched == [1] and out.shape == (1, 20, 32)


def test_wrappers_launch_only_on_cuda_tensors():
    value, shapes, loc, attn = _local_args()
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_fwd_local(value, shapes, loc, attn)
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_bwd_local(value, shapes, loc, attn,
                                 torch.zeros((1, 20, 32)))


@pytest.mark.parametrize("kw", [dict(L=2), dict(Q=7)])
def test_front_end_refuses_calls_that_are_not_tile_local_on_any_device(kw):
    value, shapes, loc, attn = _local_args(**kw)
    with pytest.raises(ValueError, match="one level"):
        tmsda.ms_deform_attn_local(value, shapes, loc, attn)


def test_front_end_on_meta_tallies_the_local_entry():
    from apollo_vision_net_tpu_torch.ops import cost

    value, shapes, loc, attn = (t.to("meta") if isinstance(t, torch.Tensor)
                                else t for t in _local_args(B=2, H=3))
    with cost.tally_kernel_operations() as tally:
        out = tmsda.ms_deform_attn_local(value, shapes, loc, attn)
    assert out.shape == (2, 20, 48) and out.device.type == "meta"
    assert tally == {"msda_fwd_local": cost.msda_operations(2 * 20, 3, 1, 9, 16)}


# -------------------------------------------------------------- chip_smoke

def test_chip_smoke_local_cases():
    import chip_smoke

    dev = torch.device("cpu")
    vec = chip_smoke.dcnv3_cases(dev)
    local = chip_smoke.dcnv3_local_cases(vec)
    assert [c["name"] for c in local] == [f"dcnv3_local_stage{i}" for i in range(4)]
    for c, v in zip(local, vec):
        assert c["kind"] == "local" and c["dtypes"] == (torch.float32,)
        assert c["vs"] == v["name"] and c["value"] is v["value"]
        msda_cuda.check_local(c["value"], c["shapes"], c["loc"], c["attn"],
                              torch.zeros(c["value"].shape[0], c["loc"].shape[1],
                                          c["value"].shape[2] * c["value"].shape[3]))
        assert c["shapes"] == ((c["value"].shape[1] // c["shapes"][0][1],
                                c["shapes"][0][1]),)
    assert [c["shapes"][0] for c in local] == [(120, 200), (60, 100), (30, 50), (15, 25)]
    edges = {c["name"]: c for c in chip_smoke.local_edge_cases(dev)}
    fwd, bwd = msda_cuda.LOCAL_FWD_TILE, msda_cuda.LOCAL_BWD_TILE
    far = edges["edge_local_outside_halo"]
    for tile in (fwd, bwd):
        assert chip_smoke.outside_halo(far["loc"], far["shapes"], tile) == 1.0
    assert edges["edge_local_15x25"]["shapes"] == ((15, 25),)
    w = edges["edge_local_ragged_D12"]["shapes"][0][1]
    assert w % fwd[1] and w % bwd[1]
    assert {c["value"].shape[-1] for c in edges.values()} >= {4, 12, 16, 32}
    for c in edges.values():
        msda_cuda.check_local(c["value"], c["shapes"], c["loc"], c["attn"])
    # corners off the image: some of the in-grid test's corners fall outside
    off = edges["edge_local_off_image"]
    (h, w), = off["shapes"]
    x = torch.floor(off["loc"][..., 0] * w - 0.5)
    assert bool(((x < 0) | (x + 1 >= w)).any())
    # N(0, 1) px offsets on the stage-0 map: a few corners leave the halo
    share = chip_smoke.outside_halo(local[0]["loc"], local[0]["shapes"], fwd)
    assert 0.0 < share < 0.1


def test_outside_halo_counts_only_corners_in_the_grid():
    import chip_smoke

    # zero offsets: every tap on a pixel centre, every in-grid corner within
    # a cell of its query, inside any halo of 3 cells
    off = torch.zeros((1, 9, 40, 2, 9, 2))
    loc = tdcn.sampling_locations(off)
    assert chip_smoke.outside_halo(loc, ((9, 40),), (8, 32)) == 0.0


def test_dryrun_multichip_runs_on_the_card_unless_asked_for_the_cpu():
    from apollo_vision_net_tpu_torch.tools import dryrun_multichip as dm

    assert inspect.signature(dm.dryrun_multichip).parameters["device"].default == "cuda"
    assert re.search(r'add_argument\("--device", default="cuda"',
                     inspect.getsource(dm.main))
