"""The map-resident MSDA entry of the port (``msda_cuda.msda_fwd_resident``
and ``msda_bwd_resident``, which ``ops.msda.ms_deform_attn`` takes for the
f32 single-level SCA over the cameras' 15x25 map) against the JAX package
on the CPU, and its host-side rules (the kernels run only on the card;
chip_smoke.py holds them against the plain version there).

- The plain MSDA and its gradients (value, locations, weights) against
  JAX's ``ms_deform_attn_xla`` through ``jax.vjp`` at a small long-list
  shape (2 cameras, a 3x5 map, 2 heads of D = 4 and 8, 600 queries of 8
  samples, corners on the map's edges and outside it), without and with a
  tile mask (JAX's output times the mask, as its callers mask it): f32,
  1e-5 of the output and 1e-4 of each gradient's largest magnitude. On the
  kernel branch (forced here, the kernels replaced by the plain version
  and its autograd) ``ResidentMSDAFunction`` gives the same gradients.
- ``resident_heads`` and RESIDENT_MAP_BYTES equal csrc/msda_common.cuh's,
  the budget edge inclusive; the blocks' shared memory fits at every D.
- ``takes_resident`` takes every f32 single-level SCA over 15x25 of the
  voxel, hybrid and bev_tiny_det heads, and not bf16, D = 2, the
  refinement SCA over 30x50, several levels or DCNv3's calls.
- The wrappers refuse CPU tensors and what the kernels do not take; on
  meta tensors the front end tallies ``msda_fwd_resident``.
- chip_smoke.py's resident cases and launch expectations.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.ops.msda import ms_deform_attn_xla
from apollo_vision_net_tpu_torch.configs import (
    bev_tiny_det,
    bev_tiny_det_map_apollo,
    hybrid_base_occ,
    hybrid_tiny_occ,
    hybrid_tiny_occ_intern_s,
    voxel_base_occ,
    voxel_tiny_occ,
)
from apollo_vision_net_tpu_torch.ops import cost
from apollo_vision_net_tpu_torch.ops import msda as tmsda
from apollo_vision_net_tpu_torch.ops import msda_cuda

from test_torch_occ import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OUT_TOL = 1e-5
GRAD_REL_TOL = 1e-4
CSRC = Path(msda_cuda.__file__).resolve().parent.parent / "csrc"


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _inputs(D, seed, B=2, h=3, w=5, H=2, Q=600, P=8, q_tile=32):
    """Locations uniform over [-0.2, 1.2]^2 of the map, a sixth of them
    with px and py whole (one corner's bilinear weight exactly 0), from a
    cell outside the map's border to one past its far side, weights
    softmaxed over the samples, a tile mask with both values."""
    rng = np.random.default_rng(seed)
    value = rng.standard_normal((B, h * w, H, D)).astype(np.float32)
    loc = rng.uniform(-0.2, 1.2, (B, Q, H, 1, P, 2)).astype(np.float32)
    edge = rng.random((B, Q, H, 1, P)) < 1 / 6
    on = np.stack([(rng.integers(-1, w + 1, edge.shape) + 0.5) / w,
                   (rng.integers(-1, h + 1, edge.shape) + 0.5) / h], -1)
    loc = np.where(edge[..., None], on, loc).astype(np.float32)
    logits = rng.standard_normal((B, Q, H, 1, P))
    attn = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).astype(np.float32)
    n_tiles = (Q + q_tile - 1) // q_tile
    mask = (rng.random((B, n_tiles)) > 0.4).astype(np.int32)
    mask[:, 0], mask[:, 1] = 0, 1
    g = rng.standard_normal((B, Q, H * D)).astype(np.float32)
    return value, ((h, w),), loc, attn, mask, g


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_msda_and_its_gradients_match_jax_at_a_long_list_shape(D, masked):
    value, shapes, loc, attn, mask, g = _inputs(D, seed=D + masked)
    q_tile = 32
    B, Q = loc.shape[:2]
    keep = np.repeat(mask, q_tile, axis=1)[:, :Q, None].astype(np.float32)
    # corners on the map's edges and outside it
    px = loc[..., 0] * shapes[0][1] - 0.5
    assert (px < 0).any() and (px + 1 >= shapes[0][1]).any()
    assert (np.floor(px) == px).any()

    def jax_fn(v, l, a):
        out = ms_deform_attn_xla(v, shapes, l, a)
        return out * keep if masked else out

    want, vjp = jax.vjp(jax_fn, jnp.asarray(value), jnp.asarray(loc),
                        jnp.asarray(attn))
    want_grads = vjp(jnp.asarray(g))
    ins = [torch.tensor(t, requires_grad=True) for t in (value, loc, attn)]
    tm = torch.tensor(mask) if masked else None
    assert msda_cuda.takes_resident(ins[0], shapes, ins[1])
    out = tmsda.ms_deform_attn(*ins[:1], shapes, *ins[1:], tile_mask=tm,
                               q_tile=q_tile)
    assert _rel_err(out.detach(), want) <= OUT_TOL
    got = torch.autograd.grad(out, ins, torch.tensor(g))
    for a, b in zip(got, want_grads):
        assert _rel_err(a, b) <= GRAD_REL_TOL
    if masked:  # a masked tile's queries: zero output, zero gradients
        assert float(out.detach()[0, :q_tile].abs().max()) == 0.0
        assert float(got[1][0, :q_tile].abs().max()) == 0.0


def test_resident_function_runs_the_resident_wrappers(monkeypatch):
    """The kernel branch of ``ms_deform_attn`` (forced, the wrappers replaced
    by the plain version and its autograd) sends an f32 single-level call
    to ResidentMSDAFunction: one resident forward, one resident backward,
    the plain gradients, the tile mask passed through."""
    value, shapes, loc, attn, mask, g = _inputs(8, seed=3)
    calls = []

    def fwd(v, s, l, a, *, tile_mask, q_tile):
        calls.append(("fwd", tile_mask is not None, q_tile))
        return tmsda.ms_deform_attn_ref(v, s, l, a, tile_mask=tile_mask,
                                        q_tile=q_tile)

    def bwd(v, s, l, a, go, *, tile_mask, q_tile):
        calls.append(("bwd", tile_mask is not None, q_tile))
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (v, l, a)]
            out = tmsda.ms_deform_attn_ref(ins[0], s, ins[1], ins[2],
                                           tile_mask=tile_mask, q_tile=q_tile)
            return torch.autograd.grad(out, ins, go)

    monkeypatch.setattr(tmsda, "use_plain", lambda t: False)
    monkeypatch.setattr(msda_cuda, "msda_fwd_resident", fwd)
    monkeypatch.setattr(msda_cuda, "msda_bwd_resident", bwd)
    ins = [torch.tensor(t, requires_grad=True) for t in (value, loc, attn)]
    tm = torch.tensor(mask)
    out = tmsda.ms_deform_attn(ins[0], shapes, ins[1], ins[2], tile_mask=tm,
                               q_tile=32)
    got = torch.autograd.grad(out, ins, torch.tensor(g))
    assert calls == [("fwd", True, 32), ("bwd", True, 32)]
    refs = [torch.tensor(t, requires_grad=True) for t in (value, loc, attn)]
    want = torch.autograd.grad(tmsda.ms_deform_attn_ref(
        refs[0], shapes, refs[1], refs[2], tile_mask=tm, q_tile=32), refs,
        torch.tensor(g))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ rules

def c_const(name):
    """A constexpr int of csrc/msda_common.cuh (a literal or a product)."""
    text = (CSRC / "msda_common.cuh").read_text()
    m = re.search(rf"\b{name} = ([^,;]+)[,;]", text)
    return eval(m.group(1), {})


def test_python_resident_constants_equal_the_c_ones():
    assert msda_cuda.RESIDENT_MAP_BYTES == c_const("kResidentMapBytes") == 49_152
    assert msda_cuda.RESIDENT_THREADS == c_const("kResidentThreads")
    common = (CSRC / "msda_common.cuh").read_text()
    # the C rule, as mirrored: the largest divisor within the budget
    assert ("if (H % hb == 0 && (int64_t)V * hb * D * 4 <= kResidentMapBytes)"
            " return hb;" in common)
    fwd = (CSRC / "msda_fwd.cu").read_text()
    assert "(D != 4 && D != 8 && D != 16 && D != 32)" in fwd
    assert msda_cuda.RESIDENT_MAX_POINTS == c_const("kResidentMaxPoints")
    # both entries' blocks take the staged map and a row of zeros
    bwd = (CSRC / "msda_bwd.cu").read_text()
    for text in (fwd, bwd):
        assert "  return (V * Hb + 1) * D * 4;\n}" in text
    assert tuple(msda_cuda.RESIDENT_WIDTHS) == (4, 8, 16, 32)


def test_resident_heads_over_15x25_and_the_inclusive_budget_edge():
    # 8 heads over 375 cells: 48,000 bytes a head at D = 32, 8 heads at D = 4
    assert [msda_cuda.resident_heads(375, 8, D) for D in (32, 16, 8, 4)] == [1, 2, 4, 8]
    # exactly RESIDENT_MAP_BYTES: 384 cells of D = 32; one cell more: none
    assert msda_cuda.resident_heads(384, 8, 32) == 1
    assert msda_cuda.resident_heads(385, 8, 32) == 0
    assert msda_cuda.resident_heads(768, 8, 16) == 1
    assert msda_cuda.resident_heads(769, 8, 16) == 0
    # the largest divisor of H, not the largest count: 6 heads of D = 8
    # over 375 cells fit 4 a block by bytes, 3 by division
    assert msda_cuda.resident_heads(375, 6, 8) == 3
    assert msda_cuda.resident_heads(375, 7, 8) == 1


@pytest.mark.parametrize("D", [4, 8, 16, 32])
def test_block_shared_memory_fits_at_every_width(D):
    hb = msda_cuda.resident_heads(375, 8, D)
    assert msda_cuda.resident_smem(375, 8, D) == (375 * hb + 1) * D * 4
    # four blocks an SM (228 KB an SM, 1 KB of it reserved a block), at
    # any budget-sized map
    for V in (375, msda_cuda.RESIDENT_MAP_BYTES // (D * 4)):
        assert 4 * (msda_cuda.resident_smem(V, 8, D) + 1024) <= 228 * 1024


def _sca_args(V=375, H=8, D=32, L=1, P=8, Q=10, dtype=torch.float32, B=6,
              device="cpu"):
    return (torch.zeros((B, V * L, H, D), dtype=dtype, device=device),
            ((15, V // 15),) * L if V % 15 == 0 else ((1, V),) * L,
            torch.zeros((B, Q, H, L, P, 2), device=device),
            torch.zeros((B, Q, H, L, P), device=device))


# (Q, D) of the f32 single-level SCA calls over 15x25 that ISSUE's table
# lists: bev_tiny_det (masked), voxel_base, hybrid_base stages 0-3, voxel,
# hybrid stages 1-3
MAIN_SCA = [(40_000, 32), (40_000, 32), (10_000, 32), (20_000, 16),
            (40_000, 8), (80_000, 4), (10_000, 32), (5_000, 16), (10_000, 8),
            (20_000, 4)]


@pytest.mark.parametrize("Q, D", MAIN_SCA)
def test_rule_takes_the_resident_entry_at_every_main_sca_shape(Q, D):
    value, shapes, loc, attn = _sca_args(D=D, Q=Q)
    assert shapes == ((15, 25),)
    assert msda_cuda.takes_resident(value, shapes, loc)
    assert msda_cuda.check_resident(value, shapes, loc, attn, None, 32) == (
        6, 15, 25, 8, D, Q, 8)
    # the gather plan the backward left: a main shape's, had it stayed
    assert msda_cuda.BWD_VARIANTS[msda_cuda.bwd_plan(6, 375, 8, D, Q, 8)] == "gather"


@pytest.mark.parametrize("kw, why", [
    (dict(dtype=torch.bfloat16), "bf16"),
    (dict(D=2), "the D = 2 stage: narrow and private"),
    (dict(V=1500), "tsa's refinement SCA over 30x50: 192 KB a head"),
    (dict(V=2500), "a TSA or decoder over the 50x50 BEV"),
    (dict(L=2), "several levels"),
    (dict(D=12), "a width without four lanes of 4"),
])
def test_rule_leaves_the_other_calls_on_their_entries(kw, why):
    value, shapes, loc, attn = _sca_args(**kw)
    assert not msda_cuda.takes_resident(value, shapes, loc), why


def test_dcnv3_calls_keep_the_tile_local_entry(monkeypatch):
    """DCNv3's stage-3 call is a single-level f32 call over 15x25 too, but
    ``ms_deform_attn_local`` takes it, never the resident entry."""
    from apollo_vision_net_tpu_torch.ops import dcnv3

    monkeypatch.setattr(tmsda, "use_plain", lambda t: False)
    sent = []
    monkeypatch.setattr(tmsda, "LocalMSDAFunction",
                        type("F", (), {"apply": staticmethod(
                            lambda *a: sent.append("local") or torch.zeros(1))}))
    monkeypatch.setattr(tmsda, "ResidentMSDAFunction",
                        type("F", (), {"apply": staticmethod(
                            lambda *a: sent.append("resident") or torch.zeros(1))}))
    value, shapes, loc, attn = _sca_args(D=16, Q=375, B=1, P=9)
    assert msda_cuda.takes_resident(value, shapes, loc)
    tmsda.ms_deform_attn_local(value, shapes, loc, attn)
    assert sent == ["local"]
    assert "ms_deform_attn_local" in Path(dcnv3.__file__).read_text()


@pytest.mark.parametrize("kw, err, match", [
    (dict(L=2), ValueError, "one level"),
    (dict(dtype=torch.bfloat16), TypeError, "f32"),
    (dict(D=2), ValueError, "D in"),
    (dict(D=64), ValueError, "D in"),
    (dict(V=1500), ValueError, "bytes"),
    (dict(P=129), ValueError, "samples a head"),
])
def test_wrappers_refuse_what_the_kernels_do_not_take(kw, err, match):
    value, shapes, loc, attn = _sca_args(**kw)
    g = torch.zeros((value.shape[0], loc.shape[1], value.shape[2] * value.shape[3]))
    with pytest.raises(err, match=match):
        msda_cuda.check_resident(value, shapes, loc, attn, None, 32)
    with pytest.raises(err, match=match):
        msda_cuda.msda_fwd_resident(value, shapes, loc, attn)
    with pytest.raises(err, match=match):
        msda_cuda.msda_bwd_resident(value, shapes, loc, attn, g)


def test_wrappers_launch_only_on_cuda_tensors():
    value, shapes, loc, attn = _sca_args()
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_fwd_resident(value, shapes, loc, attn)
    with pytest.raises(ValueError, match="CUDA"):
        msda_cuda.msda_bwd_resident(value, shapes, loc, attn,
                                    torch.zeros((6, 10, 256)))
    # a tile mask of the wrong shape is refused before any device is touched
    with pytest.raises(ValueError, match="tile_mask"):
        msda_cuda.check_resident(value, shapes, loc, attn,
                                 torch.zeros((6, 2), dtype=torch.int32), 32)


def test_front_end_on_meta_tallies_the_resident_entry():
    value, shapes, loc, attn = _sca_args(D=16, Q=100, device="meta")
    mask = torch.zeros((6, 4), dtype=torch.int32, device="meta")
    with cost.tally_kernel_operations() as tally:
        out = tmsda.ms_deform_attn(value, shapes, loc, attn, tile_mask=mask)
        tmsda.ms_deform_attn(*_sca_args(D=2, Q=100, device="meta"))
    assert out.shape == (6, 100, 128) and out.device.type == "meta"
    assert tally == {"msda_fwd_resident": cost.msda_operations(600, 8, 1, 8, 16),
                     "msda_fwd": cost.msda_operations(600, 8, 1, 8, 2)}


# -------------------------------------------------------------- chip_smoke

def test_chip_smoke_resident_cases():
    """The resident rows: the SCA cases of bev_tiny_det, voxel_tiny_occ,
    voxel_base_occ, hybrid_tiny_occ's stages 1-3 and hybrid_base_occ's
    stages 0-3 (D >= 4) on the same tensors in f32, each beside its vector
    row; the edge cases (a hot row, the border, masked tiles in a run with
    Q off the run, each D, 3 heads a block, the exact budget) all taken by
    the rule."""
    import chip_smoke

    dev = torch.device("cpu")
    shapes = {"sca_tiny_det": (6, 375, 8, 32, 40_000),
              "sca_voxel": (6, 375, 8, 32, 10_000),
              "sca_voxel_base": (6, 375, 8, 32, 40_000),
              "sca_hybrid_base_stage0": (6, 375, 8, 32, 10_000)}
    sca = [c for c in chip_smoke.tiny_det_cases(dev) + chip_smoke.voxel_cases(dev)
           + chip_smoke.voxel_base_cases(dev) if c["name"].startswith("sca")]
    res = chip_smoke.resident_cases(sca)
    names = {c["name"] for c in res}
    assert names == {f"{n}_resident" for n in (
        "sca_tiny_det", "sca_voxel", "sca_voxel_base",
        *(f"sca_hybrid_stage{s}" for s in (1, 2, 3)),
        *(f"sca_hybrid_base_stage{s}" for s in (0, 1, 2, 3)))}
    by_name = {c["name"]: c for c in sca}
    for c in res:
        v = by_name[c["vs"]]
        assert c["kind"] == "resident" and c["dtypes"] == (torch.float32,)
        assert c["value"] is v["value"] and c["shapes"] == ((15, 25),)
        if c["vs"] in shapes:
            B, V, H, D = c["value"].shape
            assert (B, V, H, D, c["loc"].shape[1]) == shapes[c["vs"]]
    assert next(c for c in res if c["vs"] == "sca_tiny_det")["tile_mask"] is not None
    edges = {c["name"]: c for c in chip_smoke.resident_edge_cases(dev)}
    for c in edges.values():
        assert c["kind"] == "resident"
        assert msda_cuda.takes_resident(c["value"], c["shapes"], c["loc"])
        B, V, H, D = c["value"].shape
        msda_cuda.check_resident(c["value"], c["shapes"], c["loc"], c["attn"],
                                 c["tile_mask"], c["q_tile"])
    assert {c["value"].shape[-1] for c in edges.values()} == {4, 8, 16, 32}
    hot = edges["edge_resident_hot_row"]["loc"].reshape(-1, 2)
    assert bool((hot == hot[0]).all())
    border = edges["edge_resident_border"]
    (h, w), = border["shapes"]
    x = torch.floor(border["loc"][..., 0] * w - 0.5)
    assert bool((x < 0).any()) and bool((x + 1 >= w).any())
    for name in ("edge_resident_masked_D16", "edge_resident_masked_D4"):
        c = edges[name]
        Q, D = c["loc"].shape[1], c["value"].shape[-1]
        # Q a multiple of neither the tile nor a block's round of items
        assert Q % c["q_tile"] and Q % (msda_cuda.RESIDENT_THREADS // (D // 4))
        assert bool(c["tile_mask"].any()) and not bool(c["tile_mask"].all())
    B, V, H, D = edges["edge_resident_budget_D32"]["value"].shape
    assert V * D * 4 == msda_cuda.RESIDENT_MAP_BYTES
    B, V, H, D = edges["edge_resident_H6_D8"]["value"].shape
    assert msda_cuda.resident_heads(V, H, D) == 3


def test_chip_smoke_names_the_resident_entry_on_the_main_paths():
    """The f32 single-level SCA over 15x25 launches the resident entries and
    nothing on the vector and gather kernels there: bev_tiny_det's 3 a
    frame, 9 + 3 a step; the voxel heads' 3, 9 + 3; the hybrids' stages
    0-3, 4 a frame, 12 + 4 a step, their D = 2 stage on narrow and private
    and DCNv3 on the tile-local entry. The flagship keeps its entries."""
    import chip_smoke

    frame = chip_smoke.stream_launches_per_frame(bev_tiny_det())
    step = chip_smoke.train_launches_per_step(bev_tiny_det())
    assert (frame["msda_fwd_resident"], frame["msda_fwd_masked"]) == (3, 0)
    assert (step["msda_fwd_resident"], step["msda_bwd_resident"]) == (9, 3)
    assert step["msda_fwd_masked"] == step["msda_bwd_masked"] == 0
    for config in (voxel_tiny_occ, voxel_base_occ):
        frame = chip_smoke.stream_launches_per_frame(config())
        step = chip_smoke.train_launches_per_step(config())
        assert (frame["msda_fwd_resident"], frame["msda_fwd"]) == (3, 6)
        assert (step["msda_fwd_resident"], step["msda_bwd_resident"]) == (9, 3)
        assert step["msda_bwd"] == step["msda_bwd.gather"] == 6
    for config in (hybrid_tiny_occ, hybrid_base_occ, hybrid_tiny_occ_intern_s):
        frame = chip_smoke.stream_launches_per_frame(config())
        step = chip_smoke.train_launches_per_step(config())
        assert frame["msda_fwd_resident"] == 4 and frame["msda_fwd.narrow"] == 1
        assert (step["msda_fwd_resident"], step["msda_bwd_resident"]) == (12, 4)
        assert step["msda_bwd.private"] == 1 and step["msda_fwd.narrow"] == 3
        # the TSA of stage 0 and the 6 det decoder layers over the BEV
        assert step["msda_bwd.gather"] == 7 and frame["msda_fwd.vector"] == 7
    assert chip_smoke.train_launches_per_step(hybrid_tiny_occ_intern_s())[
        "msda_bwd_local"] == 33
    flag = chip_smoke.train_launches_per_step(bev_tiny_det_map_apollo())
    assert flag["msda_fwd_resident"] == flag["msda_bwd_resident"] == 0
    assert flag["msda_bwd_masked.gather"] == 3
    line = chip_smoke.FRAME_CALLS
    assert set(line["msda_fwd_resident"][1]) == {
        f"sca_hybrid_base_stage{i}_resident" for i in range(4)}
    assert chip_smoke.ENTRY_DTYPE["msda_bwd_resident"] == "float32"
    assert {"msda_resident_kernel", "msda_bwd_resident_items_kernel",
            "msda_bwd_resident_samples_kernel"} <= set(chip_smoke.VECTOR_KERNELS)
