"""The host-side choices of the MSDA backward kernels and the backward
variants that chip_smoke.py expects, checked on the CPU (the kernels
themselves run only on the card).

- ``msda_cuda.bwd_plan``, ``bwd_items_per_warp`` and
  ``bwd_gather_scratch``: the plan of ``msda_bwd`` (gather or general),
  the items a warp of its vector kernel takes and the sizes of the gather
  plan's lists, against the rules csrc/msda_bwd.cu holds.
- ``msda_cuda.factored_bwd_plan``: which levels' grad_value rows the vector
  kernel of ``msda_bwd_factored`` sums in shared memory, at the base SCA
  shape (levels 2-3 of the 4-level FPN) and at edge shapes (every level,
  none, the budget's exact edge), within the budget and block size that
  the C entry holds too.
- ``chip_smoke.py``'s expectations of the variants that the main paths and
  the edge cases reach.
"""
import re
from pathlib import Path

import pytest
import torch

from apollo_vision_net_tpu_torch.configs import (
    bev_base_det_map,
    bev_base_occ,
    bev_tiny_det_map_apollo,
    bev_tiny_det_occ_apollo,
)
from apollo_vision_net_tpu_torch.ops import dcn_cuda, msda_cuda

BWD_SRC = (Path(msda_cuda.__file__).resolve().parent.parent / "csrc"
           / "msda_bwd.cu")


def c_const(name):
    """A constexpr int of csrc/msda_bwd.cu (a product of literals)."""
    m = re.search(rf"\b{name} = ([^,;]+)[,;]", BWD_SRC.read_text())
    return eval(m.group(1), {})


def fpn_shapes(cfg):
    """The FPN levels of the config's images, as SCA samples them: stride
    8, then each stride-2 conv halving, rounding up."""
    m = cfg.model
    hh, ww = m.img_shape[0] // 8, m.img_shape[1] // 8
    shapes = []
    for _ in range(m.num_feature_levels):
        shapes.append((hh, ww))
        hh, ww = (hh + 1) // 2, (ww + 1) // 2
    return tuple(shapes)


@pytest.mark.parametrize("config", [bev_base_det_map, bev_base_occ])
def test_factored_bwd_plan_privatises_levels_2_and_3_at_the_base_shape(config):
    cfg = config()
    shapes = fpn_shapes(cfg)
    assert shapes == ((60, 100), (30, 50), (15, 25), (8, 13))
    m = cfg.model
    D, P = m.embed_dims // 8, 8
    run = msda_cuda.FACTORED_BWD_RUN
    assert msda_cuda.factored_bwd_plan(shapes, D, P) == 2
    # 128 queries x 32 ch of g, 128 x 16 samples x 4 corners x 8 bytes,
    # 479 rows x 12 bytes: two blocks an SM
    used = msda_cuda.factored_bwd_priv_bytes(run, D, 2 * P, 375 + 104)
    assert used == 16_384 + 65_536 + 5_752
    assert used <= msda_cuda.FACTORED_BWD_PRIVATE_BYTES
    assert 2 * msda_cuda.FACTORED_BWD_PRIVATE_BYTES <= 227 * 1024
    # level 1 as well would not fit
    assert msda_cuda.factored_bwd_priv_bytes(
        run, D, 3 * P, 1500 + 375 + 104) > msda_cuda.FACTORED_BWD_PRIVATE_BYTES


@pytest.mark.parametrize("shapes,D,P,expect", [
    (((10, 12), (5, 6), (3, 3)), 32, 4, 0),       # every level
    (((100, 100),), 32, 4, 1),                    # none: 10,000 rows
    (((9, 13), (5, 7), (3, 4), (1, 1)), 32, 8, 2),
    (((12, 20), (6, 10), (3, 5), (2, 3)), 32, 8, 2),
    (((11, 5), (6, 3), (3, 2)), 32, 12, 2),
    (((6, 10), (3, 5)), 16, 5, 0),
    (((5, 7), (3, 3)), 4, 4, 0),
])
def test_factored_bwd_plan_edge_shapes(shapes, D, P, expect):
    private_from = msda_cuda.factored_bwd_plan(shapes, D, P)
    run = msda_cuda.FACTORED_BWD_RUN
    assert private_from == expect
    budget = msda_cuda.FACTORED_BWD_PRIVATE_BYTES

    def used(lvl):
        keys = sum(h * w for h, w in shapes[lvl:])
        return msda_cuda.factored_bwd_priv_bytes(
            run, D, (len(shapes) - lvl) * P, keys)

    if private_from < len(shapes):
        assert used(private_from) <= budget
    if private_from > 0:  # the next level up would overflow the budget
        assert used(private_from - 1) > budget


def test_factored_bwd_plan_budget_edge_is_inclusive(monkeypatch):
    shapes, D, P = ((20, 20), (8, 8)), 32, 4
    both = msda_cuda.factored_bwd_priv_bytes(128, D, 2 * P, 464)
    last = msda_cuda.factored_bwd_priv_bytes(128, D, P, 64)

    def private_from(budget, shapes=shapes, P=P):
        monkeypatch.setattr(msda_cuda, "FACTORED_BWD_PRIVATE_BYTES", budget)
        return msda_cuda.factored_bwd_plan(shapes, D, P)

    assert private_from(both) == 0
    assert private_from(both - 1) == 1
    assert private_from(last) == 1
    assert private_from(last - 1) == 2
    # the list indexes slots with 16 bits: a run of 128 queries x 129
    # private samples x 4 corners does not fit whatever the budget
    assert private_from(1 << 30, shapes=((2, 2),), P=129) == 1


@pytest.mark.parametrize("shapes,D,P", [
    (((60, 100), (30, 50), (15, 25), (8, 13)), 32, 8),
    (((4, 4),), 32, 4), (((100, 100),), 32, 4)])
def test_factored_bwd_run_is_the_block_size_whatever_the_levels(shapes, D, P):
    """A block takes FACTORED_BWD_RUN queries however many levels it keeps
    (a tile of the mask may span several blocks), the number and the
    budget that csrc/msda_bwd.cu holds as kPrivRun and kPrivMaxBytes (its
    entry refuses a plan beyond them); the plan's shared memory stays within
    the budget, and with 16-bit list indices."""
    assert c_const("kPrivRun") == msda_cuda.FACTORED_BWD_RUN == 128
    assert c_const("kPrivMaxBytes") == msda_cuda.FACTORED_BWD_PRIVATE_BYTES
    private_from = msda_cuda.factored_bwd_plan(shapes, D, P)
    run = msda_cuda.FACTORED_BWD_RUN
    sp = (len(shapes) - private_from) * P
    assert run * sp * 4 <= 65536
    if private_from < len(shapes):
        keys = sum(h * w for h, w in shapes[private_from:])
        assert msda_cuda.factored_bwd_priv_bytes(
            run, D, sp, keys) <= msda_cuda.FACTORED_BWD_PRIVATE_BYTES


def test_chip_smoke_expects_the_new_variants_on_the_main_paths():
    import chip_smoke

    per_step = chip_smoke.train_launches_per_step(bev_base_det_map())
    assert per_step["msda_bwd_factored"] == per_step[
        "msda_bwd_factored.privatized"] == 6
    assert per_step["dcn_bwd"] == per_step["dcn_bwd.quad"] == 26
    assert per_step["msda_bwd_factored.vector"] == 0
    occ = chip_smoke.train_launches_per_step(bev_base_occ())
    assert (occ["msda_bwd.gather"], occ["msda_bwd_factored.privatized"],
            occ["dcn_bwd.quad"]) == (12, 6, 26)
    assert per_step["msda_bwd"] == per_step["msda_bwd.gather"] == 18
    assert per_step["msda_bwd.general"] == 0
    # the flagship and det+occ steps: TSA and decoders plain, SCA masked
    for config, plain in ((bev_tiny_det_map_apollo, 15),
                          (bev_tiny_det_occ_apollo, 9)):
        n = chip_smoke.train_launches_per_step(config())
        assert n["msda_bwd"] == n["msda_bwd.gather"] == plain
        assert n["msda_bwd_masked"] == n["msda_bwd_masked.gather"] == 3
    assert set(msda_cuda.BWD_VARIANTS.values()) == {"gather", "general"}
    assert chip_smoke.factored_bwd_variant(
        32, False, fpn_shapes(bev_base_det_map()), 8) == "privatized"
    # D = 4 G (G = 1, 2, 4, 8) takes the privatizing kernel, other head
    # widths and misaligned rows the general one
    for D in (4, 8, 16):
        assert chip_smoke.factored_bwd_variant(
            D, False, fpn_shapes(bev_base_det_map()), 8) == "privatized"
    for D, misaligned in ((12, False), (40, False), (64, False), (32, True)):
        assert chip_smoke.factored_bwd_variant(
            D, misaligned, fpn_shapes(bev_base_det_map()), 8) == "general"
    assert "privatized" in msda_cuda.BWD_FACTORED_VARIANTS.values()
    assert "quad" in dcn_cuda.BWD_VARIANTS.values()


def test_chip_smoke_edge_cases_target_each_backward_variant():
    """The factored edge cases reach privatized, vector and general, and
    the base-size factored rows privatized (at D = 16) and vector; the DCN
    edge cases
    quad and general; each names what it targets."""
    import chip_smoke

    dev = torch.device("cpu")
    fac = {c["name"]: chip_smoke.bind_bwd_factored(c, torch.float32)[-1]
           for c in chip_smoke.factored_edge_cases(dev)}
    assert fac["edge_factored_all_private"] == "privatized"
    assert fac["edge_factored_none_private"] == "vector"
    assert fac["edge_factored_all_cameras"] == "privatized"
    assert set(fac.values()) == {"privatized", "vector", "general"}
    allcam = next(c for c in chip_smoke.factored_edge_cases(dev)
                  if c["name"] == "edge_factored_all_cameras")
    assert bool(allcam["tile_mask"][:, 1].all())
    sca = chip_smoke.factored_case(
        "sca_small", torch.Generator().manual_seed(0), dev, Bs=1, N=2, H=2,
        D=32, Q=20, P=4, shapes=((6, 8), (3, 4)), q_tile=8)
    base = {c["name"]: chip_smoke.bind_bwd_factored(c, torch.float32)[-1]
            for c in chip_smoke.base_factored_bwd_cases(sca)}
    assert base == {"sca_base_factored_D16": "privatized",
                    "sca_base_factored_L1": "vector"}
    names = ("dcn_s3_stride2", "dcn_s3", "dcn_s4_stride2", "dcn_s4")
    for dtype in (torch.float32, torch.bfloat16):
        dcn = {c["name"]: chip_smoke.bind_dcn_bwd(c, dtype)[-1]
               for c in chip_smoke.dcn_cases(dev)}
        assert all(dcn[n] == "quad" for n in names)
        assert (dcn["edge_dcn_offsets_40px"]
                == dcn["edge_dcn_offsets_40px_stride2"] == "quad")
        assert dcn["edge_dcn_misaligned"] == dcn["edge_dcn_far"] == "general"
        assert set(dcn.values()) == {"quad", "general"}
    for name in ("edge_dcn_offsets_40px", "edge_dcn_offsets_40px_stride2"):
        far = next(c for c in chip_smoke.dcn_cases(dev) if c["name"] == name)
        # most samples land more than 16 pixels from their tap
        assert float((far["offset"].abs() > 16).float().mean()) > 0.5



# ------------------------------------------------------------- msda_bwd

def test_bwd_items_per_warp_follows_the_c_slot_rule():
    """A warp of msda_bwd's vector kernel takes 32 / S items, S = L·P
    rounded up to a power of two within [2^kSlotLog2Min, 2^kSlotLog2Max]:
    8 items at L·P = 4 (TSA, decoders), 4 at 8 (SCA), one item in rounds
    of 32 samples beyond 32."""
    assert 1 << c_const("kSlotLog2Min") == msda_cuda.BWD_SLOT_MIN == 4
    assert 1 << c_const("kSlotLog2Max") == msda_cuda.BWD_SLOT_MAX == 32
    assert c_const("kBwdWarps") == msda_cuda.BWD_VEC_WARPS
    table = {1: 8, 2: 8, 3: 8, 4: 8, 5: 4, 8: 4, 9: 2, 12: 2, 16: 2, 17: 1,
             32: 1, 33: 1, 64: 1}
    assert {lp: msda_cuda.bwd_items_per_warp(lp) for lp in table} == table
    # a group of G <= 8 lanes (G / 2 <= 4 <= S) spans at most two items
    for lp in table:
        slot = 32 // msda_cuda.bwd_items_per_warp(lp)
        assert slot >= 8 // 2 and slot >= min(lp, 32)


def test_bwd_plan_takes_gather_at_every_main_shape():
    """The TSA, decoder and single-level SCA calls of the four configs
    (B, V, H, D, Q, L·P) take the gather plan; other head widths, a
    misaligned row and corner slots past 2^31 take the general one, as the
    C entry's checks (the widths below) demand."""
    text = BWD_SRC.read_text()
    widths = tuple(int(w) for w in re.findall(
        r"D == (\d+)", re.search(r"\(D == 4 \|\|[^)]*\)", text).group()))
    assert widths == msda_cuda.BWD_VECTOR_WIDTHS == (4, 8, 16, 32)
    main = [(2, 40000, 8, 32, 40000, 4),     # base TSA
            (1, 40000, 8, 32, 900, 4),       # base det decoder
            (1, 40000, 8, 32, 1000, 4),      # base map decoder
            (2, 2500, 8, 32, 2500, 4),       # flagship TSA
            (6, 1500, 8, 32, 2500, 8),       # flagship SCA (masked)
            (1, 2500, 8, 32, 900, 4),        # flagship det decoder
            (1, 2500, 8, 32, 9900, 4)]       # det+occ train decoder
    for shape in main:
        assert msda_cuda.BWD_VARIANTS[msda_cuda.bwd_plan(*shape)] == "gather"
    for D in (12, 40, 64, 2):
        assert msda_cuda.bwd_plan(1, 100, 2, D, 10, 4) == 0
    assert msda_cuda.bwd_plan(1, 100, 2, 32, 10, 4, aligned=False) == 0
    # 2^31 corner slots or value elements
    assert msda_cuda.bwd_plan(1, 100, 8, 32, 2**24, 4) == 0
    assert msda_cuda.bwd_plan(1, 100, 8, 32, 2**24 - 1, 4) == 1
    assert msda_cuda.bwd_plan(64, 2**20, 8, 32, 10, 4) == 0


def test_bwd_gather_scratch_sizes():
    """The gather plan's lists at the base TSA: a head for each value row
    (2 x 40,000 cells x 8 heads: 2.56 MB) and a (link, weight) pair for
    each of 16 corners of 2 x 40,000 x 8 items (82 MB); the C entry sets
    the B V H heads to -1 and reads the pairs as int2."""
    sizes = msda_cuda.bwd_gather_scratch(2, 40000, 8, 40000, 4)
    assert sizes == {"row_head": 640_000, "slot_links": 20_480_000}
    assert sizes["row_head"] * 4 == 2_560_000
    assert sizes["slot_links"] * 4 == 81_920_000
    text = BWD_SRC.read_text()
    assert "cudaMemsetAsync(row_head, 0xff, n_rows * sizeof(int), s)" in text
    assert "reinterpret_cast<int2*>(slot_links)" in text


def test_chip_smoke_msda_edge_cases_reach_each_backward_shape():
    """chip_smoke's MSDA edge cases reach both msda_bwd plans, 8, 4, 2 and
    1 items a warp (L·P = 3, 4, 5, 8, 12, 64), B·Q·H off a multiple of the
    items a warp takes, warps whose items straddle masked, unmasked and
    tail tiles, D = 4, 8, 16, 32, 40, 64, a misaligned value and a hot row;
    each row names the plan it must take, which ``bwd_plan`` gives."""
    import chip_smoke

    dev = torch.device("cpu")
    cases = [c for c in chip_smoke.msda_edge_cases(dev) if c["kind"] == "msda"]
    seen = set()
    per_warp, straddle, tail = set(), False, False
    for c in cases:
        B, V, H, D = c["value"].shape
        _, Q, _, L, P, _ = c["loc"].shape
        for dt in (torch.float32, torch.bfloat16):
            want = chip_smoke.bind_bwd(c, dt)[-1]
            plan = msda_cuda.bwd_plan(B, V, H, D, Q, L * P,
                                      aligned=not c.get("misaligned"))
            assert want == msda_cuda.BWD_VARIANTS[plan], c["name"]
            seen.add(want)
        if want == "gather":
            k = msda_cuda.bwd_items_per_warp(L * P)
            per_warp.add(k)
            tail |= (B * Q * H) % k != 0
            if c["tile_mask"] is not None:
                tm = c["tile_mask"]
                # a warp's items cross a tile edge, with a mixed mask
                straddle |= ((c["q_tile"] * H) % k != 0
                             and bool(tm.any()) and not bool(tm.all()))
    assert seen == {"gather", "general"}
    assert per_warp == {8, 4, 2, 1}
    assert tail and straddle
    widths = {c["value"].shape[-1] for c in cases}
    assert {4, 8, 16, 32, 40, 64} <= widths
    assert any(c.get("misaligned") for c in cases)
    hot = next(c for c in cases if c["name"] == "edge_bwd_hot_row")
    loc = hot["loc"].reshape(-1, 2)
    assert bool((loc == loc[0]).all())  # every sample on one point
