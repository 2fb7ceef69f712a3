"""The host-side choices of the factored-MSDA backward kernel and the
backward variants that chip_smoke.py expects, checked on the CPU (the
kernels themselves run only on the card).

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

from apollo_vision_net_tpu_torch.configs import bev_base_det_map, bev_base_occ
from apollo_vision_net_tpu_torch.ops import dcn_cuda, msda_cuda


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
    src = (Path(msda_cuda.__file__).resolve().parent.parent / "csrc"
           / "msda_bwd.cu").read_text()

    def const(name):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        return eval(expr, {})  # a product of integer literals

    assert const("kPrivRun") == msda_cuda.FACTORED_BWD_RUN == 128
    assert const("kPrivMaxBytes") == msda_cuda.FACTORED_BWD_PRIVATE_BYTES
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
    assert (occ["msda_bwd.lane_per_channel"], occ["msda_bwd_factored.privatized"],
            occ["dcn_bwd.quad"]) == (12, 6, 26)
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

