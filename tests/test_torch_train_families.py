"""The train steps of the last four configs to train on the card, against
the JAX package on the CPU in f32: ``voxel_base_occ``, ``hybrid_base_occ``,
``bev_base_occ_intern_s`` and ``hybrid_tiny_occ_intern_s``.

Small copies with each config's structure: the R101-DCN configs on a
ResNet-18 with DCN in stages 3-4 (the DCN offset convs damped to 0.01 of
their perturbed weights, as tests/test_torch_train_base.py's small base
step, so that the offsets are a few pixels), the InternImage-S configs on
an InternImage of the same blocks at 16 channels and depths (1, 1, 2, 1)
(the trunk class swapped for one with those defaults in both packages,
``small_internimage``); the voxel and hybrid heads at the smoke configs'
sizes, the base-occupancy head at tests/test_torch_train_base.py's
SMALL_BASE_OCC sizes (a 4-level FPN over InternImage stages 2-4, the
factored SCA); 2 cameras at 64x96, f32, grid mask off, dropout at rate 0
against JAX's ``deterministic=True``.

Each config's step runs on a painted batch of 2 at which JAX's own
gradients agree among the images and six witness images 1e-7 away
(``scan_batch_seeds``, tests/test_torch_occ_options.py's witnesses: no
kink within a rounding of the batch), the port on JAX's assignment: loss
terms within 1e-4 relative, the indices equal to JAX's solver's, and every
gradient within 1e-4 of its largest element (no kink allowance). Readings
of the scan on a CPU (torch on one thread), JAX against
itself over the 7 images / the port against JAX at the 7: voxel_base_occ
seed 1 4.7e-6 / 6.5e-6 (seed 0: JAX itself jumps by 4.2e-3, the port by
0.16 at 5 images: a ReLU kink); hybrid_base_occ seed 0 4.3e-6 / 5.3e-6;
bev_base_occ_intern_s seed 0 2.6e-7 / 3.6e-7; hybrid_tiny_occ_intern_s
seed 0 2.8e-7 / 6.5e-7 (GELU trunks: seeds 0-3 all agree). One JAX compile
of the step per config, with the batch as an argument, shared by its test
and by the scan; the four compile side by side in threads (~2 min in all
on one CPU process, against ~3.5 min one after another).
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apollo_vision_net_tpu.configs import base as jax_configs
from apollo_vision_net_tpu.losses import det_loss as jdet
from apollo_vision_net_tpu.losses import multitask as jmt
from apollo_vision_net_tpu.models import internimage as jii
from apollo_vision_net_tpu.models.detector import BEVFormer as JaxBEVFormer
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu_torch import configs as port_configs
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.data.synthetic import make_batch
from apollo_vision_net_tpu_torch.models import detector
from apollo_vision_net_tpu_torch.models import internimage as tii
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from test_torch_occ import _jax_det_indices, one_torch_thread, perturbed_params  # noqa: F401
from test_torch_occ_options import WITNESS_EPS, WITNESS_SEEDS, _grad_err
from test_torch_train_base import damp_dcn_offsets
from test_torch_voxel import GRAD_REL_TOL, STEP_LOSS_REL_TOL

SMALL_II = dict(channels=16, depths=(1, 1, 2, 1), groups=(1, 2, 4, 8))
R18_DCN = dict(backbone_depth=18, backbone_dcn_stages=(False, False, True, True))
VOXEL = dict(bev_h=6, bev_w=6, bev_z=2, num_query=12, embed_dims=32,
             encoder_layers=1, decoder_layers=2, feedforward_channels=64,
             num_cams=2, img_shape=(64, 96), queue_length=2,
             occ_xdim=12, occ_ydim=12, occ_zdim=4, occ_dims=16)
HYBRID = dict(bev_h=6, bev_w=6, num_query=12, embed_dims=32, decoder_layers=2,
              feedforward_channels=64, num_cams=2, img_shape=(64, 96),
              queue_length=2, hybrid_encoder_embed_dims=(32, 16, 8),
              hybrid_feature_map_z=(1, 2, 4), occ_xdim=12, occ_ydim=12,
              occ_zdim=4, occ_dims=8)
BASE_OCC = dict(bev_h=8, bev_w=8, embed_dims=32, num_cams=2, img_shape=(64, 96),
                encoder_layers=2, decoder_layers=2, feedforward_channels=64,
                num_query=12, queue_length=2, occ_xdim=8, occ_ydim=8,
                occ_zdim=4, occ_dims=16)
# name: (model sizes, DCN offsets damped)
FAMILIES = {
    "voxel_base_occ": (dict(VOXEL, **R18_DCN), True),
    "hybrid_base_occ": (dict(HYBRID, **R18_DCN), True),
    "bev_base_occ_intern_s": (BASE_OCC, False),
    "hybrid_tiny_occ_intern_s": (HYBRID, False),
}
# the painted batch of each step (``scan_batch_seeds``)
BATCH_SEEDS = {"voxel_base_occ": 1, "hybrid_base_occ": 0,
               "bev_base_occ_intern_s": 0, "hybrid_tiny_occ_intern_s": 0}

# torch on one thread (see test_torch_occ.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _JaxSmallInternImage(jii.InternImage):
    channels: int = SMALL_II["channels"]
    depths: tuple = SMALL_II["depths"]
    groups: tuple = SMALL_II["groups"]


class _SmallInternImage(tii.InternImage):
    def __init__(self, **kw):
        super().__init__(**dict(SMALL_II, **kw))


def small_internimage(mp):
    """Both packages' detectors build the small InternImage (SMALL_II) where
    the configs name InternImage-S."""
    mp.setattr(jii, "InternImage", _JaxSmallInternImage)
    mp.setattr(detector, "InternImage", _SmallInternImage)


def small_configs(name):
    sizes, _ = FAMILIES[name]
    out = []
    for pkg in (jax_configs, port_configs):
        cfg = getattr(pkg, name)()
        out.append(dataclasses.replace(
            cfg, compute_dtype="float32",
            model=dataclasses.replace(cfg.model, use_grid_mask=False, **sizes),
            data=dataclasses.replace(cfg.data, max_gt_boxes=8)))
    assert dataclasses.asdict(out[0]) == dataclasses.asdict(out[1])
    return out


def family_setup(name):
    """JAX's model, its params (flax init through ``forward_test_frame``
    plus noise; DCN offsets damped for the R101-DCN configs), its
    value-and-grad step compiled once with the batch as an argument, and
    the port's model on the CPU with the bridged weights (strict), in
    training mode with dropout at rate 0. Call it with ``small_internimage``
    in force."""
    jcfg, tcfg = small_configs(name)
    m = tcfg.model
    jmodel = jax_build_model(jcfg)
    batch = make_batch(tcfg, 2, seed=0, paint_gt=True)
    args = (batch["img"][0, -1][None], batch["can_bus"][0, -1][None],
            batch["lidar2img"][0, -1][None],
            jnp.zeros((1, jmodel.prev_tokens, m.embed_dims)), jnp.zeros((1,)))
    params = jax.jit(functools.partial(
        jmodel.init, method=JaxBEVFormer.forward_test_frame))(
        {"params": jax.random.PRNGKey(0)}, *args)["params"]
    params = perturbed_params(params, seed=1)
    if FAMILIES[name][1]:
        params = damp_dcn_offsets(params)
    model = detector.build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)

    def jloss(p, img, b):
        outs = jmodel.apply({"params": p}, img, b["can_bus"], b["lidar2img"],
                            b["has_prev"], deterministic=True)
        losses = jmt.det_occ_loss(
            outs, jdet.DetGT(b["gt_boxes"], b["gt_labels"], b["gt_mask"]),
            b["gt_occupancy"], occupancy_classes=m.occupancy_classes,
            group_detr=m.group_detr, num_classes=m.num_classes,
            occ_loss_type=m.occ_loss_type, occ_grid_hw=(m.occ_ydim, m.occ_xdim),
            occ_zdim=m.occ_zdim)
        return losses["loss_total"], (losses, outs)

    model.train()
    for mod in model.modules():
        if hasattr(mod, "rate"):
            mod.rate = 0.0
    step = jax.jit(jax.value_and_grad(jloss, has_aux=True)).lower(
        params, batch["img"], _jax_batch(batch)).compile()
    return dict(jcfg=jcfg, tcfg=tcfg, params=params, model=model, step=step)


def _jax_batch(batch):
    return {k: batch[k] for k in ("can_bus", "lidar2img", "has_prev", "gt_boxes",
                                  "gt_labels", "gt_mask", "gt_occupancy")}


def family_setups(names):
    """``family_setup`` of each config, in threads: XLA compiles them side
    by side (the traces take turns)."""
    mp = pytest.MonkeyPatch()
    small_internimage(mp)
    try:
        with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
            return dict(zip(names, pool.map(family_setup, names)))
    finally:
        mp.undo()


def family_runs(setup, seed, witnesses=()):
    """Both sides' step on the painted batch of 2 from ``seed`` at the
    images and at the witness images of seeds ``witnesses``
    (``test_torch_voxel.train_runs``'s records)."""
    tcfg, model, m = setup["tcfg"], setup["model"], setup["tcfg"].model
    batch = make_batch(tcfg, 2, seed=seed, paint_gt=True)
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    jbatch = _jax_batch(batch)
    images = [batch["img"]] + [
        (batch["img"] * (1 + WITNESS_EPS * np.random.default_rng(s).standard_normal(
            batch["img"].shape))).astype(np.float32) for s in witnesses]
    runs = []
    for img in images:
        (_, (jlosses, jouts)), jgrads = setup["step"](setup["params"], img, jbatch)
        tbatch = train_lib.batch_to_device(dict(batch, img=img), "cpu")
        with torch.no_grad():
            outs = model(tbatch["img"], tbatch["can_bus"], tbatch["lidar2img"],
                         tbatch["has_prev"])
            indices = train_lib.match(outs, *train_lib.ground_truth(tbatch), tcfg)
        jindices = _jax_det_indices(np.asarray(jouts["all_cls_scores"]),
                                    np.asarray(jouts["all_bbox_preds"]), gt,
                                    m.group_detr)
        model.zero_grad(set_to_none=True)
        total, losses, _ = train_lib.loss_fn(
            model, tbatch, tcfg, indices=(np.array(sorted(jindices), np.int64), None))
        total.backward()
        runs.append(dict(
            indices=indices, jindices=jindices,
            jlosses={k: float(v) for k, v in jlosses.items()},
            losses={k: float(v.detach()) for k, v in losses.items()},
            jgrads=state_dict_from_flax(jax.tree.map(np.asarray, jgrads)),
            grads={k: p.grad.clone() for k, p in model.named_parameters()}))
    return dict(cfg=tcfg, batch=batch, runs=runs)


@pytest.fixture(scope="module")
def families():
    return {name: (setup, family_runs(setup, BATCH_SEEDS[name]))
            for name, setup in family_setups(list(FAMILIES)).items()}


# the trunk and head tensors each step must reach, by config
REACHED = {
    "voxel_base_occ": ("img_backbone.layer3_0.conv2_dcn_weight",
                       "img_backbone.layer3_0.conv2_offset.weight",
                       "head.encoder_layer0.tsa.sampling_offsets.weight"),
    "hybrid_base_occ": ("img_backbone.layer4_1.conv2_offset.weight",
                        "head.voxel_stage2_layer0.tsa.sampling_offsets.weight",
                        "head.transition1.weight"),
    "bev_base_occ_intern_s": ("img_backbone.stage0_block0.dcn.offset.weight",
                              "img_backbone.stage3_block0.dcn.output_proj.weight",
                              "head.occ_branches.Dense_2.weight"),
    "hybrid_tiny_occ_intern_s": ("img_backbone.stage2_block1.dcn.offset.weight",
                                 "head.voxel_stage2_layer0.tsa.sampling_offsets.weight",
                                 "head.transition1.weight"),
}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_train_step_matches_jax(families, name):
    setup, s = families[name]
    m = setup["tcfg"].model
    (run,) = s["runs"]
    assert set(run["losses"]) == set(run["jlosses"]) and "loss_occupancy" in run["losses"]
    for k, w in run["jlosses"].items():
        assert abs(run["losses"][k] - w) <= STEP_LOSS_REL_TOL * max(abs(w), 1e-6), (k, w)
    det, _ = run["indices"]
    assert {tuple(int(x) for x in r) for r in det} == run["jindices"]
    assert len(det) == m.decoder_layers * int(s["batch"]["gt_mask"].sum()) > 0
    err = _grad_err(run["jgrads"], run["grads"], set())
    assert err <= GRAD_REL_TOL, (name, err)
    for k in REACHED[name]:
        assert float(run["grads"][k].abs().max()) > 0, (name, k)
    if name.endswith("intern_s"):
        assert m.backbone_type == "internimage"
        assert setup["model"].img_backbone.depths == SMALL_II["depths"]
    else:
        assert m.backbone_dcn_stages == (False, False, True, True)


def scan_batch_seeds(name, seeds):
    """The scan that chose BATCH_SEEDS: for each painted batch seed, both
    sides' step at the 7 images (one compile for all seeds); prints JAX's
    largest gradient difference against itself between the images, how many
    of the 6 witness images agree with the first within GRAD_REL_TOL, and
    the port's error against JAX at each image. From the repository root:
    ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
    tests/test_torch_train_families.py voxel_base_occ 0 10 [THREADS]``."""
    setup = family_setups([name])[name]
    for seed in seeds:
        s = family_runs(setup, seed, WITNESS_SEEDS)
        first = s["runs"][0]["jgrads"]
        jax_self = [_grad_err(first, run["jgrads"], set()) for run in s["runs"][1:]]
        port = [_grad_err(run["jgrads"], run["grads"], set()) for run in s["runs"]]
        print(name, "seed", seed, "jax_self_max", f"{max(jax_self):.3g}",
              "agree", sum(e <= GRAD_REL_TOL for e in jax_self),
              "port", [f"{e:.2g}" for e in port], flush=True)


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 4:
        torch.set_num_threads(int(sys.argv[4]))
    scan_batch_seeds(sys.argv[1], range(int(sys.argv[2]), int(sys.argv[3]) + 1))
