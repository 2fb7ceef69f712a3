"""The port's multi-process training against its one-process step and JAX.

Ranks are gloo processes on the CPU (``tools.dryrun_multichip.spawn_world``:
``init_method`` a file in a fresh directory, so that concurrent test
workers cannot collide on a port), one torch thread each. Configs:
``bev_smoke_det`` and ``bev_smoke_det_occ`` (8x8 BEV, embed_dims 32, 2 cams
at 64x96, queue 2, f32), a global batch of 2 samples.

Every world step is held against the port's one-process step on the
global batch with the same weights, generator seed and (checked equal)
assignment: each loss term, and every parameter's gradient averaged over
the world (``parallel.train.average_gradients``). The workers run the
one-process step themselves (rank 0) and return the errors.

Tolerances and why:
- loss terms: 1e-4 relative (the repo's f32 loss tolerance); the world
  computes each sample's forward at batch 1 and the one process at batch
  2, which rounds f32 sums in another order.
- gradients: within 1e-4 of the largest magnitude of the one-process
  gradient (plus 1e-7 of the model's largest gradient, for gradients zero
  in exact arithmetic): the world sums the samples' parts of a gradient in
  the average, one process inside each op.
- the ranks' parameters after 2 steps: bit-equal (every rank applies the
  same averaged gradients).
- against JAX: the loss terms at 1e-4 relative (``tests/test_torch_train``'s
  tolerance), at JAX's assignment.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apollo_vision_net_tpu_torch import configs
from apollo_vision_net_tpu_torch.data.synthetic import make_batch
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.models.layers import use_generator
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_ranks,
    replicate,
    shard_batch,
)
from apollo_vision_net_tpu_torch.parallel.optim import make_optimizer
from apollo_vision_net_tpu_torch.runtime.train_loop import step_seed
from apollo_vision_net_tpu_torch.tools.dryrun_multichip import spawn_world

GLOBAL_BATCH = 2
BATCH_SEED = 3
LOSS_REL_TOL = 1e-4
GRAD_REL_TOL = 1e-4
GRAD_FLOOR = 1e-7
PARTITION = ("dp", "sp", None)


def config(name: str, partition: bool = False):
    cfg = getattr(configs, name)()
    if partition:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, bev_partition=PARTITION))
    return cfg


def new_model(cfg, state=None):
    model = build_model(cfg, "cpu", seed=0)
    if state is not None:
        model.load_state_dict(torch.load(state, weights_only=True), strict=True)
    return model


def grad_step(model, cfg, batch, train: bool, indices=None, mesh=None):
    """One forward and backward (the gradients averaged over the mesh's
    world) -> (loss terms, {name: gradient}, indices)."""
    model.train(train)
    model.zero_grad(set_to_none=True)
    gen = torch.Generator().manual_seed(step_seed(0, 0))
    with use_generator(gen):
        total, losses, indices = train_lib.loss_fn(model, batch, cfg, indices,
                                                   mesh=mesh)
    total.backward()
    if mesh is not None:
        train_lib.average_gradients(mesh, model)
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    return {k: float(v) for k, v in losses.items()}, grads, indices


def rel_errs(got, want):
    """Each gradient's max abs error beyond the floor over its largest
    magnitude (or the floor, where that is larger)."""
    floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
    return {k: max(0.0, float((got[k] - w).abs().max()) - floor)
            / max(float(w.abs().max()), floor) for k, w in want.items()}


def run_case(case: dict) -> dict:
    """One rank's part of a case: the world step (or ``steps`` updates) on
    the rank's rows; rank 0 adds the one-process step's errors."""
    mesh = make_mesh(case["dp"], case["sp"])
    cfg = config(case["cfg"], case["sp"] > 1)
    batch = make_batch(cfg, GLOBAL_BATCH, seed=BATCH_SEED)
    local = train_lib.batch_to_device(shard_batch(mesh, batch), "cpu")
    model = replicate(mesh, new_model(cfg, case.get("state")))
    out = {"rank": mesh.rank, "dp_index": mesh.dp_index, "sp_index": mesh.sp_index,
           "dp_ranks": dist.get_process_group_ranks(mesh.dp_group),
           "sp_ranks": dist.get_process_group_ranks(mesh.sp_group)}
    if case.get("steps"):
        return {**out, **run_steps(case, cfg, mesh, model, local, batch)}
    seen = []  # the (batch, queries) that each encoder TSA call computes
    hook = model.head.transformer.encoder.layers[0].tsa.register_forward_hook(
        lambda mod, args, res: seen.append(tuple(res.shape[:2])))
    losses, grads, indices = grad_step(model, cfg, local, case["train"],
                                       case.get("indices"), mesh)
    hook.remove()
    out.update(losses=losses, indices=indices, tsa_queries=seen)
    if mesh.rank == 0 and case.get("reference", True):
        ref = new_model(cfg, case.get("state"))
        want_l, want_g, want_i = grad_step(
            ref, cfg, train_lib.batch_to_device(batch, "cpu"), case["train"])
        out.update(ref_losses=want_l, ref_indices=want_i,
                   grad_rel=rel_errs(grads, want_g),
                   params_with_grad=(sorted(grads), sorted(want_g)))
    return out


def run_steps(case, cfg, mesh, model, local, batch) -> dict:
    """``case["steps"]`` updates through ``make_train_step``: each step's
    loss terms, the ranks' parameters gathered and held bit-equal; rank 0
    adds the one-process run's loss terms."""
    def updates(step, model, batch):
        model.train()
        optimizer = make_optimizer(model, cfg.optim)
        gen = torch.Generator()
        history = []
        for i in range(case["steps"]):
            gen.manual_seed(step_seed(0, i))
            losses = step(model, optimizer, batch, gen)
            history.append({k: float(v) for k, v in losses.items()})
        return history

    history = updates(train_lib.make_train_step(mesh, cfg), model, local)
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    parts = [torch.empty_like(flat) for _ in range(mesh.world)]
    dist.all_gather(parts, flat)
    out = {"history": history,
           "rank_param_diff": max(float((p - flat).abs().max()) for p in parts)}
    if mesh.rank == 0:
        out["ref_history"] = updates(train_lib.make_train_step(None, cfg),
                                     new_model(cfg),
                                     train_lib.batch_to_device(batch, "cpu"))
    return out


def assert_losses_close(got: dict, want: dict):
    assert set(got) == set(want)
    bad = {k: (got[k], w) for k, w in want.items()
           if abs(got[k] - w) > LOSS_REL_TOL * max(abs(w), 1e-6)}
    assert not bad, bad


def run_cases(cases):
    return [run_case(c) for c in cases]


def assert_matches_one_process(result):
    assert_losses_close(result["losses"], result["ref_losses"])
    got_names, want_names = result["params_with_grad"]
    assert got_names == want_names
    for g, w in zip(result["indices"], result["ref_indices"]):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    worst = sorted(result["grad_rel"].items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= GRAD_REL_TOL, worst


# ------------------------------------------------------------- the worlds

WORLD2_CASES = {
    "dp2_eval": dict(cfg="bev_smoke_det", dp=2, sp=1, train=False),
    "dp2_train": dict(cfg="bev_smoke_det", dp=2, sp=1, train=True),
    "dp2_occ_train": dict(cfg="bev_smoke_det_occ", dp=2, sp=1, train=True),
    "dp2_steps": dict(cfg="bev_smoke_det_occ", dp=2, sp=1, train=True, steps=2),
    "dp1xsp2_det": dict(cfg="bev_smoke_det", dp=1, sp=2, train=True),
    "dp1xsp2_occ": dict(cfg="bev_smoke_det_occ", dp=1, sp=2, train=True),
}
WORLD4_CASES = {
    "dp2xsp2_det": dict(cfg="bev_smoke_det", dp=2, sp=2, train=True),
    "dp2xsp2_occ": dict(cfg="bev_smoke_det_occ", dp=2, sp=2, train=True),
}


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """JAX's loss terms of bev_smoke_det on a global batch sharded over a
    dp=2 mesh of the virtual CPU devices (the deterministic apply composed
    with det_loss, as tests/test_torch_train.py composes them), on flax
    weights with noise; the bridged weights and JAX's assignment for the
    port's world."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from apollo_vision_net_tpu.configs import bev_smoke_det as jax_smoke_det
    from apollo_vision_net_tpu.losses import det_loss as jdet
    from apollo_vision_net_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
    from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
    from test_torch_train import perturbed_params

    jcfg, tcfg = jax_smoke_det(), config("bev_smoke_det")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    m = tcfg.model
    batch = make_batch(tcfg, GLOBAL_BATCH, seed=BATCH_SEED)
    jmodel = jax_build_model(jcfg)
    keys = ("img", "can_bus", "lidar2img", "has_prev")
    params = jax.jit(lambda r: jmodel.init(
        {"params": r}, *[batch[k][:1] for k in keys], deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    params = perturbed_params(params, seed=1)
    mesh = jax_make_mesh(dp=2, sp=1, devices=jax.devices()[:2])
    sharded = {k: jax.device_put(v, NamedSharding(mesh, PartitionSpec("dp")))
               for k, v in batch.items()}

    @jax.jit
    def jloss(p, b):
        outs = jmodel.apply({"params": p}, *[b[k] for k in keys],
                            deterministic=True)
        gt = jdet.DetGT(b["gt_boxes"], b["gt_labels"], b["gt_mask"])
        return jdet.det_loss(outs["all_cls_scores"], outs["all_bbox_preds"],
                             gt, num_classes=m.num_classes), outs

    jlosses, outs = jloss(params, sharded)
    gt = jdet.DetGT(batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"])
    gt_norm = jdet.normalize_bbox(gt.boxes)
    gt_norm = np.where(gt.mask[..., None],
                       np.nan_to_num(gt_norm, posinf=0.0, neginf=0.0), 0.0)
    rows = []
    for lyr in range(outs["all_cls_scores"].shape[0]):
        aq = jax.vmap(lambda c, b, gn, gl, gm: jdet._match_single(
            c, b, gn, gl, gm, 2.0, 0.25))(
            outs["all_cls_scores"][lyr], outs["all_bbox_preds"][lyr], gt_norm,
            gt.labels, gt.mask)
        rows += [(lyr, b, int(aq[b, r]), r)
                 for b, r in zip(*np.nonzero(np.asarray(gt.mask)))]
    state = tmp_path_factory.mktemp("jax_bridge") / "state.pt"
    torch.save(state_dict_from_flax(jax.tree.map(np.asarray, params)), state)
    return {"losses": {k: float(v) for k, v in jlosses.items()},
            "state": str(state),
            "indices": (np.array(sorted(rows), np.int64), None)}


@pytest.fixture(scope="module")
def world2(jax_case):
    cases = dict(WORLD2_CASES, jax_dp2=dict(
        cfg="bev_smoke_det", dp=2, sp=1, train=False, reference=False,
        state=jax_case["state"], indices=jax_case["indices"]))
    results = spawn_world(2, run_cases, list(cases.values()), timeout=240)
    return {name: [r[i] for r in results] for i, name in enumerate(cases)}


@pytest.fixture(scope="module")
def world4():
    results = spawn_world(4, run_cases, list(WORLD4_CASES.values()), timeout=240)
    return {name: [r[i] for r in results] for i, name in enumerate(WORLD4_CASES)}


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("dp,sp", [(2, 1), (1, 2), (2, 2)])
def test_rank_layout_is_jax_make_mesh(dp, sp):
    """Rank i·sp + j is dp index i, sp index j: JAX's device grid."""
    import jax

    from apollo_vision_net_tpu.parallel.mesh import make_mesh as jax_make_mesh

    jmesh = jax_make_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    np.testing.assert_array_equal(mesh_ranks(dp, sp), ids - ids.min())
    assert dict(jmesh.shape) == {"dp": dp, "sp": sp}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["dp1xsp2_det", "dp2xsp2_det"])
def test_mesh_groups_follow_the_layout(name, world2, world4):
    """Each rank's indices and its dp and sp groups' members, from the
    ranks of the worlds."""
    results = (world2 if name in world2 else world4)[name]
    case = {**WORLD2_CASES, **WORLD4_CASES}[name]
    ranks = mesh_ranks(case["dp"], case["sp"])
    for r in results:
        i, j = np.argwhere(ranks == r["rank"])[0]
        assert (r["dp_index"], r["sp_index"]) == (i, j)
        assert r["dp_ranks"] == ranks[:, j].tolist()
        assert r["sp_ranks"] == ranks[i].tolist()


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["dp2_eval", "dp2_train", "dp2_occ_train"])
def test_data_parallel_step_equals_one_process(name, world2):
    """World 2 in eval mode and in training mode (dropout masks drawn for
    the global batch; equal masks on the ranks would fail it), det and
    det+occ (global num_pos, avg_factor and Lovász), against the one
    process on the global batch; both ranks report the same losses."""
    results = world2[name]
    assert results[0]["tsa_queries"] == [(1, 64)] * 2
    assert_matches_one_process(results[0])
    assert results[1]["losses"] == results[0]["losses"]


@pytest.mark.timeout(300)
def test_ranks_stay_equal_over_steps(world2):
    """Two updates through make_train_step: the ranks' parameters bit-equal,
    and each step's loss terms (the second reads the updated parameters)
    and gradient norm those of the one process."""
    results = world2["dp2_steps"]
    for r in results:
        assert r["rank_param_diff"] == 0.0
        assert r["history"] == results[0]["history"]
    for got, want in zip(results[0]["history"], results[0]["ref_history"]):
        assert_losses_close(got, want)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", ["dp1xsp2_det", "dp1xsp2_occ",
                                  "dp2xsp2_det", "dp2xsp2_occ"])
def test_bev_partition_step_equals_one_process(name, world2, world4):
    """The BEV partition (encoder rows over sp, the BEV gathered between
    layers and before the heads) in training mode against one process;
    each rank's encoder computes half the 8x8 BEV of its dp index's
    samples in each queue frame."""
    results = (world2 if name in world2 else world4)[name]
    case = {**WORLD2_CASES, **WORLD4_CASES}[name]
    for r in results:
        assert r["tsa_queries"] == [(GLOBAL_BATCH // case["dp"], 32)] * 2
    assert_matches_one_process(results[0])
    for r in results[1:]:
        assert r["losses"] == results[0]["losses"]


@pytest.mark.timeout(300)
def test_world_losses_match_jax_dp2(world2, jax_case):
    """World 2 in eval mode on the bridged weights, at JAX's assignment,
    against JAX's loss over the dp=2 mesh."""
    got, want = world2["jax_dp2"][0]["losses"], jax_case["losses"]
    assert set(want) <= set(got)
    bad = {k: (got[k], w) for k, w in want.items()
           if abs(got[k] - w) > LOSS_REL_TOL * max(abs(w), 1e-6)}
    assert not bad, bad


# --------------------------------------------------------------- the CLI

# the checkpoints' AdamW moments, as gradients are held (1e-4 of each
# tensor's largest element beyond the floor) after 2 steps; after the
# third, the noise-driven +-lr steps of the first two (up to 2e-4 on
# weights of ~1e-2) have moved some gradients by up to 1.3% (measured), and
# the moments are held at the repo's tolerance for gradients across such
# kinks (5e-2, PERF.md's f32 steps on the card)
MOMENT_REL_TOL = {2: GRAD_REL_TOL, 3: 5e-2}
CLI_ARGS = ["bev_smoke_det", "--device", "cpu", "--batch-size", "2",
            "--log-interval", "1"]


def run_cli(work_dir: str):
    """The train CLI as torchrun starts it on each rank (the process group
    already initialized): 2 steps, then ``--resume`` to 3."""
    from apollo_vision_net_tpu_torch.tools import train as train_cli

    os.environ.update(RANK=str(dist.get_rank()),
                      WORLD_SIZE=str(dist.get_world_size()), LOCAL_RANK="0")
    train_cli.main(CLI_ARGS + ["--steps", "2", "--work-dir", work_dir])
    train_cli.main(CLI_ARGS + ["--steps", "3", "--resume", "--work-dir", work_dir])


@pytest.mark.timeout(300)
def test_train_cli_at_world_2(tmp_path, monkeypatch):
    """Only rank 0 writes (one metrics record a step and the files of one
    process); the world run, before and after ``--resume``, trains as one
    process does: each step's loss terms (1e-4), the checkpoints' update
    count, config and frozen statistics (bit-equal) and AdamW moments
    (MOMENT_REL_TOL). The parameters themselves are not compared: Adam
    divides each element's gradient by its own magnitude, so an element
    whose gradient is zero in exact arithmetic (an attention key's bias,
    the bias before a GroupNorm) steps by up to +-lr on f32 noise in either
    run."""
    from apollo_vision_net_tpu_torch.runtime.metrics_log import read_metrics
    from apollo_vision_net_tpu_torch.tools import train as train_cli

    world_dir, one_dir = str(tmp_path / "world"), str(tmp_path / "one")
    spawn_world(2, run_cli, world_dir, timeout=240)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    train_cli.main(CLI_ARGS + ["--steps", "2", "--work-dir", one_dir])
    train_cli.main(CLI_ARGS + ["--steps", "3", "--resume", "--work-dir", one_dir])

    assert sorted(os.listdir(world_dir)) == sorted(os.listdir(one_dir))
    got, want = read_metrics(world_dir), read_metrics(one_dir)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert_losses_close({k: g[k] for k in w if k.startswith("loss")},
                            {k: w[k] for k in w if k.startswith("loss")})
    for step in (2, 3):
        name = f"ckpt_{step:08d}.pt"
        g = torch.load(os.path.join(world_dir, name), weights_only=True)
        w = torch.load(os.path.join(one_dir, name), weights_only=True)
        assert (g["step"], g["config"]) == (w["step"], w["config"]) == (
            step, "bev_smoke_det")
        assert g["optimizer"]["steps"] == w["optimizer"]["steps"] == step
        for k in w["model"]:
            if "running_" in k:
                assert torch.equal(g["model"][k], w["model"][k]), k
        for moment in ("exp_avg", "exp_avg_sq"):
            gs, ws = (
                {i: st[moment] for i, st in c["optimizer"]["adamw"]["state"].items()}
                for c in (g, w))
            assert gs.keys() == ws.keys()
            worst = sorted(rel_errs(gs, ws).items(), key=lambda kv: -kv[1])[:5]
            assert worst[0][1] <= MOMENT_REL_TOL[step], (step, moment, worst)
        with open(os.path.join(world_dir, name[:-3] + ".json")) as f:
            assert json.load(f)["step"] == step
