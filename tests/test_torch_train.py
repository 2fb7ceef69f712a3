"""The PyTorch port's train step against the JAX package.

A small copy of the flagship bev_tiny_det_map_apollo (the sizes of
tests/test_torch_slice.py: DLA-34 + SECONDFPNV2, 8x8 BEV, embed_dims 32, 2
cams at 64x96, 2 encoder and 2+2 decoder layers, queue 2, all f32) with
8 map vectors and max_gt_boxes 8 (<= num_query and num_map_vec) runs one queue batch of 2
samples through both sides on the same bridged weights: the JAX model's
``__call__`` with ``deterministic=True`` composed with its ``det_loss`` and
``map_loss`` (what parallel/train.loss_fn computes without dropout and grid
mask), and the port's ``loss_fn`` with the model in eval mode (dropout and
grid mask off; the history replay runs in eval mode on both sides).

Tolerances and why:
- loss terms: 1e-4 relative; f32 on both sides, sums in other orders.
- match indices: equal on the real GT rows (both sides solve the same costs
  up to f32 rounding; padded rows are constant and left out). The loss
  terms and gradients are taken at JAX's assignment on both sides. The map
  head's reference and regression layers are damped so that its points
  fall among the (mean-centred) GT vectors: with every point to one side
  of every GT point, all vectors and orders would cost the same.
- gradients: every parameter's gradient within 1e-4 of the largest
  magnitude of its own JAX gradient (plus 1e-7 of the model's largest
  gradient, for gradients that are zero in exact arithmetic); f32 through
  ~40 layers forward and back, where the two frameworks order their sums
  differently.
- optimizer: updates within 2e-5 relative to the largest JAX update of
  each tensor, given the same (bridged) gradients, with the clip active.
  The port runs torch.optim.AdamW in f64. optax forms 1 - b in f64 but the
  bias correction 1 - b^t in f32 from f32(b): 1 - f32(0.999) is 1.3e-5
  below 0.001, which scales optax's first update by 1 - 6.4e-6 and later
  ones by up to ~1e-5 (6.8e-6 measured at the first step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from apollo_vision_net_tpu.configs import bev_tiny_det_map_apollo as jax_flagship
from apollo_vision_net_tpu.losses import det_loss as jdet
from apollo_vision_net_tpu.losses import map_loss as jmap
from apollo_vision_net_tpu.parallel.optim import make_optimizer as jax_make_optimizer
from apollo_vision_net_tpu.parallel.optim import make_schedule as jax_make_schedule
from apollo_vision_net_tpu.parallel.train import build_model as jax_build_model
from apollo_vision_net_tpu.utils.grid_mask import grid_mask as jax_grid_mask
from apollo_vision_net_tpu_torch.bridge import state_dict_from_flax
from apollo_vision_net_tpu_torch.configs import bev_tiny_det_map_apollo
from apollo_vision_net_tpu_torch.data.synthetic import make_batch
from apollo_vision_net_tpu_torch.models import attention as attention_mod
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.models.layers import Dropout, use_generator
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.parallel.optim import (
    make_optimizer,
    make_schedule,
    param_label,
)
from apollo_vision_net_tpu_torch.utils.grid_mask import (
    grid_mask,
    grid_mask_from_draws,
)
from test_torch_occ import one_torch_thread  # noqa: F401

# torch on one thread (see test_torch_occ.one_torch_thread)
pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(bev_h=8, bev_w=8, embed_dims=32, num_cams=2, img_shape=(64, 96),
             encoder_layers=2, decoder_layers=2, map_decoder_layers=2,
             feedforward_channels=64, num_query=12, num_map_vec=5,
             map_num_pts=4, queue_length=2, transformer_dtype="float32",
             msda_impl="auto")
# up to 3 GT boxes and 4 map vectors a sample, padded to 8 rows (<= the 12
# det queries and 8 map vectors)
SIZES = dict(SMALL, num_map_vec=8)
LOSS_REL_TOL = 1e-4
GRAD_REL_TOL = 1e-4
OPT_REL_TOL = 2e-5


def small(cfg):
    return dataclasses.replace(
        cfg, compute_dtype="float32",
        model=dataclasses.replace(cfg.model, **SIZES),
        data=dataclasses.replace(cfg.data, max_gt_boxes=8))


def perturbed_params(params, seed):
    """flax init plus noise, so that zero-initialized kernels (sampling
    offsets, attention weights) take part; BN variances stay positive."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        if jax.tree_util.keystr(path).endswith("['var']"):
            return x * np.exp(0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(f, params)


def _jax_gt(batch):
    return (jdet.DetGT(batch["gt_boxes"], batch["gt_labels"], batch["gt_mask"]),
            jmap.MapGT(batch["map_shift_pts"], batch["map_labels"],
                       batch["map_mask"], batch["map_order_mask"]))


def _jax_indices(outs, batch, m):
    """Real-row assignments of JAX's own solver, per head, as sets of
    (layer, batch, query, gt row) rows."""
    gt, mgt = _jax_gt(batch)
    gt_norm = jdet.normalize_bbox(gt.boxes)
    gt_norm = jnp.where(gt.mask[..., None],
                        jnp.nan_to_num(gt_norm, posinf=0.0, neginf=0.0), 0.0)
    gt01 = jmap.normalize_pts(mgt.shift_pts, m.pc_range)
    det, mp = set(), set()
    for lyr in range(outs["all_cls_scores"].shape[0]):
        aq = jax.vmap(lambda c, b, gn, gl, gm: jdet._match_single(
            c, b, gn, gl, gm, 2.0, 0.25))(
            outs["all_cls_scores"][lyr], outs["all_bbox_preds"][lyr], gt_norm,
            gt.labels, gt.mask)
        for b, r in zip(*np.nonzero(np.asarray(gt.mask))):
            det.add((lyr, b, int(aq[b, r]), r))
    for lyr in range(outs["map_all_cls_scores"].shape[0]):
        aq, order = jax.vmap(lambda c, p, g, gl, gm, om: jmap._match_single(
            c, p, g, gl, gm, om, 2.0, 5.0))(
            outs["map_all_cls_scores"][lyr], outs["map_all_pts_preds"][lyr],
            gt01, mgt.labels, mgt.mask, mgt.order_mask)
        for b, v in zip(*np.nonzero(np.asarray(mgt.mask))):
            mp.add((lyr, b, int(aq[b, v]), v, int(order[b, v])))
    return det, mp


@pytest.fixture(scope="module")
def step():
    jcfg, tcfg = small(jax_flagship()), small(bev_tiny_det_map_apollo())
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    m = tcfg.model
    batch = make_batch(tcfg, 2, seed=4)  # 3 + 3 boxes, 3 + 4 map vectors
    assert batch["gt_mask"].sum() == 6 and batch["map_mask"].sum() == 7
    jmodel = jax_build_model(jcfg)
    args = (batch["img"], batch["can_bus"], batch["lidar2img"], batch["has_prev"])
    params = jax.jit(lambda r: jmodel.init(
        {"params": r}, *[a[:1] for a in args], deterministic=True))(
        jax.random.PRNGKey(0))["params"]
    params = perturbed_params(params, seed=1)
    # map reference points near the BEV centre, where the synthetic map GT
    # lies: with every predicted point off to one side of every GT point,
    # the L1 cost of a vector would not depend on the vector (its points
    # are mean-centred) nor on its order, and the matching would be all ties
    for dense in (params["head"]["map_reference_points_fc"],
                  params["head"]["map_decoder"]["layers"]["reg_branch"]["Dense_2"]):
        dense["kernel"] = dense["kernel"] * 0.01
        dense["bias"] = np.zeros_like(dense["bias"])

    def jloss(p):
        outs = jmodel.apply({"params": p}, *args, deterministic=True)
        gt, mgt = _jax_gt(batch)
        losses = jdet.det_loss(outs["all_cls_scores"], outs["all_bbox_preds"],
                               gt, num_classes=m.num_classes)
        mlosses = jmap.map_loss(outs["map_all_cls_scores"],
                                outs["map_all_pts_preds"], mgt,
                                pc_range=m.pc_range,
                                num_classes=m.map_num_classes)
        total = losses.pop("loss_total") + mlosses.pop("loss_map_total")
        losses.update(mlosses)
        losses["loss_total"] = total
        return total, (losses, outs)

    (_, (jlosses, jouts)), jgrads = jax.jit(
        jax.value_and_grad(jloss, has_aux=True))(params)

    model = build_model(tcfg, device="cpu")
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.eval()  # dropout and grid mask off, as deterministic=True
    tbatch = train_lib.batch_to_device(batch, "cpu")
    with torch.no_grad():  # the port's own matching of its own outputs
        outs = model(tbatch["img"], tbatch["can_bus"], tbatch["lidar2img"],
                     tbatch["has_prev"])
        indices = train_lib.match(outs, *train_lib.ground_truth(tbatch), tcfg)
    # losses and gradients at JAX's assignment, so that a near-tie solved
    # the other way cannot fail them for the wrong reason
    jindices = _jax_indices(jouts, batch, m)
    total, losses, _ = train_lib.loss_fn(
        model, tbatch, tcfg, indices=tuple(np.array(sorted(j), np.int64)
                                           for j in jindices))
    total.backward()
    return dict(
        tcfg=tcfg, params=params, batch=batch, model=model,
        jlosses={k: float(v) for k, v in jlosses.items()},
        losses={k: float(v) for k, v in losses.items()},
        jindices=jindices, indices=indices,
        jgrads_flax=jax.tree.map(np.asarray, jgrads),
        jgrads=state_dict_from_flax(jax.tree.map(np.asarray, jgrads)))


def test_loss_terms_match_jax(step):
    want, got = step["jlosses"], step["losses"]
    assert set(got) == set(want) and len(got) == 2 * 2 + 3 * 2 + 1
    for k, w in want.items():
        assert abs(got[k] - w) <= LOSS_REL_TOL * max(abs(w), 1e-6), (k, got[k], w)
    assert want["loss_total"] > 1.0


def test_match_indices_equal_jax_on_real_rows(step):
    det, mp = step["indices"]
    want_det, want_map = step["jindices"]
    assert {tuple(int(x) for x in r) for r in det} == want_det
    assert {tuple(int(x) for x in r) for r in mp} == want_map
    b = step["batch"]
    assert len(want_det) == 2 * int(b["gt_mask"].sum())
    assert len(want_map) == 2 * int(b["map_mask"].sum())


def test_gradients_match_jax(step):
    """Every parameter's gradient (frozen BN statistics included, whose
    gradients enter the clip's norm) against jax.grad, bridged through the
    same mapping as the weights; a DLA conv behind the SCA value path gets a
    nonzero gradient."""
    want = step["jgrads"]
    got = {k: p.grad for k, p in step["model"].named_parameters()}
    assert set(got) == set(want)
    # gradients that are zero in exact arithmetic (e.g. the self-attention
    # key bias, which softmax cancels) are f32 noise on both sides: a floor
    # of 1e-7 of the largest gradient of the model
    floor = 1e-7 * max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        g = got[k]
        assert g is not None, k
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= GRAD_REL_TOL * scale + floor, (k, err, scale)
    trunk = "img_backbone.level5.tree2.conv2.weight"
    assert float(got[trunk].abs().max()) > 0, trunk
    assert float(got["head.transformer.encoder.layers.0.sca.deformable_attention"
                     ".value_proj.weight"].abs().max()) > 0


def test_param_labels_follow_the_jax_rule(step):
    """The port's frozen / backbone / main label of every parameter equals
    the JAX package's label of the flax leaf it is bridged from."""
    from apollo_vision_net_tpu.parallel import optim as jopt

    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(step["params"])[0]:
        s = jopt._path_str(path)
        label = ("frozen" if jopt._is_frozen(s)
                 else "backbone" if jopt._is_backbone(s) else "main")
        one = {}
        node = one
        keys = [getattr(k, "key", k) for k in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(leaf)
        for name in state_dict_from_flax(one):
            flat[name] = label
    names = dict(step["model"].named_parameters())
    assert set(flat) == set(names)
    for name, label in flat.items():
        assert param_label(name) == label, name
    labels = set(flat.values())
    assert labels == {"frozen", "backbone", "main"}
    assert all(param_label(n) == "frozen" for n in names if "_bn" in n or ".bn" in n)


def test_schedule_matches_optax():
    kw = dict(lr=2e-4, warmup_iters=10, warmup_ratio=1.0 / 3.0,
              min_lr_ratio=1e-3, total_steps=50)
    want = jax_make_schedule(**kw)
    got = make_schedule(**kw)
    # optax computes in f32: 1e-6 of the peak rate
    for s in list(range(0, 55)):
        w = float(want(s))
        assert abs(got(s) - w) <= 1e-6 * kw["lr"], (s, got(s), w)
    assert got(0) == pytest.approx(kw["lr"] / 3) and got(10) == pytest.approx(kw["lr"])
    assert got(55) == pytest.approx(kw["lr"] * 1e-3)


@pytest.mark.parametrize("n_steps", [1, 2])
def test_optimizer_updates_match_optax(step, n_steps):
    """Updates of one and two steps from the bridged JAX gradients (scaled
    and shifted for the second step), with the clip active
    (grad_clip_norm 0.5), against optax's make_optimizer; the clip's norm
    counts the frozen BN gradients, as in the JAX package."""
    tcfg = step["tcfg"]
    o = dataclasses.replace(tcfg.optim, lr=1e-2, warmup_iters=3,
                            total_steps=10, grad_clip_norm=0.5)
    tx = jax_make_optimizer(lr=o.lr, weight_decay=o.weight_decay,
                            backbone_lr_mult=o.backbone_lr_mult,
                            grad_clip_norm=o.grad_clip_norm,
                            warmup_iters=o.warmup_iters,
                            warmup_ratio=o.warmup_ratio,
                            min_lr_ratio=o.min_lr_ratio,
                            total_steps=o.total_steps)
    jparams = step["params"]
    jgrads = step["jgrads_flax"]
    model = build_model(tcfg, device="cpu").double()
    model.load_state_dict(state_dict_from_flax(jparams), strict=True)
    opt = make_optimizer(model, o)
    names = dict(model.named_parameters())
    state = tx.init(jparams)
    rng = np.random.default_rng(5)
    for i in range(n_steps):
        g = jgrads if i == 0 else jax.tree.map(
            lambda x: (0.5 * x + 1e-3 * rng.standard_normal(x.shape)).astype(np.float32),
            jgrads)
        updates, state = tx.update(g, state, jparams)
        before = {k: p.detach().clone() for k, p in names.items()}
        for k, v in state_dict_from_flax(jax.tree.map(np.asarray, g)).items():
            names[k].grad = v.double()
        norm = float(opt.step())
        want_norm = float(optax.global_norm(g))
        assert abs(norm - want_norm) <= 1e-6 * want_norm
        assert want_norm > o.grad_clip_norm  # the clip is active
        want = state_dict_from_flax(jax.tree.map(np.asarray, updates))
        for k, w in want.items():
            upd = (names[k].detach() - before[k]).float()
            scale = float(w.abs().max())
            err = float((upd - w).abs().max())
            assert err <= OPT_REL_TOL * scale + 1e-12, (k, err / max(scale, 1e-30))
            if param_label(k) == "frozen":
                assert scale == 0.0 and float(upd.abs().max()) == 0.0, k
        jparams = optax.apply_updates(jparams, updates)
    frozen = [v for k, v in step["jgrads"].items() if param_label(k) == "frozen"]
    assert sum(float((v ** 2).sum()) for v in frozen) > 0  # in the norm


def test_grid_mask_matches_jax_given_the_same_draws():
    """grid_mask_from_draws against the JAX grid_mask, with the draws
    reproduced from the JAX key as grid_mask makes them."""
    x = np.random.default_rng(0).standard_normal((3, 40, 56, 3)).astype(np.float32)
    h = x.shape[1]
    for seed in range(8):
        rng = jax.random.PRNGKey(seed)
        want = np.asarray(jax_grid_mask(rng, jnp.asarray(x)))
        k_apply, k_d, k_sh, k_sw = jax.random.split(rng, 4)
        d = int(jax.random.randint(k_d, (), 2, h))
        st_h = int(jax.random.randint(k_sh, (), 0, d))
        st_w = int(jax.random.randint(k_sw, (), 0, d))
        apply = bool(jax.random.uniform(k_apply, ()) <= 0.7)
        got = grid_mask_from_draws(torch.from_numpy(x), d, st_h, st_w, apply)
        np.testing.assert_array_equal(got.numpy(), want)


def test_grid_mask_draws_on_the_generator():
    x = torch.ones((2, 30, 40, 3))
    g = torch.Generator().manual_seed(0)
    applied = 0
    for _ in range(200):
        y = grid_mask(x, g)
        kept = float(y[0, :, :, 0].mean())
        assert 0.0 < kept <= 1.0 and torch.equal(y[0], y[1])
        applied += kept < 1.0
    assert 0.6 <= applied / 200 <= 0.8  # prob 0.7
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(grid_mask(x, g1), grid_mask(x, g2))


def test_dropout_statistics_and_eval_identity(monkeypatch):
    drop = Dropout(0.1).train()
    x = torch.full((400, 500), 2.0)
    with use_generator(torch.Generator().manual_seed(1)):
        y = drop(x)
    zero = float((y == 0).float().mean())
    assert abs(zero - 0.1) < 0.005
    assert torch.allclose(y[y != 0], torch.tensor(2.0 / 0.9))
    assert abs(float(y.mean()) - 2.0) < 0.02
    assert torch.equal(drop.eval()(x), x)

    # the decoder self-attention's probability mask is one (Lq, Lk) draw
    # shared by batch and heads (flax broadcast_dropout), besides the
    # output dropout of the full shape
    shapes = []
    real = attention_mod.dropout_mask

    def spy(shape, keep_prob, device):
        shapes.append(tuple(shape))
        return real(shape, keep_prob, device)

    monkeypatch.setattr(attention_mod, "dropout_mask", spy)
    mha = attention_mod.MultiheadAttention(16, 4).train()
    q = torch.randn(3, 7, 16)
    with use_generator(torch.Generator().manual_seed(2)):
        a = mha(q)
    assert shapes == [(7, 7)]
    assert not torch.equal(a, mha.eval()(q))
    assert torch.equal(mha.eval()(q), mha.eval()(q))


def test_train_mode_draws_from_the_generator():
    """A model in training mode: the same generator seed gives the same
    loss, another seed another one; eval mode draws nothing."""
    cfg = small(bev_tiny_det_map_apollo())
    model = build_model(cfg, device="cpu", seed=3).train()
    batch = train_lib.batch_to_device(make_batch(cfg, 1, seed=2), "cpu")

    def loss(seed):
        with torch.no_grad(), use_generator(torch.Generator().manual_seed(seed)):
            return float(train_lib.loss_fn(model, batch, cfg)[0])

    assert loss(0) == loss(0) != loss(1)
    model.eval()
    assert loss(0) == loss(1)


def test_checkpoint_round_trip_and_resume(tmp_path):
    """train() on the CPU: 2 steps, then a resumed run to 3 steps, equals 3
    uninterrupted steps (weights, optimizer moments, update count); the
    checkpoint restores into a fresh model and optimizer."""
    from apollo_vision_net_tpu_torch.runtime.checkpoint import CheckpointManager
    from apollo_vision_net_tpu_torch.runtime.train_loop import train

    cfg = small(bev_tiny_det_map_apollo())
    batches = [make_batch(cfg, 1, seed=s) for s in range(3)]
    kw = dict(num_steps=3, device="cpu", seed=4, log_interval=1)
    full, full_opt = train(cfg, iter(batches), work_dir=str(tmp_path / "a"), **kw)
    train(cfg, iter(batches[:2]), work_dir=str(tmp_path / "b"), **kw)
    assert CheckpointManager(str(tmp_path / "b")).steps() == [2]
    resumed, res_opt = train(cfg, iter(batches[2:]), work_dir=str(tmp_path / "b"),
                             resume=True, **kw)
    assert CheckpointManager(str(tmp_path / "b")).steps() == [2, 3]
    assert res_opt.steps == full_opt.steps == 3
    for (k, a), b in zip(full.state_dict().items(), resumed.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    # a fresh model and optimizer restore the saved step
    model = build_model(cfg, device="cpu", seed=9)
    opt = make_optimizer(model, cfg.optim)
    assert CheckpointManager(str(tmp_path / "a")).restore(model, opt, cfg) == 3
    for (k, a), b in zip(full.state_dict().items(), model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert opt.steps == 3
    with pytest.raises(ValueError, match="checkpoint of"):
        CheckpointManager(str(tmp_path / "a")).restore(
            model, opt, dataclasses.replace(cfg, name="other"))
