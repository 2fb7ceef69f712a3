"""Overfit-to-metric training proof on the GPU.

Counterpart of the JAX package's tools/overfit_check.py: trains a config on
one fixed synthetic batch with GT cues painted into its images (so the set
is learnable), then evaluates the real metrics on that batch: det mAP/NDS
(nuScenes protocol), map chamfer mAP (MapTR protocol) and occupancy
IoU/mIoU (SSCMetrics, in percent). If the train / decode / evaluate loop
cannot overfit 4 samples, training is broken where a loss curve does not
show it.

Usage (from the repository root):
  python3 -m apollo_vision_net_tpu_torch.tools.overfit_check bev_smoke_det_occ \\
      --steps 1500 --assert
  # writes <config>_overfit.jsonl (the loss every 10 steps) and
  # <config>_metrics.json to --out

``--assert`` fails unless det mAP > 0.5, map chamfer mAP > 0.5, occ_iou >
30 and occ_miou > 10 (each where the config has the head). ``--device cpu``
runs the plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from apollo_vision_net_tpu_torch import configs as cfglib
from apollo_vision_net_tpu_torch import resolve_device
from apollo_vision_net_tpu_torch.data.synthetic import make_batch
from apollo_vision_net_tpu_torch.evaluation import formatting
from apollo_vision_net_tpu_torch.models.detector import build_model
from apollo_vision_net_tpu_torch.models.heads.map_head import get_map_results
from apollo_vision_net_tpu_torch.models.heads.occ_head import occupancy_prediction
from apollo_vision_net_tpu_torch.parallel import train as train_lib
from apollo_vision_net_tpu_torch.parallel.optim import make_optimizer
from apollo_vision_net_tpu_torch.runtime.inference import (
    POST_CENTER_RANGE,
    evaluate_results,
    occupancy_rule,
)
from apollo_vision_net_tpu_torch.runtime.train_loop import step_seed
from apollo_vision_net_tpu_torch.utils.box_coder import nms_free_decode

# SSCMetrics reports percent; 30% completion IoU demands real placement
# (class statistics alone reach ~1.5%)
BARS = {"mean_ap": 0.5, "NuscMap_chamfer/mAP": 0.5, "occ_iou": 30.0,
        "occ_miou": 10.0}


def overfit_config(cfg, steps: int, lr: float = 4e-4):
    """The config with the overfit schedule: lr, warmup max(steps / 10,
    10), cosine to ``steps``."""
    return dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, lr=lr, warmup_iters=max(steps // 10, 10), total_steps=steps))


@torch.no_grad()
def evaluate_overfit(cfg, model, batch) -> dict:
    """The training forward in eval mode (no dropout or grid mask, the
    first Group-DETR group) on the overfit batch, decoded and formatted ->
    its metrics (``evaluate_results``)."""
    m = cfg.model
    was_training = model.training
    model.eval()
    try:
        outs = model(batch["img"], batch["can_bus"], batch["lidar2img"],
                     batch["has_prev"])
    finally:
        model.train(was_training)
    host = {k: v.cpu().numpy() for k, v in batch.items() if k != "img"}
    B = batch["img"].shape[0]
    results = {"det": [], "map": [], "occ": []}
    gt = {"det": [], "map": [], "occ": None}

    for b in range(B):
        det = nms_free_decode(outs["all_cls_scores"][-1, b],
                              outs["all_bbox_preds"][-1, b], POST_CENTER_RANGE,
                              max_num=100, num_classes=m.num_classes)
        results["det"].append(formatting.detections_to_sample_record(
            *(t.cpu().numpy() for t in det)))
        gt["det"].append(formatting.gt_to_sample_record(
            host["gt_boxes"][b], host["gt_labels"][b], host["gt_mask"][b]))

    if "map_all_cls_scores" in outs:
        mr = get_map_results(outs["map_all_cls_scores"][-1],
                             outs["map_all_pts_preds"][-1], m.pc_range)
        mr = {k: v.cpu().numpy() for k, v in mr.items()}
        for b in range(B):
            results["map"].append(formatting.map_results_record(
                mr["vectors"][b], mr["scores"][b], mr["labels"][b], 0.0))
            mask = host["map_mask"][b].astype(bool)
            # shift order 0 is the original point order, in meters
            gt["map"].append(dict(
                vectors=[host["map_shift_pts"][b, v, 0] for v in np.where(mask)[0]],
                labels=host["map_labels"][b][mask]))

    if "occupancy_preds" in outs:
        pred = occupancy_prediction(outs["occupancy_preds"],
                                    occupancy_rule(cfg)).cpu().numpy()
        results["occ"] = list(pred)
        gt["occ"] = list(host["gt_occupancy"])
    return evaluate_results(cfg, results, gt)


def failed_bars(metrics: dict) -> dict:
    """The bars that ``metrics`` does not pass: {name: (value, bar)}."""
    return {k: (metrics[k], bar) for k, bar in BARS.items()
            if k in metrics and not metrics[k] > bar}


def overfit(cfg, *, steps: int, batch_size: int = 4, seed: int = 0,
            device=None, eval_every: int = 0, log=None):
    """Train ``cfg`` (with ``overfit_config``'s schedule already applied)
    for ``steps`` steps on one painted batch -> (model, batch, curve: the
    loss terms every 10 steps and at the last)."""
    dev = resolve_device(device)
    batch = train_lib.batch_to_device(
        make_batch(cfg, batch_size, seed=seed, paint_gt=True), dev)
    model = build_model(cfg, device=dev, seed=seed).train()
    optimizer = make_optimizer(model, cfg.optim)
    gen = torch.Generator(device=dev)
    curve = []
    for i in range(steps):
        gen.manual_seed(step_seed(seed, i))
        losses = train_lib.train_step(model, optimizer, batch, gen, cfg=cfg)
        if i % 10 == 0 or i == steps - 1:
            rec = {"step": i, **{k: float(v) for k, v in losses.items()}}
            curve.append(rec)
            if log is not None:
                log.write(json.dumps(rec) + "\n")
                log.flush()
            if i % 50 == 0:
                print(f"step {i}: loss_total={rec['loss_total']:.4f}", flush=True)
        if eval_every and i and i % eval_every == 0:
            mid = evaluate_overfit(cfg, model, batch)
            print(f"step {i}: " + json.dumps(
                {k: round(v, 4) for k, v in mid.items() if k in BARS}), flush=True)
    return model, batch, curve


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default="bev_smoke_det_map")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=4e-4)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--out", default="overfit_out")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU; 'cpu' runs the plain versions")
    ap.add_argument("--assert", dest="check", action="store_true",
                    help="fail unless every metric passes its bar (BARS)")
    args = ap.parse_args()

    cfg = overfit_config(getattr(cfglib, args.config)(), args.steps, args.lr)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with open(os.path.join(args.out, f"{args.config}_overfit.jsonl"), "w") as log:
        model, batch, curve = overfit(
            cfg, steps=args.steps, batch_size=args.batch_size, seed=args.seed,
            device=args.device, eval_every=args.eval_every, log=log)
    metrics = evaluate_overfit(cfg, model, batch)
    metrics["final_loss_total"] = curve[-1]["loss_total"]
    metrics["initial_loss_total"] = curve[0]["loss_total"]
    metrics["seconds"] = time.perf_counter() - t0
    metrics["device"] = str(batch["img"].device)
    if batch["img"].is_cuda:
        metrics["device_name"] = torch.cuda.get_device_name(0)
    with open(os.path.join(args.out, f"{args.config}_metrics.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(json.dumps(metrics), flush=True)
    if args.check:
        failed = failed_bars(metrics)
        if failed:
            print(f"overfit check FAILED: {failed}", flush=True)
            return 1
        print("overfit check PASSED", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
