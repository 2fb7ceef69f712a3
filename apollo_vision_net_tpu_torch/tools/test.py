"""Evaluation CLI (counterpart of the JAX package's tools/test.py; reference
tools/test.py): streaming stateful inference over a dataset, then the
det / map / occupancy evaluators.

``--data synthetic`` streams ``--num-frames`` synthetic frames;
``--data nuscenes --infos <pkl> --data-root <dir>`` streams the split in
scene-contiguous order with its GT boxes (and map vectors, occupancy) and
can dump the raw det + map results (``--dump-results``, the MapTR
nuscmap_results layout) and the records with their GT
(``--dump-pickle``). ``--checkpoint`` is a work dir written by the port's
train CLI (its newest step). Prints the metrics as JSON (and writes them
to ``--out``). Runs on the GPU unless ``--device cpu``.

    python3 -m apollo_vision_net_tpu_torch.tools.test bev_tiny_det_map_apollo \\
        --data nuscenes --infos <val.pkl> --data-root <nuscenes> \\
        --checkpoint <work_dir> --eval bbox chamfer --num-frames 0
"""
from __future__ import annotations

import argparse
import json
import logging
import pickle
from typing import List, Optional

import numpy as np

from apollo_vision_net_tpu_torch import configs


def synthetic_frames(cfg, n: int, first_seed: int = 0):
    """(frames, gt) of ``n`` synthetic frames drawn from seeds
    ``first_seed``, ``first_seed + 1``, ..., ten to a scene."""
    from apollo_vision_net_tpu_torch.data.synthetic import make_batch
    from apollo_vision_net_tpu_torch.evaluation import formatting

    frames, gt = [], {"det": [], "map": []}
    for i in range(n):
        b = make_batch(cfg, 1, seed=first_seed + i)
        frames.append(dict(img=b["img"][0, -1], can_bus=b["can_bus"][0, -1],
                           lidar2img=b["lidar2img"][0, -1],
                           scene_token=f"scene{i // 10}"))
        gt["det"].append(formatting.gt_to_sample_record(
            b["gt_boxes"][0], b["gt_labels"][0], b["gt_mask"][0]))
        if cfg.model.with_map:
            # unpack the padded map GT into per-vector polylines (order 0
            # of the shift protocol: the canonical ordering)
            mask = b["map_mask"][0]
            gt["map"].append({
                "vectors": [b["map_shift_pts"][0][v, 0]
                            for v in range(len(mask)) if mask[v]],
                "labels": b["map_labels"][0][mask]})
    return frames, gt


def nuscenes_frames(cfg, args, with_occ: bool):
    """(frames, gt) of the split in scene-contiguous order (reference
    tools/test.py:314-359: custom_multi_gpu_test -> dataset.evaluate /
    evaluate_map / evaluate_occ_iou)."""
    from apollo_vision_net_tpu_torch.data import infos as infos_lib
    from apollo_vision_net_tpu_torch.data.nuscenes_dataset import (
        NuScenesTemporalDataset,
        scene_contiguous_eval_indices,
    )
    from apollo_vision_net_tpu_torch.evaluation import formatting

    ds = NuScenesTemporalDataset(cfg, args.infos, data_root=args.data_root,
                                 training=False, img_scale=args.img_scale)
    idxs = scene_contiguous_eval_indices(ds.infos, 1, 0)
    if args.num_frames:
        idxs = idxs[: args.num_frames]
    frames = []
    gt = {"det": [], "map": [], "occ": [] if with_occ else None}
    for i in idxs:
        f = ds.get_frame(i)
        info = ds.infos[i]
        l2g = infos_lib.lidar2global(info)
        frames.append(dict(img=f["img"], can_bus=f["can_bus"],
                           lidar2img=f["lidar2img"], scene_token=f["scene_token"],
                           lidar2global=l2g))
        gt["det"].append(formatting.gt_to_sample_record(
            f["gt_boxes"], f["gt_labels"], f["gt_mask"], l2g))
        if cfg.model.with_map:
            gt["map"].append({
                "vectors": [np.asarray(v, np.float32)
                            for v in info.get("map_vectors", [])],
                "labels": np.asarray(info.get("map_labels", []), np.int32)})
        if with_occ and "gt_occupancy" in f:
            gt["occ"].append(f["gt_occupancy"])
    if with_occ and not gt["occ"]:
        gt["occ"] = None
    return frames, gt


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None,
                   help="work dir of the train CLI (its newest step)")
    p.add_argument("--data", default="synthetic",
                   choices=["synthetic", "nuscenes"])
    p.add_argument("--infos", default="",
                   help="nuscenes infos pkl (tools/create_data output)")
    p.add_argument("--data-root", default="")
    p.add_argument("--img-scale", type=float, default=0.5)
    p.add_argument("--num-frames", type=int, default=20,
                   help="frames to evaluate (0 = whole split)")
    p.add_argument("--eval", nargs="+", default=["bbox"],
                   choices=["bbox", "chamfer", "iou"])
    p.add_argument("--out", default=None)
    p.add_argument("--dump-results", default=None,
                   help="write raw det/map results (nuscmap_results-style "
                        "JSON) for offline re-evaluation")
    p.add_argument("--dump-pickle", default=None,
                   help="pickle the raw det/map/occ result records + GT")
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from apollo_vision_net_tpu_torch import resolve_device
    from apollo_vision_net_tpu_torch.models.detector import build_model
    from apollo_vision_net_tpu_torch.runtime.checkpoint import CheckpointManager
    from apollo_vision_net_tpu_torch.runtime.inference import (
        evaluate_results,
        run_streaming_eval,
    )

    device = resolve_device(args.device)
    cfg = getattr(configs, args.config)()
    model = build_model(cfg, device, seed=0)
    if args.checkpoint:
        step = CheckpointManager(args.checkpoint).restore(model, cfg=cfg)
        logging.info("restored step %d from %s", step, args.checkpoint)

    if args.data == "synthetic":
        frames, gt = synthetic_frames(cfg, args.num_frames)
    else:
        if not args.infos:
            raise SystemExit("--data nuscenes requires --infos <pkl>")
        frames, gt = nuscenes_frames(cfg, args, "iou" in args.eval)
    results = run_streaming_eval(cfg, model, frames)
    metrics = evaluate_results(cfg, results, gt)
    if args.data == "nuscenes" and args.dump_results:
        from apollo_vision_net_tpu_torch.evaluation.formatting import (
            dump_results_json,
        )

        dump_results_json(results, args.dump_results)
    if args.dump_pickle:
        with open(args.dump_pickle, "wb") as f:
            pickle.dump({**results, "gt": gt}, f)
    print(json.dumps({k: round(float(v), 5) for k, v in metrics.items()},
                     indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({k: float(v) for k, v in metrics.items()}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
