"""Offline map evaluation: re-evaluate dumped map results against map GT
annotations, the evaluator isolated from the streaming loop.

Copy of the JAX package's tools/eval_map_offline.py (reference
tools/eval_map_offline.py) over the port's ``evaluation.map_eval`` and
``evaluation.formatting``. It runs no model.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.eval_map_offline RESULTS GT
      [--metrics chamfer iou]
RESULTS: ``tools/test.py --dump-results`` JSON (nuscmap_results layout) or
a pickle of map result records; GT: ``create_data nuscenes-map-gt`` JSON or
a pickle of map GT records.
"""
from __future__ import annotations

import argparse
import json
import pickle


def load_records(results: str, annotations: str):
    """(map result records, map GT records) from JSON or pickle files."""
    from apollo_vision_net_tpu_torch.evaluation import formatting

    if results.endswith(".json"):
        res = formatting.load_results_json(results)["map"]
    else:
        with open(results, "rb") as f:
            res = pickle.load(f)
    if annotations.endswith(".json"):
        gt = formatting.load_map_gt_json(annotations)
    else:
        with open(annotations, "rb") as f:
            gt = pickle.load(f)
    return res, gt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("results", help="results JSON, or a pickle of map result records")
    p.add_argument("annotations", help="map GT JSON, or a pickle of map GT records")
    p.add_argument("--metrics", nargs="+", default=["chamfer"],
                   choices=["chamfer", "iou"])
    args = p.parse_args(argv)

    from apollo_vision_net_tpu_torch.evaluation.map_eval import evaluate_map

    results, annotations = load_records(args.results, args.annotations)
    summary = evaluate_map(results, annotations, metrics=args.metrics)
    print(json.dumps({k: round(v, 6) for k, v in summary.items()}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
