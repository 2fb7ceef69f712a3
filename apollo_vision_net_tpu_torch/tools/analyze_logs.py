"""Training-log analysis: iteration-time statistics and loss and metric
summaries of a ``metrics.jsonl`` stream.

Copy of the JAX package's tools/analyze_logs.py (reference
tools/analysis_tools/analyze_logs.py) over the port's
``runtime.metrics_log.read_metrics``; it prints the same text. It runs no
model.

Usage:
  python -m apollo_vision_net_tpu_torch.tools.analyze_logs <work_dir|metrics.jsonl>
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def report(log: str) -> str:
    """The analysis of ``log`` as text, one line a quantity."""
    from apollo_vision_net_tpu_torch.runtime.metrics_log import read_metrics

    train = read_metrics(log, kind="train")
    evals = read_metrics(log, kind="eval")
    if not train:
        raise SystemExit(f"no train records in {log}")
    lines = []
    times = np.array([r["sec_per_it"] for r in train if "sec_per_it" in r])
    if times.size:
        lines.append(f"iter time: mean {times.mean():.3f}s  median "
                     f"{np.median(times):.3f}s  min {times.min():.3f}s  "
                     f"max {times.max():.3f}s  over {times.size} logged points")
    keys = sorted({k for r in train for k, v in r.items()
                   if k.startswith("loss") and isinstance(v, (int, float))})
    lines.append(f"steps {train[0]['step']}..{train[-1]['step']}")
    for k in keys:
        ys = np.array([r[k] for r in train if k in r])
        lines.append(f"  {k:28s} first {ys[0]:10.4f}  last {ys[-1]:10.4f}  "
                     f"min {ys.min():10.4f}")
    if evals:
        lines.append("eval metrics (best over run):")
        ekeys = sorted({k for r in evals for k, v in r.items()
                        if k not in ("step", "wall_time", "kind")
                        and isinstance(v, (int, float))})
        for k in ekeys:
            ys = [(r[k], r["step"]) for r in evals if k in r]
            best, at = max(ys) if not k.endswith("_err") else min(ys)
            lines.append(f"  {k:28s} best {best:10.4f} @ step {at}")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log")
    args = p.parse_args(argv)
    sys.stdout.write(report(args.log) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
