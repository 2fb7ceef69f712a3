"""Train CLI (counterpart of the JAX package's tools/train.py; reference
tools/train.py without the registry and plugin machinery: configs are the
factories of ``apollo_vision_net_tpu_torch.configs``).

Data: ``--data synthetic`` draws contract-conformant batches
(``data/synthetic.make_batch``); ``--data nuscenes --infos <pkl>
--data-root <dir>`` reads converted infos (``tools/create_data``) and the
camera images through ``NuScenesTemporalDataset`` and ``PrefetchLoader``,
in endless shuffled epochs. ``--pretrained`` imports a torch backbone (and
FPN) checkpoint before the first step; ``--resume`` continues from the
newest checkpoint of the work dir. Runs on the GPU unless ``--device cpu``.

    python3 -m apollo_vision_net_tpu_torch.tools.train bev_tiny_det_map_apollo \\
        --data nuscenes --infos <train.pkl> --data-root <nuscenes> \\
        --pretrained <dla34.pth> --steps 1000 --work-dir <dir>
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional

from apollo_vision_net_tpu_torch import configs


def synthetic_iter(cfg, batch_size, seed=0):
    from apollo_vision_net_tpu_torch.data.synthetic import make_batch

    i = 0
    while True:
        yield make_batch(cfg, batch_size, seed=seed + i)
        i += 1


def nuscenes_iter(cfg, args):
    """dataset -> prefetching loader -> endless epoch iterator (reference
    tools/train.py:225-266 builds dataset + loader + runner)."""
    from apollo_vision_net_tpu_torch.data.loader import (
        PrefetchLoader,
        shuffled_epoch_indices,
    )
    from apollo_vision_net_tpu_torch.data.nuscenes_dataset import (
        NuScenesTemporalDataset,
    )

    ds = NuScenesTemporalDataset(
        cfg, args.infos, data_root=args.data_root, training=True,
        img_scale=args.img_scale, seed=args.seed)
    logging.info("nuscenes dataset: %d samples from %s", len(ds), args.infos)
    if len(ds) < args.batch_size:
        raise SystemExit(
            f"dataset has {len(ds)} samples < batch size {args.batch_size}: "
            "every epoch would be empty (drop-last batching)")
    epoch = 0
    while True:
        idx = shuffled_epoch_indices(len(ds), args.seed + epoch,
                                     drop_last_to=args.batch_size)
        yield from PrefetchLoader(ds.get_queue_sample, idx, args.batch_size,
                                  num_workers=args.num_workers)
        epoch += 1


def synthetic_eval_fn(cfg, n_frames: int):
    """The streaming eval on ``n_frames`` synthetic frames (NDS against
    their boxes), as the JAX CLI's ``--eval-interval``."""
    from apollo_vision_net_tpu_torch.runtime.inference import (
        evaluate_results,
        run_streaming_eval,
    )
    from apollo_vision_net_tpu_torch.tools.test import synthetic_frames

    frames, gt = synthetic_frames(cfg, n_frames, first_seed=10_000)

    def eval_fn(model):
        results = run_streaming_eval(cfg, model, frames)
        return evaluate_results(cfg, results, {"det": gt["det"]})

    return eval_fn


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config", help="config factory name, e.g. bev_tiny_det")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--data", default="synthetic",
                   choices=["synthetic", "nuscenes"])
    p.add_argument("--infos", default="",
                   help="nuscenes infos pkl (tools/create_data output)")
    p.add_argument("--data-root", default="",
                   help="dataset root for relative image paths")
    p.add_argument("--num-workers", type=int, default=4)
    p.add_argument("--img-scale", type=float, default=0.5)
    p.add_argument("--pretrained", default="",
                   help="torch .pth checkpoint for backbone(+neck) init "
                        "(reference pretrained=dict(img=...)); overrides "
                        "cfg.pretrained_path")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--eval-interval", type=int, default=0,
                   help="run the synthetic streaming eval every N steps")
    p.add_argument("--eval-frames", type=int, default=8)
    p.add_argument("--device", default=None,
                   help="default: the GPU; 'cpu' runs the plain versions")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from apollo_vision_net_tpu_torch import resolve_device
    from apollo_vision_net_tpu_torch.runtime.train_loop import train

    device = resolve_device(args.device)
    cfg = getattr(configs, args.config)()
    if args.pretrained:
        cfg = dataclasses.replace(cfg, pretrained_path=args.pretrained)
    work_dir = args.work_dir or f"work_dirs/{cfg.name}"
    if args.data == "synthetic":
        data = synthetic_iter(cfg, args.batch_size, args.seed)
    else:
        if not args.infos:
            raise SystemExit("--data nuscenes requires --infos <pkl>")
        data = nuscenes_iter(cfg, args)
    eval_fn = (synthetic_eval_fn(cfg, args.eval_frames)
               if args.eval_interval else None)
    train(cfg, data, num_steps=args.steps, work_dir=work_dir, device=device,
          resume=args.resume, seed=args.seed, log_interval=args.log_interval,
          eval_fn=eval_fn, eval_interval=args.eval_interval)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
