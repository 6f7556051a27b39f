"""Evaluation CLI of the port (the counterpart of the root ``eval.py``)::

    python -m decafnet_tpu_torch.eval --name <experiment_dir> --ckpt <id>
        [--dryrun] [--set dotted.key value ...] [--device cuda|cpu]
        [--dist-backend nccl|gloo]

Loads the frozen opt.yaml of the experiment directory, backfills defaults
introduced since it was written, applies the overrides, loads the EMA
weights of ``models/<ckpt>.pth`` and prints the Rank@k / IoU@t table and
the mean eval losses. Runs on the CUDA card unless ``--device`` says
otherwise; raises where there is none.

Under ``torchrun --nproc_per_node N -m decafnet_tpu_torch.eval ...`` each
rank (NCCL on the cards, gloo with ``--device cpu``, or ``--dist-backend``)
evaluates its share of the videos (``eval.shard_processes``) and the lead
prints the global table. ``--set eval.shard_videos V`` decodes same-bucket
groups of V videos in one call (one process only); ``--set eval.shard_time
N`` under N ranks splits each video's time axis over them instead
(sequence parallelism; banded or global video attention; no data+time
mesh, as in the JAX eval). A rank that finishes
its share first waits for the others at most ``parallel.TIMEOUT_MIN``
(120 minutes).
"""

from __future__ import annotations

import argparse
import sys

from .. import parallel
from .evaluator import Evaluator, config_from_logdir


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m decafnet_tpu_torch.eval",
        description="Evaluate an experiment's checkpoint on its eval split.")
    parser.add_argument("--name", required=True,
                        help="experiment directory containing opt.yaml")
    parser.add_argument("--ckpt", default="last",
                        help='checkpoint id, e.g. "6-36000" or "last"')
    parser.add_argument("--dryrun", action="store_true",
                        help="evaluate the first video only")
    parser.add_argument("--set", dest="set_cfgs", nargs="*", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default; cuda:LOCAL_RANK under torchrun) "
                        "or cpu")
    parser.add_argument("--dist-backend", default=None,
                        help="process-group backend under torchrun: nccl "
                        "(default on CUDA) or gloo (default with --device cpu)")
    return parser.parse_args(argv)


def build_evaluator(argv=None):
    """The Evaluator that :func:`main` runs for these arguments."""
    args = parse_args(argv)
    parallel.init_distributed(
        args.dist_backend or ("gloo" if args.device == "cpu" else None))
    cfg = config_from_logdir(args.name, args.ckpt, args.set_cfgs,
                             dryrun=args.dryrun)
    evaluator = Evaluator(cfg, device=args.device)
    print(f"device: {evaluator.device}", flush=True)
    return evaluator


def main(argv=None):
    """Evaluate and return the (ranks, iou_threshs) recall matrix (the
    global one in a process group)."""
    try:
        return build_evaluator(argv).run()
    finally:
        parallel.destroy()


if __name__ == "__main__":
    main()
    sys.exit(0)
