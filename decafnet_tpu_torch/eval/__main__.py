"""Evaluation CLI of the port (the counterpart of the root ``eval.py``)::

    python -m decafnet_tpu_torch.eval --name <experiment_dir> --ckpt <id>
        [--dryrun] [--set dotted.key value ...] [--device cuda|cpu]

Loads the frozen opt.yaml of the experiment directory, backfills defaults
introduced since it was written, applies the overrides, loads the EMA
weights of ``models/<ckpt>.pth`` and prints the Rank@k / IoU@t table and
the mean eval losses. Runs on the CUDA card unless ``--device`` says
otherwise; raises where there is none.
"""

from __future__ import annotations

import argparse
import sys

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
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def build_evaluator(argv=None):
    """The Evaluator that :func:`main` runs for these arguments."""
    args = parse_args(argv)
    cfg = config_from_logdir(args.name, args.ckpt, args.set_cfgs,
                             dryrun=args.dryrun)
    evaluator = Evaluator(cfg, device=args.device)
    print(f"device: {evaluator.device}", flush=True)
    return evaluator


def main(argv=None):
    """Evaluate and return the (ranks, iou_threshs) recall matrix."""
    return build_evaluator(argv).run()


if __name__ == "__main__":
    main()
    sys.exit(0)
