"""Training CLI of the port (the counterpart of the root ``train.py``)::

    python -m decafnet_tpu_torch.train --cfg a.yaml [b.yaml ...]
        [--set dotted.key value ...] [--device cuda|cpu]

Builds the config (task defaults <- files <- overrides), writes the
experiment's ``opt.yaml`` into ``<log.root>/<aux.log>/<aux.exp>/<aux.runid>``,
runs the Trainer (which resumes from ``models/last.pth`` and
``states/last.pt`` when both exist) and writes ``finished``. Runs on the
CUDA card unless ``--device`` says otherwise; raises where there is none.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..core import setup_cfg
from .trainer import Trainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m decafnet_tpu_torch.train",
        description="Train the grounder on the configured dataset.")
    parser.add_argument("--cfg", nargs="*", default=[],
                        help="yaml config files, merged in order")
    parser.add_argument("--set", dest="set_cfgs", nargs="*", default=None,
                        help="dotted.key value override pairs")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def build_trainer(argv=None):
    """The config, ``opt.yaml`` and Trainer that :func:`main` runs."""
    args = parse_args(argv)
    cfg = setup_cfg(args.cfg, args.set_cfgs)
    root = cfg.aux.logdir
    os.makedirs(root, exist_ok=True)
    cfg.dump_to_file(os.path.join(root, "opt.yaml"))
    print(f"experiment: {cfg.aux.exp}", flush=True)
    print(f"logdir: {root}", flush=True)
    trainer = Trainer(cfg, device=args.device)
    print(f"device: {trainer.device}", flush=True)
    return trainer


def train(trainer):
    """Run ``trainer`` to the end and write the ``finished`` sentinel."""
    trainer.run()
    with open(os.path.join(trainer.cfg.aux.logdir, "finished"), "w") as f:
        f.write("done\n")
    return trainer


def main(argv=None):
    """Train; returns the finished Trainer."""
    return train(build_trainer(argv))


if __name__ == "__main__":
    main()
    sys.exit(0)
