"""Training CLI of the port (the counterpart of the root ``train.py``)::

    python -m decafnet_tpu_torch.train --cfg a.yaml [b.yaml ...]
        [--set dotted.key value ...] [--device cuda|cpu]
        [--dist-backend nccl|gloo]

Builds the config (task defaults <- files <- overrides), writes the
experiment's ``opt.yaml`` into ``<log.root>/<aux.log>/<aux.exp>/<aux.runid>``,
runs the Trainer (which resumes from ``models/last.pth`` and
``states/last.pt`` when both exist) and writes ``finished``. Runs on the
CUDA card unless ``--device`` says otherwise; raises where there is none.

Data parallelism, one process per card::

    torchrun --nproc_per_node N -m decafnet_tpu_torch.train --cfg a.yaml ...

joins ``torchrun``'s process group (NCCL on the cards, or gloo with
``--device cpu``; ``--dist-backend`` picks one explicitly), each rank on
``cuda:LOCAL_RANK`` unless ``--device`` names a device. ``train.batch_size``
is the global batch; the lead rank writes ``opt.yaml``, the logs, the
checkpoints and ``finished``. Only the lead runs the train-time eval while
the other ranks wait at a barrier, so one eval must take less than
``parallel.TIMEOUT_MIN`` (120 minutes), after which the group fails.
With ``--set tpu.shard_time True`` the ranks split each video's time axis
instead of the batch (sequence parallelism, ``parallel/seq.py``); adding
``tpu.mesh_shape "[n_data, n_time]"`` (n_data * n_time = N) splits the
batch over n_data groups of n_time ranks and each video's time axis within
a group, e.g. ``torchrun --nproc_per_node 4 ... --set tpu.shard_time True
tpu.mesh_shape "[2, 2]"``.
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import parallel
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
                        help="cuda (default; cuda:LOCAL_RANK under torchrun) "
                        "or cpu")
    parser.add_argument("--dist-backend", default=None,
                        help="process-group backend under torchrun: nccl "
                        "(default on CUDA) or gloo (default with --device cpu)")
    return parser.parse_args(argv)


def join_group(args):
    """``torchrun``'s process group for the CLI's ``--device`` and
    ``--dist-backend`` (nothing outside ``torchrun``)."""
    backend = args.dist_backend or ("gloo" if args.device == "cpu" else None)
    return parallel.init_distributed(backend)


def build_trainer(argv=None):
    """The config, ``opt.yaml`` and Trainer that :func:`main` runs."""
    args = parse_args(argv)
    join_group(args)
    cfg = setup_cfg(args.cfg, args.set_cfgs)
    # a seed drawn at random must be the same on every rank
    cfg.seed = parallel.broadcast_object(cfg.seed)
    root = cfg.aux.logdir
    if parallel.is_lead():
        os.makedirs(root, exist_ok=True)
        cfg.dump_to_file(os.path.join(root, "opt.yaml"))
        print(f"experiment: {cfg.aux.exp}", flush=True)
        print(f"logdir: {root}", flush=True)
    trainer = Trainer(cfg, device=args.device)
    print(f"device: {trainer.device}", flush=True)
    return trainer


def train(trainer):
    """Run ``trainer`` to the end; the lead writes the ``finished``
    sentinel."""
    trainer.run()
    if trainer.is_lead:
        with open(os.path.join(trainer.cfg.aux.logdir, "finished"), "w") as f:
            f.write("done\n")
    return trainer


def main(argv=None):
    """Train; returns the finished Trainer."""
    try:
        return train(build_trainer(argv))
    finally:
        parallel.destroy()


if __name__ == "__main__":
    main()
    sys.exit(0)
