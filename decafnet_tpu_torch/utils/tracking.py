"""Experiment-metric sink (port of decafnet_tpu/utils/tracking.py).

The record is an append-only ``metrics.jsonl`` in the experiment directory.
Records are also pushed to wandb only when ``WANDB_API_KEY`` is set and the
``wandb`` package imports: project ``WANDB_PROJECT`` or the config's
``aux.log``, run name the experiment name, and a run id made of the
experiment name and ``aux.runid``, so a resumed run continues the same
remote run.
"""

from __future__ import annotations

import json
import os


class MetricsSink:
    """Append metric records to ``<logdir>/metrics.jsonl``, and push them to
    wandb where the environment allows (see the module docstring). A sink
    made with ``enabled=False`` (a non-lead rank's) writes nothing."""

    def __init__(self, logdir, cfg=None, enabled=True):
        self.path = os.path.join(logdir, "metrics.jsonl")
        self.enabled = enabled
        self._wandb = None
        if enabled and os.environ.get("WANDB_API_KEY"):
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                exp = runid = ""
                group = os.environ.get("WANDB_PROJECT", "decafnet_tpu")
                if cfg is not None:
                    exp = cfg.aux.get("exp", "")
                    runid = str(cfg.aux.get("runid", 0))
                    group = os.environ.get("WANDB_PROJECT",
                                           cfg.aux.get("log", group))
                self._wandb = wandb.init(
                    project=group, name=exp or None,
                    id=f"{exp}-{runid}".strip("-") or None, resume="allow",
                    config=cfg.to_dict() if cfg is not None else None)

    def log(self, record, step=None):
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in record.items()
                             if isinstance(v, (int, float))}, step=step)
