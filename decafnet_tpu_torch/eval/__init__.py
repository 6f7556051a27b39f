"""Evaluation of the port: the shape-bucketed decode, the dataset-driven
Evaluator and the R@k meter (CLI: ``python -m decafnet_tpu_torch.eval``)."""

from .metrics import RecallMeter, interval_iou
from .evaluator import (Decoder, Evaluator, checkpoint_path, config_from_logdir,
                        modulated_level_scores, resolve_device)
