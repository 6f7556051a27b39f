"""Training of the port: ground-truth assignment, losses, the optimizer
chain, the microbatch loss and the Trainer (port of decafnet_tpu.train).
The eval diagnostics use the first two."""

from .annotate import annotate_points
from .losses import (calc_focal_loss, calc_iou_loss, ctr_diou_loss,
                     ctr_giou_loss, ctr_iou_terms, segment_iou,
                     sigmoid_focal_loss)
from .optim import Optimizer, decay_mask, ema_update, make_schedule
from .trainer import Trainer, build_microbatch_loss, prune_checkpoints
