"""Ground-truth assignment and losses of the port (the eval diagnostics
use them; training builds on them)."""

from .annotate import annotate_points
from .losses import (calc_focal_loss, calc_iou_loss, ctr_diou_loss,
                     ctr_giou_loss, ctr_iou_terms, segment_iou,
                     sigmoid_focal_loss)
