"""Host utilities of the port: logging, metering, metric sinks, result
dumps and their analysis, phase timing and tracing."""

from .analysis import (EvalResults, compute_iou, compute_iou_by_length,
                       interpolate_array, load_reference_checkpoint)
from .logging import AverageMeter, Logger, count_parameters, easy_reduce, time_str
from .profiling import PhaseTimer, annotate, trace
from .tracking import MetricsSink
