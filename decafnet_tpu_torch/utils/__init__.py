"""Host utilities of the port: logging, metering, metric sinks, result
dumps."""

from .analysis import EvalResults
from .logging import AverageMeter, Logger, count_parameters, easy_reduce, time_str
from .tracking import MetricsSink
