"""Multi-process data parallelism and sequence parallelism of the port
(``torch.distributed``, one process per card under ``torchrun``)."""

from .dist import (TIMEOUT_MIN, all_reduce_sum, any_rank, backend, barrier,
                   broadcast_object, destroy, host_batch_slice,
                   init_distributed, initialized, is_lead, local_device, rank,
                   world_size)
from .seq import TimeShard
