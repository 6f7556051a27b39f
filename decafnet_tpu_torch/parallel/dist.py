"""Process groups for data parallelism: one process per card, launched by
``torchrun`` (the counterpart of decafnet_tpu/parallel/mesh.py, whose SPMD
mesh turns the reference's DDP/NCCL machinery into XLA collectives; the port
goes back to that machinery, in PyTorch's idiom).

:func:`init_distributed` joins the group that ``torchrun`` describes in the
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and does nothing without it, as ``mesh.init_distributed``
does without a coordinator address. Off a group every helper here is the
single-process identity: rank 0 of 1, the lead, no-op barriers and sums.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# how long a collective or barrier waits for the other ranks before the
# group fails. The lead's train-time eval runs while the other ranks wait at
# a barrier, so it must finish within this (torch's own default, 10 min,
# leaves too little room for one eval of a long-video split)
TIMEOUT_MIN = 120


def initialized():
    return dist.is_available() and dist.is_initialized()


def init_distributed(backend=None):
    """Join the process group of ``torchrun``'s environment; returns whether
    this process is in one. ``backend`` None picks NCCL where CUDA is
    available and gloo where it is not; an explicit one is used as given.
    Under NCCL the process's current card becomes ``cuda:LOCAL_RANK``.
    A collective fails after ``TIMEOUT_MIN`` minutes of waiting."""
    if initialized():
        return True
    if not all(k in os.environ for k in ENV_KEYS):
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device())
    dist.init_process_group(backend=backend, init_method="env://",
                            timeout=datetime.timedelta(minutes=TIMEOUT_MIN))
    return True


def destroy():
    """Leave the process group, if this process is in one."""
    if initialized():
        dist.destroy_process_group()


def rank():
    return dist.get_rank() if initialized() else 0


def world_size():
    return dist.get_world_size() if initialized() else 1


def is_lead():
    """Rank 0: the process that writes logs, checkpoints and tables."""
    return rank() == 0


def backend():
    return dist.get_backend() if initialized() else None


def local_device():
    """``cuda:LOCAL_RANK``: the card of this process on its host."""
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def barrier():
    if not initialized():
        return
    if backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_sum(t):
    """Sum ``t`` over the ranks in place, so every rank holds the same
    result; returns it. ``t`` lies on this rank's card under NCCL, on the
    card or the CPU under gloo."""
    if world_size() > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def any_rank(flag, device):
    """True on every rank when ``flag`` is true on any (an all-reduce MAX)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor(float(bool(flag)), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def host_batch_slice(n_items, rank, world):
    """Index range of this process's slice of a globally ordered batch."""
    per = n_items // world
    return rank * per, (rank + 1) * per


def broadcast_object(obj):
    """The lead's ``obj`` on every rank (a picklable value)."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]
