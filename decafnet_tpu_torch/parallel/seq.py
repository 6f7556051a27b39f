"""Sequence parallelism: each video's time axis split over the ranks of a
process group (the counterpart of decafnet_tpu/parallel/mesh.py's
``time_sharding`` and ``shard_batch(..., axis="time")``).

Rank r of S holds the contiguous block ``[r * t, (r + 1) * t)`` of every
time-sharded tensor of global length ``S * t``; at each FPN level the blocks
halve with the lengths, so a block always starts at ``rank * t`` of its own
level. The three (…, T) video inputs (:data:`TIME_KEYS`) are sliced with
:meth:`TimeShard.shard`; everything else (the text, the weights, the
targets) is replicated.

XLA's SPMD partitioner inserts the JAX package's halo exchanges; PyTorch has
none, so the ops that look past their own column call them here:

* :meth:`TimeShard.halo` widens a block by its neighbours' edge columns
  (zeros, a False mask, or a given fill past the video's ends: a conv's
  zero padding) and, under autograd, sends the halo's gradients back to the
  owners' edge columns;
* :meth:`TimeShard.gather` concatenates the blocks of every rank (the global
  cuts: delegation's top-k, the decode); its backward sums the gradients of
  the ranks and keeps this rank's block;
* :meth:`TimeShard.all_reduce` for a global min or sum;
* :func:`crop` cuts a widened result back to the block.

Each runs in a ``torch.profiler`` range (``seq.halo``,
``seq.halo_backward``, ``seq.gather``, ``seq.crop``), so a profile shows
the device time of the exchanges and of the halos' copies.

Every exchange is one ``all_reduce`` of a zeroed ``(S, …)`` slot buffer, a
collective that gloo and NCCL both have for CUDA and CPU tensors (gloo has no
``reduce_scatter``, and may lack send/recv and ``all_gather`` on CUDA
tensors); bf16 and bool travel as f32 (exact), f64 as f64. A failed
collective raises; nothing falls back.

A 2-D ``tpu.mesh_shape: (n_data, n_time)`` composes this with data
parallelism (:func:`mesh_shard`): rank r sits at (r // n_time, r % n_time)
of the JAX package's ``('data', 'time')`` mesh, and its :class:`TimeShard`
is its time subgroup's, so every exchange stays inside the subgroup.

The ops read the shard of the running computation from :func:`active`: the
Trainer and the Evaluator enter :func:`sharding` around their sharded
forward and backward (the backward too: a remat recompute exchanges halos),
and the model leaves it (:func:`replicated`) around the text net, which
every rank runs whole. Outside :func:`sharding` every op is the
single-process op. Every rank must run the same exchanges in the same
order: a rank that skips one deadlocks the group (until
``parallel.TIMEOUT_MIN``), it does not raise.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist
from torch.profiler import record_function

# the (…, T) video tensors of a batch, sharded on their time axis
TIME_KEYS = ("vid", "shallow_vid", "vid_masks")


def _wire_dtype(tensors):
    """The dtype the tensors travel in: f64 if one is f64, else f32 (bf16,
    f32 and bool all convert exactly)."""
    return (torch.float64 if any(t.dtype == torch.float64 for t in tensors)
            else torch.float32)


def _flat(tensors, dtype):
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def _unflat(buf, like):
    """``buf`` cut into tensors of the shapes and dtypes of ``like`` (a list
    of (shape, dtype))."""
    out, at = [], 0
    for shape, dtype in like:
        n = math.prod(shape)
        piece = buf[at:at + n].reshape(shape)
        out.append(piece.bool() if dtype == torch.bool else piece.to(dtype))
        at += n
    return out


class TimeShard:
    """This rank's place in a time-sharded group (None: the default group
    of ``torch.distributed``): ``rank`` of ``size`` ranks."""

    def __init__(self, group=None):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def offset(self, t):
        """Global index of this rank's first column in a block of ``t``."""
        return self.rank * t

    def shard(self, x, axis=-1):
        """This rank's block of a global tensor (contiguous)."""
        T = x.shape[axis]
        if T % self.size:
            raise ValueError(f"a time axis of {T} does not split over "
                             f"{self.size} ranks")
        t = T // self.size
        return x.narrow(axis, self.rank * t, t).contiguous()

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """``t`` reduced over the ranks, in place (bf16 travels as f32)."""
        if t.dtype in (torch.float32, torch.float64):
            dist.all_reduce(t, op=op, group=self.group)
            return t
        wire = t.to(torch.float32)
        dist.all_reduce(wire, op=op, group=self.group)
        return t.copy_(wire)

    def _slots(self, pieces, n, dtype, device):
        """One all-reduce over S slots of ``n`` entries (the same n on every
        rank): ``pieces`` maps a slot to the flat tensor this rank writes at
        its start; returns the (S, n) result."""
        buf = torch.zeros((self.size, n), dtype=dtype, device=device)
        for slot, p in pieces.items():
            buf[slot, :p.numel()] = p
        dist.all_reduce(buf, group=self.group)
        return buf

    # -- gather -------------------------------------------------------------

    def gather(self, *xs, axis=-1):
        """The global tensors of this rank's blocks ``xs`` (each (…, t) at
        ``axis``), concatenated along the time axis, in one collective.
        Differentiable: the backward sums every rank's gradient of the
        global tensor and keeps this rank's block. Returns a tuple."""
        with record_function("seq.gather"):
            if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
                return _Gather.apply(self, axis, *xs)
            return self._gather(xs, axis)

    def _gather(self, xs, axis):
        dtype, dev = _wire_dtype(xs), xs[0].device
        moved = [x.movedim(axis, 0) for x in xs]      # time first
        flat = _flat(moved, dtype)
        buf = self._slots({self.rank: flat}, flat.numel(), dtype, dev)
        # slot r holds rank r's blocks of every tensor, one after another
        like = [(m.shape, x.dtype) for x, m in zip(xs, moved)]
        per_rank = [_unflat(buf[r], like) for r in range(self.size)]
        return tuple(torch.cat([blocks[i] for blocks in per_rank])
                     .movedim(0, axis).contiguous() for i in range(len(xs)))

    # -- halo ---------------------------------------------------------------

    def halo(self, *xs, left, right, axis=-1, fill=0.0):
        """Each of ``xs`` (this rank's blocks, one length t at ``axis``)
        widened to ``left + t + right`` columns by the last ``left`` columns
        of the rank before and the first ``right`` of the rank after, in one
        collective. Past the video's ends the new columns are ``fill``
        in a float tensor and False in a bool mask. Under autograd the gradients of the new
        columns go back to the ranks that own them and add into their edge
        columns. Returns a tuple."""
        t = xs[0].shape[axis]
        if left > t or right > t:
            raise ValueError(f"a halo of ({left}, {right}) columns is longer "
                             f"than a rank's block of {t}")
        with record_function("seq.halo"):
            if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
                return _Halo.apply(self, left, right, axis, fill, *xs)
            return self._widen(xs, left, right, axis, fill)

    def _widen(self, xs, left, right, axis, fill):
        dtype, dev = _wire_dtype(xs), xs[0].device
        S, r = self.size, self.rank
        moved = [x.movedim(axis, -1) for x in xs]
        t = moved[0].shape[-1]
        heads = [m[..., :right] for m in moved]
        tails = [m[..., t - left:] for m in moved]
        flat = _flat(heads + tails, dtype)
        buf = self._slots({r: flat}, flat.numel(), dtype, dev)
        like = ([(h.shape, x.dtype) for h, x in zip(heads, xs)]
                + [(tl.shape, x.dtype) for tl, x in zip(tails, xs)])
        n = len(xs)
        prev = _unflat(buf[r - 1], like)[n:] if r > 0 else None
        nxt = _unflat(buf[r + 1], like)[:n] if r < S - 1 else None
        outs = []
        for i, m in enumerate(moved):
            parts = [m]
            if left:
                parts.insert(0, prev[i] if prev is not None else _edge(m, left, fill))
            if right:
                parts.append(nxt[i] if nxt is not None else _edge(m, right, fill))
            outs.append(torch.cat(parts, dim=-1).movedim(-1, axis).contiguous())
        return tuple(outs)

    def _return_halo_grads(self, grads, left, right, axis):
        """The backward of :meth:`halo`: each widened gradient's new columns
        summed into the owners' edge columns. Returns the block gradients."""
        dtype, dev = _wire_dtype(grads), grads[0].device
        S, r = self.size, self.rank
        moved = [g.movedim(axis, -1) for g in grads]
        t = moved[0].shape[-1] - left - right
        to_next = [m[..., left + t:] for m in moved]    # its first columns
        to_prev = [m[..., :left] for m in moved]        # its last columns
        # slot s: [the gradients of rank s's first columns | of its last]
        n_heads = sum(g.numel() for g in to_next)
        n = n_heads + sum(g.numel() for g in to_prev)
        pieces = {}
        if right and r + 1 < S:
            pieces[r + 1] = _flat(to_next, dtype)
        if left and r > 0:
            pieces[r - 1] = torch.cat([torch.zeros(n_heads, dtype=dtype,
                                                   device=dev),
                                       _flat(to_prev, dtype)])
        buf = self._slots(pieces, n, dtype, dev)
        got = _unflat(buf[r], [(g.shape, g.dtype) for g in to_next + to_prev])
        out = []
        for i, m in enumerate(moved):
            mid = m[..., left:left + t].clone()
            if right:
                mid[..., :right] += got[i]
            if left:
                mid[..., t - left:] += got[len(grads) + i]
            out.append(mid.movedim(-1, axis))
        return out


def _edge(m, width, fill):
    """``width`` columns past the video's end, shaped like the last axis of
    ``m``: ``fill``, or False for a bool mask."""
    shape = m.shape[:-1] + (width,)
    if m.dtype == torch.bool:
        return torch.zeros(shape, dtype=torch.bool, device=m.device)
    return torch.full(shape, fill, dtype=m.dtype, device=m.device)


class _Halo(torch.autograd.Function):
    """:meth:`TimeShard.halo` under autograd."""

    @staticmethod
    def forward(ctx, shard, left, right, axis, fill, *xs):
        ctx.shard, ctx.left, ctx.right, ctx.axis = shard, left, right, axis
        ctx.floating = [x.is_floating_point() for x in xs]
        outs = shard._widen(xs, left, right, axis, fill)
        ctx.mark_non_differentiable(*[o for o, f in zip(outs, ctx.floating)
                                      if not f])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        idx = [i for i, f in enumerate(ctx.floating) if f]
        with record_function("seq.halo_backward"):
            back = ctx.shard._return_halo_grads([grads[i] for i in idx],
                                                ctx.left, ctx.right, ctx.axis)
        out = [None] * len(grads)
        for i, g in zip(idx, back):
            out[i] = g
        return (None,) * 5 + tuple(out)


class _Gather(torch.autograd.Function):
    """:meth:`TimeShard.gather` under autograd."""

    @staticmethod
    def forward(ctx, shard, axis, *xs):
        ctx.shard, ctx.axis = shard, axis
        ctx.floating = [x.is_floating_point() for x in xs]
        outs = shard._gather(xs, axis)
        ctx.mark_non_differentiable(*[o for o, f in zip(outs, ctx.floating)
                                      if not f])
        return outs

    @staticmethod
    def backward(ctx, *grads):
        shard, axis = ctx.shard, ctx.axis
        out = []
        for g, f in zip(grads, ctx.floating):
            if not f:
                out.append(None)
                continue
            g = shard.all_reduce(g.contiguous().clone())
            out.append(shard.shard(g, axis))
        return (None, None) + tuple(out)


def mesh_dims(mesh_shape, world):
    """``(n_data, n_time)`` of a ``tpu.shard_time`` run over ``world`` ranks:
    the time axis over every rank for ``mesh_shape`` None or 1-D, a 2-D
    ``(n_data, n_time)`` as given. Raises for a shape that names another
    count of ranks than the group's, or more than two axes."""
    shape = tuple(int(n) for n in mesh_shape or ())
    if len(shape) > 2:
        raise ValueError(f"tpu.mesh_shape {shape}: at most two axes, "
                         f"(n_data, n_time)")
    if shape and math.prod(shape) != world:
        raise ValueError(f"tpu.shard_time shards the time axis over the "
                         f"{world} ranks of the process group, and "
                         f"tpu.mesh_shape {shape} names another count")
    return shape if len(shape) == 2 else (1, world)


def mesh_shard(mesh_shape):
    """This rank's place on the data x time mesh of ``mesh_shape`` over the
    process group (:func:`mesh_dims`): ``(d, n_data, shard)``, ``d`` its
    data index and ``shard`` the :class:`TimeShard` of the ranks ``d *
    n_time + i``, as the JAX ``make_mesh`` reshapes the devices to
    (n_data, n_time). With one data index the shard is the whole group's."""
    n_data, n_time = mesh_dims(mesh_shape, dist.get_world_size())
    if n_data == 1:
        return 0, 1, TimeShard()
    # every rank creates every subgroup, in the same order
    groups = [dist.new_group(list(range(d * n_time, (d + 1) * n_time)))
              for d in range(n_data)]
    d = dist.get_rank() // n_time
    return d, n_data, TimeShard(groups[d])


# the shard of the running computation: one per process, not per thread,
# because autograd runs a CUDA backward (and a remat recompute inside it) on
# its own device threads, which must see the shard the forward saw
_ACTIVE = None


def active():
    """The :class:`TimeShard` of the running sharded computation, or None."""
    return _ACTIVE


@contextlib.contextmanager
def _set(shard):
    global _ACTIVE
    prev, _ACTIVE = _ACTIVE, shard
    try:
        yield shard
    finally:
        _ACTIVE = prev


def sharding(shard):
    """Run the enclosed forward (and backward) time-sharded by ``shard``
    (None: unsharded, a no-op)."""
    return _set(shard)


def replicated():
    """Leave the time sharding for a computation every rank runs whole (the
    text net)."""
    return _set(None)


def crop(x, left, right):
    """The block of a result computed on a block widened by (``left``,
    ``right``) halo columns, as a contiguous copy (the kernels take
    contiguous inputs)."""
    with record_function("seq.crop"):
        return x[..., left:x.shape[-1] - right].contiguous()
