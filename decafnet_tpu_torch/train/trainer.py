"""The microbatch loss, the train step and the training loop (port of
decafnet_tpu/train/trainer.py).

One step: the batch's row blocks (``train.microbatch_size`` videos each)
run forward and backward in turn, their gradients summed in ``.grad``
(the JAX step's ``lax.scan``); then the optimizer chain (global-norm clip,
AdamW at the scheduled lr), the EMA of the weights and the loss-norm EMA
``m * n + (1 - m) * max(positives, 1)``. The loss is
``(focal(cls1) + focal(cls2)) / 2 + loss_weight * DIoU``, each summed over
the valid points and divided by the running loss norm.

Data parallelism: in a process group (``torchrun``, see
:mod:`decafnet_tpu_torch.parallel`) every rank loads its contiguous block
of each global batch, the model runs under ``DistributedDataParallel``
with gradients summed over the ranks (the JAX step's loss is a sum over the
global batch), the metrics and the positive-point count are summed before
the loss-norm EMA, and only the lead rank writes logs, checkpoints and runs
the train-time eval; the result equals the single-process run's.

Sequence parallelism (``tpu.shard_time: true``, the JAX 1-D ``time`` mesh):
in a process group of S ranks every rank loads the whole global batch and
keeps its block of each video's time axis (:mod:`parallel.seq`); the
forward and backward run inside that shard, so the ops exchange halos and
delegation gathers its bins; the loss sums the focal and DIoU terms of this
rank's points only, so nothing replicated counts S times; the gradients are
summed over the ranks after the backward (no ``DistributedDataParallel``,
whose bucket all-reduces would interleave with the halo exchanges on the
same group) and the positive count and metrics before the loss-norm EMA;
and every rank draws the dropouts from one generator seeded by ``cfg.seed``
at the global shape, so the step is the single-process step. A 2-D
``tpu.mesh_shape: (n_data, n_time)`` composes both, as the JAX
``data+time`` mesh does (:func:`parallel.seq.mesh_shard`): rank r loads
data block ``d = r // n_time`` of the global batch and keeps time block
``r % n_time`` of it, every exchange runs in its time subgroup, the
gradients and metrics are summed over the whole group, and the dropouts
draw from the generator of data rank ``d`` (:func:`rank_seed`) at the
global time shape, so the step is the ``n_data``-rank DDP step.

Compute dtype: ``tpu.compute_dtype: bfloat16`` (or ``bf16``) trains as the
JAX package does with an explicit bf16 (``auto`` is f32 for training, as
the JAX ``resolve_compute_dtype(eval_mode=False)`` gives): bf16 activations,
f32 master weights cast at each use (:func:`ops.params.cast` takes the
differentiable ``p.to(bf16)`` under autograd, so every gradient arrives in
f32), the kernel ops' bf16 kernels in the forward with their backward
recomputed through the bf16 plain versions, the losses on f32 logits and
offsets, and the AdamW moments, the EMA and the loss-norm EMA in f32. The
train-time eval of the EMA runs in bf16 too.

Checkpoints: ``models/{last,<epoch>-<itr>}.pth`` hold ``{model, model_ema}``
state dicts in the reference layout (what ``load_pth`` and the JAX
``load_torch_checkpoint`` read); ``states/last.pt`` holds the optimizer
state, loss norm, step, epoch and itr. Both are written atomically; a
Trainer resumes from them when both exist. Like the JAX trainer, the
checkpoint does not save the dropout stream: a resumed run draws from a
generator seeded by ``cfg.seed`` again.
"""

from __future__ import annotations

import contextlib
import copy
import os
import signal
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from .. import parallel
from ..parallel import seq
from ..data import DataLoader, batchify_train, make_dataset
from ..models import (check_time_sharding, init_random, load_pth, make_model,
                      require_two_heads)
from ..models.points import fpn_lengths, generate_points, select_points
from ..utils.logging import AverageMeter, Logger, time_str
from ..utils.tracking import MetricsSink
from .annotate import annotate_points
from .losses import calc_focal_loss, calc_iou_loss
from .optim import Optimizer, ema_update, make_schedule

TASKS = ("grounder", "mad", "charades")


def check_supported(cfg):
    """Raise for training settings the port cannot run, naming the rule,
    instead of running something else; and for the forward-only model
    variants."""
    require_two_heads(cfg, "Trainer")
    world, batch = parallel.world_size(), cfg.train.batch_size
    if cfg.tpu.get("shard_time"):
        check_time_split(cfg, world)
    elif batch % world:
        raise ValueError(f"train.batch_size {batch} does not divide over "
                         f"{world} processes")
    if cfg.task not in TASKS:
        raise ValueError(f"task {cfg.task!r}: training knows {TASKS}")
    if cfg.train.version != 2:
        raise ValueError("only train.version=2 is implemented (set "
                         "`train: {version: 2}`)")


def check_time_split(cfg, world):
    """Raise for a ``tpu.shard_time`` run the port cannot shard over its
    ``world`` ranks, naming the rule: a ``tpu.mesh_shape`` of another count
    than the group (:func:`parallel.seq.mesh_dims`), a global batch that
    does not split over its ``n_data`` data indices, and a train length
    that does not split over its ``n_time`` time ranks
    (:func:`models.check_time_sharding`)."""
    n_data, n_time = seq.mesh_dims(cfg.tpu.get("mesh_shape"), world)
    if cfg.train.batch_size % n_data:
        raise ValueError(f"train.batch_size {cfg.train.batch_size} does not "
                         f"divide over the {n_data} data indices of "
                         f"tpu.mesh_shape")
    if n_time > 1:
        check_time_sharding(cfg, cfg.data.max_vid_len, n_time)


def build_microbatch_loss(model, cfg):
    """The per-microbatch loss of the JAX ``build_microbatch_loss``:
    ``loss(mb, generator, loss_norm, points_t) -> (total, metrics)`` with
    ``mb`` a dict of device tensors from :func:`batchify_train` and
    ``metrics`` {cls, reg, total, norm} (``norm`` the positive points).
    Video-major (``tpu.video_major_train``, the default) runs ``vid_map``
    once per video; else the video inputs are repeated per query row."""
    Q = cfg.data.max_num_text or 1
    fc_a, fc_s = cfg.loss.fc_a, cfg.loss.fc_s
    tr = cfg.train
    vid_stride = cfg.model.vid_stride
    video_major = bool(cfg.tpu.get("video_major_train", True))

    def microbatch_loss(mb, generator, loss_norm, points_t):
        vid, shallow, vmask = mb["vid"], mb["shallow_vid"], mb["vid_masks"]
        if video_major:
            q = Q
        else:
            vid, shallow, vmask = (torch.repeat_interleave(x, Q, dim=0)
                                   for x in (vid, shallow, vmask))
            q = 1
        logits1, logits2, offsets, masks = model(
            vid, shallow, vmask, mb["text"], mb["text_cls"], mb["text_masks"],
            queries_per_video=q, generator=generator)
        logits1 = torch.cat(logits1, dim=1)                 # (R, P)
        logits2 = torch.cat(logits2, dim=1)
        offsets = torch.cat(offsets, dim=2)                 # (R, 2, P)
        masks = torch.cat(masks, dim=1) & mb["row_valid"][:, None]

        gt_labels, gt_offsets = annotate_points(
            points_t, mb["targets"] / vid_stride,
            center_sampling=tr.center_sampling,
            center_sampling_radius=tr.center_sampling_radius)
        pos = gt_labels & masks
        norm = pos.sum().float()

        def focal(logits):
            return calc_focal_loss(logits, gt_labels, masks, smoothing=fc_s,
                                   alpha=fc_a).sum() / loss_norm

        cls_loss = (focal(logits1) + focal(logits2)) / 2
        reg_loss = calc_iou_loss(offsets, gt_offsets, pos,
                                 reg_loss=tr.reg_loss).sum() / loss_norm
        total = cls_loss + tr.loss_weight * reg_loss
        return total, {"cls": cls_loss, "reg": reg_loss, "total": total,
                       "norm": norm}

    return microbatch_loss


def train_points(cfg, device, shard=None):
    """(4, P) candidate points of the static train length on ``device``;
    with a time ``shard``, each level's block of this rank (the points of
    the model's sharded outputs)."""
    lens = fpn_lengths(cfg.data.max_vid_len // cfg.model.vid_stride,
                       cfg.model.num_fpn_levels)
    pts = generate_points(cfg.pt_gen.max_seq_len, cfg.pt_gen.num_fpn_levels,
                          cfg.pt_gen.regression_range, cfg.pt_gen.sigma)
    levels = select_points(pts, lens)
    if shard is not None:
        levels = [shard.shard(torch.from_numpy(p), axis=0).numpy()
                  for p in levels]
    return torch.from_numpy(np.ascontiguousarray(
        np.concatenate(levels).T)).to(device)


def prune_checkpoints(mdir, keep, exempt_epochs=()):
    """Keep the ``keep`` most recent ``<epoch>-<itr>`` checkpoints in
    ``mdir`` (``.pth``, and ``.msgpack`` from the JAX trainer) by (epoch,
    itr), plus those of ``exempt_epochs`` and every other file; ``keep`` <=
    0 keeps everything (the JAX ``_prune_checkpoints``)."""
    if not keep or keep <= 0:
        return
    exempt = {int(e) for e in exempt_epochs or ()}
    tagged = {}
    for fname in os.listdir(mdir):
        stem, ext = os.path.splitext(fname)
        if ext not in (".msgpack", ".pth") or "-" not in stem:
            continue
        try:
            epoch, itr = (int(x) for x in stem.split("-"))
        except ValueError:
            continue
        tagged.setdefault((epoch, itr), []).append(fname)
    for epoch, itr in sorted(tagged, reverse=True)[keep:]:
        if epoch in exempt:
            continue
        for fname in tagged[(epoch, itr)]:
            try:
                os.remove(os.path.join(mdir, fname))
            except FileNotFoundError:
                pass


def _atomic_save(obj, path):
    """``torch.save`` to a temporary file renamed over ``path``: a kill
    mid-write never leaves a truncated checkpoint under the real name."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _sum_hook(state, bucket):
    """DDP communication hook: the bucket's gradients summed over the ranks
    (DDP's default averages them)."""
    fut = dist.all_reduce(bucket.buffer(), async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def rank_seed(seed, rank):
    """The dropout generator's seed of ``rank``: ``seed`` itself on rank 0
    (so one process draws what the single-process run draws), a stream of
    its own on every other rank."""
    if rank == 0:
        return seed
    return int(np.random.SeedSequence((seed, rank)).generate_state(1)[0])


def _to_device(batch, device):
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in batch.items()}


class Trainer:
    """Training of ``cfg`` on one device (None: the CUDA card, this
    process's ``cuda:LOCAL_RANK`` in a process group, raising where there is
    none; the CPU only when asked).

    ``model`` (the bare module) trains, ``ema`` holds the EMA weights (what
    eval reads), and ``generator`` (on the device, seeded by ``cfg.seed``
    and the rank: :func:`rank_seed`) feeds the dropouts. In a process group
    ``ddp`` is ``model`` under ``DistributedDataParallel`` and runs the
    forwards; else it is None. Under ``tpu.shard_time`` in a group of more
    than one rank, ``shard`` is this rank's :class:`parallel.TimeShard`
    (of its time subgroup under a 2-D ``tpu.mesh_shape``), ``ddp`` is None
    and ``generator`` is seeded as data rank ``data_rank`` of
    ``data_world``; else ``shard`` is None and the data ranks are the
    group's."""

    def __init__(self, cfg, device=None):
        from ..eval.evaluator import Evaluator, resolve_device

        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.rank, self.world = parallel.rank(), parallel.world_size()
        self.is_lead = self.rank == 0
        self.shard = None
        self.data_rank, self.data_world = self.rank, self.world
        if cfg.tpu.get("shard_time") and self.world > 1:
            self.data_rank, self.data_world, self.shard = seq.mesh_shard(
                cfg.tpu.get("mesh_shape"))
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(cfg.seed, self.data_rank))

        self.num_epochs = cfg.train.epochs + cfg.train.warmup_epochs
        self.dataset = make_dataset(cfg, num_epochs=self.num_epochs,
                                    is_training=True,
                                    rng=np.random.RandomState(cfg.seed))
        self.max_num_text = cfg.data.max_num_text or 1
        # every rank loads its data block of the global batch (under
        # shard_time each rank of a time subgroup the same block)
        self.loader = DataLoader(
            self.dataset, cfg.train.batch_size, shuffle=True, seed=cfg.seed,
            num_threads=cfg.train.num_workers, rank=self.data_rank,
            world_size=self.data_world,
            shard_within_batch=self.data_world > 1,
            transform=lambda samples: batchify_train(
                samples, cfg.data.max_vid_len, cfg.data.max_text_len,
                self.max_num_text))
        self.itrs_per_epoch = len(self.loader)
        self.num_itrs = self.num_epochs * self.itrs_per_epoch
        self.epoch = self.itr = 0
        self.micro = cfg.train.get("microbatch_size") or cfg.train.batch_size

        model = make_model(cfg)
        init_random(model, cfg.seed)
        if cfg.model.pretrain:
            load_pth(model, cfg.model.pretrain, "model")
        self.model = model.to(self.device).train()
        self.ema = copy.deepcopy(self.model).eval().requires_grad_(False)
        self.points_t = train_points(cfg, self.device, self.shard)

        sched_cfg = dict(cfg.scheduler, _base_lr=cfg.optimizer.lr)
        self.optimizer = Optimizer(self.model, cfg.optimizer,
                                   make_schedule(sched_cfg, self.itrs_per_epoch))
        self.loss_norm = torch.tensor(float(cfg.train.loss_norm),
                                      dtype=torch.float32, device=self.device)

        root = cfg.aux.logdir
        if self.is_lead:
            os.makedirs(os.path.join(root, "models"), exist_ok=True)
            os.makedirs(os.path.join(root, "states"), exist_ok=True)
        self.logger = Logger(os.path.join(root, "log.txt") if self.is_lead
                             else None, quiet=not self.is_lead)
        self.metrics_sink = MetricsSink(root, cfg, enabled=self.is_lead)
        self.loss_meters = {}
        self.timer = AverageMeter()
        n_params = sum(p.numel() for p in self.model.parameters()) / 1e6
        self.logger.write(f"Model: {n_params:.2f}M parameters")

        if (cfg.aux.get("resume", True)
                and os.path.exists(os.path.join(root, "models", "last.pth"))
                and os.path.exists(os.path.join(root, "states", "last.pt"))):
            self.load()
        elif cfg.aux.get("model_resume"):
            self.load_model_only(cfg.aux.model_resume)

        # wrapped after the weights are loaded: DDP broadcasts rank 0's
        # parameters at construction (every rank loads the optimizer state
        # itself). The only buffers are constant position tables, so none
        # is broadcast per forward; every parameter gets a gradient in
        # every microbatch, so no unused-parameter search
        self.ddp = None
        if self.shard is not None:
            # every rank starts from the lead's weights (its own are the
            # same seed's, or the same files')
            for t in list(self.model.parameters()) + list(self.ema.parameters()):
                dist.broadcast(t.data, 0)
        elif parallel.initialized():
            self.ddp = DistributedDataParallel(
                self.model, device_ids=(
                    [self.device.index if self.device.index is not None
                     else torch.cuda.current_device()]
                    if self.device.type == "cuda" else None),
                broadcast_buffers=False)
            self.ddp.register_comm_hook(None, _sum_hook)
        self.loss_fn = build_microbatch_loss(self.ddp or self.model, cfg)

        # train-time eval runs on the lead only; the other ranks wait
        self.evaluator = None
        if self.is_lead and cfg.aux.eval_run and cfg.aux.eval_run > 0:
            self.evaluator = Evaluator(cfg, device=self.device,
                                       train_time=True)

    @property
    def step(self):
        """Optimizer steps taken (the JAX ``TrainState.step``)."""
        return self.optimizer.count

    # -- the step -----------------------------------------------------------

    def accumulate(self, batch, micro=None):
        """Forward and backward over ``batch`` (device tensors; in a process
        group this rank's block of the global batch) in
        ``global videos / micro`` row blocks (``micro`` defaults to
        ``train.microbatch_size``), summing gradients into ``.grad``
        (cleared first; in a group summed over the ranks after the last
        block). Returns the metrics summed over the blocks and the ranks,
        0-d device tensors. Time-sharded, ``batch`` is this rank's data
        block (the whole global batch on a 1-D mesh), each block runs on
        this rank's part of the time axis and the gradients are summed over
        the ranks after the last block."""
        self.optimizer.zero_grad()
        micro = micro or self.micro
        rows = batch["vid"].shape[0] * self.data_world
        n_micro = max(rows // micro, 1)
        totals = None
        for i in range(n_micro):
            mb = {}
            for k, v in batch.items():
                if v.shape[0] % n_micro:
                    raise ValueError(f"{k}: {v.shape[0]} rows do not split "
                                     f"into {n_micro} microbatches")
                n = v.shape[0] // n_micro
                mb[k] = v[i * n:(i + 1) * n]
                if self.shard is not None and k in seq.TIME_KEYS:
                    mb[k] = self.shard.shard(mb[k])
            # DDP sums the gradients in the last block's backward only
            sync = self.ddp is None or i == n_micro - 1
            with contextlib.nullcontext() if sync else self.ddp.no_sync(), \
                    seq.sharding(self.shard):
                loss, metrics = self.loss_fn(mb, self.generator,
                                             self.loss_norm, self.points_t)
                loss.backward()
            metrics = {k: v.detach() for k, v in metrics.items()}
            totals = metrics if totals is None else {
                k: totals[k] + metrics[k] for k in totals}
        if self.shard is not None:
            self._sum_grads()
        if self.world > 1:
            keys = list(totals)
            summed = parallel.all_reduce_sum(torch.stack([totals[k] for k in keys]))
            totals = dict(zip(keys, summed.unbind()))
        return totals

    def _sum_grads(self):
        """Every parameter's gradient summed over the ranks (one collective
        over the flattened gradients)."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        parallel.all_reduce_sum(flat)
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
            at += p.numel()

    def update(self, metrics):
        """Optimizer step, EMA and loss-norm EMA after :meth:`accumulate`."""
        self.optimizer.step()
        ema_update(self.model.parameters(), self.ema.parameters(),
                   self.cfg.train.ema_beta)
        mom = self.cfg.train.loss_norm_momentum
        self.loss_norm = (mom * self.loss_norm
                          + (1.0 - mom) * torch.clamp_min(metrics["norm"], 1.0))

    def train_step(self, batch):
        """One optimizer step on a batch of device tensors; returns its
        metrics."""
        self.model.train()
        metrics = self.accumulate(batch)
        self.update(metrics)
        return metrics

    # -- checkpoints --------------------------------------------------------

    def checkpoint(self):
        """Write the checkpoint (the lead rank only; a no-op elsewhere)."""
        if not self.is_lead:
            return
        root = self.cfg.aux.logdir

        def cpu(module):
            return {k: v.detach().cpu() for k, v in module.state_dict().items()}

        blob = {"model": cpu(self.model), "model_ema": cpu(self.ema)}
        for name in (f"{self.epoch}-{self.itr}.pth", "last.pth"):
            _atomic_save(blob, os.path.join(root, "models", name))
        _atomic_save({"optimizer": self.optimizer.state_dict(),
                      "loss_norm": self.loss_norm.cpu(), "step": self.step,
                      "epoch": self.epoch, "itr": self.itr},
                     os.path.join(root, "states", "last.pt"))
        prune_checkpoints(os.path.join(root, "models"),
                          self.cfg.aux.get("save_run", 0),
                          self.cfg.log.get("checkpoint_epochs"))

    def load(self):
        """Resume weights, EMA, optimizer state, loss norm and position from
        ``models/last.pth`` and ``states/last.pt``."""
        root = self.cfg.aux.logdir
        path = os.path.join(root, "models", "last.pth")
        load_pth(self.model, path, "model")
        load_pth(self.ema, path, "model_ema")
        s = torch.load(os.path.join(root, "states", "last.pt"),
                       map_location=self.device, weights_only=True)
        self.optimizer.load_state_dict(s["optimizer"])
        self.loss_norm = s["loss_norm"].to(self.device)
        self.epoch, self.itr = int(s["epoch"]), int(s["itr"])
        self.logger.write(
            f"Loaded checkpoint [epoch {self.epoch} / itr {self.itr}]")

    def load_model_only(self, path):
        """Weights-only warm start (``aux.model_resume``) from a
        reference-layout ``.pth``: ``model`` and ``model_ema``."""
        if not path.endswith(".pth"):
            raise ValueError(f"{path}: the port warm-starts from .pth files "
                             f"only")
        load_pth(self.model, path, "model")
        load_pth(self.ema, path, "model_ema")

    # -- loop ---------------------------------------------------------------

    def run(self):
        """Train to the end (one step under ``aux.dryrun``). A SIGTERM
        only sets a flag; the loop checkpoints at the next step boundary
        and exits with code 143, and a new Trainer resumes there. In a
        process group the ranks agree on the flag at each boundary, so all
        of them leave at the same step."""
        cfg = self.cfg
        self.logger.write("Training started.")
        self._preempted = False

        def on_sigterm(signum, frame):
            self.logger.write("SIGTERM received; will checkpoint at the "
                              "next step boundary.")
            self._preempted = True

        def preempted():
            # the ranks' agreed answer; a SIGTERM that lands during the
            # all-reduce keeps its flag for the next boundary (it is never
            # overwritten with the answer read before it)
            agreed = parallel.any_rank(self._preempted, self.device)
            self._preempted = self._preempted or agreed
            return agreed

        def checkpoint_and_exit():
            self.logger.write("Preemption checkpoint for resume.")
            self.checkpoint()
            parallel.barrier()
            raise SystemExit(143)

        try:
            prev_handler = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            prev_handler = None  # not on the main thread
        try:
            while self.epoch < self.num_epochs:
                self.loader.set_epoch(self.epoch)
                start = time.time()
                for batch in self.loader:
                    metrics = self.train_step(_to_device(batch, self.device))
                    self.itr += 1
                    if preempted():
                        checkpoint_and_exit()
                    for k in ("cls", "reg", "total"):
                        self.loss_meters.setdefault(k, AverageMeter()).update(
                            float(metrics[k]))
                    self.timer.update(time.time() - start)
                    start = time.time()
                    if self.itr == 1 or self.itr % cfg.aux.log_interval == 0:
                        self.log()
                    if cfg.aux.dryrun:
                        break
                    if (cfg.aux.eval_by == "itr" and cfg.aux.eval_run > 0
                            and self.itr % cfg.aux.eval_run == 0):
                        self.evaluate(self.itr)
                self.epoch += 1
                if preempted():
                    checkpoint_and_exit()
                if cfg.aux.eval_by == "epoch":
                    self.evaluate(self.epoch)
                if cfg.aux.dryrun:
                    break
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        self.logger.write("Training completed.")

    def evaluate(self, ct):
        """Checkpoint; every ``aux.eval_run`` epochs (or itrs) also
        evaluate the EMA weights, logging to ``eval_<epoch>_<itr>.txt``
        (the lead; the other ranks wait for it)."""
        self.checkpoint()
        if (self.evaluator is not None and self.cfg.aux.eval_run > 0
                and ct % self.cfg.aux.eval_run == 0):
            self.evaluator.logger = Logger(os.path.join(
                self.cfg.aux.logdir, f"eval_{self.epoch}_{self.itr}.txt"))
            self.evaluator.run(ema=self.ema, tag=f"{self.epoch}_{self.itr}")
        parallel.barrier()

    def log(self):
        t = len(str(self.num_itrs))
        parts = [f"[{self.itr:0{t}d}/{self.num_itrs:0{t}d}]"]
        record = {"itr": self.itr, "epoch": self.epoch}
        for k, meter in self.loss_meters.items():
            parts.append(f"{k} {meter.item():.3f} |")
            record[f"train/{k}"] = meter.item()
            meter.reset()
        record["itr_time"] = self.timer.item()
        parts.append(time_str(self.timer.item()))
        self.timer.reset()
        self.logger.write(" ".join(parts))
        self.metrics_sink.log(record, step=self.itr)
