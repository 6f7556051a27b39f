"""Evaluation: grounder forward + proposal decode + NMS, queries as batch
rows (port of decafnet_tpu/eval/evaluator.py, the per-video path that
``eval.py`` runs).

:class:`Decoder` owns the per-shape-bucket decode of one model on one
device, shared by the Evaluator and the serving path. Per bucket (T, Q, L)
the model runs video-major (V videos x Q query rows); scores are sigmoid
logits (optionally modulated by external scores); the top-k cut is a
per-query threshold (``scores >= kth``, so ties match the JAX decode; in
the bf16 compute mode the scores are bf16, as in JAX, and the threshold is
applied to them before any upcast, since bf16 scores tie far more often);
segments are assembled for all points and filtered by length. Then either
fixed-k SoftNMS with voting runs on the device and only the (Q, k, 2)
detections return to the host, or (``eval.reference_exact``) the (Q, P)
candidates return and the host C++ SoftNMS runs per query. With targets the
same call computes the per-query eval losses (focal and IoU over the
annotated points).

Spans and counters go into the decoder's record (``timer``, a
:class:`~decafnet_tpu_torch.utils.profiling.PhaseTimer`; ``time_dict`` is
its buckets): the reference's ``prepare`` (a request), ``forward`` and
``post_process`` (a decode call), ``nms`` (the host SoftNMS, when it runs);
``forward``'s parts ``decode.stage`` (the group's arrays joined on the
host), ``decode.h2d`` (copied to the device), ``decode.dispatch`` (the
forward's and the decode's launches) and ``decode.d2h`` (the outputs back,
where the host waits for the device); the counters ``decode.h2d_bytes``,
``decode.rows`` (V x Q) and ``decode.real_rows`` (the rows of real
queries); and the stages ``model.*`` (:mod:`models.decafnet`) and
``decode.select_nms`` (scores, the top-k threshold, the device SoftNMS),
whose stream times, while a profiler records, go under ``<stage>.stream``.
Each decode shape's first call also goes into the set-up record
(``profiling.SETUP``).

:class:`Evaluator` walks a dataset one video at a time (or, with
``eval.shard_videos`` V > 1, decodes same-bucket groups of V videos in one
call), fills the ``RecallMeter`` and prints the Rank@k / IoU@t table and the
mean losses. In a process group (``eval.shard_processes``) each rank
evaluates its rank-strided share of the videos and the counts and loss sums
are summed over the ranks, so every rank ends with the global table.
With ``eval.shard_time`` S equal to the group's world size (sequence
parallelism, the JAX ``time`` mesh) every rank loads every video instead,
the model runs on this rank's block of each video's time axis
(:mod:`parallel.seq`), each level's outputs are gathered, and the decode,
SoftNMS and table run on every rank as in one process; the lead writes.
"""

from __future__ import annotations

import itertools
import os
import time

import numpy as np
import torch

from ..core import (CfgNode, get_cfg_defaults, update_eval_data, update_from,
                    update_opt)
from ..data import DataLoader, batchify_eval, make_dataset, min_chunk_size
from ..models import (check_time_sharding, load_params, load_pth, make_model,
                      require_two_heads)
from ..models.points import fpn_lengths, generate_points, select_points
from .. import parallel
from ..parallel import seq
from ..ops.masked import max_pool1d
from ..ops.nms import batched_nms_device, batched_nms_host
from ..train.annotate import annotate_points
from ..train.losses import calc_focal_loss, calc_iou_loss
from ..utils import analysis   # a module: utils.analysis imports eval.metrics
from ..utils.logging import Logger, easy_reduce, time_str
from ..utils.profiling import SETUP, PhaseTimer, is_count, stage
from .metrics import RecallMeter


def resolve_device(device=None):
    """``None`` means the CUDA card (this process's ``cuda:LOCAL_RANK`` in a
    process group) and raises where there is none; the CPU is used only
    when asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the port runs on a CUDA device by default and "
                               "none is available; pass device='cpu' to run "
                               "on the CPU")
        device = parallel.local_device() if parallel.initialized() else "cuda"
    return torch.device(device)


def checkpoint_path(logdir, ckpt):
    """``<logdir>/models/<ckpt>.pth``, the reference-layout checkpoint the
    port reads; raises naming both candidates when it is missing (the JAX
    trainer also writes a ``.msgpack``, which waits for the port's
    trainer)."""
    pth = os.path.join(logdir, "models", f"{ckpt}.pth")
    if not os.path.exists(pth):
        msg = os.path.join(logdir, "models", f"{ckpt}.msgpack")
        raise FileNotFoundError(
            f"no checkpoint at {pth}" + (
                f" ({msg} exists, but the port reads .pth files only)"
                if os.path.exists(msg) else f" or {msg}"))
    return pth


def modulated_level_scores(fpn_logits, fpn_masks, ext_scores):
    """Per-level sigmoid scores, optionally multiplied by external scores
    (Q, T_level0) that are max-pool-downsampled (k3, s2, p1) level to level,
    then masked."""
    scores_list = []
    ext = ext_scores
    for lvl, logits in enumerate(fpn_logits):
        s = torch.sigmoid(logits)
        if ext is not None:
            s = s * ext
            ext = max_pool1d(ext[:, None, :], 3, 2, 1)[:, 0]
        scores_list.append(s * fpn_masks[lvl].to(s.dtype))
    return scores_list


class Decoder:
    """Shape-bucketed decode of one model on one device.

    ``cfg`` is a full config tree; ``model`` a
    :class:`~decafnet_tpu_torch.models.DeCafNetIterative` on ``device``.
    ``cfg.eval.reference_exact`` selects the host SoftNMS.
    ``decode_calls`` counts model forwards (one per decoded group);
    ``timer`` records the spans and counters of the module docstring. With a
    time ``shard`` (:class:`parallel.TimeShard`) the forward runs on this
    rank's block of the video and its outputs are gathered before the
    decode."""

    def __init__(self, cfg, model, device, shard=None):
        self.cfg, self.model, self.device = cfg, model, torch.device(device)
        self.shard = shard
        self.all_points = generate_points(
            cfg.model.vid_net.max_seq_len * 10, cfg.pt_gen.num_fpn_levels,
            cfg.pt_gen.regression_range, cfg.pt_gen.sigma)
        self.vid_stride = cfg.model.vid_stride
        self.chunk = min_chunk_size(cfg.model.num_fpn_levels,
                                    cfg.model.mha_win_size)
        self.base_len = cfg.data.max_vid_len
        if self.base_len % (self.chunk * self.vid_stride):
            raise ValueError(f"max video length must be a multiple of "
                             f"{self.chunk * self.vid_stride}")
        self.pre_nms_topk = cfg.eval.pre_nms_topk
        self.pre_nms_thresh = cfg.eval.pre_nms_thresh
        self.seg_len_thresh = cfg.eval.seg_len_thresh
        self.query_cap = cfg.eval.get("max_num_queries", 32)
        self.reference_exact = bool(cfg.eval.get("reference_exact", False))
        tn = cfg.model.text_net
        self.text_len_cap = tn.max_seq_len if tn.get("use_abs_pe") else None
        self.nms_cfg = dict(cfg.nms)
        self.loss_cfg = (cfg.loss.fc_a, cfg.loss.fc_s,
                         cfg.train.center_sampling,
                         cfg.train.center_sampling_radius)
        self.timer = PhaseTimer()
        self.time_dict = self.timer.buckets
        self._points = {}
        self._shapes = set()    # decode shapes called at least once
        self.decode_calls = 0

    def points(self, T):
        """(4, P) candidate points of bucket length T on the device."""
        if T not in self._points:
            lens = fpn_lengths(T // self.vid_stride, self.cfg.model.num_fpn_levels)
            pts = np.concatenate(select_points(self.all_points, lens))
            self._points[T] = torch.from_numpy(
                np.ascontiguousarray(pts.T)).to(self.device)
        return self._points[T]

    def video_items(self, sample):
        """Split one video into per-chunk work items; where the sample has
        ground truth, each item holds its rows' targets in grid units
        (padding rows get [0, 1])."""
        with self.timer.phase("prepare"):
            meta, chunks = batchify_eval(
                sample, self.chunk, self.base_len, self.vid_stride,
                self.query_cap, text_len_cap=self.text_len_cap)
        items, q_done = [], 0
        tgt = meta.get("target")
        for chunk in chunks:
            n_q = int(chunk["q_valid"].sum())
            item = {"meta": meta, "chunk": chunk, "n_q": n_q, "q_start": q_done}
            if tgt is not None:
                targets = np.tile(np.array([[0.0, 1.0]], np.float32),
                                  (chunk["text"].shape[0], 1))
                targets[:n_q] = (np.asarray(tgt[q_done:q_done + n_q], np.float32)
                                 / self.vid_stride)
                item["targets"] = targets
            items.append(item)
            q_done += n_q
        return meta, items

    @staticmethod
    def bucket_key(item):
        c = item["chunk"]
        return (c["vid"].shape[-1], c["text"].shape[0], c["text"].shape[-1],
                c["ext_scores"] is not None)

    @torch.inference_mode()
    def decode(self, vid, shallow, vid_masks, text, text_cls, text_masks,
               ext_scores, pe_interp, Q, targets=None):
        """One forward + decode over V videos x Q rows (device tensors).

        Returns a dict of (V*Q, ...) device tensors in grid units: device
        NMS gives ``segments`` (R, k, 2), ``scores`` (R, k) and ``counts``
        (R,); ``reference_exact`` gives the candidates ``left``, ``right``,
        ``scores`` and ``valid``, each (R, P). With ``targets`` (R, 2) it
        adds the per-row ``cls_loss`` and ``reg_loss`` (R,)."""
        self.decode_calls += 1
        logits2, offsets, masks = self.level_outputs(
            vid, shallow, vid_masks, text, text_cls, text_masks, pe_interp, Q)
        with stage("decode.select_nms"):
            scores = torch.cat(
                modulated_level_scores(logits2, masks, ext_scores), 1)
            offs = torch.cat(offsets, dim=2)                   # (R, 2, P)
            pmask = torch.cat(masks, dim=1)                    # (R, P)
            points_t = self.points(vid.shape[-1])

            # top-k as a per-query threshold at the k-th largest value: the
            # same candidate set as the JAX decode, ties included
            valid = (scores > self.pre_nms_thresh) & pmask
            ranked = torch.where(valid, scores, torch.full_like(scores, -1.0))
            topk = min(self.pre_nms_topk, scores.shape[1])
            kth = torch.topk(ranked, topk, dim=1).values[:, -1:]
            valid = valid & (scores >= kth)

            ctr, stride = points_t[0][None], points_t[3][None]
            left = ctr - offs[:, 0, :] * stride
            right = ctr + offs[:, 1, :] * stride
            top_valid = valid & ((right - left) > self.seg_len_thresh)
            top_scores = torch.where(top_valid, scores,
                                     torch.zeros_like(scores))

            if self.reference_exact:
                out = {"left": left, "right": right, "scores": top_scores,
                       "valid": top_valid}
            else:
                nc = self.nms_cfg
                segs, det_scores, counts = batched_nms_device(
                    left, right, top_scores, top_valid, nc["max_num_segs"],
                    mode=nc["mode"], iou_thresh=nc["iou_thresh"],
                    min_score=nc["min_score"], sigma=nc["sigma"],
                    voting_thresh=nc["voting_thresh"])
                out = {"segments": segs, "scores": det_scores,
                       "counts": counts}

        if targets is not None:
            # per-query eval-loss diagnostics
            fc_a, fc_s, cs, csr = self.loss_cfg
            gt_labels, gt_offsets = annotate_points(
                points_t, targets, center_sampling=cs,
                center_sampling_radius=csr)
            pos = gt_labels & pmask
            norm = torch.clamp_min(pos.sum(dim=1).float(), 1.0)
            out["cls_loss"] = calc_focal_loss(
                torch.cat(logits2, dim=1), gt_labels, pmask, smoothing=fc_s,
                alpha=fc_a) / norm
            out["reg_loss"] = calc_iou_loss(offs, gt_offsets, pos,
                                            reg_loss="iou") / norm
        return out

    def level_outputs(self, vid, shallow, vid_masks, text, text_cls,
                      text_masks, pe_interp, Q):
        """The model's per-level (cls_head2 logits, offsets, masks), what
        the decode and the eval losses read, over the whole video.
        Time-sharded, the model runs on this rank's block of the video
        tensors (``pe_interp`` stays global) and every rank gathers the
        levels' outputs in one collective."""
        if self.shard is None:
            return self.model(vid, shallow, vid_masks, text, text_cls,
                              text_masks, pe_interp=pe_interp,
                              queries_per_video=Q)[1:]
        check_time_sharding(self.cfg, vid.shape[-1], self.shard.size)
        vid, shallow, vid_masks = (self.shard.shard(a)
                                   for a in (vid, shallow, vid_masks))
        with seq.sharding(self.shard):
            outs = self.model(vid, shallow, vid_masks, text, text_cls,
                              text_masks, pe_interp=pe_interp,
                              queries_per_video=Q)[1:]
        flat = self.shard.gather(*[x for level in outs for x in level])
        L = len(outs[0])
        return [list(flat[i * L:(i + 1) * L]) for i in range(3)]

    def decode_group(self, items, losses=False):
        """Decode V same-bucket items (V videos x Q query rows) in one call.
        Returns one (results, losses) pair per item: per-query detections
        in seconds, and per-query {cls_loss, reg_loss} when ``losses`` (an
        empty list otherwise). A shape's first call also goes into the
        set-up record as ``setup.first_call``, less the kernel library's
        load when the call loads it."""
        shape = (len(items),) + self.bucket_key(items[0])
        if shape in self._shapes:
            return self._decode_group(items, losses)
        library_s = SETUP.total("setup.library")
        t0 = time.perf_counter()
        out = self._decode_group(items, losses)
        SETUP.add("setup.first_call", time.perf_counter() - t0
                  - (SETUP.total("setup.library") - library_s))
        self._shapes.add(shape)
        return out

    def _decode_group(self, items, losses):
        Q = items[0]["chunk"]["text"].shape[0]
        timer = self.timer
        with timer.recording(call=self.decode_calls + 1):
            with timer.phase("forward"):
                with timer.phase("decode.stage"):
                    host = self._stage(items, Q, losses)
                timer.add("decode.h2d_bytes",
                          sum(a.nbytes for a in host.values()))
                timer.add("decode.rows", len(items) * Q)
                timer.add("decode.real_rows", sum(it["n_q"] for it in items))
                with timer.phase("decode.h2d"):
                    dev = {k: torch.from_numpy(a).to(self.device)
                           for k, a in host.items()}
                    pe_interp = None
                    if "pe_interp0" in dev:
                        pe_interp = [dev["pe_interp0"].long(),
                                     dev["pe_interp1"].long(),
                                     dev["pe_interp2"]]
                with timer.phase("decode.dispatch"):
                    out = self.decode(
                        dev["vid"], dev["shallow_vid"], dev["vid_masks"],
                        dev["text"], dev["text_cls"], dev["text_masks"],
                        dev.get("ext_scores"), pe_interp, Q,
                        targets=dev.get("targets"))
                with timer.phase("decode.d2h"):
                    # bf16 scores (reference_exact in the bf16 mode) reach
                    # numpy as f32
                    out = {k: (v.float() if v.is_floating_point() else v)
                           .cpu().numpy() for k, v in out.items()}
            timer.stream_times()
            return self._post_process(items, Q, out, losses)

    def _stage(self, items, Q, losses):
        """The host arrays the call sends, by name, in the order sent: the
        three ``pe_interp`` plans (when the model has them; per-row plans
        (V, t) repeated to (V*Q, t)), the ``targets`` (with ``losses``),
        then the chunks' arrays, each joined over the items (ext_scores
        when present)."""
        c0 = items[0]["chunk"]
        out = {}
        if c0["pe_interp"] is not None:
            for j in range(3):
                out[f"pe_interp{j}"] = (
                    c0["pe_interp"][j] if len(items) == 1 else np.repeat(
                        np.stack([it["chunk"]["pe_interp"][j]
                                  for it in items]), Q, axis=0))
        if losses:
            out["targets"] = np.concatenate([it["targets"] for it in items])
        keys = ("vid", "shallow_vid", "vid_masks", "text", "text_cls",
                "text_masks") + (("ext_scores",)
                                 if c0["ext_scores"] is not None else ())
        for k in keys:
            out[k] = np.concatenate([it["chunk"][k] for it in items], axis=0)
        return out

    def _post_process(self, items, Q, out, losses):
        """Per item, its queries' detections in seconds and their losses:
        "nms", the host SoftNMS proper (``reference_exact``; device NMS
        already ran inside "forward"), then "post_process", the host-side
        slicing and grid -> seconds."""
        nc = self.nms_cfg
        rows = [range(v * Q, v * Q + item["n_q"])
                for v, item in enumerate(items)]
        dets = {}
        if self.reference_exact:
            with self.timer.phase("nms"):
                for r in itertools.chain(*rows):
                    m = out["valid"][r]
                    dets[r] = batched_nms_host(
                        np.stack([out["left"][r][m], out["right"][r][m]], -1),
                        out["scores"][r][m], iou_thresh=nc["iou_thresh"],
                        min_score=nc["min_score"],
                        max_num_segs=nc["max_num_segs"], mode=nc["mode"],
                        sigma=nc["sigma"], voting_thresh=nc["voting_thresh"])
        per_item = []
        with self.timer.phase("post_process"):
            for item, rs in zip(items, rows):
                results = []
                for r in rs:
                    if self.reference_exact:
                        segs, scores = dets[r]
                    else:
                        c = int(out["counts"][r])
                        segs = out["segments"][r][:c]
                        scores = out["scores"][r][:c]
                    results.append(self.to_seconds(segs, scores, item["meta"]))
                row_losses = [{"cls_loss": float(out["cls_loss"][r]),
                               "reg_loss": float(out["reg_loss"][r])}
                              for r in rs] if losses else []
                per_item.append((results, row_losses))
        return per_item

    def to_seconds(self, segs, scores, meta):
        """Grid units -> seconds, clipped to the video's duration."""
        segs = np.asarray(segs, np.float32).reshape(-1, 2)
        if len(segs):
            segs = segs * self.vid_stride
            segs = (segs * meta["clip_stride"] + 0.5 * meta["clip_size"]) \
                / meta["fps"]
            segs = np.clip(segs, 0, meta["duration"])
        return {"segments": segs, "scores": np.asarray(scores).reshape(-1)}


def check_supported(cfg, train_time=False):
    """Raise for eval settings the port does not have yet, naming the
    ROADMAP item, instead of running something else; and for the
    combinations the JAX Evaluator refuses. The trainer's evaluator
    (``train_time``) never shards the time axis."""
    ev, world = cfg.eval, parallel.world_size()
    V = int(ev.get("shard_videos") or 1)
    S = 1 if train_time else int(ev.get("shard_time") or 1)
    if V > 1 and S > 1:
        raise ValueError("eval.shard_videos and eval.shard_time are exclusive")
    if S > 1:
        check_time_sharding(cfg, cfg.data.max_vid_len, S)
        if S != world:
            raise ValueError(
                f"eval.shard_time={S} shards each video's time axis over the "
                f"ranks of the process group, which has {world}: launch "
                f"{S} ranks with torchrun (or set eval.shard_time {world})")
    if V > 1 and world > 1:
        raise ValueError(
            f"eval.shard_videos={V} stacks videos within one process; in a "
            f"multi-process group use eval.shard_processes (per-process "
            f"video shards) instead")


class Evaluator:
    """Dataset-driven evaluation of one model on one device.

    ``cfg``: a full config tree (see :func:`config_from_logdir`); the
    ``eval.data`` tree names the dataset. Weights come from ``params`` (a
    flax-layout tree of numpy arrays) or else from
    ``<aux.logdir>/models/<aux.ckpt>.pth`` (its ``model_ema``); with
    ``train_time`` (the trainer's evaluator) from the ``ema`` handed to
    each :meth:`run` instead, and the log goes to stdout until the trainer
    sets one. ``device``: None for the CUDA card (raises without one), or
    explicit. ``video_ms`` holds each video's wall time of the last
    :meth:`run` (from its load to its last decoded query chunk), and
    ``loss_means`` its mean eval losses (over every rank's queries).

    In a process group of W > 1 ranks with ``eval.shard_processes`` (the
    default), rank r loads and evaluates videos r, r + W, ... and
    :meth:`run` sums the counts and losses over the ranks; only the lead
    writes the log. With ``eval.shard_time`` W every rank evaluates every
    video instead, one time block of it each (``shard``), and ends with the
    whole table. The trainer's evaluator (``train_time``) runs on the lead
    alone and never shards."""

    def __init__(self, cfg, params=None, device=None, train_time=False):
        require_two_heads(cfg, "Evaluator")
        check_supported(cfg, train_time)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dataset = make_dataset(cfg, is_training=False)
        self.shard = (seq.TimeShard() if not train_time
                      and int(cfg.eval.get("shard_time") or 1) > 1 else None)
        # the rank shard is taken before any feature IO: the loader reads
        # only this rank's videos
        self.shard_proc = (parallel.world_size() > 1 and not train_time
                           and self.shard is None
                           and bool(cfg.eval.get("shard_processes", True)))
        self.proc_rank, self.proc_world = ((parallel.rank(), parallel.world_size())
                                           if self.shard_proc else (0, 1))
        self.loader = DataLoader(self.dataset, batch_size=1, shuffle=False,
                                 drop_last=False, rank=self.proc_rank,
                                 world_size=self.proc_world,
                                 num_threads=cfg.train.num_workers)

        # the JAX Evaluator resolves the compute dtype per shape bucket and
        # keeps one model per dtype (_model_for_bucket); with its length gate
        # off the resolution is the same for every bucket, and a port model's
        # weights are the same in every dtype, so one model serves
        model = make_model(cfg)
        if params is not None:
            load_params(model, params)
        elif not train_time:
            load_pth(model, checkpoint_path(cfg.aux.logdir,
                                            cfg.aux.get("ckpt", "last")))
        self.model = model.to(self.device).eval()
        self.decoder = Decoder(cfg, self.model, self.device, self.shard)
        self.meter = RecallMeter(tuple(cfg.eval.ranks), cfg.eval.iou_threshs)

        self.tag = cfg.aux.get("ckpt", "eval")
        root = cfg.aux.logdir
        self.is_lead = parallel.is_lead()
        if root and not train_time and self.is_lead:
            os.makedirs(root, exist_ok=True)
            self.logger = Logger(os.path.join(root, f"eval_{self.tag}.txt"))
        else:
            self.logger = Logger(quiet=not self.is_lead)
        self.video_ms = []

    def _decode_videos(self, V, loss_list, dump):
        """Stream work items into same-bucket groups of V videos; decode a
        group when full (padding the final partial groups with inert
        ``n_q = 0`` copies) and finish each video once all its query chunks
        have returned (the JAX ``_run_sharded`` on a mesh of one device).
        At V = 1 every item is decoded alone as it comes, and the videos
        finish in the loader's order. Each video's wall time, from its load
        to its last returned chunk, goes to ``video_ms``."""
        pending = {}       # bucket key -> items
        states = {}        # clip_id -> assembly state

        def flush(key):
            items = pending.pop(key)
            real = len(items)
            while len(items) < V:   # inert pad: n_q = 0 rows are ignored
                items.append({**items[0], "n_q": 0})
            decoded = self.decoder.decode_group(items, losses=True)
            for item, (r, l) in zip(items[:real], decoded[:real]):
                st = states[item["meta"]["clip_id"]]
                qs = item["q_start"]
                st["results"][qs:qs + item["n_q"]] = r
                st["losses"][qs:qs + item["n_q"]] = l
                st["done"] += item["n_q"]
                if st["done"] == st["total"]:
                    self._finish_video(st["meta"], st["results"],
                                       st["losses"], loss_list, dump)
                    self.video_ms.append(
                        1e3 * (time.perf_counter() - st["t0"]))
                    del states[item["meta"]["clip_id"]]

        for samples in self.loader:
            t0 = time.perf_counter()
            meta, items = self.decoder.video_items(samples[0])
            n = meta["num_queries"]
            states[meta["clip_id"]] = {"meta": meta, "total": n, "done": 0,
                                       "t0": t0,
                                       "results": [None] * n,
                                       "losses": [None] * n}
            for item in items:
                key = self.decoder.bucket_key(item)
                pending.setdefault(key, []).append(item)
                if len(pending[key]) == V:
                    flush(key)
            if self.cfg.aux.dryrun:
                break
        for key in list(pending):
            flush(key)
        if states:
            raise RuntimeError(f"unfinished videos: {list(states)}")

    def _allreduce_eval(self, loss_list):
        """The global table from every rank's shard: the RecallMeter
        counts, the text count and the per-key loss sums and counts travel
        as one float64 vector summed over the ranks, so every rank ends with
        the same global metrics. Returns a one-dict loss list whose means
        are the global means."""
        keys = ("cls_loss", "reg_loss")
        sums, cnts = np.zeros(len(keys)), np.zeros(len(keys))
        for d in loss_list:
            for i, k in enumerate(keys):
                v = d.get(k, np.nan)
                if np.isfinite(v):
                    sums[i] += v
                    cnts[i] += 1
        payload = np.concatenate([self.meter.counts.ravel().astype(np.float64),
                                  [float(self.meter.text_cnt)], sums, cnts])
        # under NCCL the vector travels on this rank's card, under gloo on
        # the CPU
        device = self.device if parallel.backend() == "nccl" else "cpu"
        total = parallel.all_reduce_sum(torch.tensor(
            payload, dtype=torch.float64, device=device)).cpu().numpy()
        nc = self.meter.counts.size
        self.meter.counts = total[:nc].reshape(self.meter.counts.shape)
        self.meter.text_cnt = int(round(total[nc]))
        g_sums, g_cnts = total[nc + 1:nc + 1 + len(keys)], total[nc + 1 + len(keys):]
        return [{k: (g_sums[i] / g_cnts[i] if g_cnts[i] else float("nan"))
                 for i, k in enumerate(keys)}]

    def _finish_video(self, meta, results, losses, loss_list, dump):
        targets_sec = np.asarray(meta["segment"], np.float64)
        if len(results) != len(targets_sec):
            raise RuntimeError(f"video {meta['clip_id']}: {len(results)} "
                               f"results for {len(targets_sec)} queries")
        for result, target in zip(results, targets_sec):
            self.meter.update(result["segments"], result["scores"], target)
        loss_list.extend(losses)
        if dump is not None:
            dump.add_video(meta["clip_id"], targets_sec, results, losses)

    def run(self, ema=None, tag=None):
        """Evaluate every video (the first only under ``aux.dryrun``; this
        rank's share in a process group); returns the (ranks,
        iou_threshs) recall matrix. ``ema`` (a state dict or a module, e.g.
        the trainer's EMA model) is copied into the evaluated model first;
        ``tag`` names the results dump (``results_<tag>.pk``, with a
        ``.r<rank>`` suffix for a rank's shard)."""
        if ema is not None:
            self.model.load_state_dict(
                ema.state_dict() if isinstance(ema, torch.nn.Module) else ema)
        if tag is not None:
            self.tag = tag
        self.meter.reset()
        self.decoder.timer.reset()
        self.video_ms = []
        self.logger.write("Evaluation started.")
        start = time.time()
        loss_list = []
        dump = analysis.EvalResults(self.tag) if self.cfg.eval.get("save_results") else None

        self._decode_videos(max(int(self.cfg.eval.get("shard_videos") or 1), 1),
                            loss_list, dump)
        if dump is not None and self.cfg.aux.logdir and (self.shard_proc
                                                        or self.is_lead):
            name = f"results_{self.tag}.pk"
            if self.shard_proc:   # this rank's shard of the detections
                name += f".r{self.proc_rank}"
            dump.save(os.path.join(self.cfg.aux.logdir, name))

        if self.shard_proc:
            loss_list = self._allreduce_eval(loss_list)
        metrics, table = self.meter.table()
        log_str = "\nFinal:\n" + table + "\n-----\n"
        self.loss_means = {}
        if loss_list:
            self.loss_means = easy_reduce(loss_list, "mean", skip_nan=True)
            log_str += "; ".join(f"{k}: {v:.3f}"
                                 for k, v in self.loss_means.items())
        self.logger.write(log_str)
        phase_summary = " | ".join(
            f"{k}: {sum(v)} (n={len(v)})" if is_count(k)
            else f"{k}: {sum(v):.2f}s (n={len(v)})"
            for k, v in self.decoder.time_dict.items())
        self.logger.write(f"phase wall-times: {phase_summary}")
        self.logger.write(
            f"Evaluation completed in {time_str(time.time() - start)}.")
        return metrics


def config_from_logdir(logdir, ckpt="last", set_cfgs=None, dryrun=False):
    """The eval config of an experiment directory, as ``eval.py`` builds it:
    the frozen ``opt.yaml`` backfilled with the task's defaults, ``--set``
    overrides, the dense sidekick stream (``shallow_ds = 1``), the derived
    fields and ``eval.data``."""
    cfg = CfgNode.load_file(os.path.join(logdir, "opt.yaml"))
    cfg = update_from(cfg, get_cfg_defaults(cfg.get("task", "grounder")))
    if set_cfgs:
        cfg.merge_from_list(list(set_cfgs))
    cfg.data.shallow_ds = 1
    cfg.eval.data.shallow_ds = 1
    update_opt(cfg)
    update_eval_data(cfg)
    cfg.aux.logdir = logdir
    cfg.aux.ckpt = ckpt
    cfg.aux.dryrun = dryrun
    return cfg
