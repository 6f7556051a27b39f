"""Per-video evaluation records and their analysis (port of
decafnet_tpu/utils/analysis.py): the Evaluator dumps ``EvalResults`` with
``eval.save_results``; ``compute_iou_by_length`` buckets them;
``load_reference_checkpoint`` reads the reference's own result pickles;
``compute_iou`` and ``interpolate_array`` are the reference's helpers."""

from __future__ import annotations

import pickle

import numpy as np


class EvalResults:
    """Per-video evaluation records: detections + targets in seconds."""

    def __init__(self, tag=""):
        self.tag = tag
        self.videos = []

    def add_video(self, vid_id, targets_sec, detections, losses=None):
        """detections: list per query of {'segments': (k, 2), 'scores': (k,)}."""
        self.videos.append({
            "vid_id": vid_id,
            "targets": np.asarray(targets_sec, np.float64),
            "detections": [
                {"segments": np.asarray(d["segments"], np.float32),
                 "scores": np.asarray(d["scores"], np.float32)}
                for d in detections
            ],
            "losses": losses,
        })

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump({"tag": self.tag, "videos": self.videos}, f)

    @staticmethod
    def load(path):
        """Read a dump this class wrote (pickle: trusted files only)."""
        with open(path, "rb") as f:
            blob = pickle.load(f)
        out = EvalResults(blob.get("tag", ""))
        out.videos = blob["videos"]
        return out

    def top1_ious(self):
        """(gt_length_sec, top1_iou) pairs over all queries."""
        # imported here: the eval package imports the models, whose stage
        # spans import this package's profiling
        from ..eval.metrics import interval_iou
        pairs = []
        for v in self.videos:
            for target, det in zip(v["targets"], v["detections"]):
                segs, scores = det["segments"], det["scores"]
                if len(segs) == 0:
                    pairs.append((float(target[1] - target[0]), 0.0))
                    continue
                best = segs[int(np.argmax(scores))]
                pairs.append((
                    float(target[1] - target[0]),
                    float(interval_iou(best[None], target[None])[0])))
        return pairs


def compute_iou_by_length(results, bins=(0, 5, 10, 20, 40, np.inf)):
    """Mean top-1 IoU bucketed by ground-truth segment length in seconds.
    ``results``: an :class:`EvalResults` or the path of its dump. Returns
    {(lo, hi): (mean_iou, count)}, NaN for an empty bucket."""
    if isinstance(results, str):
        results = EvalResults.load(results)
    pairs = results.top1_ious()
    out = {}
    for lo, hi in zip(bins[:-1], bins[1:]):
        vals = [iou for length, iou in pairs if lo <= length < hi]
        out[(lo, hi)] = (float(np.mean(vals)) if vals else float("nan"),
                         len(vals))
    return out


class _RefVideo:
    """Attribute bag standing in for the reference's ``Video`` while
    unpickling (pickle fills ``__dict__``; no constructor arguments)."""


class _RefCheckpoint:
    """Attribute bag standing in for the reference's ``Checkpoint``."""


class _RefUnpickler(pickle.Unpickler):
    """Unpickles reference result dumps without the reference package: its
    ``libs.helper.utils`` ``Checkpoint`` / ``Video`` classes map onto the
    attribute bags above. Every other global must be on an allowlist of the
    reconstruction callables such a pickle holds (numpy and torch tensor
    rebuilds, OrderedDict, plain containers); the dumps are untrusted, and
    pickle's default ``find_class`` would run any importable callable, so
    anything off the list raises ``pickle.UnpicklingError``."""

    _REMAP = {
        ("libs.helper.utils", "Checkpoint"): _RefCheckpoint,
        ("libs.helper.utils", "Video"): _RefVideo,
    }

    _ALLOW = {
        ("numpy", "ndarray"), ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "scalar"),
        ("torch._utils", "_rebuild_tensor"),
        ("torch._utils", "_rebuild_tensor_v2"),
        ("torch.storage", "_load_from_bytes"),
        ("collections", "OrderedDict"),
        ("builtins", "list"), ("builtins", "dict"), ("builtins", "tuple"),
        ("builtins", "set"), ("builtins", "frozenset"),
        ("builtins", "complex"), ("builtins", "bytearray"),
    }

    def find_class(self, module, name):
        cls = self._REMAP.get((module, name))
        if cls is not None:
            return cls
        if (module, name) in self._ALLOW or (
                module == "torch" and name.endswith("Storage")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"refusing to unpickle {module}.{name}: reference result "
            "pickles are untrusted content and only numpy/torch tensor "
            "reconstruction plus the Checkpoint/Video shims are allowed")


def _to_numpy(x):
    """torch tensor -> numpy; anything else through ``np.asarray``."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_reference_checkpoint(path):
    """Read a reference result pickle (a ``Checkpoint`` of per-video
    ``Video`` records: ``abs_target`` (n, 2) in seconds, ``results`` a list
    per query of {'segments': (k, 2), 'scores': (k,)}) into
    :class:`EvalResults`. Each video's other attributes (tid, loss,
    rel_target, ...) are kept under 'ref_extra'."""
    with open(path, "rb") as f:
        ckpt = _RefUnpickler(f).load()
    if not isinstance(ckpt, _RefCheckpoint):
        raise ValueError(f"{path} is not a reference Checkpoint pickle "
                         f"(got {type(ckpt).__name__})")
    out = EvalResults(tag=f"ref-ckpt-{getattr(ckpt, 'iteration', '?')}")
    core = {"vname", "abs_target", "results"}
    for vname, video in ckpt.videos.items():
        out.videos.append({
            "vid_id": vname,
            "targets": _to_numpy(video.abs_target).astype(np.float64),
            "detections": [
                {"segments": _to_numpy(r["segments"]).astype(np.float32),
                 "scores": _to_numpy(r["scores"]).astype(np.float32)}
                for r in getattr(video, "results", [])],
            "losses": getattr(video, "loss", None),
            "ref_extra": {k: v for k, v in vars(video).items()
                          if k not in core},
        })
    return out


def compute_iou(intervals1, intervals2):
    """Pairwise interval IoU of two lists of (start, end), as (s1, e1, s2,
    e2, iou) tuples in pair order. The "union" is the enclosing span
    min(starts)..max(ends), as the reference computes it."""
    out = []
    for (s1, e1) in intervals1:
        for (s2, e2) in intervals2:
            inter = max(0, min(e1, e2) - max(s1, s2))
            union = max(e1, e2) - min(s1, s2)
            out.append((s1, e1, s2, e2, inter / union if union > 0 else 0))
    return out


def interpolate_array(original_array, target_length, kind="linear"):
    """Resample a 1-D array to ``target_length`` samples at
    linspace(0, n - 1, target_length), as scipy's ``interp1d`` does for
    ``kind`` 'linear' or 'nearest' (which rounds a half down)."""
    x = np.asarray(original_array, np.float64)
    n = len(x)
    pos = np.linspace(0, n - 1, target_length)
    if kind == "nearest":
        idx = np.clip(np.ceil(pos - 0.5).astype(np.int64), 0, n - 1)
        return x[idx]
    if kind != "linear":
        raise ValueError(f"unsupported interpolation kind: {kind}")
    return np.interp(pos, np.arange(n), x)
