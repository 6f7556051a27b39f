"""1D segment (Soft)NMS with segment voting (port of decafnet_tpu/ops/nms.py).

Two paths, as in the JAX package:

  * **Device** (the default decode): the decode only consumes the top
    ``max_num_segs`` detections, and SoftNMS emits them in non-increasing
    decayed-score order, so ``k`` selection steps over the padded (Q, N)
    candidate arrays suffice. Plain torch, batched over queries; ties in the
    selection go to the first index, as ``jnp.argmax``.
  * **Host** (``eval.reference_exact``): the full reference algorithm in C++
    (``csrc/nms1d.cpp``, C ABI). At first use it is built with ``g++ -O3
    -shared -fPIC`` into ``build/host/<source hash>/libnms1d.so`` at the root
    of the checkout and loaded with ``ctypes``; a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NMS_SOURCE = os.path.join(_PKG, "csrc", "nms1d.cpp")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


# ---------------------------------------------------------------------------
# Host library (g++, ctypes)
# ---------------------------------------------------------------------------


def host_library_path():
    """Where the host NMS library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(NMS_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(HOST_BUILD_DIR, h.hexdigest()[:16], "libnms1d.so")


def build_host():
    """Compile the host NMS library if this source hash has none yet.
    Returns (library path, seconds spent compiling; 0.0 when cached)."""
    path = host_library_path()
    if os.path.exists(path):
        return path, 0.0
    t0 = time.perf_counter()
    out_dir = os.path.dirname(path)
    os.makedirs(out_dir, exist_ok=True)
    # build beside the target and rename: concurrent processes never load a
    # half-written library
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = os.path.join(tmp, "libnms1d.so")
        out = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp_lib, NMS_SOURCE],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed to build {NMS_SOURCE}:\n"
                               f"{out.stdout}{out.stderr}")
        os.replace(tmp_lib, path)
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=1)
def host_library():
    """The loaded host NMS library (built on first call)."""
    lib = ctypes.CDLL(build_host()[0])
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.nms1d.restype = ctypes.c_int64
    lib.nms1d.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float, i64p]
    lib.softnms1d.restype = ctypes.c_int64
    lib.softnms1d.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_float,
                              ctypes.c_float, f32p, i64p]
    return lib


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _host_inputs(segs, scores):
    segs = np.ascontiguousarray(segs, np.float32).reshape(-1, 2)
    scores = np.ascontiguousarray(scores, np.float32).reshape(-1)
    if len(segs) != len(scores):
        raise ValueError(f"{len(segs)} segments but {len(scores)} scores")
    return segs, scores


def nms_host(segs, scores, iou_thresh):
    """Greedy hard NMS on the host. Returns kept indices (desc. score)."""
    segs, scores = _host_inputs(segs, scores)
    n = len(segs)
    out = np.empty(n, np.int64)
    kept = host_library().nms1d(_f32p(segs), _f32p(scores), n,
                                ctypes.c_float(iou_thresh), _i64p(out))
    return out[:kept]


def softnms_host(segs, scores, sigma, min_score):
    """Full SoftNMS with the Gaussian decay exp(-iou^2 / sigma) on the host.
    Returns (dets (m, 3), surviving indices)."""
    segs, scores = _host_inputs(segs, scores)
    n = len(segs)
    dets = np.zeros((n, 3), np.float32)
    idx = np.empty(n, np.int64)
    m = host_library().softnms1d(
        _f32p(segs), _f32p(scores), n, ctypes.c_float(sigma),
        ctypes.c_float(min_score), _f32p(dets), _i64p(idx))
    return dets[:m], idx[:m]


def segment_voting_host(nms_segs, all_segs, all_scores, iou_thresh):
    """Segment voting in numpy: each kept segment becomes the score-weighted
    average of the candidates overlapping it at IoU >= iou_thresh."""
    n1, n2 = nms_segs[:, 0], nms_segs[:, 1]
    a1, a2 = all_segs[:, 0], all_segs[:, 1]
    left = np.maximum(n1[:, None], a1[None, :])
    right = np.minimum(n2[:, None], a2[None, :])
    overlap = np.clip(right - left, 0.0, None)
    union = (n2 - n1)[:, None] + (a2 - a1)[None, :] - overlap
    iou = overlap / np.maximum(union, 1e-12)
    weights = (iou >= iou_thresh).astype(np.float32) * all_scores[None, :]
    denom = np.sum(weights, axis=1, keepdims=True)
    weights = weights / np.maximum(denom, 1e-12)
    return np.stack([weights @ a1, weights @ a2], axis=-1)


def batched_nms_host(segs, scores, iou_thresh, min_score, max_num_segs,
                     mode="soft_nms", sigma=0.5, voting_thresh=0.75):
    """Reference-exact host decode of one query: (n, 2) segments and (n,)
    scores in, at most ``max_num_segs`` (segments, scores) out by score."""
    segs = np.asarray(segs, np.float32)
    scores = np.asarray(scores, np.float32)
    if len(segs) == 0:
        return np.zeros((0, 2), np.float32), np.zeros((0,), np.float32)

    if mode == "nms":
        if min_score > 0:
            keep = scores > min_score
            segs_f, scores_f = segs[keep], scores[keep]
        else:
            segs_f, scores_f = segs, scores
        idx = nms_host(segs_f, scores_f, iou_thresh)
        idx = idx[:max_num_segs] if max_num_segs > 0 else idx
        nms_segs, nms_scores = segs_f[idx], scores_f[idx]
    elif mode == "soft_nms":
        dets, idx = softnms_host(segs, scores, sigma, min_score)
        m = len(idx)
        if max_num_segs > 0:
            m = min(m, max_num_segs)
        nms_segs, nms_scores = dets[:m, :2], dets[:m, 2]
    else:
        raise NotImplementedError(f"invalid NMS mode: {mode}")

    if voting_thresh > 0 and len(nms_segs) > 0:
        nms_segs = segment_voting_host(np.asarray(nms_segs, np.float32),
                                       segs, scores, voting_thresh)

    order = np.argsort(-nms_scores, kind="stable")
    m = min(max_num_segs, len(nms_segs))
    return nms_segs[order[:m]], nms_scores[order[:m]]


# ---------------------------------------------------------------------------
# Device (torch)
# ---------------------------------------------------------------------------


def _pairwise_iou_1d(a1, a2, x1, x2):
    """IoU of (Q, 1) segments against (Q, N) segments with the +1e-6 area
    epsilon of the reference NMS."""
    area_a = a2 - a1 + 1e-6
    areas = x2 - x1 + 1e-6
    inter = torch.clamp_min(torch.minimum(a2, x2) - torch.maximum(a1, x1), 0.0)
    return inter / (area_a + areas - inter)


def soft_nms_topk(x1, x2, scores, valid, k, sigma=0.9, min_score=0.001):
    """Top-k SoftNMS with the Gaussian decay exp(-iou^2 / sigma) (the
    reference's method 2, the one the configs use) over (Q, N) candidates
    (padding rows: valid False). Returns dets (Q, k, 3) rows (x1, x2, decayed score) in selection order,
    zero past the surviving count, and counts (Q,) int32."""
    Q, N = x1.shape
    neg = torch.tensor(-float("inf"), device=x1.device)
    sc = torch.where(valid, scores.float(), neg)
    active = valid.clone()
    idx = torch.arange(N, device=x1.device)[None, :]
    dets = torch.zeros((Q, k, 3), dtype=torch.float32, device=x1.device)
    count = torch.zeros((Q,), dtype=torch.int32, device=x1.device)
    for i in range(k):
        cur = torch.where(active, sc, neg)
        m = torch.argmax(cur, dim=1, keepdim=True)           # first maximum
        best = torch.gather(cur, 1, m)
        has = best > neg                                      # (Q, 1)
        b1, b2 = torch.gather(x1, 1, m), torch.gather(x2, 1, m)
        row = torch.cat([b1, b2, best], dim=1)
        dets[:, i] = torch.where(has, row, torch.zeros_like(row))
        count += has[:, 0].to(torch.int32)
        iou = _pairwise_iou_1d(b1, b2, x1, x2)
        w = torch.exp(-(iou * iou) / sigma)
        others = active & (idx != m)
        sc = torch.where(others, sc * w, sc)
        active = others & (sc >= min_score) & has
    return dets, count


def hard_nms_topk(x1, x2, scores, valid, k, iou_thresh=0.1):
    """Top-k greedy hard NMS; same contract as :func:`soft_nms_topk`."""
    Q, N = x1.shape
    neg = torch.tensor(-float("inf"), device=x1.device)
    sc = torch.where(valid, scores.float(), neg)
    idx = torch.arange(N, device=x1.device)[None, :]
    dets = torch.zeros((Q, k, 3), dtype=torch.float32, device=x1.device)
    count = torch.zeros((Q,), dtype=torch.int32, device=x1.device)
    for i in range(k):
        m = torch.argmax(sc, dim=1, keepdim=True)
        best = torch.gather(sc, 1, m)
        has = best > neg
        b1, b2 = torch.gather(x1, 1, m), torch.gather(x2, 1, m)
        row = torch.cat([b1, b2, best], dim=1)
        dets[:, i] = torch.where(has, row, torch.zeros_like(row))
        count += has[:, 0].to(torch.int32)
        iou = _pairwise_iou_1d(b1, b2, x1, x2)
        sc = torch.where((iou >= iou_thresh) | (idx == m), neg, sc)
    return dets, count


def segment_voting_xy(n1, n2, a1, a2, all_scores, iou_thresh, all_valid=None):
    """Refine (Q, K) kept segments n1/n2 as the score-weighted average of
    the (Q, N) candidates a1/a2 overlapping them at IoU >= iou_thresh.
    Returns (voted_x1, voted_x2), each (Q, K)."""
    left = torch.maximum(n1[:, :, None], a1[:, None, :])
    right = torch.minimum(n2[:, :, None], a2[:, None, :])
    overlap = torch.clamp_min(right - left, 0.0)
    union = (n2 - n1)[:, :, None] + (a2 - a1)[:, None, :] - overlap
    iou = overlap / torch.clamp_min(union, 1e-12)
    weights = (iou >= iou_thresh).float() * all_scores[:, None, :]
    if all_valid is not None:
        weights = weights * all_valid[:, None, :].float()
    denom = torch.sum(weights, dim=2, keepdim=True)
    weights = weights / torch.clamp_min(denom, 1e-12)
    return (torch.bmm(weights, a1[:, :, None])[..., 0],
            torch.bmm(weights, a2[:, :, None])[..., 0])


def batched_nms_device(x1, x2, scores, valid, k, mode="soft_nms",
                       iou_thresh=0.1, min_score=0.001, sigma=0.9,
                       voting_thresh=0.75):
    """Decode-side NMS for a batch of queries: x1, x2, scores (Q, N) f32,
    valid (Q, N) bool. Returns (Q, k, 2) refined segments, (Q, k) scores and
    (Q,) counts."""
    x1, x2, scores = x1.float(), x2.float(), scores.float()
    if mode == "soft_nms":
        dets, count = soft_nms_topk(x1, x2, scores, valid, k, sigma=sigma,
                                    min_score=min_score)
    elif mode == "nms":
        # the reference's hard-NMS path pre-filters by min_score
        va = valid & (scores > min_score) if min_score > 0 else valid
        dets, count = hard_nms_topk(x1, x2, scores, va, k,
                                    iou_thresh=iou_thresh)
    else:
        raise NotImplementedError(f"invalid NMS mode: {mode}")
    out_scores = dets[:, :, 2]
    o1, o2 = dets[:, :, 0], dets[:, :, 1]
    if voting_thresh > 0:
        row_valid = (torch.arange(k, device=x1.device)[None, :]
                     < count[:, None])
        v1, v2 = segment_voting_xy(o1, o2, x1, x2, scores * valid.float(),
                                   voting_thresh, all_valid=valid)
        o1 = torch.where(row_valid, v1, torch.zeros_like(v1))
        o2 = torch.where(row_valid, v2, torch.zeros_like(v2))
    return torch.stack([o1, o2], dim=-1), out_scores, count
