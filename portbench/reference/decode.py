"""The reference's whole ``ground`` path for one request: padding, the
plain forward (``model.Reference``), the candidate decode, SoftNMS with
segment voting, and the grid-to-seconds conversion, each written out plainly
from the reference's eval procedure (``libs/worker_v2.py`` of
github.com/ZijiaLewisLu/CVPR2025-DeCafNet as its configs set it).

A request is what a client sends the service: ``vid`` (Cv, t) and
``shallow_vid`` (Cs, t) clip features, ``texts`` (Q arrays (Ct, l_q)),
``text_cls`` (Q, Cs), ``fps``, ``clip_size``, ``clip_stride``. The answer
is one dict per query: ``segments`` (n, 2) in seconds and ``scores`` (n,),
in SoftNMS emission order, and ``heads`` (see :func:`soft_nms`).
"""

from __future__ import annotations

import numpy as np
import torch

from .model import Reference

ROWS_PER_BLOCK = 8      # queries the reference's forward runs at a time
HEADS = 256             # candidates a query's first detection is held to


def padded_length(t, m):
    """The reference's eval length: the configured input length (the
    sinusoid table's). A longer video would interpolate the table to its
    own padded length, which this reference does not do."""
    vn = m["vid_net"]
    base = vn["max_seq_len"] * vn.get("stride", 1)
    if t > base:
        raise ValueError(f"a video of {t} clips is longer than the "
                         f"configured {base}: not a length this reference "
                         f"computes")
    return base


def vote(picks, left, right, scores, valid, voting_thresh):
    """Each of ``picks`` (n, 2) replaced by the score-weighted mean of the
    valid candidates overlapping it at IoU >= ``voting_thresh``."""
    if voting_thresh <= 0:
        return picks
    lo = torch.maximum(picks[:, :1], left[None])
    hi = torch.minimum(picks[:, 1:2], right[None])
    overlap = (hi - lo).clamp_min(0.0)
    union = (picks[:, 1:2] - picks[:, :1]) + (right - left)[None] - overlap
    iou = overlap / union.clamp_min(1e-12)
    w = (iou >= voting_thresh).float() * (scores * valid)[None]
    w = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)
    return torch.stack([w @ left, w @ right], dim=1)


def soft_nms(left, right, scores, valid, k, sigma, min_score, voting_thresh):
    """SoftNMS with the Gaussian decay exp(-iou^2 / sigma) over one query's
    candidates, k selections, each pick then voted (:func:`vote`). Returns
    (segments (n, 2), scores (n,)) in selection order, and the heads: the
    ``HEADS`` best valid candidates by score, (score, voted segment) rows,
    best first. Any of them the program may pick first where its rounding
    reorders candidates that nearly tie."""
    sc = torch.where(valid, scores, torch.full_like(scores, -float("inf")))
    top = torch.topk(sc, min(HEADS, len(sc)))
    best = top.indices[torch.isfinite(top.values)]
    heads = torch.cat([sc[best, None], vote(
        torch.stack([left[best], right[best]], 1), left, right, scores,
        valid, voting_thresh)], 1)
    active = valid.clone()
    picks = []
    for _ in range(k):
        cur = torch.where(active, sc, torch.full_like(sc, -float("inf")))
        i = int(torch.argmax(cur))
        if not torch.isfinite(cur[i]):
            break
        picks.append((float(left[i]), float(right[i]), float(cur[i])))
        inter = (torch.minimum(right, right[i]) - torch.maximum(left, left[i])
                 ).clamp_min(0.0)
        iou = inter / ((right[i] - left[i] + 1e-6) + (right - left + 1e-6)
                       - inter)
        others = active.clone()
        others[i] = False
        sc = torch.where(others, sc * torch.exp(-(iou * iou) / sigma), sc)
        active = others & (sc >= min_score)
    heads = heads.cpu().numpy().astype(np.float32)
    if not picks:
        return np.zeros((0, 2), np.float32), np.zeros((0,), np.float32), heads
    p = torch.tensor(picks, dtype=torch.float32, device=left.device)
    segs = vote(p[:, :2], left, right, scores, valid, voting_thresh)
    return (segs.cpu().numpy().astype(np.float32),
            p[:, 2].cpu().numpy().astype(np.float32), heads)


def decode_query(logits, offsets, masks, cfg, k):
    """One query's detections in grid units from its per-level outputs."""
    ev, nms = cfg["eval"], cfg["nms"]
    scores, left, right, pmask = [], [], [], []
    for lvl, (lg, off, mk) in enumerate(zip(logits, offsets, masks)):
        stride = 2 ** lvl
        ctr = torch.arange(lg.shape[-1], device=lg.device,
                           dtype=torch.float32) * stride
        scores.append(torch.sigmoid(lg) * mk)
        left.append(ctr - off[0] * stride)
        right.append(ctr + off[1] * stride)
        pmask.append(mk)
    scores, left, right = torch.cat(scores), torch.cat(left), torch.cat(right)
    pmask = torch.cat(pmask)
    valid = (scores > ev["pre_nms_thresh"]) & pmask
    ranked = torch.where(valid, scores, torch.full_like(scores, -1.0))
    kth = torch.topk(ranked, min(ev["pre_nms_topk"], len(scores))).values[-1]
    valid = valid & (scores >= kth) & ((right - left) > ev["seg_len_thresh"])
    scores = torch.where(valid, scores, torch.zeros_like(scores))
    if nms["mode"] != "soft_nms":
        raise ValueError("the reference decodes with soft_nms only")
    return soft_nms(left, right, scores, valid, k, nms["sigma"],
                    nms["min_score"], nms["voting_thresh"])


@torch.no_grad()
def ground(P, cfg, request, k=None, precision="f32", device="cpu",
           alternates=False):
    """The reference's answer to ``request`` (see the module doc) with the
    weights ``P`` (flat dict of tensors on ``device``) and the full config
    tree ``cfg``: one dict per query, ``segments`` (n, 2) in seconds and
    ``scores`` (n,), n <= ``k`` (default: the config's ``max_num_segs``),
    and ``heads`` (see :func:`soft_nms`; segments in seconds). With
    ``alternates``, a query whose delegation nearly ties at the kept
    bins' edge (``model.delegation_weights``) also has ``alternates``: the
    answer with the other bin kept, as correct as the first."""
    m = cfg["model"]
    k = k or cfg["nms"]["max_num_segs"]
    ref = Reference(P, m, precision)
    vid = np.asarray(request["vid"], np.float32)
    shallow = np.asarray(request["shallow_vid"], np.float32)
    t = vid.shape[1]
    T = padded_length(t, m)
    dev = torch.device(device)

    def padded(a):
        out = torch.zeros((a.shape[0], T), dtype=torch.float32, device=dev)
        out[:, :t] = torch.from_numpy(a).to(dev)
        return out

    vid_p, shallow_p = padded(vid), padded(shallow)
    vid_mask = torch.arange(T, device=dev) < t
    texts = [np.asarray(x, np.float32) for x in request["texts"]]
    text_cls = torch.from_numpy(np.asarray(request["text_cls"],
                                           np.float32)).to(dev)
    L = max(x.shape[1] for x in texts)
    fps, size = float(request["fps"]), float(request["clip_size"])
    stride_s = float(request["clip_stride"])
    duration = t * stride_s / fps
    vid_stride = m["vid_net"].get("stride", 1)

    def answers_of(rows, text, text_mask, cls, w):
        R = len(rows)
        logits, offsets, masks = ref.forward(
            vid_p.expand(R, -1, -1), shallow_p.expand(R, -1, -1),
            vid_mask.expand(R, -1), text, text_mask, cls, w)
        out = []
        for r in range(R):
            segs, scores, heads = decode_query([x[r] for x in logits],
                                               [x[r] for x in offsets],
                                               [x[r] for x in masks], cfg, k)
            seconds = [np.clip((x * vid_stride * stride_s + 0.5 * size) / fps,
                               0.0, duration) for x in (segs, heads[:, 1:])]
            out.append({"segments": seconds[0], "scores": scores,
                        "heads": np.concatenate([heads[:, :1], seconds[1]],
                                                1)})
        return out

    answers = []
    for s in range(0, len(texts), ROWS_PER_BLOCK):
        block = texts[s:s + ROWS_PER_BLOCK]
        R = len(block)
        text = torch.zeros((R, texts[0].shape[0], L), device=dev)
        text_mask = torch.zeros((R, L), dtype=torch.bool, device=dev)
        for r, x in enumerate(block):
            text[r, :, :x.shape[1]] = torch.from_numpy(x).to(dev)
            text_mask[r, :x.shape[1]] = True
        cls = text_cls[s:s + R]
        w, alts = ref.delegation(shallow_p.expand(R, -1, -1),
                                 vid_mask.expand(R, -1), cls, alternates)
        block_answers = answers_of(range(R), text, text_mask, cls, w)
        if alts:
            rows = sorted(alts)
            idx = torch.tensor(rows, device=dev)
            for r, a in zip(rows, answers_of(
                    rows, text[idx], text_mask[idx], cls[idx],
                    torch.stack([alts[r] for r in rows]))):
                block_answers[r]["alternates"] = [a]
        answers.extend(block_answers)
    return answers
