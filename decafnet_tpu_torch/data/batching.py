"""Static-shape batch assembly, numpy only (port of
decafnet_tpu/data/batching.py): ``batchify_train`` for the trainer, and the
eval batching below.

Eval videos are padded to a small geometric set of bucket lengths
(multiples of the chunkable unit, then powers of two of the configured input
length), and query counts / text lengths to power-of-two buckets, so a
request stream reuses a few shapes. Masked-out padding is numerically inert
end to end with one exception: for videos longer than the training length
the reference interpolates the sinusoid PE to its own padded length (next
multiple of the chunkable unit), so the PE values at valid positions depend
on that length. ``pe_interp_arrays`` gives the interpolation plan that
targets the reference's padded length over the bucket's length.
"""

from __future__ import annotations

import numpy as np


def pad_axis(x, length, axis=-1):
    """Zero-pad ``x`` along ``axis`` to ``length``."""
    if x.shape[axis] == length:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, length - x.shape[axis])
    return np.pad(x, pad)


def min_chunk_size(num_fpn_levels, mha_win_size):
    """Chunkable unit so every FPN level divides evenly under banded
    attention (reference: libs/worker_v2.py:769-781)."""
    out = 1
    for idx in range(num_fpn_levels):
        stride = 2 ** idx
        if mha_win_size > 0:
            stride *= (mha_win_size // 2) * 2
        out = max(out, stride)
    return out


def bucket_length(t, chunk, base):
    """Smallest padded length >= t that is a multiple of ``chunk`` and either
    <= base (use base) or base * 2^k -- bounds the number of shapes."""
    if t <= base:
        return base
    length = base
    while length < t:
        length *= 2
    # length is a multiple of base which is a multiple of chunk by config
    assert length % chunk == 0
    return length


def bucket_queries(q, cap=32):
    """Next power-of-two query-count bucket, capped."""
    b = 1
    while b < q and b < cap:
        b *= 2
    return min(b, cap)


def bucket_pow2(n, lo=8):
    """Next power-of-two bucket >= n, at least ``lo`` -- used for eval text
    lengths so the number of decode shapes stays bounded instead of
    growing with every distinct token count."""
    b = lo
    while b < n:
        b *= 2
    return b


def reference_padded_len(t, chunk, base_len, vid_stride=1):
    """The eval padding length of the reference: ``base_len`` when the video
    fits, else the next multiple of ``chunk * vid_stride``
    (reference: libs/worker_v2.py:969-976)."""
    unit = chunk * vid_stride
    if t <= base_len:
        return base_len
    return (t + unit - 1) // unit * unit


def pe_interp_arrays(ref_len, bucket_len, base_len, vid_stride=1):
    """Host-side PE interpolation plan for long videos.

    Returns None when the video fits the training length (the PE table is
    used directly), else (lo, hi, w): for each post-conv position of the
    static *bucket*, the table gather indices and f64-computed lerp weight
    that interpolate the table to the *reference's* post-conv length
    ``ref_len // vid_stride``, exactly like
    torch F.interpolate(mode='linear', align_corners=True)
    (reference: libs/modeling/video_net.py:144-151). Positions beyond the
    reference length hold clamped values; they are masked in the model.
    """
    if ref_len <= base_len:
        return None
    in_size = base_len // vid_stride          # PE table length (max_seq_len)
    out_len = ref_len // vid_stride           # reference interp target
    out_max = bucket_len // vid_stride        # static bucket positions
    pos = np.arange(out_max, dtype=np.float64) * (in_size - 1) \
        / max(out_len - 1, 1)
    lo = np.clip(np.floor(pos).astype(np.int32), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    # beyond the table (masked bucket tail) lo == hi, so any weight yields
    # the clamped edge value; clip keeps the arithmetic benign
    w = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
    return lo, hi, w


def batchify_train(samples, input_vid_len, max_text_len, max_num_text):
    """Assemble a static train batch from dataset sample dicts.

    Returns a dict of numpy arrays, video-major (row r belongs to video
    r // max_num_text):
      vid (B, Cv, T), shallow_vid (B, Cs, T), vid_masks (B, T),
      text (R, Ct, L), text_masks (R, L), text_cls (R, Ccls),
      targets (R, 2), row_valid (R,)        with R = B * max_num_text.
    Rows past a video's queries are padding: target [0, 1], row_valid
    False.
    """
    B = len(samples)
    R = B * max_num_text
    T, L = input_vid_len, max_text_len
    cv = samples[0]["vid"].shape[0]
    cs = samples[0]["shallow_vid"].shape[0]
    ct = samples[0]["text"][0].shape[0]
    ccls = samples[0]["text_cls"].shape[1]

    vid = np.zeros((B, cv, T), np.float32)
    shallow = np.zeros((B, cs, T), np.float32)
    vid_masks = np.zeros((B, T), bool)
    text = np.zeros((R, ct, L), np.float32)
    text_masks = np.zeros((R, L), bool)
    text_cls = np.zeros((R, ccls), np.float32)
    targets = np.tile(np.asarray([[0.0, 1.0]], np.float32), (R, 1))
    row_valid = np.zeros((R,), bool)

    for b, s in enumerate(samples):
        t = s["vid"].shape[1]
        if t > T:
            raise ValueError(f"video length {t} exceeds input_vid_len {T}")
        vid[b, :, :t] = s["vid"]
        shallow[b, :, :t] = s["shallow_vid"]
        vid_masks[b, :t] = True
        for qi, tok in enumerate(s["text"][:max_num_text]):
            r = b * max_num_text + qi
            n = min(tok.shape[1], L)
            text[r, :, :n] = tok[:, :n]
            text_masks[r, :n] = True
            text_cls[r] = s["text_cls"][qi]
            targets[r] = s["target"][qi]
            row_valid[r] = True

    return {"vid": vid, "shallow_vid": shallow, "vid_masks": vid_masks,
            "text": text, "text_masks": text_masks, "text_cls": text_cls,
            "targets": targets, "row_valid": row_valid}


def batchify_eval(sample, chunk, base_len, vid_stride=1, query_cap=32,
                  text_len_cap=None):
    """Assemble per-video eval batches, chunking queries to <= query_cap.

    ``text_len_cap`` (set to text_net.max_seq_len when the text net uses an
    absolute PE): padding a query past the PE table length would trigger
    eval-time PE interpolation in the text net, changing PE values at VALID
    token positions -- so the pow-2 bucket is capped there. Queries actually
    longer than the cap are rejected loudly rather than silently diverging
    from the reference (which processes each query unpadded at its own
    length, libs/worker_v2.py:940-955).

    Returns (meta, chunks) where each chunk is a dict:
      vid (1, Cv, T), shallow_vid (1, Cs, T), vid_masks (1, T),
      text (Qb, Ct, L), text_masks (Qb, L), text_cls (Qb, Ccls),
      ext_scores (Qb, T) or None, q_valid (Qb,)
    """
    vid = sample["vid"]
    shallow = sample["shallow_vid"]
    t = vid.shape[1]
    T = bucket_length(t, chunk * vid_stride, base_len)
    ref_len = reference_padded_len(t, chunk, base_len, vid_stride)
    pe_interp = pe_interp_arrays(ref_len, T, base_len, vid_stride)

    vid_p = pad_axis(vid, T)[None]
    shallow_p = pad_axis(shallow, T)[None]
    vid_masks = (np.arange(T) < t)[None]

    texts = sample["text"]
    Q = len(texts)
    # pow-2 text-length bucket: one decode shape per (T, Q, L)
    # bucket instead of one per distinct token count (padded tokens are
    # masked and numerically inert through the text net)
    max_tok = max(tok.shape[1] for tok in texts)
    L = bucket_pow2(max_tok)
    if text_len_cap is not None:
        assert max_tok <= text_len_cap, (
            f"query of {max_tok} tokens exceeds the text net's absolute-PE "
            f"table ({text_len_cap}); eval-time text PE interpolation under "
            f"length bucketing is unsupported")
        L = min(L, int(text_len_cap))
    ext = sample.get("ext_scores")

    chunks = []
    for start in range(0, Q, query_cap):
        group = texts[start:start + query_cap]
        qb = bucket_queries(len(group), query_cap)
        text = np.zeros((qb, texts[0].shape[0], L), np.float32)
        text_masks = np.zeros((qb, L), bool)
        text_cls = np.zeros((qb, sample["text_cls"].shape[1]), np.float32)
        q_valid = np.zeros((qb,), bool)
        ext_p = np.zeros((qb, T), np.float32) if ext is not None else None
        for qi, tok in enumerate(group):
            l = tok.shape[1]
            text[qi, :, :l] = tok
            text_masks[qi, :l] = True
            text_cls[qi] = sample["text_cls"][start + qi]
            q_valid[qi] = True
            if ext is not None:
                ext_p[qi, :min(t, ext.shape[1])] = \
                    ext[start + qi][:min(t, ext.shape[1])]
        chunks.append({
            "vid": vid_p, "shallow_vid": shallow_p, "vid_masks": vid_masks,
            "text": text, "text_masks": text_masks, "text_cls": text_cls,
            "ext_scores": ext_p, "q_valid": q_valid, "pe_interp": pe_interp,
        })

    # ground truth ("segment", "target") is there for dataset samples only
    meta = {k: sample[k] for k in
            ("fps", "duration", "clip_size", "clip_stride", "segment",
             "clip_id", "text_id", "target") if k in sample}
    meta["vid_len"] = t
    meta["num_queries"] = Q
    return meta, chunks
