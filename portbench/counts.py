"""The benchmark's own arithmetic: the decode calls a traffic makes, the
model's FLOPs per call, and each hand kernel's least time per call on the
H100 (its roofline bound), from shapes alone.

Conventions: a FLOP is one multiply or one add (a multiply-add is 2).
Bytes are each input byte read once and each output byte written once, at
the activations' element size; inputs are counted over the valid columns
of each row (the columns the algorithm needs), outputs over every column
of the bucket (the kernel must write them). A bound is the larger of
bytes / bandwidth and FLOPs / peak, so any implementation of the same
algorithm reads the same work.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# NVIDIA H100 SXM (data sheet, dense, 700 W): HBM3 bandwidth, and the
# highest rate the card multiplies each activation dtype at: f32 inputs
# through TF32 tensor cores, bf16 through bf16 ones
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


@dataclass
class DecodeCall:
    """One forward of the model: ``videos`` stacked videos (inert copies
    included) x ``qb`` query rows each at bucket length ``T`` and text
    bucket ``L``; ``lengths`` the valid clips of each video, ``queries``
    the real queries of each video (0 for an inert copy)."""
    T: int
    L: int
    qb: int
    lengths: list = field(default_factory=list)
    queries: list = field(default_factory=list)

    def row_lengths(self):
        return [t for t in self.lengths for _ in range(self.qb)]


def pow2_at_least(n, lo=1):
    b = lo
    while b < n:
        b *= 2
    return b


def bucket_length(t, m):
    """The padded video length of ``t`` clips: the configured input length,
    or that length times the least power of two that holds ``t``."""
    vn = m["vid_net"]
    base = vn["max_seq_len"] * vn.get("stride", 1)
    return base if t <= base else base * pow2_at_least(-(-t // base))


def decode_calls(requests, cfg, max_group=8):
    """The decode calls that ``GroundingService.ground_many(requests,
    max_group)`` (or, for one request, ``ground``) makes, by the service's
    bucketing rule: queries in chunks of at most ``eval.max_num_queries``
    padded to a power of two, text padded to a power of two of at least 8
    tokens, same-bucket videos stacked up to ``max_group`` and padded to a
    power of two with inert copies."""
    cap = cfg["eval"].get("max_num_queries", 32)
    buckets = {}
    for req in requests:
        t = req["vid"].shape[1]
        texts = req["texts"]
        L = pow2_at_least(max(x.shape[1] for x in texts), 8)
        for s in range(0, len(texts), cap):
            q = len(texts[s:s + cap])
            key = (bucket_length(t, cfg["model"]), pow2_at_least(min(q, cap)), L)
            buckets.setdefault(key, []).append((t, q))
    calls = []
    for (T, qb, L), items in buckets.items():
        for s in range(0, len(items), max_group):
            group = items[s:s + max_group]
            v = pow2_at_least(len(group))
            group = group + [(group[0][0], 0)] * (v - len(group))
            calls.append(DecodeCall(T, L, qb, [t for t, _ in group],
                                    [q for _, q in group]))
    return calls


def level_lengths(T, levels):
    return [-(-T // 2 ** i) for i in range(levels)]


def model_flops(m, call):
    """FLOPs of the grounder's forward for the real queries of ``call``:
    per real video the delegated 1x1 projection; per real query row the
    correlation, text net, fusion, video FPN, heads and TCN at the bucket
    length (the decode and NMS after them are left out)."""
    vn, tn, fu = m["vid_net"], m["text_net"], m["fusion"]
    E, T = vn["embd_dim"], call.T
    levels, win = vn["arch"][2], vn["mha_win_size"]
    Ts = level_lengths(T, levels)
    cv = vn["in_dim"]
    cs = cv                      # the sidekick stream has the expert's width
    per_video = 2 * (cv + (cs if m.get("msf") else 0)) * E * T

    Et, Lt = tn["embd_dim"], call.L + (1 if tn.get("use_bkgd_token", True) else 0)
    text = 2 * tn["in_dim"] * Et * call.L
    text += tn.get("n_layers", 5) * (24 * Et * Et * Lt + 4 * Lt * Lt * Et)
    fusion = fu.get("n_layers", 2) * (22 * E * E * T + 4 * T * Lt * E
                                      + 6 * E * T + 4 * E * Et * Lt)
    video = 2 * E * E * T + vn["arch"][0] * 6 * E * E * T
    for lvl, t in enumerate(Ts):
        video += 24 * E * E * t + 4 * win * E * t + 18 * E * t
    rdim = m.get("rdim") or 32
    E2 = E + rdim
    n_cls = m["cls_head"].get("n_layers", 2)
    n_reg = m["reg_head"].get("n_layers", 2)
    S = sum(Ts)
    heads = n_cls * 6 * E * E * S + 6 * E * S                     # cls_head
    heads += 2 * levels * rdim * T + levels * 8 * rdim * rdim * T \
        + 2 * rdim * rdim * T                                     # TCN
    heads += n_cls * 6 * E2 * E2 * S + 6 * E2 * S                 # cls_head2
    heads += n_reg * 6 * E2 * E2 * S + 12 * E2 * S                # reg_head
    per_row = 2 * cs * T + text + fusion + video + heads
    n_videos = sum(1 for q in call.queries if q > 0)
    return per_video * n_videos + per_row * sum(call.queries)


def _bound(nbytes, flops, dtype):
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def conv3_bound(m, call, dtype):
    """Least seconds of the conv3 + LN + ReLU launches of one forward: the
    video net's embedding convs at level 0 and the two layers of each of
    the three heads over every level (C_in = C_out = the width of each).
    Per launch the weights once; per row x over its valid columns, the
    output over all; 2 * 3 * C_in * C_out FLOPs per valid column (the LN and
    ReLU not counted)."""
    e = ELEMENT_BYTES[dtype]
    vn = m["vid_net"]
    E, levels = vn["embd_dim"], vn["arch"][2]
    E2 = E + (m.get("rdim") or 32)
    lens = call.row_lengths()
    layers = [(E, [0])] * vn["arch"][0]
    layers += [(E, range(levels))] * m["cls_head"].get("n_layers", 2)
    layers += [(E2, range(levels))] * (m["cls_head"].get("n_layers", 2)
                                       + m["reg_head"].get("n_layers", 2))
    total = 0.0
    for C, lvls in layers:                  # one launch each
        nbytes, flops = 3 * C * C * e + 3 * C * 4, 0
        for lvl in lvls:
            Tl = -(-call.T // 2 ** lvl)
            for t in lens:
                n = -(-t // 2 ** lvl)
                nbytes += C * n * e + Tl + C * Tl * e
                flops += 6 * C * C * n
        total += _bound(nbytes, flops, dtype)
    return total


def band_bound(m, call, dtype):
    """Least seconds of the band-attention launches of one forward, one per
    FPN level: q, k, v over each row's valid columns, the mask, the output
    over all columns; 4 * window * C FLOPs per valid query (scores and the
    weighted sum; the softmax not counted)."""
    e = ELEMENT_BYTES[dtype]
    vn = m["vid_net"]
    C, win = vn["embd_dim"], vn["mha_win_size"]
    total = 0.0
    for lvl in range(vn["arch"][2]):        # one launch each
        Tl = -(-call.T // 2 ** lvl)
        nbytes = flops = 0
        for t in call.row_lengths():
            n = -(-t // 2 ** lvl)
            nbytes += 3 * C * n * e + Tl + C * Tl * e
            flops += 4 * win * C * n
        total += _bound(nbytes, flops, dtype)
    return total


def trio_bound(m, call, dtype):
    """Least seconds of the q/k/v trio launch of one forward (the stride-1
    encoder at level 0): x over each row's valid columns, the mask, three
    outputs over all columns; 3 * 2 * 3 * C FLOPs per valid column (the
    three depthwise convs; the LNs not counted)."""
    e = ELEMENT_BYTES[dtype]
    C = m["vid_net"]["embd_dim"]
    nbytes = 9 * C * 4 + 3 * 2 * C * 4
    flops = 0
    for t in call.row_lengths():
        nbytes += C * t * e + call.T + 3 * C * call.T * e
        flops += 18 * C * t
    return _bound(nbytes, flops, dtype)


BOUNDS = {"conv3": conv3_bound, "band": band_bound, "trio": trio_bound}


def mfu(flops, seconds, dtype):
    """Percent of the card's peak for the activation dtype."""
    return 100.0 * flops / seconds / PEAK_FLOPS[dtype] if seconds > 0 else None
