#!/usr/bin/env python3
"""Device time of the port's conv3 + LN + ReLU (or band attention) over
one served decode call, as a given tree of the repository launches it, for
A/B runs of two trees on one card:

    python3 scripts/torch_conv3_ab.py [--repo ROOT] [--label NAME] [--op conv3|band]

``--repo`` names the root of the tree whose ``decafnet_tpu_torch`` runs
(default: this one); each tree builds its own kernels under its own
``build/``. Run it once per tree in turns on one card (for example the
parent commit unpacked by ``git archive`` into ``build/parent``): parent,
change, change, parent. Prints one JSON line: per dtype (f32, bf16) and
per served call shape (the level-0 embedding conv at C = 128; a head layer
over the 7 levels at C = 128 and at C = 160) the device ms, CUDA events
over 20 calls; a head layer runs as one launch when the tree has
``conv3_ln_act_levels`` and as one launch per level otherwise. Also the
time per decode call (2 embedding convs, 2 head layers at C = 128 and 4 at
C = 160) and the card's name and power limit.

``--op band``: band attention (window 5) at each of the 7 served levels
(64 rows; 8 videos of chip_smoke.VIDEO_LENS clips x 8 queries, the
head views of (64, 128, T) projections), per dtype the device ms per level
(CUDA events over 20 calls) and their sum, the time per decode call (one
launch per level); and per dtype at the 7 levels of a time-sharded rank
(seq2: 32 rows, 1152 / 2^l columns and the halo of 2 on each side) in the
two layouts band_attention has handed over under time sharding, (B, H, T,
D) tensors and time-minor (B, H, D, T) buffers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def band_times(cs, ops, dev):
    """Band attention at each served level, per dtype: ms per level and per
    decode call."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        levels = []
        for lvl in range(cs.LEVELS):
            T = cs.T0 // 2 ** lvl
            args, _ = cs.band_case(dev, g, cs.ROWS, T, cs.row_lens(lvl), dtype=dtype)
            levels.append(cs.time_ms(lambda: ops.band_attention(*args), 20))
            del args
        out["bf16" if dtype == torch.bfloat16 else "f32"] = {
            "level_ms": levels, "decode_ms": sum(levels)}
    # a time-sharded rank's blocks (seq2: 32 rows, level l's 1152 / 2^l
    # columns and the halo on each side) in the two layouts band_attention
    # has handed over under time sharding: (B, H, T, D) tensors, and
    # time-minor (B, H, D, T) buffers
    for dtype in (torch.float32, torch.bfloat16):
        for how, name in (("contiguous", "BHTD"), ("as_is", "time_minor")):
            g = torch.Generator(device=dev).manual_seed(cs.SEED)
            levels = []
            for lvl in range(cs.LEVELS):
                T = cs.T0 // 2 // 2 ** lvl + 2 * (cs.WINDOW // 2)
                lens = [min(n, T) for n in cs.row_lens(lvl)[:32]]
                args, _ = cs.band_case(dev, g, 32, T, lens, how=how, dtype=dtype)
                levels.append(cs.time_ms(lambda: ops.band_attention(*args), 20))
                del args
            key = ("bf16" if dtype == torch.bfloat16 else "f32") + "_seq2_rank_" + name
            out[key] = {"level_ms": levels, "sum_ms": sum(levels)}
    return out


def conv3_times(cs, ops, dev):
    """conv3 + LN + ReLU per served call shape and per decode call, per
    dtype."""
    grouped = getattr(ops, "conv3_ln_act_levels", None)
    out = {"grouped": grouped is not None}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(cs.SEED)
        rec = {}
        for C, layers in ((cs.EMBD, 2), (cs.EMBD + cs.RDIM, 4)):
            Ts = [cs.T0 // 2 ** lvl for lvl in range(cs.LEVELS)]
            xs = [torch.randn(cs.ROWS, C, T, generator=g, device=dev).to(dtype)
                  for T in Ts]
            masks = [cs.prefix_mask(cs.row_lens(lvl), T, dev)
                     for lvl, T in enumerate(Ts)]
            p = (torch.randn(C, C, 3, generator=g, device=dev) / math.sqrt(3 * C),
                 None, 1 + 0.1 * torch.randn(C, 1, generator=g, device=dev),
                 0.1 * torch.randn(C, 1, generator=g, device=dev))
            if C == cs.EMBD:
                rec["embd"] = cs.time_ms(lambda: ops.conv3_ln_act(xs[0], masks[0], *p), 20)
            if grouped is not None:
                fn = lambda: grouped(xs, masks, *p)  # noqa: E731
            else:
                fn = lambda: [ops.conv3_ln_act(x, m, *p) for x, m in zip(xs, masks)]  # noqa: E731
            rec[f"head_C{C}"] = cs.time_ms(fn, 20)
            rec[f"head_C{C}_layers"] = layers
            del xs, masks
        rec["decode_ms"] = 2 * rec["embd"] + sum(
            rec[f"head_C{C}_layers"] * rec[f"head_C{C}"]
            for C in (cs.EMBD, cs.EMBD + cs.RDIM))
        out["bf16" if dtype == torch.bfloat16 else "f32"] = rec
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--label", default="")
    ap.add_argument("--op", choices=("conv3", "band"), default="conv3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_conv3_ab: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs     # this tree's shapes and timing
    sys.path.insert(0, os.path.abspath(args.repo))
    import decafnet_tpu_torch  # noqa: F401  (TF32 off)
    from decafnet_tpu_torch import ops

    assert os.path.dirname(ops.__file__).startswith(os.path.abspath(args.repo))
    dev = torch.device("cuda")
    out = {"label": args.label, "repo": os.path.relpath(args.repo, HERE),
           "op": args.op}
    if args.op == "band":
        out.update(band_times(cs, ops, dev))
    else:
        out.update(conv3_times(cs, ops, dev))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
