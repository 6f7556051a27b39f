#!/usr/bin/env python3
"""Design study of the wide band-attention kernels
(decafnet_tpu_torch/csrc/band_attention_wide.cu) on one card, f32 and bf16:
a query's head dims split over the warps of a block (lanes 1: a warp's
stores cover 64 columns of a d-row), 8 parts of 8 dims ("warps8", the most
the dims allow up to 8) or half as many warps with twice the steps
("warps4": more blocks per multiprocessor), against warps8's parts split
over the lanes of a warp ("lanes": lanes 4, or 2 where the dims allow no
more; tiles of 16 or 32 columns, partial scores added by an xor-shuffle
tree), beside the wrapper's plan (band_attention_wide_plan) and the
general kernel (csrc/band_attention_general.cu).

    python3 scripts/torch_band_wide_variants.py [--levels 7]

At head widths 16, 64 and 128 with window 11, 256 with window 5, and 16,
64 and 128 with window 5 (the widths legs' own window), over the served FPN
levels (64 rows, 4 heads, T = 2304 ... 36, the served valid lengths), each
plan runs on the same inputs: max |diff| against the plain version
(band_attention_torch; f32 within 1e-5, bf16 within 2 bf16 eps of max(1,
|plain|)), then the device time of each, timed in turns (first ... last,
last ... first; CUDA events), with the level's byte bound. One JSON line
per (dtype, shape) with the per-level times and their sums, after one line
with the card's name and power limit and ptxas's report of the source.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SHAPES = ((16, 11), (64, 11), (128, 11), (256, 5), (16, 5), (64, 5), (128, 5))


def candidates(dtype, B, H, T, D, halo, sms):
    """The plans compared at one level: name -> BandWidePlan."""
    from decafnet_tpu_torch.ops import local_attention as la

    plan = la.band_attention_wide_plan(dtype, B, H, T, D, halo, sms)
    n = D // la.BAND_WIDE_DIMS
    warps = max(w for w in range(1, la.BAND_WIDE_MAX_WARPS + 1) if n % w == 0)
    out = {"plan": plan,
           "warps8": la.band_attention_wide_plan(dtype, B, H, T, D, halo, sms,
                                                 warps=warps, lanes=1)}
    if warps % 2 == 0:
        out["warps4"] = la.band_attention_wide_plan(
            dtype, B, H, T, D, halo, sms, warps=warps // 2, lanes=1)
    # warps8's parts over the lanes of fewer warps
    lanes = next((l for l in (4, 2) if warps % l == 0), None)
    if lanes is not None:
        out["lanes"] = la.band_attention_wide_plan(
            dtype, B, H, T, D, halo, sms, warps=warps // lanes, lanes=lanes)
    return out


def in_turns(fns, iters):
    """Device ms of each of ``fns`` (name -> fn), timed first to last, then
    last to first: each one's mean and the spread of its two repeats."""
    import chip_smoke as cs

    names = list(fns)
    first = {n: cs.time_ms(fns[n], iters) for n in names}
    second = {n: cs.time_ms(fns[n], iters) for n in reversed(names)}
    return {n: ((first[n] + second[n]) / 2, abs(first[n] - second[n])) for n in names}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=7)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import decafnet_tpu_torch  # noqa: F401
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.ops import cuda, local_attention as la

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cuda.library()
    print(json.dumps({"card": smi, "ptxas": cs.ptxas_report(
        cuda.build_log("band_attention_wide.cu"))}), flush=True)
    dev = torch.device("cuda")
    sms = cuda.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        esz = 2 if dtype == torch.bfloat16 else 4
        for D, W in SHAPES:
            rec = {"dtype": str(dtype).split(".")[-1], "D": D, "window": W,
                   "rows": cs.ROWS, "heads": cs.HEADS, "card": smi, "levels": []}
            for level in range(args.levels):
                T = cs.T0 // 2 ** level
                lens = cs.row_lens(level)
                qkv_m_w, _ = cs.band_case(dev, g, cs.ROWS, T, lens, D=D, dtype=dtype,
                                          window=W)
                plans = candidates(dtype, cs.ROWS, cs.HEADS, T, D, W // 2, sms)
                fns = {name: (lambda p=p: la.launch_band_attention_wide(*qkv_m_w, plan=p))
                       for name, p in plans.items()}
                fns["general"] = lambda: la.launch_band_attention_general(*qkv_m_w)
                with cuda.plain_versions():
                    want = ops.band_attention(*qkv_m_w)
                n_valid = sum(min(n, T) for n in lens)
                n_bytes = (esz * (3 * n_valid * cs.HEADS * D + cs.ROWS * cs.HEADS * T * D)
                           + cs.ROWS * T)
                lv = {"level": level, "T": T,
                      "bound_ms": 1e3 * n_bytes / cs.HBM_BYTES_PER_S,
                      "plans": {n: p._asdict() for n, p in plans.items()}}
                for name, fn in fns.items():
                    got = fn()
                    torch.cuda.synchronize()
                    a, r = cs.bf16_err(got, want)
                    good = bool(torch.isfinite(got).all()) and (
                        r <= cs.TOL_BF16 if esz == 2 else a <= cs.TOL["band_attention"])
                    ok &= good
                    lv[name] = {"max_abs_err": a, "max_rel_err": r, "ok": good}
                    del got
                slow = {"general": fns.pop("general")}
                for name, (ms, spread) in (in_turns(fns, 10) | in_turns(slow, 3)).items():
                    lv[name].update(ms=ms, spread_ms=spread, share=lv["bound_ms"] / ms)
                rec["levels"].append(lv)
                del qkv_m_w, want, fns, slow
            names = [n for n in rec["levels"][0] if isinstance(rec["levels"][0][n], dict)
                     and "ms" in rec["levels"][0][n]]
            rec["bound_ms"] = sum(lv["bound_ms"] for lv in rec["levels"])
            rec["sum_ms"] = {n: sum(lv[n]["ms"] for lv in rec["levels"] if n in lv)
                             for n in names}
            rec["best_per_level"] = [min((n for n in lv if isinstance(lv[n], dict)
                                          and "ms" in lv[n] and n != "general"),
                                         key=lambda n: lv[n]["ms"])
                                     for lv in rec["levels"]]
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
