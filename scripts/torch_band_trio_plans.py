#!/usr/bin/env python3
"""Launch plans and design variants of the port's band-attention and q/k/v
trio kernels, on one card.

    python3 scripts/torch_band_trio_plans.py

Plans: through the shipped library, runs every launch plan the two kernels
take at the served shapes of one decode call (64 rows, T=2304; band
attention at all 7 FPN levels, the trio at level 0 in f32 and in bf16):
band attention with (tile, split) = time columns per block and lanes per
query, the trio with tile = time columns per block. Each plan is held
against the plain version (it must agree within chip_smoke's tolerance, in
bf16 its 2 bf16 eps of max(1, |plain|)) and timed with CUDA events.
One JSON line per shape: every plan's time and error, the wrapper's plan,
the fastest plan.

Variants: builds edited copies of csrc/band_attention.cu and
csrc/qkv_depthwise_ln.cu (each edit must apply), one nvcc per variant, all
started together, into build/band_trio_variants/, and times each at the
wrapper's plans on the same inputs: both kernels without the masked-tail
skip, and the trio with 1 or 2 lanes per column instead of 4.

Last line: per kernel, the time per served decode call with the wrapper's
plans, with the fastest plan at each shape, and per variant, with the
card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CSRC = os.path.join(REPO, "decafnet_tpu_torch", "csrc")
OUT = os.path.join(REPO, "build", "band_trio_variants")
BAND_TILES = (32, 64, 96, 128, 192, 256)
TRIO_TILES = (16, 32, 64, 96, 128)
MAX_THREADS = 512  # both kernels' __launch_bounds__

# the same source with one edit each
TRIO_LANES = "constexpr int CS = 4;"
VARIANTS = {
    "band_attention": ("decafnet_band_attention_f32", {
        "no_tail_skip": ("if (!__syncthreads_or(valid)) {",
                         "if (!__syncthreads_or(valid) && false) {")}),
    "qkv_depthwise_ln": ("decafnet_qkv_depthwise_ln_f32", {
        "no_tail_skip": ("all = __syncthreads_and(all);\n  if (!any) {",
                         "all = __syncthreads_and(all);\n  if (!any && false) {"),
        "lanes1": (TRIO_LANES, "constexpr int CS = 1;"),
        "lanes2": (TRIO_LANES, "constexpr int CS = 2;")}),
}


def plans(tiles, T, splits):
    """(tile, split) pairs the kernels take (tile a multiple of 32 // split,
    at most MAX_THREADS threads) with fewer than two tiles' worth of
    columns past T."""
    out = []
    for split in splits:
        for tile in tiles:
            if tile % (32 // split) == 0 and tile * split <= MAX_THREADS \
                    and tile < 2 * T:
                out.append((tile, split))
    return out


def build_variants():
    from decafnet_tpu_torch.ops import cuda

    os.makedirs(OUT, exist_ok=True)
    nvcc, procs = cuda.toolkit_binary(), {}
    for kernel, (_, edits) in VARIANTS.items():
        with open(os.path.join(CSRC, kernel + ".cu")) as f:
            src = f.read()
        for name, (old, new) in edits.items():
            assert src.count(old) == 1, f"variant edit does not apply: {old!r}"
            cu = os.path.join(OUT, f"{kernel}_{name}.cu")
            with open(cu, "w") as f:
                f.write(src.replace(old, new))
            procs[(kernel, name)] = subprocess.Popen(
                [nvcc, *cuda.NVCC_FLAGS, "-shared", cu, "-o", cu[:-3] + ".so"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (kernel, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel} {name}:\n{log}")
        entry = VARIANTS[kernel][0]
        fn = getattr(ctypes.CDLL(os.path.join(OUT, f"{kernel}_{name}.so")), entry)
        fn.argtypes = cuda._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[(kernel, name)] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        print("torch_band_trio_plans: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import decafnet_tpu_torch  # noqa: F401  (TF32 off for the plain versions)
    from decafnet_tpu_torch.ops import cuda, fused_conv, local_attention

    cuda.library()
    fns = build_variants()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    total = {k: {"wrapper_plans_ms": 0.0, "fastest_plans_ms": 0.0,
                 **{n: 0.0 for (kk, n) in fns if kk == k}}
             for k in (*VARIANTS, "qkv_depthwise_ln_bf16")}

    def band_variant(fn, q, k, v, mask, window, plan):
        B, H, T, D = q.shape
        out = torch.empty((B, H, D, T), device=dev)
        m8 = cuda.as_bytes(mask)
        err = fn(cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(m8),
                 cuda.ptr(out), B, H, T, D, *q.stride(), window // 2, *plan,
                 cuda.stream())
        cuda.check(err, "band_attention variant")
        return out.transpose(2, 3)

    def trio_variant(fn, x, mask, ws, lws, lbs, tile):
        B, C, T = x.shape
        outs = [torch.empty_like(x) for _ in range(3)]
        p = [t.reshape(-1).contiguous() for t in list(ws) + list(lws) + list(lbs)]
        wq, wk, wv, lwq, lwk, lwv, lbq, lbk, lbv = p
        err = fn(*map(cuda.ptr, (x, cuda.as_bytes(mask), wq, wk, wv, lwq, lbq,
                                 lwk, lbk, lwv, lbv, *outs)),
                 B, C, T, 1e-5, tile, cuda.stream())
        cuda.check(err, "qkv_depthwise_ln variant")
        return tuple(outs)

    def study(kernel, level, args, chosen, candidates, launch, variant):
        op, bf16 = kernel.removesuffix("_bf16"), kernel.endswith("_bf16")
        with cuda.plain_versions():
            want = getattr(local_attention if op == "band_attention"
                           else fused_conv, op)(*args)
        row = {"kernel": kernel, "level": level, "shape": list(args[0].shape),
               "wrapper_plan": chosen, "plans": []}
        for plan in candidates:
            got = launch(*args, plan)
            err = cs.bf16_err(got, want)[1] if bf16 else cs.max_err(got, want)
            assert err <= (cs.TOL_BF16 if bf16 else cs.TOL[op]), \
                (kernel, level, plan, err)
            ms = cs.time_ms(lambda: launch(*args, plan), 20)
            row["plans"].append({"plan": plan, "ms": ms, "max_abs_err": err})
        best = min(row["plans"], key=lambda p: p["ms"])
        row["fastest"] = best
        chosen_ms = next(p["ms"] for p in row["plans"] if p["plan"] == chosen)
        total[kernel]["wrapper_plans_ms"] += chosen_ms
        total[kernel]["fastest_plans_ms"] += best["ms"]
        row["variants"] = {}
        for (kk, name), fn in fns.items():
            if kk != kernel:
                continue
            err = cs.max_err(variant(fn, *args, chosen), want)
            assert err <= cs.TOL[kernel], (kernel, name, err)
            ms = cs.time_ms(lambda: variant(fn, *args, chosen), 20)
            row["variants"][name] = {"ms": ms, "max_abs_err": err}
            total[kernel][name] += ms
        print(json.dumps(row), flush=True)

    for level in range(cs.LEVELS):
        T = cs.T0 // 2 ** level
        lens = cs.row_lens(level)
        args, _ = cs.band_case(dev, g, cs.ROWS, T, lens)
        chosen = local_attention.band_attention_plan(
            cs.ROWS, cs.HEADS, T, cuda.sm_count(dev))
        cands = plans(BAND_TILES, T, (1, 2, 4))
        cands += [chosen] if chosen not in cands else []
        study("band_attention", level, args, chosen, cands,
              local_attention.launch_band_attention, band_variant)
        if level == 0:
            args, _ = cs.trio_case(dev, g, cs.ROWS, cs.EMBD, T, lens)
            chosen = fused_conv.qkv_depthwise_ln_plan(T)
            cands = [t for t, _ in plans(TRIO_TILES, T, (fused_conv.QKV_LANES,))]
            cands += [chosen] if chosen not in cands else []
            trio = lambda *a: fused_conv.launch_qkv_depthwise_ln(  # noqa: E731
                *a[:-1], 1e-5, a[-1])
            study("qkv_depthwise_ln", level, args, chosen, cands, trio,
                  trio_variant)
            # bf16: two columns per lane, so tiles of 16 columns
            args, _ = cs.trio_case(dev, g, cs.ROWS, cs.EMBD, T, lens,
                                   dtype=torch.bfloat16)
            chosen = fused_conv.qkv_depthwise_ln_plan(T, torch.bfloat16)
            cands = [t for t in TRIO_TILES if t % 16 == 0]
            cands += [chosen] if chosen not in cands else []
            study("qkv_depthwise_ln_bf16", level, args, chosen, cands, trio,
                  None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"per": "one served decode call (64 rows, T=2304; band "
                      "attention 7 levels, trio level 0)", "ms": total,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
