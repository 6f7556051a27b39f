#!/usr/bin/env python3
"""Design study of conv3 + LN + ReLU above 1024 output channels, f32, on one
card: the shipped pass kernel (decafnet_tpu_torch/csrc/conv3_ln_act_passes.cu,
candidate "b": one block per 128-column item, passes of 128 or 160
channels, the pre-LN sums kept in the output tensor) against a cluster of
blocks each running passes of 144 channels with its pre-LN columns in
shared memory (candidate "a": scripts/conv3_cluster_passes.cu, 64-column
items, the LN sums exchanged through distributed shared memory), and below
1024 both against the shipped cluster kernel (csrc/conv3_ln_act_wide.cu).

    python3 scripts/torch_conv3_passes_variants.py

Builds the study source with nvcc (the port's flags) into
build/conv3_passes_variants/, then at C_in = C_out = 288, 544, 1056 and
2048 over the served 7 levels (64 rows, T = 2304 ... 36, the served valid
lengths) runs each design and the plain version on the same inputs: max
|diff| against the plain version and against an f64 run, and the device
time of each design timed in turns (first, second, ..., ..., second,
first; CUDA events) with its share of the 3xTF32 bound. One JSON line per
width, with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SRC = os.path.join(REPO, "scripts", "conv3_cluster_passes.cu")
OUT = os.path.join(REPO, "build", "conv3_passes_variants")
SLICE = 144          # channels per pass (NS in the study source)
WIDTHS = (288, 544, 1056, 2048)


def build():
    """The study library (built once per source hash) and nvcc's output."""
    from decafnet_tpu_torch.ops import cuda

    h = hashlib.sha256(" ".join(cuda.NVCC_FLAGS).encode())
    for path in [SRC] + cuda.headers():
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(OUT, h.hexdigest()[:16])
    lib = os.path.join(out, "libconv3_cluster_passes.so")
    log = ""
    if not os.path.exists(lib):
        os.makedirs(out, exist_ok=True)
        res = subprocess.run([cuda.toolkit_binary(), *cuda.NVCC_FLAGS, "-shared", SRC,
                              "-o", lib], capture_output=True, text=True)
        log = res.stdout + res.stderr
        if res.returncode:
            raise RuntimeError("nvcc failed\n" + log)
    dll = ctypes.CDLL(lib)
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.conv3_cluster_passes_f32.argtypes = [vp, i, vp, i] + [vp] * 4 + [i, i, f, i, vp]
    dll.conv3_cluster_passes_f32.restype = i
    dll.conv3_cluster_passes_plan.argtypes = [i, vp]
    dll.conv3_cluster_passes_plan.restype = i
    return dll, log


def plan(dll, C_out):
    """(blocks a cluster, passes a block) of the study kernel at C_out."""
    out = (ctypes.c_int * 2)()
    assert dll.conv3_cluster_passes_plan(C_out, out) == 0, C_out
    return tuple(out)


def launch_cluster_passes(dll, xs, masks, w, ln_w, ln_b, op):
    """One launch of the study kernel over the levels (no bias, ReLU)."""
    from decafnet_tpu_torch.ops import cuda, fused_conv

    C_out, C_in = w.shape[0], xs[0].shape[1]
    head, (_, lw, lb), outs, _keep = fused_conv._conv3_launch_args(
        "conv3_cluster_passes", xs, masks, w, None, ln_w, ln_b, "relu", lambda c: 64)
    if "img" not in op:        # built once, outside the timed calls
        cl, passes = plan(dll, C_out)
        op["img"] = fused_conv._slice_images(w, torch.float32, cl * passes, SLICE)
    err = dll.conv3_cluster_passes_f32(*head, cuda.ptr(op["img"]), None, cuda.ptr(lw),
                                       cuda.ptr(lb), C_in, C_out, 1e-5, 1, cuda.stream())
    cuda.check(err, "conv3_cluster_passes")
    return outs


def in_turns(fns, iters):
    """Device ms of each of ``fns`` (name -> fn), timed first to last, then
    last to first: each one's mean and the spread of its two repeats."""
    import chip_smoke as cs

    names = list(fns)
    first = {n: cs.time_ms(fns[n], iters) for n in names}
    second = {n: cs.time_ms(fns[n], iters) for n in reversed(names)}
    return {n: ((first[n] + second[n]) / 2, abs(first[n] - second[n])) for n in names}


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import decafnet_tpu_torch  # noqa: F401  (full f32: TF32 off)
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.ops import cuda, fused_conv

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cuda.library()
    dll, log = build()
    print(json.dumps({"card": smi, "ptxas": cs.ptxas_report(log)}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 19)
    Ts = [cs.T0 // 2 ** lvl for lvl in range(cs.LEVELS)]
    lens = [cs.row_lens(lvl) for lvl in range(cs.LEVELS)]
    cols = cs.ROWS * sum(Ts)
    for C in WIDTHS:
        xs, masks, (w, _, lw, lb) = cs.conv3_levels_case(dev, g, cs.ROWS, C, Ts, lens)
        op = {}
        fns = {}
        if fused_conv.conv3_route(C) == "wide":
            fns["cluster"] = lambda: tuple(ops.conv3_ln_act_levels(xs, masks, w, None, lw, lb))
        fns["a_cluster_passes"] = lambda: tuple(
            launch_cluster_passes(dll, xs, masks, w, lw, lb, op))
        fns["b_passes"] = lambda: tuple(fused_conv.launch_conv3_ln_act_passes(
            xs, masks, w, None, lw, lb, "relu", 1e-5))
        with cuda.plain_versions():
            want = tuple(ops.conv3_ln_act_levels(xs, masks, w, None, lw, lb))
        refs = [cs.conv3_f64(x, m, w, None, lw, lb) for x, m in zip(xs, masks)]
        bound = 1e3 * 3 * 6 * cols * C * C / cs.TF32_FLOPS
        rec = {"C": C, "rows": cs.ROWS, "levels": Ts, "card": smi, "bound_ms": bound,
               "a_plan": {"cluster": plan(dll, C)[0], "passes": plan(dll, C)[1],
                          "pass_channels": SLICE, "tile": 64},
               "b_plan": fused_conv.conv3_passes_plan(torch.float32, C)._asdict()}
        for name, fn in fns.items():
            got = fn()
            torch.cuda.synchronize()
            rec[name] = {"max_abs_err": cs.max_err(got, want),
                         "max_abs_err_f64": max(cs.max_err(y.double(), r)
                                                for y, r in zip(got, refs))}
            del got
        for name, (ms, spread) in in_turns(fns, 5).items():
            rec[name].update(ms=ms, spread_ms=spread, share=bound / ms)
        print(json.dumps(rec), flush=True)
        for name in fns:
            assert rec[name]["max_abs_err"] <= cs.TOL["conv3_ln_act"], rec
            assert rec[name]["max_abs_err_f64"] <= cs.TOL_F64, rec
        del xs, masks, want, refs, fns, op
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
