#!/usr/bin/env python3
"""Design study of conv3 + LN + ReLU above 256 output channels, f32, on one
card: the shipped wide kernel (decafnet_tpu_torch/csrc/conv3_ln_act_wide.cu,
a thread-block cluster whose blocks split C_out) against one block per item
computing its C_out in passes of 144 channels, the item's pre-LN columns
kept in shared memory (scripts/conv3_wide_passes.cu).

    python3 scripts/torch_conv3_wide_variants.py

Builds the study source with nvcc (the port's flags) into
build/conv3_wide_variants/, then at C_in = C_out = 288 and 544 over the
served 7 levels (64 rows, T = 2304 ... 36, the served valid lengths) runs
both kernels and the plain version on the same inputs: max |diff| against
the plain version and against an f64 run, and the device time of each
kernel timed in turns (cluster, passes, passes, cluster; CUDA events). One
JSON line per width, with the card's name and power limit.
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

SRC = os.path.join(REPO, "scripts", "conv3_wide_passes.cu")
OUT = os.path.join(REPO, "build", "conv3_wide_variants")
SLICE = 144          # channels per pass (NS in the study source)
WIDTHS = (288, 544)


def build():
    """The study library (built once per source hash) and nvcc's output."""
    from decafnet_tpu_torch.ops import cuda

    h = hashlib.sha256(" ".join(cuda.NVCC_FLAGS).encode())
    for path in [SRC] + cuda.headers():
        with open(path, "rb") as f:
            h.update(f.read())
    out = os.path.join(OUT, h.hexdigest()[:16])
    lib = os.path.join(out, "libconv3_passes.so")
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
    dll.conv3_passes_f32.argtypes = [vp, i, vp, i] + [vp] * 4 + [i, i, f, i, vp]
    dll.conv3_passes_f32.restype = i
    dll.conv3_passes_plan.argtypes = [i]
    dll.conv3_passes_plan.restype = i
    return dll, log


def passes_operands(w, passes):
    """(passes, ceil(C_in/8), 2, 3, SLICE, 8): each pass's slice of ``w``
    (zero-padded to passes x SLICE channels) as the tuned f32 image at N =
    SLICE, its TF32 halves."""
    from decafnet_tpu_torch.ops import fused_conv

    wp = w.new_zeros(passes * SLICE, *w.shape[1:])
    wp[:w.shape[0]] = w
    return torch.stack([torch.stack(fused_conv.tf32_split(
        fused_conv.conv3_weight_fragments(s, SLICE)), 1) for s in wp.split(SLICE)])


def launch_passes(dll, xs, masks, w, ln_w, ln_b, op):
    """One launch of the study kernel over the levels (no bias, ReLU)."""
    from decafnet_tpu_torch.ops import cuda, fused_conv

    C_out, C_in = w.shape[0], xs[0].shape[1]
    passes = dll.conv3_passes_plan(C_out)
    head, (_, lw, lb), outs, _keep = fused_conv._conv3_launch_args(
        "conv3_passes", xs, masks, w, None, ln_w, ln_b, "relu", lambda c: 64)
    if "img" not in op:        # built once, outside the timed calls
        op["img"] = passes_operands(w, passes)
    img = op["img"]
    err = dll.conv3_passes_f32(*head, cuda.ptr(img), None, cuda.ptr(lw), cuda.ptr(lb),
                               C_in, C_out, 1e-5, 1, cuda.stream())
    cuda.check(err, "conv3_passes")
    return outs


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
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 18)
    Ts = [cs.T0 // 2 ** lvl for lvl in range(cs.LEVELS)]
    lens = [cs.row_lens(lvl) for lvl in range(cs.LEVELS)]
    for C in WIDTHS:
        xs, masks, (w, _, lw, lb) = cs.conv3_levels_case(dev, g, cs.ROWS, C, Ts, lens)
        op = {}

        def cluster():
            return tuple(ops.conv3_ln_act_levels(xs, masks, w, None, lw, lb))

        def passes():
            return tuple(launch_passes(dll, xs, masks, w, lw, lb, op))

        with cuda.plain_versions():
            want = cluster()
        refs = [cs.conv3_f64(x, m, w, None, lw, lb) for x, m in zip(xs, masks)]
        rec = {"C": C, "rows": cs.ROWS, "levels": Ts, "card": smi,
               "cluster_plan": fused_conv.conv3_wide_plan(torch.float32, C)._asdict(),
               "passes": dll.conv3_passes_plan(C), "pass_channels": SLICE}
        for name, fn in (("cluster", cluster), ("passes", passes)):
            got = fn()
            torch.cuda.synchronize()
            rec[name + "_max_abs_err"] = cs.max_err(got, want)
            rec[name + "_max_abs_err_f64"] = max(
                cs.max_err(y.double(), r) for y, r in zip(got, refs))
        ab = cs.time_in_turns(cluster, passes, 10)
        cols = cs.ROWS * sum(Ts)
        bound = 1e3 * 3 * 2 * cols * C * 3 * C / cs.TF32_FLOPS
        rec.update(cluster_ms=ab["old_ms"], passes_ms=ab["new_ms"],
                   cluster_spread_ms=ab["old_spread_ms"],
                   passes_spread_ms=ab["new_spread_ms"], bound_ms=bound,
                   cluster_share=bound / ab["old_ms"], passes_share=bound / ab["new_ms"])
        print(json.dumps(rec), flush=True)
        assert rec["cluster_max_abs_err"] <= cs.TOL["conv3_ln_act"], rec
        assert rec["passes_max_abs_err"] <= cs.TOL["conv3_ln_act"], rec
        del xs, masks, want, refs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
