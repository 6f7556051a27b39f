#!/usr/bin/env python3
"""Design alternatives of the port's conv3 + LN + ReLU kernel, on one card.

    python3 scripts/torch_conv3_variants.py

Builds decafnet_tpu_torch/csrc/conv3_ln_act.cu as shipped and a few variants
made by editing its text (each edit must apply, or the script fails), one
nvcc per variant, all started together, into build/conv3_variants/. Then it
runs every variant on the same inputs: the served shapes of one decode call
(64 rows, T=2304, all 7 levels, C=128 and 160) and edge shapes, and prints
one JSON line per shape (each variant's max |error| against an f64 run and
its time, CUDA events) and a last summary line: time per served decode call
and max error per variant, with the card's name and power limit.

Variants:
  shipped        the source as it is;
  chained        the three TF32 passes accumulate in place through all of K
                 (no fresh sum per stage of 8 input channels);
  no_setmaxnreg  the warpgroups keep the registers of the launch bounds (168
                 a thread) instead of 232 for the consumers and 40 for the
                 producer;
  cvt_rna        x split with the cvt.rna.tf32.f32 instruction instead of the
                 two integer operations.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SRC = os.path.join(REPO, "decafnet_tpu_torch", "csrc", "conv3_ln_act.cu")
HEADER = os.path.join(REPO, "decafnet_tpu_torch", "csrc", "conv3_wgmma.cuh")
OUT = os.path.join(REPO, "build", "conv3_variants")

FRESH = "      float d[NW / 2];\n"
FIRST = "WgmmaTf32<NW>::mma(d, al[tap], wh, tap != 0);"
ADD = """#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] += d[i];
"""
MAXNREG = ('    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");\n',
           '  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");\n')

INT_RNA = """__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}"""

CVT_RNA = """__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}"""



def shipped_source():
    """conv3_ln_act.cu with the header it shares with the wide kernels
    (conv3_wgmma.cuh) inlined, so an edit can reach the helpers there too."""
    with open(SRC) as f:
        src = f.read()
    with open(HEADER) as f:
        head = f.read().replace("#pragma once\n", "")
    include = '#include "conv3_wgmma.cuh"\n'
    assert src.count(include) == 1, "conv3_ln_act.cu no longer includes its header"
    return src.replace(include, head)


def variants(src):
    def edit(text, old, new):
        assert text.count(old) == 1, f"variant edit does not apply: {old[:60]!r}"
        return text.replace(old, new)

    chained = edit(edit(edit(src, FRESH, "      float (&d)[NW / 2] = acc;\n"),
                        FIRST, FIRST.replace("tap != 0", "(tap | c) != 0")), ADD, "")
    return {"shipped": src,
            "chained": chained,
            "no_setmaxnreg": edit(edit(src, MAXNREG[0], ""), MAXNREG[1], ""),
            "cvt_rna": edit(src, INT_RNA, CVT_RNA)}


def build_all(srcs):
    from decafnet_tpu_torch.ops import cuda

    os.makedirs(OUT, exist_ok=True)
    nvcc, procs = cuda.toolkit_binary(), {}
    for name, text in srcs.items():
        cu = os.path.join(OUT, name + ".cu")
        with open(cu, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda.NVCC_FLAGS, "-shared", cu, "-o",
             os.path.join(OUT, name + ".so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(os.path.join(OUT, name + ".so")).decafnet_conv3_ln_act_f32
        fn.argtypes = cuda._SIGNATURES["decafnet_conv3_ln_act_f32"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main():
    if not torch.cuda.is_available():
        print("torch_conv3_variants: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import decafnet_tpu_torch  # noqa: F401  (TF32 off for the plain versions)
    from decafnet_tpu_torch.ops import cuda, fused_conv
    from decafnet_tpu_torch.ops.fused_conv import conv3_weight_operands

    fns = build_all(variants(shipped_source()))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)

    def launch(name, x, m8, ops, b, lw, lb, out):
        """One launch of a variant over one level."""
        B, C_in, T = x.shape
        level = (fused_conv._Level * 1)(fused_conv._Level(
            x.data_ptr(), m8.data_ptr(), out.data_ptr(), B, T))
        work = fused_conv._device_work_table(
            ((B, T),), fused_conv.conv3_tile(x.dtype, out.shape[1]), dev)
        err = fns[name](level, 1, cuda.ptr(work), work.shape[0], cuda.ptr(ops),
                        cuda.ptr(b), cuda.ptr(lw), cuda.ptr(lb),
                        C_in, out.shape[1], 1e-5, 1, cuda.stream())
        cuda.check(err, "conv3_ln_act variant")

    served = [(cs.ROWS, C, cs.T0 // 2 ** lvl, cs.row_lens(lvl),
               4 if (C == cs.EMBD + cs.RDIM or lvl == 0) else 2)
              for lvl in range(cs.LEVELS) for C in (cs.EMBD, cs.EMBD + cs.RDIM)]
    edges = [(4, cs.EMBD + cs.RDIM, T, [T, max(T - 3, 1), T // 2, 0], 0)
             for T in (1000, 36, 17, 9, 4, 3)]
    total = {n: {"decode_ms": 0.0, "max_abs_err_f64": 0.0} for n in fns}
    for B, C, T, lens, calls in served + edges:
        x = torch.randn(B, C, T, generator=g, device=dev)
        w = torch.randn(C, C, 3, generator=g, device=dev) / math.sqrt(3 * C)
        b = torch.randn(C, generator=g, device=dev)
        lw = 1 + 0.1 * torch.randn(C, generator=g, device=dev)
        lb = 0.1 * torch.randn(C, generator=g, device=dev)
        mask = cs.prefix_mask(lens, T, dev)
        m8, ops = cuda.as_bytes(mask), conv3_weight_operands(w)
        ref = cs.conv3_f64(x, mask, w, b, lw, lb)
        row = {"shape": [B, C, T], "calls_per_decode": calls}
        for name in fns:
            out = torch.empty(B, C, T, device=dev)
            launch(name, x, m8, ops, b, lw, lb, out)
            torch.cuda.synchronize()
            err = float((out.double() - ref).abs().max())
            row[name] = {"max_abs_err_f64": err}
            total[name]["max_abs_err_f64"] = max(total[name]["max_abs_err_f64"], err)
            if calls:
                ms = cs.time_ms(lambda: launch(name, x, m8, ops, b, lw, lb, out), 30)
                row[name]["ms"] = ms
                total[name]["decode_ms"] += calls * ms
        print(json.dumps(row), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"per": "one served decode call (64 rows, T=2304, 7 levels)",
                      "variants": total, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
