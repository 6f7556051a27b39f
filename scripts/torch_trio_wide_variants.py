#!/usr/bin/env python3
"""Design study of the wide trio kernels (decafnet_tpu_torch/csrc/
qkv_depthwise_ln_wide.cu) on one card, f32 and bf16: every launch plan the
kernel takes at the embd-512 and embd-1024 legs' widths, 64 rows x T = 2304,
each named c<cluster>_t<tile>_k<chunk>, in three families:

  cluster     2 to 8 blocks split the channels, each stages its share once
              (chunk = share): the lead design;
  one_block   one block stages all C channels once, at tiles narrow enough
              to fit (no cluster barrier, a larger halo share);
  l2_reread   the block stages fewer channels than its share at once and
              stages them again for the outputs, from L2 (chunk < share);

beside the wrapper's plan (qkv_wide_plan) and the general kernel
(csrc/qkv_depthwise_ln_general.cu). Every plan also runs on variants of
the source made by editing its text (each edit must apply, or the script
fails; one nvcc per variant, all started together, into
build/trio_wide_variants/), named <plan>@<variant>:

  regs64      the blocks of 256 threads the launch bounds ask a
              multiprocessor to hold (as shipped: f32 4, 64 registers a
              thread; bf16 3, 80) set to 4 in both dtypes: 64 registers;
  regs80      3 blocks: 80 registers;
  regs128     2 blocks: 128 registers;
  two_pass    a chunk's statistics in two passes over its channels, as the
              tuned kernel takes them (the lanes' sums by an xor tree give
              the mean, then the centred squares' sums M2), in place of each
              lane's Welford pass and the lanes' merge.

    python3 scripts/torch_trio_wide_variants.py [--widths 512 1024]

Each plan runs on the same inputs (rows valid, partly valid and masked, as
chip_smoke.py's served rows) and is held against the plain version
(qkv_depthwise_ln_torch; f32 within 1e-5, bf16 within 2 bf16 eps of max(1,
|plain|)), then the device time of each, timed in turns (first ... last,
last ... first; CUDA events), with the byte bound (x read once, q, k, v
written once, the mask; at 3.35 TB/s). One JSON line per (dtype, C) with
every plan's time and share of the bound, the fastest of each family, after
one line with the card's name and power limit and ptxas's report of the
source.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TILES = (16, 32, 64, 128)
SRC = os.path.join(REPO, "decafnet_tpu_torch", "csrc", "qkv_depthwise_ln_wide.cu")
OUT = os.path.join(REPO, "build", "trio_wide_variants")
BOUNDS = "return sizeof(E) == 2 ? 3 : 4;"
ONE_PASS = ("    // one pass: each lane's running", "      nl += nb;\n    }\n")
TWO_PASS = """    // two passes: the lanes' sums give the mean, then the centred squares
#pragma unroll 4
    for (int c = part; c < nc; c += CS) {
      float y[3][V];
      conv(c, y);
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v) mk[s][v] += y[s][v];
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int o = QW; o < 32; o <<= 1) mk[s][v] += __shfl_xor_sync(0xffffffffu, mk[s][v], o);
        mk[s][v] /= (float)nc;
      }
#pragma unroll 4
    for (int c = part; c < nc; c += CS) {
      float y[3][V];
      conv(c, y);
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = y[s][v] - mk[s][v];
          qk[s][v] = fmaf(d, d, qk[s][v]);
        }
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v)
#pragma unroll
        for (int o = QW; o < 32; o <<= 1) qk[s][v] += __shfl_xor_sync(0xffffffffu, qk[s][v], o);
"""
VARIANTS = {"regs64": (BOUNDS, "return 4;"), "regs80": (BOUNDS, "return 3;"),
            "regs128": (BOUNDS, "return 2;"), "two_pass": (ONE_PASS, TWO_PASS)}


def edit(src, old, new):
    """``src`` with ``old`` replaced by ``new``; ``old`` a string, or a pair
    (first line, last line) whose span from the first through the last is
    replaced. Fails unless it occurs once."""
    if isinstance(old, tuple):
        assert src.count(old[0]) == 1, f"variant edit does not apply: {old[0]!r}"
        i = src.index(old[0])
        j = src.index(old[1], i) + len(old[1])
        return src[:i] + new + src[j:]
    assert src.count(old) == 1, f"variant edit does not apply: {old!r}"
    return src.replace(old, new)
ENTRIES = ("decafnet_qkv_depthwise_ln_wide_f32", "decafnet_qkv_depthwise_ln_wide_bf16")


def build_variants():
    """The source with each of VARIANTS' edits, built side by side: name ->
    (library, ptxas report)."""
    import chip_smoke as cs
    from decafnet_tpu_torch.ops import cuda

    with open(SRC) as f:
        src = f.read()
    os.makedirs(OUT, exist_ok=True)
    nvcc, procs = cuda.toolkit_binary(), {}
    for name, (old, new) in VARIANTS.items():
        cu = os.path.join(OUT, name + ".cu")
        with open(cu, "w") as f:
            f.write(edit(src, old, new))
        procs[name] = subprocess.Popen(
            [nvcc, *cuda.NVCC_FLAGS, "-shared", cu, "-o", os.path.join(OUT, name + ".so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, name + ".so"))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes = cuda._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        out[name] = (lib, cs.ptxas_report(log))
    return out


def on_library(lib, fn):
    """``fn`` with the kernel library swapped for ``lib`` while it runs."""
    from decafnet_tpu_torch.ops import cuda

    def run():
        saved = cuda.library
        cuda.library = lambda: lib
        try:
            return fn()
        finally:
            cuda.library = saved
    return run


def candidates(C, T, dtype):
    """Every plan the kernel takes at (C, T) among clusters 1-8, TILES and
    chunks of the share, 256 and 128 channels: name -> (family, plan)."""
    from decafnet_tpu_torch.ops import fused_conv as fc

    out = {"plan": ("plan", fc.qkv_wide_plan(C, T, dtype))}
    for cluster in range(1, fc.QKV_WIDE_MAX_CLUSTER + 1):
        share = -(-C // cluster)
        for tile in TILES:
            for chunk in sorted({share, 256, 128}, reverse=True):
                if chunk > share:
                    continue
                try:
                    p = fc.qkv_wide_plan(C, T, dtype, cluster, tile, chunk)
                except ValueError:
                    continue
                family = ("l2_reread" if chunk < share else
                          "one_block" if cluster == 1 else "cluster")
                out[f"c{cluster}_t{tile}_k{chunk}"] = (family, p)
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
    ap.add_argument("--widths", type=int, nargs="+", default=[512, 1024])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import decafnet_tpu_torch  # noqa: F401
    from decafnet_tpu_torch import ops
    from decafnet_tpu_torch.ops import cuda, fused_conv as fc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    cuda.library()
    variants = build_variants()
    print(json.dumps({"card": smi, "ptxas": cs.ptxas_report(
        cuda.build_log("qkv_depthwise_ln_wide.cu")),
        **{f"ptxas@{n}": rep for n, (_, rep) in variants.items()}}), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    T = cs.T0
    ok = True
    for dtype in (torch.float32, torch.bfloat16):
        esz = 2 if dtype == torch.bfloat16 else 4
        for C in args.widths:
            trio_args, _ = cs.trio_case(dev, g, cs.ROWS, C, T, cs.row_lens(0), dtype=dtype)
            plans = candidates(C, T, dtype)
            fns = {name: (lambda p=p: fc.launch_qkv_depthwise_ln_wide(*trio_args, 1e-5, p))
                   for name, (_, p) in plans.items()}
            for name, (family, p) in list(plans.items()):
                for vname, (lib, _) in variants.items():
                    plans[f"{name}@{vname}"] = (family, p)
                    fns[f"{name}@{vname}"] = on_library(lib, fns[name])
            fns["general"] = lambda: fc.launch_qkv_depthwise_ln_general(*trio_args, 1e-5)
            with cuda.plain_versions():
                want = ops.qkv_depthwise_ln(*trio_args)
            n_bytes = esz * 4 * cs.ROWS * C * T + 4 * 15 * C + cs.ROWS * T
            bound = 1e3 * n_bytes / cs.HBM_BYTES_PER_S
            rec = {"dtype": str(dtype).split(".")[-1], "C": C, "rows": cs.ROWS, "T": T,
                   "card": smi, "bound_ms": bound, "plans": {}}
            for name, fn in fns.items():
                got = fn()
                torch.cuda.synchronize()
                a, r = cs.bf16_err(got, want)
                good = all(bool(torch.isfinite(t).all()) for t in got) and (
                    r <= cs.TOL_BF16 if esz == 2 else a <= cs.TOL["qkv_depthwise_ln"])
                ok &= good
                rec["plans"][name] = {"max_abs_err": a, "max_rel_err": r, "ok": good}
                if name in plans:
                    rec["plans"][name].update(family=plans[name][0], **plans[name][1]._asdict())
                del got
            slow = {"general": fns.pop("general")}
            for name, (ms, spread) in (in_turns(fns, 10) | in_turns(slow, 3)).items():
                rec["plans"][name].update(ms=ms, spread_ms=spread, share=bound / ms)
            rec["fastest"] = {
                fam: min((n for n, v in rec["plans"].items() if v.get("family") == fam),
                         key=lambda n: rec["plans"][n]["ms"], default=None)
                for fam in ("plan", "cluster", "one_block", "l2_reread")}
            rec["fastest_ms"] = {fam: rec["plans"][n]["ms"] if n else None
                                 for fam, n in rec["fastest"].items()}
            rec["fastest_by_build"] = {
                b: min((n for n in rec["plans"] if n != "general"
                        and (n.endswith("@" + b) if b != "shipped" else "@" not in n)),
                       key=lambda n: rec["plans"][n]["ms"])
                for b in ("shipped", *variants)}
            # each plan: as shipped over each variant
            rec["shipped_over_variant"] = {
                b: {n: v["ms"] / rec["plans"][f"{n}@{b}"]["ms"]
                    for n, v in rec["plans"].items() if f"{n}@{b}" in rec["plans"]}
                for b in variants}
            print(json.dumps(rec), flush=True)
            del trio_args, want, fns, slow
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
