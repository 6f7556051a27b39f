#!/usr/bin/env python3
"""Launch plans and design variants of the port's band-attention and q/k/v
trio kernels, on one card.

    python3 scripts/torch_band_trio_plans.py [--repo ROOT] [--only NAME ...]

``--repo`` names the root of the tree whose ``decafnet_tpu_torch`` and
``csrc`` run (default: this one; for example the parent commit unpacked by
``git archive`` into ``build/parent``). ``--only`` keeps the studies named
(``band_attention``, ``band_attention_bf16``, ``band_attention_bf16_layouts``,
``qkv_depthwise_ln``, ``qkv_depthwise_ln_bf16``).

Plans: through the tree's library, runs every launch plan the kernels take
at the served shapes of one decode call (64 rows, T=2304; band attention at
all 7 FPN levels in f32 and in bf16, the trio at level 0 in f32 and in
bf16). Band attention in f32 (and the block-per-tile bf16 kernel of a
parent tree) takes (tile, split) = time columns per block and lanes per
query; the bf16 band kernel takes (split, grid) = lanes per query pair (1:
its TMA pipeline, where it reads the views; 4: its direct warps) and
blocks; the trio takes tile = time columns per block. The layouts study
runs every bf16 band plan at views other than the served ones: a seq2
rank's 7 levels (32 rows, 1152 / 2^l columns + 2 halo columns each side)
as (B, H, T, D) tensors and time-minor, and the served level 0 one element
off 16 bytes and in rows padded to 8 bytes. Each plan is held against the
plain version (it must agree within chip_smoke's tolerance, in bf16 its 2
bf16 eps of max(1, |plain|)) and timed with CUDA events. One JSON line per
shape: every plan's time and error, the wrapper's plan, the fastest plan.

Variants: builds edited copies of csrc/band_attention.cu and
csrc/qkv_depthwise_ln.cu (each edit must apply exactly once), one nvcc per
variant, all started together, into <repo>/build/band_trio_variants/, and
times each at the wrapper's plans on the same inputs: both f32 kernels
without the masked-tail skip, the trio with 1 or 2 lanes per column instead
of 4, and the bf16 band kernel's phase study. That study has one edit set
per design of the bf16 band kernel (chosen by the source it finds):
"phases" adds clock64 counts per phase, summed over blocks or items (the
block-per-tile design: per block, read by thread 0 at the kernel's own
barriers: mask staging, copies + q loads, score loop + softmax, value loop
+ stores; the persistent design: per item of its TMA pipeline (split 1),
read by lane 0 of each producer and consumer warp: the producer's wait for
a free stage, its mask + issue, its mask alone; the consumer's wait for a
full stage; and per warp item of either split, the score loop + softmax,
the value loop + stores), "no_halo" drops the halo columns' loads (split
1), "no_stores" the
output stores, "q_smem" stages q in shared memory (block-per-tile design;
the persistent one already does) and, in the persistent design, "q_regs"
reads q into registers before the score loop, "mask_ahead4" holds the
masks of 4 items ahead instead of 2, "loads_only"
releases each stage unread (no arithmetic, no stores) and "compute_only"
issues no boxes (the arithmetic on stale stages). Variants that change the
function ("no_halo", "no_stores", "loads_only", "compute_only") are timed
only.

Last line: per kernel, the time per served decode call with the wrapper's
plans, with the fastest plan at each shape, and per variant, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BAND_TILES = (32, 64, 96, 128, 192, 256)
TRIO_TILES = (16, 32, 64, 96, 128)
MAX_THREADS = 512  # the f32 kernels' __launch_bounds__

# ---------------------------------------------------------------- variants
# the same source with one edit set each: [(old, new), ...]

TRIO_LANES = "constexpr int CS = 4;"
F32_VARIANTS = {
    "band_attention": ("band_attention", "decafnet_band_attention_f32", {
        "no_tail_skip": [("if (!__syncthreads_or(valid)) {",
                          "if (!__syncthreads_or(valid) && false) {")]}),
    "qkv_depthwise_ln": ("qkv_depthwise_ln", "decafnet_qkv_depthwise_ln_f32", {
        "no_tail_skip": [("all = __syncthreads_and(all);\n  if (!any) {",
                          "all = __syncthreads_and(all);\n  if (!any && false) {")],
        "lanes1": [(TRIO_LANES, "constexpr int CS = 1;")],
        "lanes2": [(TRIO_LANES, "constexpr int CS = 2;")]}),
}

# clock64 sums of the phase study: g_phase[i] over every block (or item),
# read and zeroed by decafnet_band_phases
PHASE_COUNTERS = """
__device__ unsigned long long g_phase[8];
extern "C" int decafnet_band_phases(unsigned long long* host) {
  cudaError_t e = cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phase, z, sizeof(g_phase));
  return (int)e;
}
"""
PHASE_ADD = "atomicAdd(&g_phase[{}], (unsigned long long)({}));"

# the block-per-tile design (the template band_attention_kernel<E, ...>,
# in both dtypes in a parent tree): per block, thread 0's clock at the
# kernel's own barriers
TILED_PHASES = [
    ('#include "cp_async.cuh"\n', '#include "cp_async.cuh"\n' + PHASE_COUNTERS),
    ("  E* ob = out + (size_t)bh * D * T + t;\n",
     "  E* ob = out + (size_t)bh * D * T + t;\n  const long long c0_ = clock64();\n"),
    ("  if (!__syncthreads_or(valid)) {  // no valid query in the tile: zeros, no loads\n",
     "  const int any_ = __syncthreads_or(valid);\n"
     "  const long long c1_ = clock64();\n"
     "  if (tid == 0) {\n"
     "    " + PHASE_ADD.format(0, "c1_ - c0_") + "\n"
     "    " + PHASE_ADD.format(4, "1") + "\n"
     "    if (!any_) " + PHASE_ADD.format(5, "1") + "\n"
     "  }\n"
     "  if (!any_) {\n"),
    ("  cp_async_wait_all();\n  __syncthreads();\n",
     "  cp_async_wait_all();\n  __syncthreads();\n  const long long c2_ = clock64();\n"
     "  if (tid == 0) " + PHASE_ADD.format(1, "c2_ - c1_") + "\n"),
    ("  if (t >= T) return;\n",
     "  const long long c3_ = clock64();\n"
     "  if (tid == 0) " + PHASE_ADD.format(2, "c3_ - c2_") + "\n"
     "  if (t >= T) return;\n"),
    ("    put(ob + (size_t)d * T, valid ? acc : 0.f);\n  }\n}\n",
     "    put(ob + (size_t)d * T, valid ? acc : 0.f);\n  }\n"
     "  if (tid == 0) " + PHASE_ADD.format(3, "clock64() - c3_") + "\n}\n"),
]
TILED_PHASE_NAMES = ("mask_staging", "copies_and_q", "scores_softmax",
                     "values_stores", "blocks", "skipped_blocks")
TILED_EDITS = {
    "phases": TILED_PHASES,
    "no_halo": [("  for (int i = tid; i < 2 * HALO * D; i += nthreads) {",
                 "  for (int i = tid; i < 0 * HALO * D; i += nthreads) {")],
    "no_stores": [("    put(ob + (size_t)d * T, valid ? acc : 0.f);\n",
                   "    if (__float_as_uint(acc) == 0x7fc00001u) put(ob + (size_t)d * T, acc);\n")],
    "q_smem": [
        ("  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + D * row);  // [tile + 2 HALO]\n",
         "  E* qs = vs + D * row;\n"
         "  uint8_t* ms = reinterpret_cast<uint8_t*>(qs + D * row);  // [tile + 2 HALO]\n"),
        ("        cp_async16(vd, vb + off);\n",
         "        cp_async16(vd, vb + off);\n"
         "        cp_async16(qs + d * row + PAD + V * ch, q + base + off);\n"),
        ("          stage1(vd + e, in ? vb + off + e : vb, in);\n",
         "          stage1(vd + e, in ? vb + off + e : vb, in);\n"
         "          stage1(qs + d * row + PAD + V * ch + e, in ? q + base + off + e : q + base, in);\n"),
        ("      stage1(vs + d * row + PAD + c, vb + tc + d * sd, in);\n",
         "      stage1(vs + d * row + PAD + c, vb + tc + d * sd, in);\n"
         "      stage1(qs + d * row + PAD + c, q + base + tc + d * sd, in);\n"),
        ("  for (int i = 0; i < DL; ++i) qr[i] = to_f32(qt[(long long)(i * SPLIT + part) * sd]);\n",
         "  (void)qt;\n"),
        ("  cp_async_wait_all();\n  __syncthreads();\n",
         "  cp_async_wait_all();\n  __syncthreads();\n#pragma unroll\n"
         "  for (int i = 0; i < DL; ++i) qr[i] = to_f32(qs[(i * SPLIT + part) * row + PAD + tq]);\n"),
        ("  const size_t smem = sizeof(E) * 2 * D * row +",
         "  const size_t smem = sizeof(E) * 3 * D * row +")],
}
# which variants keep the function (held against the plain version)
KEEPS_FUNCTION = {"phases", "q_smem", "no_tail_skip", "lanes1", "lanes2"}

# the persistent design (band_attention_bf16_kernel): at split 1 per item,
# lane 0 of each producer warp and of each consumer warp; the arithmetic
# (pair_attention) also counts the split-4 warps' items
PERSISTENT_MARKER = "band_attention_bf16_kernel"
PERSISTENT_PHASES = [
    ('#include "hopper.cuh"\n', '#include "hopper.cuh"\n' + PHASE_COUNTERS),
    ("      mbar_wait(&empty[s], ((n / BF_STAGES) & 1) ^ 1);\n",
     "      const long long pc0_ = clock64();\n"
     "      mbar_wait(&empty[s], ((n / BF_STAGES) & 1) ^ 1);\n"
     "      const long long pc1_ = clock64();\n"),
    ("      __syncwarp();  // the warp's stores above, before any of its lanes arrives\n",
     "      __syncwarp();  // the warp's stores above, before any of its lanes arrives\n"
     "      if (lane == 0) " + PHASE_ADD.format(7, "clock64() - pc1_") + "\n"),
    ("        else\n          mbar_arrive(&full[s]);\n        continue;\n",
     "        else\n          mbar_arrive(&full[s]);\n"
     "        if (lane == 0) {\n"
     "          " + PHASE_ADD.format(0, "pc1_ - pc0_") + "\n"
     "          " + PHASE_ADD.format(1, "clock64() - pc1_") + "\n"
     "        }\n"
     "        continue;\n"),
    ("      mbar_arrive(&full[s]);\n    }\n  }\n}\n",
     "      mbar_arrive(&full[s]);\n"
     "      if (lane == 0) {\n"
     "        " + PHASE_ADD.format(0, "pc1_ - pc0_") + "\n"
     "        " + PHASE_ADD.format(1, "clock64() - pc1_") + "\n"
     "      }\n"
     "    }\n  }\n}\n"),
    ("    mbar_wait(&full[s], (n / BF_STAGES) & 1);\n",
     "    const long long cc0_ = clock64();\n"
     "    mbar_wait(&full[s], (n / BF_STAGES) & 1);\n"
     "    if ((threadIdx.x & 31) == 0) {\n"
     "      " + PHASE_ADD.format(2, "clock64() - cc0_") + "\n"
     "      " + PHASE_ADD.format(5, "1") + "\n"
     "    }\n"),
    ("    if (!flags[s]) {  // no valid query in the tile: zeros, nothing loaded\n",
     "    if (!flags[s]) {  // no valid query in the tile: zeros, nothing loaded\n"
     "      if (lane == 0) " + PHASE_ADD.format(6, "1") + "\n"),
    ("  float s0[WIN], s1[WIN];                // scores of the queries at t and t + 1\n",
     "  const long long pa0_ = clock64();\n"
     "  float s0[WIN], s1[WIN];                // scores of the queries at t and t + 1\n"),
    ("  const bool valid0 = (ok >> HALO) & 1, valid1 = (ok >> (HALO + 1)) & 1;\n",
     "  const bool valid0 = (ok >> HALO) & 1, valid1 = (ok >> (HALO + 1)) & 1;\n"
     "  const long long pa1_ = clock64();\n"
     "  if ((threadIdx.x & 31) == 0) " + PHASE_ADD.format(3, "pa1_ - pa0_") + "\n"),
    ("    out(i, valid0 ? a0 : 0.f, valid1 ? a1 : 0.f);\n  }\n}\n",
     "    out(i, valid0 ? a0 : 0.f, valid1 ? a1 : 0.f);\n  }\n"
     "  if ((threadIdx.x & 31) == 0) " + PHASE_ADD.format(4, "clock64() - pa1_") + "\n}\n"),
]
PERSISTENT_PHASE_NAMES = ("producer_wait_free", "producer_mask_issue",
                          "consumer_wait_full", "scores_softmax", "values_stores",
                          "consumer_warp_items", "skipped_warp_items",
                          "producer_mask")
PERSISTENT_EDITS = {
    "phases": PERSISTENT_PHASES,
    "no_halo": [
        ("encode_view(&maps.k, l.k, l.B, l.H, l.T, l.sb, l.sh, l.sd, BF_W);",
         "encode_view(&maps.k, l.k, l.B, l.H, l.T, l.sb, l.sh, l.sd, BF_TILE);"),
        ("encode_view(&maps.v, l.v, l.B, l.H, l.T, l.sb, l.sh, l.sd, BF_W);",
         "encode_view(&maps.v, l.v, l.B, l.H, l.T, l.sb, l.sh, l.sd, BF_TILE);"),
        ("  mbar_arrive_expect_tx(full, BF_LOAD);",
         "  mbar_arrive_expect_tx(full, BF_QBYTES + 4 * BF_D * BF_TILE);")],
    "no_stores": [("                              store_pair(ob + (size_t)d * a.T, a0, a1, t, a.T, even);",
                   "                              if (__float_as_uint(a0) == 0x7fc00001u) "
                   "store_pair(ob + (size_t)d * a.T, a0, a1, t, a.T, even);")],
    "q_regs": [("    pair_attention<HALO, 1>([&](int d) { return qs[d * (BF_TILE / 2)]; },",
                "    uint32_t qr[BF_D];\n#pragma unroll\n"
                "    for (int d = 0; d < BF_D; ++d) qr[d] = qs[d * (BF_TILE / 2)];\n"
                "    pair_attention<HALO, 1>([&](int d) { return qr[d]; },")],
    "mask_ahead4": [("constexpr int BF_MASK_AHEAD = 2;", "constexpr int BF_MASK_AHEAD = 4;")],
    # the two halves alone: the consumers release each full stage unread (the
    # producers' loads alone), or the producers issue no boxes (the
    # consumers' arithmetic alone, on whatever the stages hold)
    "loads_only": [
        ("    const uint32_t* qs = reinterpret_cast<const uint32_t*>(stage) + col / 2;\n",
         "    if (BF_W) {\n      __syncwarp();\n      if (lane == 0) mbar_arrive(&empty[s]);\n"
         "      continue;\n    }\n"
         "    const uint32_t* qs = reinterpret_cast<const uint32_t*>(stage) + col / 2;\n")],
    "compute_only": [
        ("  mbar_arrive_expect_tx(full, BF_LOAD);\n",
         "  mbar_arrive(full);\n  if (BF_LOAD) return;\n  mbar_arrive_expect_tx(full, BF_LOAD);\n")],
}
KEEPS_FUNCTION.update({"q_regs", "mask_ahead4"})


def bf16_band_design(src):
    """(design name, edit sets, phase names) of the bf16 band kernel in
    ``src``."""
    if PERSISTENT_MARKER in src:
        return "persistent", PERSISTENT_EDITS, PERSISTENT_PHASE_NAMES
    return "block_per_tile", TILED_EDITS, TILED_PHASE_NAMES


def plans(tiles, T, splits):
    """(tile, split) pairs the f32 kernel takes (tile a multiple of
    32 // split, at most MAX_THREADS threads) with fewer than two tiles'
    worth of columns past T."""
    out = []
    for split in splits:
        for tile in tiles:
            if tile % (32 // split) == 0 and tile * split <= MAX_THREADS \
                    and tile < 2 * T:
                out.append((tile, split))
    return out


def bf16_plans(la, B, H, T, sms, pipelined):
    """The (split, grid) plans the bf16 band kernel of a tree's
    local_attention ``la`` takes: split 1 (its TMA pipeline, where it reads
    the views) at a block per multiprocessor, split 4 (its direct warps) at
    a warp per item."""
    items = B * H * -(-T // la.BAND_BF16_TILE)
    warp_items = B * H * -(-T // la.BAND_BF16_WARP_COLS)
    return ([(1, min(items, sms))] if pipelined else []) + [
        (4, -(-warp_items // la.BAND_BF16_WARPS))]


def build_variants(repo, only):
    """{(study, variant): C function} of every edited build."""
    from decafnet_tpu_torch.ops import cuda

    csrc = os.path.join(repo, "decafnet_tpu_torch", "csrc")
    out_dir = os.path.join(repo, "build", "band_trio_variants")
    os.makedirs(out_dir, exist_ok=True)
    sets = dict(F32_VARIANTS)
    with open(os.path.join(csrc, "band_attention.cu")) as f:
        design, edits, _ = bf16_band_design(f.read())
    sets["band_attention_bf16"] = ("band_attention", "decafnet_band_attention_bf16",
                                   edits)
    flags = [f if f != cuda.CSRC_DIR else csrc for f in cuda.NVCC_FLAGS]
    nvcc, procs = cuda.toolkit_binary(), {}
    for study, (source, _, variants) in sets.items():
        if study not in only:
            continue
        with open(os.path.join(csrc, source + ".cu")) as f:
            src = f.read()
        for name, pairs in variants.items():
            text = src
            for old, new in pairs:
                assert text.count(old) == 1, f"variant edit does not apply: {old!r}"
                text = text.replace(old, new)
            cu = os.path.join(out_dir, f"{study}_{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            procs[(study, name)] = subprocess.Popen(
                [nvcc, *flags, "-shared", cu, "-o", cu[:-3] + ".so"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for (study, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {study} {name}:\n{log}")
        entry = sets[study][1]
        lib = ctypes.CDLL(os.path.join(out_dir, f"{study}_{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = cuda._SIGNATURES[entry]
        fn.restype = ctypes.c_int
        if name == "phases":
            fn.phases = lib.decafnet_band_phases
            fn.phases.argtypes = [ctypes.c_void_p]
            fn.phases.restype = ctypes.c_int
        fns[(study, name)] = fn
    return fns, design


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--repo", default=HERE)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_band_trio_plans: needs a CUDA device", file=sys.stderr)
        return 2
    repo = os.path.abspath(args.repo)
    sys.path.insert(0, HERE)
    import chip_smoke as cs     # this tree's shapes, timing and tolerances
    sys.path.insert(0, repo)
    import decafnet_tpu_torch  # noqa: F401  (TF32 off for the plain versions)
    from decafnet_tpu_torch.ops import cuda, fused_conv, local_attention

    assert os.path.dirname(cuda.__file__).startswith(repo)
    studies = ("band_attention", "band_attention_bf16", "band_attention_bf16_layouts",
               "qkv_depthwise_ln", "qkv_depthwise_ln_bf16")
    only = set(args.only or studies)
    cuda.library()
    fns, design = build_variants(repo, only)
    new_bf16 = hasattr(local_attention, "band_attention_bf16_plan")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED)
    total = {k: {"wrapper_plans_ms": 0.0, "fastest_plans_ms": 0.0,
                 **{n: 0.0 for (kk, n) in fns if kk == k}}
             for k in studies if k in only}

    def band_variant(fn, q, k, v, mask, window, plan):
        B, H, T, D = q.shape
        out = torch.empty((B, H, D, T), device=dev, dtype=q.dtype)
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

    def phases(fn, run):
        """Per-phase clock64 sums of one launch of the instrumented build."""
        buf = (ctypes.c_ulonglong * 8)()
        cuda.check(fn.phases(ctypes.cast(buf, ctypes.c_void_p)), "phases")
        run()
        torch.cuda.synchronize()
        cuda.check(fn.phases(ctypes.cast(buf, ctypes.c_void_p)), "phases")
        names = (PERSISTENT_PHASE_NAMES if design == "persistent" else TILED_PHASE_NAMES)
        counts = list(buf)
        return {"cycles": dict(zip(names, counts)),
                "raw": counts}

    def study(kernel, level, args, chosen, candidates, launch, variant, **extra):
        op = "band_attention" if kernel.startswith("band") else "qkv_depthwise_ln"
        bf16 = "_bf16" in kernel
        tol = cs.TOL_BF16 if bf16 else cs.TOL[op]

        def error(got, want):
            return cs.bf16_err(got, want)[1] if bf16 else cs.max_err(got, want)

        with cuda.plain_versions():
            want = getattr(local_attention if op == "band_attention"
                           else fused_conv, op)(*args)
        row = {"kernel": kernel, "level": level, "shape": list(args[0].shape),
               **extra, "wrapper_plan": chosen, "plans": []}
        for plan in candidates:
            got = launch(*args, plan)
            err = error(got, want)
            assert err <= tol, (kernel, level, plan, err)
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
            got = variant(fn, *args, chosen)
            rec = {"keeps_function": name in KEEPS_FUNCTION}
            if name in KEEPS_FUNCTION:
                err = error(got, want)
                assert err <= tol, (kernel, name, err)
                rec["max_abs_err"] = err
            rec["ms"] = cs.time_ms(lambda: variant(fn, *args, chosen), 20)
            if name == "phases":
                rec.update(phases(fn, lambda: variant(fn, *args, chosen)))
            row["variants"][name] = rec
            total[kernel][name] += rec["ms"]
        print(json.dumps(row), flush=True)

    def band_candidates(args):
        q, T = args[0], args[0].shape[2]
        if q.dtype == torch.bfloat16 and new_bf16:
            return bf16_plans(local_attention, q.shape[0], cs.HEADS, T,
                              cuda.sm_count(dev),
                              local_attention.band_bf16_pipelined(*args[:3]))
        return plans(BAND_TILES, T, (1, 2, 4))

    def band_plan(args):
        """The plan the tree's wrapper launches for these views."""
        q, T = args[0], args[0].shape[2]
        if q.dtype == torch.bfloat16 and new_bf16:
            return local_attention.band_attention_bf16_plan(
                q.shape[0], cs.HEADS, T, cuda.sm_count(dev),
                local_attention.band_bf16_pipelined(*args[:3]))
        return local_attention.band_attention_plan(
            q.shape[0], cs.HEADS, T, cuda.sm_count(dev))

    for level in range(cs.LEVELS):
        T = cs.T0 // 2 ** level
        lens = cs.row_lens(level)
        for dtype in (torch.float32, torch.bfloat16):
            kernel = "band_attention" + ("_bf16" if dtype == torch.bfloat16 else "")
            if kernel not in only:
                continue
            args, _ = cs.band_case(dev, g, cs.ROWS, T, lens, dtype=dtype)
            chosen = band_plan(args)
            cands = band_candidates(args)
            cands += [chosen] if chosen not in cands else []
            study(kernel, level, args, chosen, cands,
                  local_attention.launch_band_attention, band_variant)
            del args
        if level == 0:
            trio = lambda *a: fused_conv.launch_qkv_depthwise_ln(  # noqa: E731
                *a[:-1], 1e-5, a[-1])
            if "qkv_depthwise_ln" in only:
                args, _ = cs.trio_case(dev, g, cs.ROWS, cs.EMBD, T, lens)
                chosen = fused_conv.qkv_depthwise_ln_plan(T)
                cands = [t for t, _ in plans(TRIO_TILES, T, (fused_conv.QKV_LANES,))]
                cands += [chosen] if chosen not in cands else []
                study("qkv_depthwise_ln", level, args, chosen, cands, trio,
                      trio_variant)
            if "qkv_depthwise_ln_bf16" in only:
                # bf16: two columns per lane, so tiles of 16 columns
                args, _ = cs.trio_case(dev, g, cs.ROWS, cs.EMBD, T, lens,
                                       dtype=torch.bfloat16)
                chosen = fused_conv.qkv_depthwise_ln_plan(T, torch.bfloat16)
                cands = [t for t in TRIO_TILES if t % 16 == 0]
                cands += [chosen] if chosen not in cands else []
                study("qkv_depthwise_ln_bf16", level, args, chosen, cands, trio,
                      None)
    # the bf16 kernel at the views of a time-sharded rank (seq2: 32 rows,
    # level l's block of 1152 / 2^l columns and the halo on each side), as
    # (B, H, T, D) tensors and time-minor (what band_attention hands over),
    # and at the served level 0 one element off 16 bytes and in padded rows
    if "band_attention_bf16_layouts" in only:
        h = cs.WINDOW // 2
        cases = [("seq2_rank", 32, cs.T0 // 2 // 2 ** lvl + 2 * h, lvl, how)
                 for lvl in range(cs.LEVELS) for how in ("contiguous", "as_is")]
        cases += [("served", cs.ROWS, cs.T0, 0, how) for how in ("offset", "padded")]
        for where, B, T, level, how in cases:
            lens = [min(n, T) for n in cs.row_lens(level)[:B]]
            args, _ = cs.band_case(dev, g, B, T, lens, how=how, dtype=torch.bfloat16)
            chosen = band_plan(args)
            cands = band_candidates(args)
            cands += [chosen] if chosen not in cands else []
            study("band_attention_bf16_layouts", level, args, chosen, cands,
                  local_attention.launch_band_attention, band_variant,
                  where=where, layout=how, strides=list(args[0].stride()))
            del args
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"per": "one served decode call (64 rows, T=2304; band "
                      "attention 7 levels, trio level 0)", "ms": total,
                      "bf16_band_design": design,
                      "repo": os.path.relpath(repo, HERE), "card": smi}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
